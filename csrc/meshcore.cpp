// meshcore — native host-side mesh preprocessing for pumipic_jax.
//
// Plays the role of the reference's C++ mesh-distribution machinery
// (src/pumipic_part_construct.cpp BFS kernels, src/pumipic_lb.cpp sbar maps,
// src/pumipic_comm.cpp setupComm index builds) for the offline picpart
// pipeline: the hot preprocessing loops that are irreducibly sequential or
// hash-heavy run here instead of Python.  Exposed with a plain C ABI and
// loaded via ctypes (pumipic_jax/native.py); every entry point has a numpy
// fallback so the library is an accelerator, not a dependency.
//
// Build: g++ -O3 -march=native -shared -fPIC meshcore.cpp -o libmeshcore.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// BFS distance (in vertex-bridge hops) from a seed element set.
// elem2verts: E*k vertex ids; dist out: E entries (INT64_MAX beyond cap).
void pp_bfs_layers(int64_t E, int64_t V, int64_t k,
                   const int64_t* elem2verts, const uint8_t* seed,
                   int64_t max_layers, int64_t* dist) {
  // vertex -> elems CSR
  std::vector<int64_t> deg(V + 1, 0);
  for (int64_t i = 0; i < E * k; ++i) deg[elem2verts[i] + 1]++;
  for (int64_t v = 0; v < V; ++v) deg[v + 1] += deg[v];
  std::vector<int64_t> v2e(E * k);
  {
    std::vector<int64_t> cur(deg.begin(), deg.end() - 1);
    for (int64_t e = 0; e < E; ++e)
      for (int64_t j = 0; j < k; ++j)
        v2e[cur[elem2verts[e * k + j]]++] = e;
  }

  const int64_t INF = INT64_MAX;
  std::vector<int64_t> vdist(V, INF);
  std::vector<int64_t> frontier;
  for (int64_t e = 0; e < E; ++e) {
    dist[e] = seed[e] ? 0 : INF;
    if (seed[e]) frontier.push_back(e);
  }
  std::vector<int64_t> next;
  for (int64_t layer = 1; layer <= max_layers && !frontier.empty(); ++layer) {
    next.clear();
    for (int64_t e : frontier) {
      for (int64_t j = 0; j < k; ++j) {
        int64_t v = elem2verts[e * k + j];
        if (vdist[v] != INF) continue;
        vdist[v] = layer;
        for (int64_t t = deg[v]; t < deg[v + 1]; ++t) {
          int64_t ne = v2e[t];
          if (dist[ne] > layer) {
            dist[ne] = layer;
            next.push_back(ne);
          }
        }
      }
    }
    frontier.swap(next);
  }
}

// Distinct safe-set ("sbar") computation.  safe: R*Eg row-major flags.
// Returns S (number of sbars with >= 2 members).  sbar_of_elem: Eg entries
// (-1 for none/singleton).  members: flattened member-rank lists with
// offsets (members_off has S+1 entries).  Requires R <= 64.
int64_t pp_sbar_map(int64_t R, int64_t Eg, const uint8_t* safe,
                    int64_t* sbar_of_elem, int64_t* members,
                    int64_t* members_off, int64_t members_cap) {
  if (R > 64) return -1;
  std::unordered_map<uint64_t, int64_t> ids;
  std::vector<uint64_t> masks;
  for (int64_t g = 0; g < Eg; ++g) {
    uint64_t m = 0;
    for (int64_t r = 0; r < R; ++r)
      if (safe[r * Eg + g]) m |= (uint64_t(1) << r);
    if (__builtin_popcountll(m) < 2) {
      sbar_of_elem[g] = -1;
      continue;
    }
    auto it = ids.find(m);
    if (it == ids.end()) {
      it = ids.emplace(m, (int64_t)masks.size()).first;
      masks.push_back(m);
    }
    sbar_of_elem[g] = it->second;
  }
  int64_t S = (int64_t)masks.size();
  int64_t off = 0;
  for (int64_t s = 0; s < S; ++s) {
    members_off[s] = off;
    uint64_t m = masks[s];
    for (int64_t r = 0; r < R; ++r)
      if (m & (uint64_t(1) << r)) {
        if (off >= members_cap) return -2;
        members[off++] = r;
      }
  }
  members_off[S] = off;
  return S;
}

// Vertex fan-in exchange lists.  vert_gid/vert_owner: R*Vmax (-1 pad).
// Emits triples (src_rank, owner_rank, src_local_id, owner_local_id) into
// out (capacity cap rows of 4); returns count or -1 on overflow.
int64_t pp_exchange_lists(int64_t R, int64_t Vmax, int64_t Vg,
                          const int64_t* vert_gid, const int64_t* vert_owner,
                          int64_t* out, int64_t cap) {
  // Each global entity has exactly ONE owner, so one Vg-sized gid -> local
  // id table (filled from the owning rank's own copy) serves every lookup.
  // (A per-rank R x Vg table here cost O(R*Vg) host RAM — 512 MB at 64
  // ranks on a 1M-vertex mesh; round-5 review.)
  std::vector<int64_t> owner_lid(Vg, -1);
  for (int64_t r = 0; r < R; ++r) {
    for (int64_t l = 0; l < Vmax; ++l) {
      int64_t g = vert_gid[r * Vmax + l];
      if (g >= 0 && vert_owner[r * Vmax + l] == r) owner_lid[g] = l;
    }
  }
  int64_t n = 0;
  for (int64_t r = 0; r < R; ++r) {
    for (int64_t l = 0; l < Vmax; ++l) {
      int64_t g = vert_gid[r * Vmax + l];
      if (g < 0) continue;
      int64_t o = vert_owner[r * Vmax + l];
      if (o == r || o < 0) continue;
      int64_t lo = owner_lid[g];
      if (lo < 0) return -3;  // owner must hold its vertex
      if (n >= cap) return -1;
      out[n * 4 + 0] = r;
      out[n * 4 + 1] = o;
      out[n * 4 + 2] = l;
      out[n * 4 + 3] = lo;
      ++n;
    }
  }
  return n;
}

// Deduplicate element sides (edges of tris / faces of tets).
// side_verts: (E*S)*k sorted-within-row vertex tuples.  Outputs: for each
// occurrence its unique side id (inv, E*S entries); returns the number of
// unique sides.  unique side -> first occurrence index in first_occ.
int64_t pp_unique_sides(int64_t n_occ, int64_t k, const int64_t* side_verts,
                        int64_t* inv, int64_t* first_occ) {
  struct Key {
    const int64_t* p;
    int64_t k;
    bool operator==(const Key& o) const {
      return std::memcmp(p, o.p, sizeof(int64_t) * k) == 0;
    }
  };
  struct Hash {
    size_t operator()(const Key& key) const {
      uint64_t h = 1469598103934665603ull;
      for (int64_t i = 0; i < key.k; ++i) {
        h ^= (uint64_t)key.p[i];
        h *= 1099511628211ull;
      }
      return (size_t)h;
    }
  };
  std::unordered_map<Key, int64_t, Hash> map;
  map.reserve(n_occ * 2);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n_occ; ++i) {
    Key key{side_verts + i * k, k};
    auto it = map.find(key);
    if (it == map.end()) {
      map.emplace(key, n_unique);
      first_occ[n_unique] = i;
      inv[i] = n_unique;
      ++n_unique;
    } else {
      inv[i] = it->second;
    }
  }
  return n_unique;
}

}  // extern "C"
