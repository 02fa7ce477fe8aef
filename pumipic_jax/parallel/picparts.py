"""PICparts: replication-based mesh distribution (host build).

Reference parity (``src/pumipic_part_construct.cpp``, ``pumipic_input.hpp``,
``pumipic_mesh.hpp`` — SURVEY.md §2 L2): every rank owns a *core* of mesh
elements plus BFS-buffered copies of neighboring cores; a *safe zone* around
the core lets particles move without inter-rank transfer; lower-dimension
ownership is the minimum adjacent element owner; each picpart is a
self-contained renumbered mesh with global-id maps.

Redesign: picpart construction is **offline preprocessing** in
numpy.  All per-rank picparts are padded to identical shapes and stacked
along a leading ``ranks`` axis, producing ONE pytree whose leaves shard over
the device mesh with ``P('ranks')`` — inside ``shard_map`` each device sees
exactly its own picpart.  The reference's per-dimension comm metadata
(boundary-entity index lists exchanged via MPI at startup,
``Mesh::setupComm`` src/pumipic_comm.cpp:12-184) becomes precomputed
fixed-shape exchange tables consumed by ``lax.all_to_all``:

- ``vert_send_ids[r, s, k]``: local vertex ids on rank r whose owner is s
  (the fan-in route), padded with -1;
- ``vert_recv_ids[r, s, k]``: the matching local ids on the owner;
- ``elem_gid_sorted``/``elem_gid_perm``: per-rank sorted global element ids
  for device-side GID→LID translation during migration (replaces the
  reference's ``Kokkos::UnorderedMap``, SCS_buildFns.h:102-113).

Buffer/safe policies (``Input::FULL/BFS/MINIMUM/NONE``,
src/pumipic_input.hpp:33-76): FULL replicates the whole mesh (safe
everywhere); BFS grows ``buffer_layers`` rings over the vertex bridge and
marks elements within ``safe_layers`` of the core safe; MINIMUM is BFS with
one layer and no safe ring; NONE buffers nothing (safe = core only, every
boundary crossing migrates).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh.core import Mesh2D, Mesh3D
from pumipic_jax.utils.types import LID_DTYPE


class BufferMethod(Enum):
    FULL = "full"
    BFS = "bfs"
    MINIMUM = "minimum"
    NONE = "none"


@dataclass(frozen=True)
class PicPartsInput:
    """``pumipic::Input`` analog (src/pumipic_input.hpp:8-77).

    ``bridge_dim``: entity dimension over which BFS buffer/safe layers grow
    (pumipic_input.hpp:20-26) — 0 = vertex bridges (default), 1 = edge
    bridges, 2 = face bridges (3D meshes only).  Higher bridge dims grow
    buffers more slowly (fewer elements share an edge/face than a vertex).
    """

    buffer_method: BufferMethod = BufferMethod.BFS
    buffer_layers: int = 3
    safe_layers: int = 1
    bridge_dim: int = 0


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PicParts:
    """Stacked picparts: every array leaf has leading axis = num_ranks and is
    intended to shard with ``P('ranks')``.  The reference's ``pumipic::Mesh``
    runtime object (src/pumipic_mesh.hpp:97-138)."""

    mesh: object                 # Mesh2D/Mesh3D pytree, leaves (R, ...)
    elem_owner: jax.Array        # (R, E) owner rank per local elem (-1 pad)
    elem_safe: jax.Array         # (R, E) bool safe-zone flag
    elem_gid: jax.Array          # (R, E) global elem id (-1 pad)
    elem_gid_sorted: jax.Array   # (R, E) sorted gids for searchsorted
    elem_gid_perm: jax.Array     # (R, E) local id of k-th sorted gid
    vert_owner: jax.Array        # (R, V) owner rank per local vertex
    vert_gid: jax.Array          # (R, V)
    vert_send_ids: jax.Array     # (R, R, Kv) fan-in gather ids (-1 pad)
    vert_recv_ids: jax.Array     # (R, R, Kv) owner-side ids (-1 pad)
    elem_send_ids: jax.Array     # (R, R, Ke) element-dim exchange (-1 pad)
    elem_recv_ids: jax.Array     # (R, R, Ke)
    # --- per-dimension comm metadata (Mesh::setupComm builds EVERY entity
    # dim, src/pumipic_comm.cpp:12-184).  "side" = dim-1 entities (edges in
    # 2D, faces in 3D), indexed by the local mesh's edge/face numbering.
    side_gid: Optional[jax.Array] = None       # (R, Ns) global side id
    side_owner: Optional[jax.Array] = None     # (R, Ns) min adj elem owner
    side_send_ids: Optional[jax.Array] = None  # (R, R, Ks)
    side_recv_ids: Optional[jax.Array] = None  # (R, R, Ks)
    # 3D dim-1 entities (edges): Mesh3D stores no edge adjacency, so the
    # picpart carries its own deterministic local edge numbering
    edge2verts: Optional[jax.Array] = None     # (R, Ne3, 2) local verts (-1)
    edge_gid: Optional[jax.Array] = None       # (R, Ne3)
    edge_owner: Optional[jax.Array] = None     # (R, Ne3)
    edge_send_ids: Optional[jax.Array] = None  # (R, R, Ke3)
    edge_recv_ids: Optional[jax.Array] = None  # (R, R, Ke3)
    num_ranks: int = _static_field(default=1)
    num_core_elems: int = _static_field(default=0)   # max over ranks (info)

    @property
    def nelems(self) -> int:
        return self.mesh.nelems

    @property
    def nverts(self) -> int:
        return self.mesh.nverts

    def comm_array_size(self, dim: int) -> int:
        """createCommArray analog: per-rank array length for entity dim
        (src/pumipic_mesh.hpp:62-73)."""
        mdim = self.mesh.dim
        if dim == 0:
            return self.mesh.nverts
        if dim == mdim:
            return self.mesh.nelems
        if dim == mdim - 1:
            return self.mesh.nedges if mdim == 2 else self.mesh.nfaces
        if dim == 1 and mdim == 3:
            return self.edge2verts.shape[1]
        raise ValueError(f"dim {dim} invalid for a {mdim}D mesh")

    def comm_ids(self, dim: int):
        """(send_ids, recv_ids) exchange tables for entity dim — feed them
        to :func:`pumipic_jax.parallel.reduce.reduce_comm_array`."""
        mdim = self.mesh.dim
        if dim == 0:
            return self.vert_send_ids, self.vert_recv_ids
        if dim == mdim:
            return self.elem_send_ids, self.elem_recv_ids
        if dim == mdim - 1:
            return self.side_send_ids, self.side_recv_ids
        if dim == 1 and mdim == 3:
            return self.edge_send_ids, self.edge_recv_ids
        raise ValueError(f"dim {dim} invalid for a {mdim}D mesh")


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

def partition_rcb(coords: np.ndarray, elem2verts: np.ndarray, num_ranks: int
                  ) -> np.ndarray:
    """Recursive coordinate bisection over element centroids: balanced,
    spatially compact parts (stand-in for the reference's externally-supplied
    .ptn partition vectors)."""
    cent = coords[elem2verts].mean(axis=1)
    E = cent.shape[0]
    owners = np.zeros(E, np.int64)

    def split(idx, ranks0, ranks1):
        n = ranks1 - ranks0
        if n == 1 or idx.size == 0:
            owners[idx] = ranks0
            return
        spread = cent[idx].max(0) - cent[idx].min(0)
        axis = int(np.argmax(spread))
        order = np.argsort(cent[idx, axis], kind="stable")
        n_left = (n // 2) * idx.size // n
        left = idx[order[:n_left]]
        right = idx[order[n_left:]]
        split(left, ranks0, ranks0 + n // 2)
        split(right, ranks0 + n // 2, ranks1)

    split(np.arange(E), 0, num_ranks)
    return owners


def partition_from_classification(class_id: np.ndarray, class_to_rank: Dict[int, int]
                                  ) -> np.ndarray:
    """CLASSIFICATION partition input (src/pumipic_input.hpp: cpn files):
    assign each element by its geometric-model region."""
    return np.asarray([class_to_rank[int(c)] for c in class_id], np.int64)


def write_ptn(path: str, owners: np.ndarray) -> None:
    """Write a .ptn partition file: one owner rank per element per line
    (the format print_partition emits and ptn_loading consumes)."""
    np.savetxt(path, np.asarray(owners, np.int64), fmt="%d")


def read_ptn(path: str) -> np.ndarray:
    """Read a .ptn element-partition file."""
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def write_cpn(path: str, class_to_rank: Dict[int, int]) -> None:
    """Write a .cpn classification-partition file: '<num> <class> <rank>'
    pairs."""
    with open(path, "w") as f:
        f.write(f"{len(class_to_rank)}\n")
        for c, r in sorted(class_to_rank.items()):
            f.write(f"{c} {r}\n")


def read_cpn(path: str) -> Dict[int, int]:
    with open(path) as f:
        n = int(f.readline())
        out = {}
        for _ in range(n):
            c, r = f.readline().split()
            out[int(c)] = int(r)
    return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _elem_adjacency_via_verts(elem2verts: np.ndarray, nverts: int):
    """vertex-bridged element adjacency as CSR (host)."""
    E, k = elem2verts.shape
    # vert -> elems
    vid = elem2verts.reshape(-1)
    eid = np.repeat(np.arange(E), k)
    order = np.argsort(vid, kind="stable")
    v_sorted, e_sorted = vid[order], eid[order]
    starts = np.searchsorted(v_sorted, np.arange(nverts))
    ends = np.searchsorted(v_sorted, np.arange(nverts), side="right")
    return v_sorted, e_sorted, starts, ends


def _bridge_keys(elem2verts: np.ndarray, nverts: int, bridge_dim: int):
    """Per-element bridge-entity ids for the BFS frontier: (E, K) key array +
    key count.  bridge_dim 0 = vertices (keys are vertex ids), 1 = edges,
    2 = faces (sorted vertex tuples, deduplicated globally)."""
    if bridge_dim == 0:
        return np.asarray(elem2verts, np.int64), nverts
    k = elem2verts.shape[1]
    dim = k - 1
    if not 0 < bridge_dim < dim:
        raise ValueError(
            f"bridge_dim {bridge_dim} invalid for {dim}D simplices"
        )
    from itertools import combinations

    tuples = []
    for combo in combinations(range(k), bridge_dim + 1):
        tuples.append(np.sort(elem2verts[:, combo], axis=1))
    sides = np.concatenate(tuples)                       # (E * C, b+1)
    uniq, inv = np.unique(sides, axis=0, return_inverse=True)
    E = elem2verts.shape[0]
    C = len(tuples)
    keys = inv.reshape(C, E).T.copy()                    # (E, C)
    return np.asarray(keys, np.int64), uniq.shape[0]


def _bfs_layers(elem_keys: np.ndarray, nkeys: int, seed_mask: np.ndarray,
                max_layers: int) -> np.ndarray:
    """BFS distance (in bridge-entity hops) from the seed element set,
    capped at max_layers (+inf beyond).  Vectorized frontier sweep — the
    host analog of the reference's layered BFS device kernels
    (part_construct.cpp:387-437).  ``elem_keys``: (E, K) bridge-entity ids
    from :func:`_bridge_keys` (the native path treats them like vertex ids)."""
    from pumipic_jax import native

    nd = native.bfs_layers(
        np.asarray(elem_keys, np.int64), nkeys,
        np.asarray(seed_mask, np.uint8), max_layers,
    )
    if nd is not None:
        return np.where(nd <= max_layers, nd, np.iinfo(np.int32).max)

    E = elem_keys.shape[0]
    dist = np.full(E, np.iinfo(np.int32).max, np.int64)
    dist[seed_mask] = 0
    frontier = seed_mask.copy()
    for layer in range(1, max_layers + 1):
        # bridge entities touched by the frontier
        vmask = np.zeros(nkeys, bool)
        vmask[elem_keys[frontier].reshape(-1)] = True
        # elements touching those entities
        emask = vmask[elem_keys].any(axis=1)
        new = emask & (dist > layer)
        if not new.any():
            break
        dist[new] = layer
        frontier = new
    return dist


def _encode_rows(rows: np.ndarray, base: int) -> np.ndarray:
    """Injective int64 key for (n, t) sorted vertex tuples (base = #verts)."""
    key = rows[:, 0].astype(np.int64)
    for j in range(1, rows.shape[1]):
        key = key * base + rows[:, j]
    return key


def _global_subentities(elem2verts: np.ndarray, owners: np.ndarray,
                        V_g: int, t: int):
    """Global dim-(t-1) entities (edges t=2, faces t=3) as sorted unique
    keys, with min-adjacent-element-owner ownership (defineOwners,
    part_construct.cpp:304-323)."""
    from itertools import combinations

    k = elem2verts.shape[1]
    parts = [np.sort(elem2verts[:, c], axis=1)
             for c in combinations(range(k), t)]
    occ = np.concatenate(parts)
    keys = _encode_rows(occ, V_g)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    own = np.full(len(uniq_keys), np.iinfo(np.int64).max)
    np.minimum.at(own, inv, np.tile(owners, len(parts)))
    return uniq_keys, own


def _lookup_gids(local_verts: np.ndarray, vgids: np.ndarray,
                 uniq_keys: np.ndarray, V_g: int) -> np.ndarray:
    """Local entity (rows of local vertex ids) -> global entity id."""
    gverts = np.sort(vgids[local_verts], axis=1)
    keys = _encode_rows(gverts, V_g)
    pos = np.searchsorted(uniq_keys, keys)
    assert (uniq_keys[pos] == keys).all(), "local entity missing globally"
    return pos


def build_picparts(
    coords: np.ndarray,
    elem2verts: np.ndarray,
    owners: np.ndarray,
    num_ranks: int,
    inp: PicPartsInput = PicPartsInput(),
    class_id: Optional[np.ndarray] = None,
    mesh_cls=Mesh2D,
) -> PicParts:
    """Construct stacked picparts from a full mesh + element ownership.

    The reference's ``Mesh::Mesh(Input&)`` (part_construct.cpp:43-274) as
    offline preprocessing; returns a device-ready :class:`PicParts`.
    """
    owners = np.asarray(owners, np.int64)
    E_g = elem2verts.shape[0]
    V_g = coords.shape[0]
    if class_id is None:
        class_id = np.ones(E_g, np.int64)

    # global vertex owners: min adjacent element owner (defineOwners,
    # part_construct.cpp:304-323)
    vert_owner_g = np.full(V_g, np.iinfo(np.int64).max)
    for k in range(elem2verts.shape[1]):
        np.minimum.at(vert_owner_g, elem2verts[:, k], owners)

    # per-rank picpart element sets
    bridge_keys, n_keys = _bridge_keys(elem2verts, V_g, inp.bridge_dim)
    local_elems: List[np.ndarray] = []
    local_safe: List[np.ndarray] = []
    for r in range(num_ranks):
        core = owners == r
        if inp.buffer_method == BufferMethod.FULL:
            sel = np.ones(E_g, bool)
            safe = np.ones(E_g, bool)
        elif inp.buffer_method == BufferMethod.NONE:
            sel = core
            safe = core.copy()
        else:
            layers = (1 if inp.buffer_method == BufferMethod.MINIMUM
                      else inp.buffer_layers)
            dist = _bfs_layers(bridge_keys, n_keys, core, layers)
            sel = dist <= layers
            safe_layers = (0 if inp.buffer_method == BufferMethod.MINIMUM
                           else min(inp.safe_layers, layers - 1))
            safe = dist <= safe_layers
        gids = np.nonzero(sel)[0]
        local_elems.append(gids)
        local_safe.append(safe[gids])

    E_max = max(len(g) for g in local_elems)
    # build per-rank renumbered meshes, then pad & stack
    meshes = []
    eo_l, es_l, eg_l, vo_l, vg_l = [], [], [], [], []
    vert_gids_per_rank = []
    for r in range(num_ranks):
        gids = local_elems[r]
        ev_g = elem2verts[gids]
        vgids = np.unique(ev_g.reshape(-1))
        g2l = np.full(V_g, -1, np.int64)
        g2l[vgids] = np.arange(len(vgids))
        lm = mesh_cls.from_arrays(coords[vgids], g2l[ev_g], class_id[gids])
        meshes.append(lm)
        eo_l.append(owners[gids])
        es_l.append(local_safe[r])
        eg_l.append(gids)
        vo_l.append(vert_owner_g[vgids])
        vg_l.append(vgids)
        vert_gids_per_rank.append(vgids)

    V_max = max(m.nverts for m in meshes)
    stacked_mesh = _pad_stack_meshes(meshes, E_max, V_max)

    def pad1(arrs, n, fill):
        return np.stack([
            np.concatenate([a, np.full(n - len(a), fill, a.dtype)])
            for a in arrs
        ])

    elem_owner = pad1(eo_l, E_max, -1)
    elem_safe = pad1([s.astype(np.int64) for s in es_l], E_max, 0).astype(bool)
    elem_gid = pad1(eg_l, E_max, -1)
    vert_owner = pad1(vo_l, V_max, -1)
    vert_gid = pad1(vg_l, V_max, -1)

    # sorted elem gids for device GID->LID (pad gid -1 sorts first; use a
    # large sentinel instead so real gids stay in a contiguous sorted prefix)
    BIG = np.iinfo(np.int64).max // 2
    eg_for_sort = np.where(elem_gid >= 0, elem_gid, BIG)
    perm = np.argsort(eg_for_sort, axis=1, kind="stable")
    eg_sorted = np.take_along_axis(eg_for_sort, perm, axis=1)

    # fan-in exchange lists (copies -> owner), per entity dimension
    from pumipic_jax import native

    def _exchange_tables(ent_gid, ent_owner, n_global):
        quads = native.exchange_lists(ent_gid, ent_owner, n_global)
        if quads is None:
            # numpy fallback: vectorized over all (rank, local-entity) copies
            g2l_stack = np.full((num_ranks, n_global), -1, np.int64)
            for r in range(num_ranks):
                valid = ent_gid[r] >= 0
                g2l_stack[r, ent_gid[r][valid]] = np.nonzero(valid)[0]
            rr, ll = np.nonzero(
                (ent_gid >= 0) & (ent_owner >= 0) &
                (ent_owner != np.arange(num_ranks)[:, None])
            )
            gg = ent_gid[rr, ll]
            oo = ent_owner[rr, ll]
            lo = g2l_stack[oo, gg]
            assert (lo >= 0).all(), "owner must hold a copy of its entity"
            quads = np.stack([rr, oo, ll, lo], axis=1)

        # bucket the (src, owner) pairs into fixed-width per-pair lists
        pair_key = quads[:, 0] * num_ranks + quads[:, 1]
        order = np.argsort(pair_key, kind="stable")
        quads = quads[order]
        pair_key = pair_key[order]
        counts = np.bincount(pair_key, minlength=num_ranks * num_ranks)
        K = max(int(counts.max()), 1)
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(quads)) - starts[pair_key]
        send = np.full((num_ranks, num_ranks, K), -1, np.int64)
        recv = np.full((num_ranks, num_ranks, K), -1, np.int64)
        send[quads[:, 0], quads[:, 1], slot] = quads[:, 2]
        recv[quads[:, 1], quads[:, 0], slot] = quads[:, 3]
        return send, recv

    vert_send_ids, vert_recv_ids = _exchange_tables(vert_gid, vert_owner, V_g)
    elem_send_ids, elem_recv_ids = _exchange_tables(elem_gid, elem_owner, E_g)

    # --- per-dimension comm metadata: the reference's setupComm runs for
    # EVERY entity dimension (src/pumipic_comm.cpp:12-184).  dim-1 "sides"
    # use the local mesh's edge (2D) / face (3D) numbering; 3D edges get a
    # deterministic picpart-local numbering of their own.
    dim = elem2verts.shape[1] - 1
    side_t = dim                       # side arity: 2 verts in 2D, 3 in 3D
    uniq_side, side_own_g = _global_subentities(elem2verts, owners, V_g, side_t)
    Ns_max = max(
        (m.nedges if dim == 2 else m.nfaces) for m in meshes
    )
    sg_l, so_l = [], []
    for r in range(num_ranks):
        m = meshes[r]
        lverts = np.asarray(m.edge2verts if dim == 2 else m.face2verts)
        gid = _lookup_gids(lverts, vert_gids_per_rank[r], uniq_side, V_g)
        sg_l.append(gid)
        so_l.append(side_own_g[gid])
    side_gid = pad1(sg_l, Ns_max, -1)
    side_owner = pad1(so_l, Ns_max, -1)
    side_send_ids, side_recv_ids = _exchange_tables(
        side_gid, side_owner, len(uniq_side))

    edge_fields = {}
    if dim == 3:
        uniq_edge, edge_own_g = _global_subentities(
            elem2verts, owners, V_g, 2)
        e2v_l, eg3_l, eo3_l = [], [], []
        from itertools import combinations

        for r in range(num_ranks):
            lev = np.asarray(meshes[r].elem2verts)
            pairs = np.concatenate([
                np.sort(lev[:, c], axis=1)
                for c in combinations(range(4), 2)
            ])
            lkeys = _encode_rows(pairs, meshes[r].nverts)
            _, first = np.unique(lkeys, return_index=True)
            loc_edges = pairs[np.sort(first)]      # deterministic local order
            gid = _lookup_gids(loc_edges, vert_gids_per_rank[r],
                               uniq_edge, V_g)
            e2v_l.append(loc_edges)
            eg3_l.append(gid)
            eo3_l.append(edge_own_g[gid])
        Ne3_max = max(len(g) for g in eg3_l)
        edge_gid = pad1(eg3_l, Ne3_max, -1)
        edge_owner = pad1(eo3_l, Ne3_max, -1)
        e2v = np.stack([
            np.concatenate(
                [a, np.full((Ne3_max - len(a), 2), -1, a.dtype)])
            for a in e2v_l
        ])
        edge_send_ids, edge_recv_ids = _exchange_tables(
            edge_gid, edge_owner, len(uniq_edge))
        edge_fields = dict(
            edge2verts=jnp.asarray(e2v, LID_DTYPE),
            edge_gid=jnp.asarray(edge_gid, LID_DTYPE),
            edge_owner=jnp.asarray(edge_owner, LID_DTYPE),
            edge_send_ids=jnp.asarray(edge_send_ids, LID_DTYPE),
            edge_recv_ids=jnp.asarray(edge_recv_ids, LID_DTYPE),
        )

    return PicParts(
        side_gid=jnp.asarray(side_gid, LID_DTYPE),
        side_owner=jnp.asarray(side_owner, LID_DTYPE),
        side_send_ids=jnp.asarray(side_send_ids, LID_DTYPE),
        side_recv_ids=jnp.asarray(side_recv_ids, LID_DTYPE),
        **edge_fields,
        mesh=stacked_mesh,
        elem_owner=jnp.asarray(elem_owner, LID_DTYPE),
        elem_safe=jnp.asarray(elem_safe),
        elem_gid=jnp.asarray(elem_gid, LID_DTYPE),
        elem_gid_sorted=jnp.asarray(
            np.minimum(eg_sorted, np.iinfo(np.int32).max - 1), LID_DTYPE
        ),
        elem_gid_perm=jnp.asarray(perm, LID_DTYPE),
        vert_owner=jnp.asarray(vert_owner, LID_DTYPE),
        vert_gid=jnp.asarray(vert_gid, LID_DTYPE),
        vert_send_ids=jnp.asarray(vert_send_ids, LID_DTYPE),
        vert_recv_ids=jnp.asarray(vert_recv_ids, LID_DTYPE),
        elem_send_ids=jnp.asarray(elem_send_ids, LID_DTYPE),
        elem_recv_ids=jnp.asarray(elem_recv_ids, LID_DTYPE),
        num_ranks=num_ranks,
        num_core_elems=int(max((owners == r).sum() for r in range(num_ranks))),
    )


def _pad_stack_meshes(meshes, E_max: int, V_max: int):
    """Pad per-rank meshes to common shapes and stack along a leading rank
    axis.  Padded elements are inert: walk_nbrs = -1 so a walk that somehow
    enters one exits as a boundary; padded vertices carry zeros."""
    Ned_max = max(getattr(m, "nedges", getattr(m, "nfaces", 0)) for m in meshes)
    v2e_max = max(m.vert2elem_vals.shape[0] for m in meshes)

    def pad_to(arr, n, fill):
        a = np.asarray(arr)
        if a.shape[0] == n:
            return a
        pad_shape = (n - a.shape[0],) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])

    out = {}
    m0 = meshes[0]
    is2d = isinstance(m0, Mesh2D)
    side_field = "nedges" if is2d else "nfaces"

    def stack(field, n, fill):
        return jnp.asarray(
            np.stack([pad_to(getattr(m, field), n, fill) for m in meshes])
        )

    def stack_rows(field, n, pad_row):
        """Pad with an explicit per-row pattern (for the walk tables, whose
        padded rows must be inert under the all-float layout)."""
        row = np.asarray(pad_row, np.float32)

        def pad(m):
            a = np.asarray(getattr(m, field))
            if a.shape[0] == n:
                return a
            return np.concatenate(
                [a, np.broadcast_to(row, (n - a.shape[0], row.shape[0]))]
            )

        return jnp.asarray(np.stack([pad(m) for m in meshes]))

    common = dict(
        coords=stack("coords", V_max, 0.0),
        elem2verts=stack("elem2verts", E_max, 0),
        side_is_exposed=stack("side_is_exposed", Ned_max, True),
        elem_v0=stack("elem_v0", E_max, 0.0),
        elem_inv_basis=stack("elem_inv_basis", E_max, 0.0),
        vert2elem_offsets=jnp.asarray(np.stack([
            pad_to(m.vert2elem_offsets, V_max + 1,
                   int(np.asarray(m.vert2elem_offsets)[-1]))
            for m in meshes
        ])),
        vert2elem_vals=stack("vert2elem_vals", v2e_max, 0),
        class_id=stack("class_id", E_max, -1),
        # padded walk rows are inert and self-cleaning: weights evaluate
        # negative everywhere (never "inside") and all neighbors are -1, so
        # any walker entering one is treated as hitting an exposed side
        walk_geom=stack_rows(
            "walk_geom", E_max,
            ([0, 0, -1, 0, 0, -1] + [-1] * 6) if is2d
            else ([0, 0, 0, -1] * 3 + [-1] * 4),
        ),
        elem_tags={},
        vert_tags={},
        nelems=E_max,
        nverts=V_max,
    )
    if is2d:
        return Mesh2D(
            elem2edges=stack("elem2edges", E_max, 0),
            edge2verts=stack("edge2verts", Ned_max, 0),
            edge2elems=stack("edge2elems", Ned_max, -1),
            elem_area=stack("elem_area", E_max, 0.0),
            nedges=Ned_max,
            **common,
        )
    return Mesh3D(
        elem2faces=stack("elem2faces", E_max, 0),
        face2verts=stack("face2verts", Ned_max, 0),
        face2elems=stack("face2elems", Ned_max, -1),
        elem_volume=stack("elem_volume", E_max, 0.0),
        # padded plane rows: two opposing x-planes at -inf offset guarantee
        # any moving segment "exits" through a -1 neighbor immediately
        walk_planes=stack_rows(
            "walk_planes", E_max,
            [1, 0, 0, -1e30, -1, 0, 0, -1e30,
             0, 0, 0, -1e30, 0, 0, 0, -1e30] + [-1] * 4,
        ),
        nfaces=Ned_max,
        **common,
    )


def local_view(tree):
    """Inside a shard_map body: strip the leading (length-1) rank axis from a
    stacked pytree, yielding this device's picpart."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)
