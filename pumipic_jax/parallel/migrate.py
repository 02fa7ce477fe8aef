"""Distributed particle migration over the device mesh.

Reference parity: ``SellCSigma::migrate`` (scs/SCS_migrate.h:4-221) and
``pumipic::migrate_ptcls``/``setUnsafeProcs`` (src/pumipic_ptcl_ops.hpp:17-85)
— particles whose post-search element is outside the safe zone are sent to
that element's owner; ranks exchange counts then per-member views; receivers
translate global element ids to local ids and rebuild.

The ragged Isend/Irecv exchange becomes a **fixed-capacity
bucketed exchange**: each rank packs up to ``cap`` departing particles per
destination (slot = dest-rank-relative rank, computed with the same sort
machinery as rebuild), the buckets move in one collective, and arrivals
translate GID→LID with a binary search over the picpart's sorted global ids
(the reference's ``Kokkos::UnorderedMap`` lookup, SCS_buildFns.h:102-113).

**Lossless under overflow** (the reference's ragged exchange is sized
exactly and never drops a particle, SCS_migrate.h:39-175): before the
payload exchange, ranks negotiate per-pair admission quotas with two tiny
(R,)-vector collectives — each receiver grants senders (in rank order) up
to its bucket capacity AND its conservatively-counted free slots.  Leavers
beyond their quota stay HOME (active, counted in ``num_kept_home``) and
retry on the next step's routing — semantics the safe-zone model tolerates
(the particle is still inside this rank's buffered region).  ``overflow``
flags only TRUE bucket overflow (per-destination volume > ``cap``, i.e. the
send-buffer size is the binding constraint); receiver-side quota parking
with volumes within cap is lossless backpressure reported solely via
``num_kept_home``.  Arrivals whose element is absent from the receiving picpart
are likewise counted (``num_recv_unresolved``) rather than silently lost.

Two collectives are provided:

- **world**: one ``lax.all_to_all`` with an (R, cap, F) buffer — simplest,
  payload O(R · cap) per rank.
- **neighbor-scoped** (the reference's ``Distributor`` subset exchange,
  SCS_migrate.h:41-62, psDistributor.hpp:9-137): the buffered-peer digraph
  is edge-colored on the host into ``rounds ≤ ~max-degree`` partial
  permutations; migration runs one ``lax.ppermute`` per round with a
  (rounds, cap, F) buffer — payload O(neighbors · cap), independent of R.
  Arrivals are re-ordered by source rank before placement, so results are
  bit-identical to the world path.

All functions run INSIDE shard_map on local views (except the host-side
``build_neighbor_plan``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.parallel.mesh_axis import RANK_AXIS, hier_all_to_all

INVALID = -1


class MigrateResult(NamedTuple):
    state: Dict[str, jax.Array]   # updated local particle state
    num_sent: jax.Array           # () particles that left this rank
    num_recv: jax.Array           # () particles that arrived
    overflow: jax.Array           # () bool: a destination's intended volume
    #                                 exceeded the physical bucket size cap
    #                                 (quota parking alone never sets this)
    num_recv_unresolved: jax.Array  # () arrivals whose elem gid is unknown
    num_illegal_dest: jax.Array   # () dests outside the neighbor plan (0 for
    #                                 the world collective)
    num_kept_home: jax.Array = 0  # () leavers kept home by admission quotas
    #                                 (they retry next step; never dropped)


def set_unsafe_procs(
    elem_safe: jax.Array,
    elem_owner: jax.Array,
    new_elem: jax.Array,
    active: jax.Array,
    my_rank: jax.Array,
) -> jax.Array:
    """setUnsafeProcs analog (ptcl_ops.hpp:32-52): destination rank per
    particle — stay home while in the safe zone, else the element's owner."""
    e = jnp.maximum(new_elem, 0)
    safe = elem_safe[e] & (new_elem >= 0)
    owner = elem_owner[e]
    return jnp.where(active & (new_elem >= 0) & ~safe, owner, my_rank)


def pack_route(
    elem_safe: jax.Array,     # (E,) bool
    elem_owner: jax.Array,    # (E,) int
    sbar_of_elem: Optional[jax.Array],   # (E,) int (-1 = none) or None
    num_ranks: int,
) -> jax.Array:
    """Pack (safe, owner, sbar) into ONE f32 per element:
    ``((sbar+2)*2 + safe) * R + owner`` — exact in f32 while the packed
    value stays < 2^24 (R·S up to ~8M).  The picparts hot step then pays a
    single particle-rate gather where set_unsafe_procs + the LB +
    noncore-priority used three (safe, owner, sbar)."""
    E = elem_safe.shape[0]
    sb = (jnp.full((E,), -1, jnp.int32) if sbar_of_elem is None
          else sbar_of_elem.astype(jnp.int32))
    owner = jnp.maximum(elem_owner.astype(jnp.int32), 0)
    val = ((sb + 2) * 2 + elem_safe.astype(jnp.int32)) * num_ranks + owner
    return val.astype(jnp.float32)


def route_pack_bound_ok(num_sbars: int, num_ranks: int) -> bool:
    """Static exactness bound for :func:`pack_route` (checked by callers —
    both are build-time constants)."""
    return ((num_sbars + 2) * 2 + 1) * num_ranks + num_ranks < (1 << 24)


def route_particles(
    route: jax.Array,         # (E,) from pack_route
    new_elem: jax.Array,      # (N,) post-search local element (-1 lost)
    active: jax.Array,
    my_rank: jax.Array,
    num_ranks: int,
):
    """Decode the packed routing gather: returns (dest_rank, sbar, noncore)
    with set_unsafe_procs semantics for dest (stay while safe, else owner;
    ptcl_ops.hpp:32-52), per-particle sbar for the balancer, and the
    noncore flag (element owned elsewhere) for selection priority —
    all off ONE f32 gather, pure f32 arithmetic at particle rate."""
    v = route[jnp.maximum(new_elem, 0)]
    ok = active & (new_elem >= 0)
    return route_decode(v, ok, my_rank, num_ranks)


def route_decode(
    v: jax.Array,             # (N,) pre-gathered pack_route values
    ok: jax.Array,            # (N,) particle is live with a valid element
    my_rank: jax.Array,
    num_ranks: int,
):
    """Decode pre-gathered :func:`pack_route` values (the gather may ride a
    wider fused row, e.g. the analytic picparts [g2l | route] columns)."""
    Rf = jnp.float32(num_ranks)
    t = jnp.floor(v / Rf)
    owner_f = v - t * Rf
    half = jnp.floor(t / 2.0)
    safe = (t - half * 2.0) > 0.5
    sbar = half.astype(jnp.int32) - 2
    me_f = my_rank.astype(jnp.float32)
    dest = jnp.where(ok & ~safe, owner_f, me_f).astype(jnp.int32)
    sbar = jnp.where(ok, sbar, -1)
    noncore = ok & (owner_f != me_f)
    return dest, sbar, noncore


def gid_to_lid(gid_sorted: jax.Array, gid_perm: jax.Array, gids: jax.Array
               ) -> jax.Array:
    """Translate global element ids to local ids via binary search over the
    picpart's sorted gid table; -1 if not present."""
    E = gid_sorted.shape[0]
    pos = jnp.searchsorted(gid_sorted, gids)
    pos_c = jnp.minimum(pos, E - 1)
    found = gid_sorted[pos_c] == gids
    return jnp.where(found & (gids >= 0), gid_perm[pos_c], INVALID).astype(jnp.int32)


# ---------------------------------------------------------------------------
# neighbor plan (Distributor-scoped exchange schedule)
# ---------------------------------------------------------------------------

def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NeighborPlan:
    """Edge-colored exchange schedule over the buffered-peer digraph.

    Round k is a partial permutation: every rank sends to at most one peer
    and receives from at most one.  ``perms`` is the static (src, dst) pair
    list per round consumed by ``lax.ppermute``."""

    round_of_dest: jax.Array   # (R, R) int32: round on which r sends to s;
    #                             -1 = s is not a neighbor of r
    src_of_round: jax.Array    # (R, rounds) int32: who sends to r on round k
    #                             (-1 = nobody)
    perms: tuple = _static_field(default=())   # per-round ((src, dst), ...)
    num_rounds: int = _static_field(default=0)
    max_out_degree: int = _static_field(default=0)
    # DCN-aware schedule (multi-slice meshes): rounds [0, num_intra_rounds)
    # carry only within-slice edges (ICI); later rounds batch the
    # cross-slice edges (DCN).  Equals num_rounds on flat meshes.
    num_intra_rounds: int = _static_field(default=0)


def build_neighbor_plan(distributor, slice_of_rank=None) -> NeighborPlan:
    """Greedy bipartite edge coloring of the directed neighbor graph
    (senders × receivers): each color class is a partial permutation.
    For a graph with max in/out degree Δ this uses ≤ 2Δ-1 rounds (usually
    ≈ Δ); the reference's per-neighbor Isend/Irecv achieves the same
    O(neighbors) payload (SCS_migrate.h:41-62).

    ``slice_of_rank`` (R,) splits the schedule for a multi-slice mesh:
    within-slice edges are colored into the leading rounds (each such
    ppermute rides ICI links only) and cross-slice edges into trailing
    rounds (batched DCN traffic) — results are bit-identical to the
    unsplit schedule (arrivals re-order by source rank at placement)."""
    nb = np.asarray(distributor.is_neighbor)
    R = nb.shape[0]
    edges = [(r, s) for r in range(R) for s in range(R)
             if r != s and nb[r, s]]
    # sort for deterministic coloring
    edges.sort()
    if slice_of_rank is not None:
        sl = np.asarray(slice_of_rank)
        intra = [e for e in edges if sl[e[0]] == sl[e[1]]]
        inter = [e for e in edges if sl[e[0]] != sl[e[1]]]
    else:
        intra, inter = edges, []

    colors = {}
    src_used: Dict[int, set] = {r: set() for r in range(R)}
    dst_used: Dict[int, set] = {r: set() for r in range(R)}
    for e in intra:
        r, s = e
        c = 0
        while c in src_used[r] or c in dst_used[s]:
            c += 1
        colors[e] = c
        src_used[r].add(c)
        dst_used[s].add(c)
    num_intra = max(colors.values(), default=-1) + 1
    for e in inter:
        r, s = e
        c = num_intra                       # DCN rounds start after ICI ones
        while c in src_used[r] or c in dst_used[s]:
            c += 1
        colors[e] = c
        src_used[r].add(c)
        dst_used[s].add(c)
    rounds = max(colors.values(), default=-1) + 1

    round_of_dest = np.full((R, R), -1, np.int32)
    src_of_round = np.full((R, max(rounds, 1)), -1, np.int32)
    perms = [[] for _ in range(rounds)]
    for (r, s), c in colors.items():
        round_of_dest[r, s] = c
        src_of_round[s, c] = r
        perms[c].append((r, s))
    max_out = int(max((len(v) for v in src_used.values()), default=0))
    return NeighborPlan(
        round_of_dest=jnp.asarray(round_of_dest),
        src_of_round=jnp.asarray(src_of_round),
        perms=tuple(tuple(p) for p in perms),
        num_rounds=rounds,
        max_out_degree=max_out,
        num_intra_rounds=num_intra if slice_of_rank is not None else rounds,
    )


# ---------------------------------------------------------------------------
# payload packing / arrival placement (shared by both collectives)
# ---------------------------------------------------------------------------

def _to_lanes(arr):
    # Carrier dtype is s32: f32 payloads are bitcast (bit-exact through int
    # pipelines), NOT the reverse — int32 values below 2^23 bitcast to f32
    # are denormals, which a backend may flush to zero in copy/fusion
    # paths (same rule as the rebuild field pack and the walk-state pack
    # in ops/search.py).
    if arr.ndim == 1:
        arr = arr[:, None]
    elif arr.ndim > 2:
        # tensor-valued member fields ((N,)+shape, e.g. a (2,2) Jacobian)
        # flatten to lane columns; _place_arrivals restores the shape
        arr = arr.reshape(arr.shape[0], -1)
    if arr.dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(arr, jnp.int32)
    if arr.dtype == jnp.int32:
        return arr
    if arr.dtype == jnp.bool_:
        return arr.astype(jnp.int32)
    raise TypeError(f"unsupported migrate dtype {arr.dtype}")


def _pack_payload(state, leaving, gid):
    """Pack gid + every field into (N, F) s32 lanes (floats bitcast), so the
    collective moves ONE buffer regardless of member count — the reference
    sends one message per member type per neighbor (SCS_migrate.h:147-175)."""
    payload_parts = [_to_lanes(gid.astype(jnp.int32))]
    field_slices = {}
    off = 1
    for name in sorted(state.keys()):
        if name in ("elem", "active"):
            continue
        lanes = _to_lanes(state[name])
        field_slices[name] = (off, off + lanes.shape[1], state[name].dtype,
                              state[name].shape[1:])
        off += lanes.shape[1]
        payload_parts.append(lanes)
    return jnp.concatenate(payload_parts, axis=1), field_slices


def _bucket_ranks(key: jax.Array, num_buckets: int):
    """Stable-sort leavers by bucket: per-particle rank within its bucket
    (in slot order) plus per-bucket counts.  ``key`` = bucket id, or >=
    num_buckets for non-leavers."""
    N = key.shape[0]
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    counts = jax.ops.segment_sum(
        jnp.ones((N,), jnp.int32), sorted_key, num_segments=num_buckets + 1
    )[:num_buckets]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
    rank_in_bucket = jnp.arange(N, dtype=jnp.int32) - starts[
        jnp.minimum(sorted_key, num_buckets)
    ]
    return order, sorted_key, rank_in_bucket, counts


def _slots_from_ranks(order, sorted_key, rank_in_bucket, counts,
                      num_buckets: int, cap: int,
                      quota: Optional[jax.Array] = None):
    """Finish :func:`_bucket_ranks` into send-buffer slots.  With ``quota``
    (num_buckets,) only the first ``min(cap, quota[b])`` leavers per bucket
    are admitted; the rest are returned in the ``kept`` mask (original
    order) so callers keep them home instead of dropping them off the send
    buffer."""
    N = sorted_key.shape[0]
    lim_b = (jnp.full((num_buckets,), cap, jnp.int32) if quota is None
             else jnp.minimum(quota.astype(jnp.int32), cap))
    lim = lim_b[jnp.minimum(sorted_key, num_buckets - 1)]
    is_leaver = sorted_key < num_buckets
    admitted = is_leaver & (rank_in_bucket < lim)
    slot_sorted = jnp.where(
        admitted, sorted_key * cap + rank_in_bucket, num_buckets * cap)
    slot = jnp.zeros((N,), jnp.int32).at[order].set(slot_sorted)
    kept = jnp.zeros((N,), bool).at[order].set(is_leaver & ~admitted)
    # overflow = TRUE bucket overflow only (intended volume exceeded the
    # physical send-bucket size ``cap`` — the config knob is too tight).
    # Quota-limited admission (receiver free-slot backpressure with
    # counts <= cap) is lossless parking and is reported ONLY through
    # ``kept``/num_kept_home, so downstream overflow==0 asserts don't
    # invalidate runs that lost nothing (ADVICE r4).
    overflow = jnp.any(counts > cap)
    return slot, overflow, kept


def _bucket_slots(key: jax.Array, num_buckets: int, cap: int,
                  quota: Optional[jax.Array] = None):
    """One-call form of ``_bucket_ranks`` + ``_slots_from_ranks``."""
    order, sorted_key, rank_in_bucket, counts = _bucket_ranks(
        key, num_buckets)
    return _slots_from_ranks(order, sorted_key, rank_in_bucket, counts,
                             num_buckets, cap, quota)


def _negotiate_quota(counts_dest: jax.Array, cap: int,
                     n_free_min: jax.Array, axis_name: str) -> jax.Array:
    """Admission negotiation (two (R,)-vector collectives): senders
    announce intended per-destination counts; each receiver grants quotas
    in sender-rank order, bounded by its bucket capacity and its
    conservative free-slot count (capacity − current actives — arrivals
    are guaranteed placeable even if no leaver departs).  Returns (R,)
    ``quota[q]`` = how many of MY leavers rank q will admit.  The
    fixed-capacity analog of the reference's exact-size count exchange
    (SCS_migrate.h:39-76)."""
    incoming = jax.lax.all_to_all(
        counts_dest[:, None], axis_name, split_axis=0, concat_axis=0,
        tiled=False,
    )[:, 0]                                   # (R,) intended from each sender
    capped = jnp.minimum(incoming, cap)
    cum_before = jnp.cumsum(capped) - capped
    admit = jnp.clip(n_free_min - cum_before, 0, capped)
    quota = jax.lax.all_to_all(
        admit[:, None], axis_name, split_axis=0, concat_axis=0, tiled=False,
    )[:, 0]
    return quota


def _fill_send(payload, slot, num_buckets: int, cap: int):
    F = payload.shape[1]
    send = jnp.zeros((num_buckets * cap, F), jnp.int32)
    send = send.at[:, 0].set(jnp.int32(INVALID))
    return send.at[slot].set(payload, mode="drop")


def _place_arrivals(state, staying, new_elem, recv, field_slices,
                    gid_sorted, gid_perm):
    """Translate arrival gids and place them into free slots (stayers keep
    theirs); stable argsort compaction instead of bounded nonzero."""
    N = new_elem.shape[0]
    arr_gid = recv[:, 0]
    present = arr_gid >= 0
    arr_lid = gid_to_lid(gid_sorted, gid_perm, arr_gid)
    arr_valid = present & (arr_lid >= 0)
    # routing bugs surface as a count, not silent loss (the reference
    # asserts on unknown gids at the receiver)
    num_unresolved = jnp.sum((present & (arr_lid < 0)).astype(jnp.int32))
    num_recv = jnp.sum(arr_valid.astype(jnp.int32))

    free = jnp.argsort(staying, stable=True).astype(jnp.int32)
    n_free = jnp.sum((~staying).astype(jnp.int32))
    arr_pos = jnp.cumsum(arr_valid.astype(jnp.int32)) - 1
    arr_slot = jnp.where(
        arr_valid & (arr_pos < n_free), free[jnp.minimum(arr_pos, N - 1)], N
    )
    recv_overflow = num_recv > n_free

    new_state = {}
    elem_out = jnp.where(staying, new_elem, INVALID)
    elem_out = elem_out.at[arr_slot].set(arr_lid, mode="drop")
    active_out = staying.at[arr_slot].set(arr_valid, mode="drop")
    new_state["elem"] = elem_out
    new_state["active"] = active_out
    for name in sorted(state.keys()):
        if name in ("elem", "active"):
            continue
        lo, hi, dtype, inner = field_slices[name]
        lanes = recv[:, lo:hi]
        if dtype == jnp.int32:
            vals = lanes
        elif dtype == jnp.bool_:
            vals = lanes != 0
        else:
            vals = jax.lax.bitcast_convert_type(lanes, jnp.float32)
        if inner == ():
            vals = vals[:, 0]
        elif len(inner) > 1:
            vals = vals.reshape((vals.shape[0],) + inner)
        kept = jnp.where(
            staying.reshape((-1,) + (1,) * (state[name].ndim - 1)),
            state[name], jnp.zeros_like(state[name]),
        )
        new_state[name] = kept.at[arr_slot].set(vals, mode="drop")
    return new_state, num_recv, num_unresolved, recv_overflow


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def migrate(
    state: Dict[str, jax.Array],   # flat particle arrays incl "elem","active"
    new_elem: jax.Array,           # (N,) post-search local element (-1 = lost)
    dest_rank: jax.Array,          # (N,) from set_unsafe_procs
    elem_gid: jax.Array,           # (E,) local -> global element id
    gid_sorted: jax.Array,         # (E,)
    gid_perm: jax.Array,           # (E,)
    my_rank: jax.Array,
    num_ranks: int,
    cap: int,
    axis_name=RANK_AXIS,
    plan: Optional[NeighborPlan] = None,
    hier: bool = False,
) -> MigrateResult:
    """Bucketed migration (call inside shard_map).  With ``plan`` the
    exchange runs neighbor-scoped ppermute rounds (payload O(neighbors·cap));
    without it, one world all_to_all (payload O(R·cap)).

    ``axis_name`` may be a multi-slice ("slice", "ranks") tuple (flat-rank
    semantics; ppermute/all_to_all over the tuple are the flattened axis).
    ``hier=True`` routes the world exchange through the two-stage
    within-slice/across-slice collective (mesh_axis.hier_all_to_all) —
    bit-identical, one aggregated DCN transpose instead of R scattered
    sends."""
    if num_ranks == 1:
        # single-rank early-out, exactly the reference's comm-size-1 path
        # (SCS_migrate.h): no exchange, just apply the post-search element
        # assignment.  Static branch: R is a compile-time constant, so the
        # whole packing/exchange machinery vanishes from the executable.
        active = state["active"] & (new_elem >= 0)
        new_state = dict(state)
        new_state["elem"] = jnp.where(active, new_elem, INVALID)
        new_state["active"] = active
        z = jnp.int32(0)
        return MigrateResult(
            state=new_state, num_sent=z, num_recv=z,
            overflow=jnp.asarray(False), num_recv_unresolved=z,
            num_illegal_dest=z, num_kept_home=z,
        )
    if plan is not None and plan.num_rounds > 0:
        return _migrate_neighbors(
            state, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
            my_rank, num_ranks, cap, plan, axis_name,
        )

    N = new_elem.shape[0]
    R, K = num_ranks, cap
    active = state["active"] & (new_elem >= 0)
    wants_leave = active & (dest_rank != my_rank)

    # one sort groups leavers by destination; its counts feed the admission
    # negotiation, whose quotas then decide slots (lossless: beyond-quota
    # leavers stay home and retry next step, never fall off the buffer)
    key = jnp.where(wants_leave, dest_rank, R)
    order, sorted_key, rank_in_bucket, counts = _bucket_ranks(key, R)
    n_free_min = jnp.int32(N) - jnp.sum(state["active"].astype(jnp.int32))
    quota = _negotiate_quota(counts, K, n_free_min, axis_name)
    slot, overflow, kept = _slots_from_ranks(
        order, sorted_key, rank_in_bucket, counts, R, K, quota)

    leaving = wants_leave & ~kept
    staying = active & ~leaving
    num_sent = jnp.sum(leaving.astype(jnp.int32))
    num_kept = jnp.sum(kept.astype(jnp.int32))

    gid = jnp.where(leaving, elem_gid[jnp.maximum(new_elem, 0)], INVALID)
    payload, field_slices = _pack_payload(state, leaving, gid)
    send = _fill_send(payload, slot, R, K).reshape(R, K, -1)

    if hier and not isinstance(axis_name, str) and len(axis_name) == 2:
        recv = hier_all_to_all(send, axis_name).reshape(R * K, -1)
    else:
        recv = jax.lax.all_to_all(
            send, axis_name, split_axis=0, concat_axis=0, tiled=False
        ).reshape(R * K, -1)

    new_state, num_recv, num_unresolved, recv_overflow = _place_arrivals(
        state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm
    )
    return MigrateResult(
        state=new_state,
        num_sent=num_sent,
        num_recv=num_recv,
        overflow=overflow | recv_overflow,
        num_recv_unresolved=num_unresolved,
        num_illegal_dest=jnp.int32(0),
        num_kept_home=num_kept,
    )


def migrate_structure(
    ps,
    new_elem: jax.Array,
    dest_rank: jax.Array,
    elem_gid: jax.Array,
    gid_sorted: jax.Array,
    gid_perm: jax.Array,
    my_rank: jax.Array,
    num_ranks: int,
    cap: int,
    axis_name=RANK_AXIS,
    plan: Optional[NeighborPlan] = None,
    hier: bool = False,
):
    """Structure-integrated distributed migration: the JAX analog of the
    per-container ``migrate`` the reference implements four times
    (scs/SCS_migrate.h:4-221, csr/CSR_migrate.hpp, cabm/cabm_migrate.hpp,
    dps/dps_migrate.hpp).

    Because every layout here is the same fixed-capacity SoA pytree with
    slot placement as *data* (particles/structure.py), one implementation
    serves all four: pack the structure's member fields into the bucketed
    collective, place arrivals into free slots, then ``rebuild`` restores
    the layout invariant (σ-sorted chunks / CSR offsets / SoA padding) on
    the merged population.  Call INSIDE shard_map on local views.

    Returns ``(ps, MigrateResult)`` — ``MigrateResult.state`` is the raw
    flat state (diagnostics); the returned structure is rebuilt and its
    ``overflowed`` flag covers layout capacity, while ``MigrateResult.
    overflow`` covers exchange buckets.
    """
    state = dict(ps.fields)
    state["elem"] = ps.elem
    state["active"] = ps.active
    res = migrate(
        state, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
        my_rank, num_ranks, cap, axis_name=axis_name, plan=plan, hier=hier,
    )
    merged = res.state
    ps2 = dataclasses.replace(
        ps,
        fields={k: merged[k] for k in ps.fields},
        elem=merged["elem"].astype(ps.elem.dtype),
        active=merged["active"],
    )
    # rebuild re-sorts the merged population into layout slots; arrivals
    # already carry LOCAL element ids from _place_arrivals
    ps2 = ps2.rebuild(jnp.where(merged["active"], merged["elem"], INVALID))
    return ps2, res


def _migrate_neighbors(
    state, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
    my_rank, num_ranks, cap, plan: NeighborPlan, axis_name,
):
    """Neighbor-scoped exchange: one masked ppermute per edge-color round.

    Buckets are indexed by ROUND (each round this rank sends to at most one
    peer), so the send buffer is (rounds, cap, F).  Arrivals are re-ordered
    by source rank before placement so the final state is bit-identical to
    the world all_to_all path.  Particles routed to a non-neighbor stay home
    and are counted in ``num_illegal_dest`` (Distributor validation,
    psDistributor.hpp)."""
    N = new_elem.shape[0]
    K = cap
    D = plan.num_rounds
    active = state["active"] & (new_elem >= 0)
    wants_leave = active & (dest_rank != my_rank)

    dest_c = jnp.clip(dest_rank, 0, num_ranks - 1)
    round_of = plan.round_of_dest[my_rank, dest_c]        # (N,)
    illegal = wants_leave & (round_of < 0)
    routed = wants_leave & (round_of >= 0)
    num_illegal = jnp.sum(illegal.astype(jnp.int32))

    # admission negotiation at round granularity: each round sends to at
    # most one peer, so per-round counts ARE per-destination counts — map
    # them through dest_of_round for the (R,)-vector quota exchange
    key = jnp.where(routed, round_of, D)
    order, sorted_key, rank_in_bucket, counts = _bucket_ranks(key, D)
    rod = plan.round_of_dest[my_rank]                     # (R,)
    dof = jnp.full((D,), num_ranks, jnp.int32).at[
        jnp.where(rod >= 0, rod, D)
    ].set(jnp.arange(num_ranks, dtype=jnp.int32), mode="drop")
    counts_dest = jnp.zeros((num_ranks,), jnp.int32).at[dof].set(
        counts, mode="drop")
    n_free_min = jnp.int32(N) - jnp.sum(state["active"].astype(jnp.int32))
    quota = _negotiate_quota(counts_dest, K, n_free_min, axis_name)
    quota_round = jnp.where(
        dof < num_ranks, quota[jnp.minimum(dof, num_ranks - 1)], 0)
    slot, overflow, kept = _slots_from_ranks(
        order, sorted_key, rank_in_bucket, counts, D, K, quota_round)

    leaving = routed & ~kept
    staying = active & ~leaving
    num_sent = jnp.sum(leaving.astype(jnp.int32))
    num_kept = jnp.sum(kept.astype(jnp.int32))

    gid = jnp.where(leaving, elem_gid[jnp.maximum(new_elem, 0)], INVALID)
    payload, field_slices = _pack_payload(state, leaving, gid)
    send = _fill_send(payload, slot, D, K).reshape(D, K, -1)

    # one partial-permutation ppermute per round; non-receivers get zeros
    # (gid bitcast 0 -> 0 >= 0 is "present"!), so mask rounds with no sender
    # to this rank via src_of_round.
    recvs = []
    for k in range(D):
        r_k = jax.lax.ppermute(send[k], axis_name, perm=list(plan.perms[k]))
        has_src = plan.src_of_round[my_rank, k] >= 0
        invalid_col = jnp.full((K,), INVALID, jnp.int32)
        r_k = jnp.where(has_src, r_k, r_k.at[:, 0].set(invalid_col))
        recvs.append(r_k)
    recv = jnp.stack(recvs)                                # (D, K, F)

    # re-order rounds by source rank for world-path-identical placement
    srcs = plan.src_of_round[my_rank]                      # (D,)
    order = jnp.argsort(jnp.where(srcs >= 0, srcs, num_ranks))
    recv = recv[order].reshape(D * K, -1)

    new_state, num_recv, num_unresolved, recv_overflow = _place_arrivals(
        state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm
    )
    return MigrateResult(
        state=new_state,
        num_sent=num_sent,
        num_recv=num_recv,
        overflow=overflow | recv_overflow,
        num_recv_unresolved=num_unresolved,
        num_illegal_dest=num_illegal,
        num_kept_home=num_kept,
    )
