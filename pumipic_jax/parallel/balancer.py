"""Particle load balancing across picparts ("sbar" diffusion).

Reference parity: ``ParticleBalancer`` (``src/pumipic_lb.hpp:33-114``,
``pumipic_lb.cpp``) — build time: compute **sbars**, the distinct
sets-of-ranks whose safe zones overlap an element; build an EnGPar N-graph
whose hyperedges are sbars and vertices are (sbar × member-rank).  Run time
(``repartition``): accumulate particle weight per (sbar, rank) with
forced-migration weight counted at its *destination* rank as immovable
(``addWeights``, lb.hpp:128-205: per-peer weight exchange lands on the
rank-private vertex), run EnGPar's diffusive weight balancer **to a
tolerance** (``balance``, pumipic_lb.cpp:496-530 →
``engpar::balanceWeights(tol, step_factor)``), then greedily relabel
particles' target ranks against the per-sbar send plan, non-core-destined
particles first (``selectParticles``, lb.hpp:229-287).  An array-based
``partition`` variant does initial placement from per-element counts
(lb.hpp:289-350).

Redesign (no EnGPar): the sbar map and the hyperedge pair list
are host preprocessing; at run time every rank computes the SAME diffusion
plan from an all-gathered (rank × sbar) weight matrix — a
tolerance-terminated Jacobi flow relaxation over the pair edges, fully
jitted, zero extra communication beyond one ``all_gather`` of S floats and
one ``psum`` of R floats — and applies its own slice of the plan with a
rank-within-sbar interval lookup (O(N log P) time, O(N) memory; the same
sort machinery as rebuild).  Deterministic: every rank derives identical
flows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.parallel.mesh_axis import RANK_AXIS
from pumipic_jax.utils.types import LID_DTYPE


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BalancerTables:
    """Host-built sbar structures (device-resident, mostly replicated)."""

    sbar_of_elem: jax.Array   # (R, E) sbar id per local elem; -1 immovable
    edge_sbar: jax.Array      # (P,) sbar of each directed pair edge
    edge_src: jax.Array       # (P,)
    edge_dst: jax.Array       # (P,)
    # per-rank views of outgoing edges, sorted by sbar (padded -1)
    my_edge_idx: jax.Array    # (R, Pmax) index into the global edge list
    num_sbars: int = _static_field(default=0)
    num_edges: int = _static_field(default=0)


def build_balancer(pp, num_ranks: int) -> BalancerTables:
    """Compute sbars from the picparts' safe zones (buildLocalSbarMap /
    buildNgraph analog, pumipic_lb.cpp:93-110,434-490)."""
    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    R = num_ranks
    E_local = eg.shape[1]

    E_g = int(eg.max()) + 1
    safe_by_rank = np.zeros((R, E_g), np.uint8)
    for r in range(R):
        valid = (eg[r] >= 0) & es[r]
        safe_by_rank[r, eg[r][valid]] = 1

    from pumipic_jax import native

    res = native.sbar_map(safe_by_rank)
    if res is not None:
        sbar_of_gelem, mem_lists = res
        sbar_ids = {tuple(int(x) for x in mem): s
                    for s, mem in enumerate(mem_lists)}
        S = len(mem_lists)
    else:
        member_sets: Dict[int, list] = {g: [] for g in range(E_g)}
        for r in range(R):
            valid = (eg[r] >= 0) & es[r]
            for g in eg[r][valid]:
                member_sets[int(g)].append(r)

        sbar_ids = {}
        sbar_of_gelem = np.full(E_g, -1, np.int64)
        for g in range(E_g):
            mem = tuple(sorted(set(member_sets[g])))
            if len(mem) < 2:
                continue  # singleton: particles here can't be rebalanced
            if mem not in sbar_ids:
                sbar_ids[mem] = len(sbar_ids)
            sbar_of_gelem[g] = sbar_ids[mem]
        S = len(sbar_ids)

    sbar_of_elem = np.full((R, E_local), -1, np.int64)
    for r in range(R):
        valid = eg[r] >= 0
        sbar_of_elem[r][valid] = sbar_of_gelem[eg[r][valid]]

    edges = []  # (sbar, src, dst)
    for mem, s in sbar_ids.items():
        for a in mem:
            for b in mem:
                if a != b:
                    edges.append((s, a, b))
    edges.sort(key=lambda e: (e[1], e[0]))  # by (src, sbar) for prefix scans
    P = max(len(edges), 1)
    e_arr = np.asarray(edges or [(0, 0, 0)], np.int64)

    Pmax = 1
    per_rank = []
    for r in range(R):
        idx = [i for i, e in enumerate(edges) if e[1] == r]
        per_rank.append(idx)
        Pmax = max(Pmax, len(idx))
    my_edge_idx = np.full((R, Pmax), -1, np.int64)
    for r, idx in enumerate(per_rank):
        my_edge_idx[r, : len(idx)] = idx

    return BalancerTables(
        sbar_of_elem=jnp.asarray(sbar_of_elem, LID_DTYPE),
        edge_sbar=jnp.asarray(e_arr[:, 0], LID_DTYPE),
        edge_src=jnp.asarray(e_arr[:, 1], LID_DTYPE),
        edge_dst=jnp.asarray(e_arr[:, 2], LID_DTYPE),
        my_edge_idx=jnp.asarray(my_edge_idx, LID_DTYPE),
        num_sbars=max(S, 1),
        num_edges=P,
    )


def plan_flows(
    bt: BalancerTables,
    w_sr: jax.Array,          # (R, S) movable weight per (rank, sbar)
    w_fixed: jax.Array,       # (R,) immovable weight per rank (dest-attributed)
    tol: float = 1.05,
    max_iters: int = 8,
    alpha: float = 0.5,       # kept for API compat; unused
) -> jax.Array:
    """Sbar-level Gauss-Seidel water-filling — the
    ``engpar::balanceWeights(input, tol, step_factor)`` replacement
    (pumipic_lb.cpp:496-530), converging WITHIN one call.

    Weight held in an sbar is freely re-assignable among the sbar's member
    ranks (a member's safe zone covers the element, so any member is a
    legal destination — selectParticles targets, lb.hpp:253).  Each sweep
    visits every sbar once and water-fills its total movable weight over
    the members' base loads (load minus this sbar's current allocation):
    the max load never increases, and a fully concentrated population
    reaches the achievable optimum in a few sweeps instead of one
    sbar-hop per APP step like the round-2 per-edge Jacobi (VERDICT r2 #5).
    Sweeps stop when ``max(load)/avg <= tol`` (bounded by ``max_iters``).

    Returns integer per-edge flows aligned with ``bt``'s edge list: the
    (R,S) allocation delta is decomposed into edge flows by matching the
    senders' and receivers' cumulative intervals within each sbar (exact,
    vectorized, deterministic).  Pure function of replicated inputs →
    identical plan on every rank.
    """
    R, S = w_sr.shape
    src, dst, sb = bt.edge_src, bt.edge_dst, bt.edge_sbar

    # member matrix from the (all ordered pairs) edge list: every member of
    # a real sbar appears as a source (sbars have >= 2 members by build)
    member = jnp.zeros((S, R), bool).at[sb, src].set(True, mode="drop")

    total = jnp.sum(w_fixed) + jnp.sum(w_sr)
    avg = jnp.maximum(total / R, 1e-30)

    def waterfill(B, T):
        """λ with sum_m max(λ - B_m, 0) = T (non-members carry B = +inf).

        Candidate λ_j fills the j smallest bases; it is consistent iff the
        LAST filled base is under water (λ_j >= Bs[j-1], the simplex-
        projection rule), and the answer is the largest consistent j.
        (A previous off-by-one compared λ_j to Bs[j-2], which over-fills:
        with bases [0, 2, 10] and T=1 it returned λ=4.33 — allocating
        weight to members ABOVE the true water level 1.0 — so the plan
        could migrate weight onto already-loaded ranks; regression
        test_waterfill_heterogeneous_bases.)"""
        Bs = jnp.sort(B)
        cum = jnp.cumsum(jnp.where(jnp.isfinite(Bs), Bs, 0.0))
        j = jnp.arange(1, R + 1, dtype=w_sr.dtype)
        lam_j = (T + cum) / j
        valid = (lam_j >= Bs - 1e-6) & jnp.isfinite(Bs)
        jstar = jnp.max(jnp.where(valid, jnp.arange(R), -1))
        return lam_j[jnp.maximum(jstar, 0)]

    def sbar_body(s, carry):
        a, loads = carry
        m = member[s]
        a_s = a[:, s]
        B = jnp.where(m, loads - a_s, jnp.inf)
        T = jnp.sum(jnp.where(m, a_s, 0.0))
        lam = waterfill(B, T)
        a_new = jnp.where(m, jnp.maximum(lam - B, 0.0), 0.0)
        # exact mass conservation under float drift
        a_new = a_new * (T / jnp.maximum(jnp.sum(a_new), 1e-30))
        loads = jnp.where(m, loads - a_s + a_new, loads)
        return a.at[:, s].set(a_new), loads

    def cond(carry):
        a, loads, it = carry
        return (it < max_iters) & (jnp.max(loads) / avg > tol)

    def body(carry):
        a, loads, it = carry
        a, loads = jax.lax.fori_loop(0, S, sbar_body, (a, loads))
        return a, loads, it + 1

    loads0 = w_fixed + jnp.sum(w_sr, axis=1)
    a, _, _ = jax.lax.while_loop(cond, body, (w_sr, loads0, jnp.int32(0)))

    # allocation delta -> per-edge flows: within each sbar, senders' and
    # receivers' cumulative intervals overlap exactly where weight moves
    send = jnp.maximum(w_sr - a, 0.0)                      # (R, S)
    recv = jnp.maximum(a - w_sr, 0.0)
    s_hi = jnp.cumsum(send, axis=0)
    s_lo = s_hi - send
    r_hi = jnp.cumsum(recv, axis=0)
    r_lo = r_hi - recv
    f = jnp.maximum(
        0.0,
        jnp.minimum(s_hi[src, sb], r_hi[dst, sb])
        - jnp.maximum(s_lo[src, sb], r_lo[dst, sb]),
    )
    return jnp.floor(f + 1e-4).astype(jnp.int32)


def _edge_intervals(bt: BalancerTables, flows: jax.Array, me: jax.Array):
    """Per-outgoing-edge [start, end) candidate-rank intervals within each
    sbar, plus the global flow prefix used for the interval lookup."""
    S = bt.num_sbars
    Pmax = bt.my_edge_idx.shape[1]

    mye = bt.my_edge_idx[me]                       # (Pmax,), sorted by sbar
    mye_valid = mye >= 0
    mye_c = jnp.maximum(mye, 0)
    e_sbar = jnp.where(mye_valid, bt.edge_sbar[mye_c], S)
    e_dst = jnp.where(mye_valid, bt.edge_dst[mye_c], -1)
    e_flow = jnp.where(mye_valid, flows[mye_c], 0)

    # global cumulative flow over my edges; per-sbar base = flow before the
    # sbar's first edge.  A candidate (sbar s, rank r) maps to global
    # position base(s) + r; its edge is the interval containing it.
    cumsum = jnp.cumsum(e_flow)                    # (Pmax,)
    sbar_first = jax.ops.segment_min(
        jnp.arange(Pmax, dtype=jnp.int32), e_sbar, num_segments=S + 1
    )  # first edge position per sbar (Pmax where sbar has no edge here)
    first_c = jnp.minimum(sbar_first[:S], Pmax - 1)
    sbar_base = jnp.where(
        (sbar_first[:S] < Pmax) & (sbar_first[:S] > 0),
        cumsum[jnp.maximum(first_c - 1, 0)], 0,
    )
    # total flow out of each sbar (for candidate-rank bounds)
    sbar_total = jax.ops.segment_sum(
        e_flow, jnp.minimum(e_sbar, S), num_segments=S + 1
    )[:S]
    return e_dst, cumsum, sbar_base, sbar_total


def rank_within_key(key: jax.Array, num_keys: int) -> jax.Array:
    """Stable rank of each item among items sharing its key (items with
    key == num_keys are ignored).  O(N log N) sort, O(N) memory."""
    N = key.shape[0]
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    counts = jax.ops.segment_sum(
        jnp.ones((N,), jnp.int32), sorted_key, num_segments=num_keys + 1
    )
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
    rank_sorted = jnp.arange(N, dtype=jnp.int32) - starts[
        jnp.minimum(sorted_key, num_keys)
    ]
    return jnp.zeros((N,), jnp.int32).at[order].set(rank_sorted)


def select_particles(
    bt: BalancerTables,
    flows: jax.Array,         # (P,) from plan_flows
    sbar: jax.Array,          # (N,) particle sbar (-1 immovable)
    candidate: jax.Array,     # (N,) bool: active & staying home
    dest_rank: jax.Array,     # (N,) current destinations
    me: jax.Array,
    noncore: Optional[jax.Array] = None,  # (N,) bool: elem owned elsewhere
) -> jax.Array:
    """Relabel up to flow[e] candidates per outgoing edge (selectParticles,
    lb.hpp:229-287).  Non-core-destined candidates are selected first, as
    the reference's two-pass greedy does.  Returns updated dest_rank.

    O(N) memory: candidates are ranked within their sbar (noncore first)
    and assigned to edges by a single searchsorted interval lookup against
    the per-sbar flow prefix — no (N × P) mask."""
    S = bt.num_sbars
    e_dst, cumsum, sbar_base, sbar_total = _edge_intervals(bt, flows, me)

    is_cand = candidate & (sbar >= 0)
    if noncore is None:
        key = jnp.where(is_cand, sbar, S)
        rank_in_sbar = rank_within_key(key, S)
    else:
        # order: within each sbar, non-core candidates first (reference
        # selectNonCoreParticles pass).  Rank over the composite key, then
        # re-rank against per-sbar starts.
        key2 = jnp.where(is_cand, sbar * 2 + (~noncore).astype(sbar.dtype),
                         2 * S)
        rank2 = rank_within_key(key2, 2 * S)
        # core candidates sit after all non-core ones of the same sbar
        n_noncore = jax.ops.segment_sum(
            (is_cand & noncore).astype(jnp.int32),
            jnp.where(is_cand, sbar, S), num_segments=S + 1,
        )[:S]
        sb_c = jnp.maximum(sbar, 0)
        rank_in_sbar = jnp.where(
            is_cand & ~noncore, rank2 + n_noncore[sb_c], rank2
        )

    sb_c = jnp.maximum(sbar, 0)
    in_plan = is_cand & (rank_in_sbar < sbar_total[sb_c])
    gpos = sbar_base[sb_c] + rank_in_sbar
    edge = jnp.searchsorted(cumsum, gpos, side="right")
    edge = jnp.minimum(edge, e_dst.shape[0] - 1)
    chosen_dst = jnp.where(in_plan, e_dst[edge], -1)
    return jnp.where(chosen_dst >= 0, chosen_dst, dest_rank).astype(
        dest_rank.dtype
    )


def repartition(
    bt: BalancerTables,
    sbar_of_elem_local: jax.Array,   # (E,) this rank's sbar map
    new_elem: jax.Array,             # (N,) post-search local elements
    active: jax.Array,
    dest_rank: jax.Array,            # (N,) from set_unsafe_procs
    me: jax.Array,
    tol: float = 1.05,
    elem_owner: Optional[jax.Array] = None,  # (E,) for noncore-first priority
    axis_name: str = RANK_AXIS,
    sbar_of_ptcl: Optional[jax.Array] = None,  # (N,) pre-decoded sbar (-1)
    noncore: Optional[jax.Array] = None,       # (N,) pre-decoded priority
) -> jax.Array:
    """Full LB pass inside shard_map (repartition, lb.hpp:352-362): weight
    accumulation with forced migrations counted at their destination
    (addWeights analog), tolerance-terminated diffusion plan, particle
    selection.  Returns updated dest_rank.

    ``sbar_of_ptcl``/``noncore``: per-particle values already decoded from
    the packed routing gather (:func:`pumipic_jax.parallel.migrate.
    route_particles`) — skips this function's own particle-rate gathers
    off ``sbar_of_elem_local``/``elem_owner``."""
    S = bt.num_sbars
    R = jax.lax.axis_size(axis_name)
    if R == 1:
        # nothing to balance on one rank (the reference's EnGPar call is a
        # no-op at comm size 1); static early-out keeps the whole weight
        # exchange/diffusion/selection out of the single-rank executable
        return dest_rank

    if sbar_of_ptcl is not None:
        sbar = sbar_of_ptcl
    else:
        sbar = jnp.where(
            active & (new_elem >= 0),
            sbar_of_elem_local[jnp.maximum(new_elem, 0)],
            -1,
        )
    staying = active & (dest_rank == me)
    leaving = active & (dest_rank != me)

    # movable weight: staying particles in sbar elements, per sbar
    keys = jnp.where(staying & (sbar >= 0), sbar, S)
    w_local = jax.ops.segment_sum(
        jnp.ones_like(keys, jnp.float32), keys, num_segments=S + 1
    )[:S]

    # immovable weight, attributed where it will LAND (addWeights
    # lb.hpp:128-205: forced weight is exchanged to the destination rank):
    #   - my particles forced to rank r count toward r,
    #   - my staying particles outside any sbar count toward me.
    forced_to = jax.ops.segment_sum(
        jnp.ones_like(keys, jnp.float32),
        jnp.where(leaving, dest_rank, R), num_segments=R + 1,
    )[:R]
    immovable_here = jnp.sum((staying & (sbar < 0)).astype(jnp.float32))
    fixed_vec = forced_to + immovable_here * (
        jnp.arange(R) == me
    ).astype(jnp.float32)
    w_fixed = jax.lax.psum(fixed_vec, axis_name)           # (R,) replicated

    w_sr = jax.lax.all_gather(w_local, axis_name)          # (R, S)

    flows = plan_flows(bt, w_sr, w_fixed, tol)
    if noncore is None and elem_owner is not None:
        noncore = (
            active & (new_elem >= 0)
            & (elem_owner[jnp.maximum(new_elem, 0)] != me)
        )
    return select_particles(bt, flows, sbar, staying, dest_rank, me, noncore)


def partition(
    bt: BalancerTables,
    sbar_of_elem_local: jax.Array,   # (E,)
    ptcls_per_elem: jax.Array,       # (E,) int
    num_ptcls: int,                  # static: sum of ptcls_per_elem (padded)
    me: jax.Array,
    tol: float = 1.05,
    axis_name: str = RANK_AXIS,
) -> jax.Array:
    """Array-based initial-placement variant (``ParticleBalancer::partition``,
    lb.hpp:289-350): from per-element particle counts, plan a balance and
    return a (num_ptcls,) destination-rank array in element-major particle
    order (entries past the true total are this rank).  Call inside
    shard_map."""
    E = ptcls_per_elem.shape[0]
    ppe = jnp.maximum(ptcls_per_elem.astype(jnp.int32), 0)
    offsets = jnp.cumsum(ppe)                          # inclusive
    total = offsets[E - 1]

    # expand to element-major particle order: pid -> elem
    pid = jnp.arange(num_ptcls, dtype=jnp.int32)
    elem = jnp.searchsorted(offsets, pid, side="right").astype(jnp.int32)
    valid = pid < total
    elem = jnp.where(valid, jnp.minimum(elem, E - 1), 0)

    sbar = jnp.where(valid, sbar_of_elem_local[elem], -1)
    S = bt.num_sbars
    keys = jnp.where(sbar >= 0, sbar, S)
    w_local = jax.ops.segment_sum(
        jnp.ones((num_ptcls,), jnp.float32) * valid, keys,
        num_segments=S + 1,
    )[:S]
    immovable = jnp.sum(((sbar < 0) & valid).astype(jnp.float32))
    R = jax.lax.axis_size(axis_name)
    fixed_vec = immovable * (jnp.arange(R) == me).astype(jnp.float32)
    w_fixed = jax.lax.psum(fixed_vec, axis_name)
    w_sr = jax.lax.all_gather(w_local, axis_name)

    flows = plan_flows(bt, w_sr, w_fixed, tol)
    dest0 = jnp.full((num_ptcls,), me, jnp.int32)
    return select_particles(bt, flows, sbar, valid, dest0, me)


def ptcl_imbalance(num_local: jax.Array, axis_name: str = RANK_AXIS):
    """printPtclImb analog (lb.hpp:380-398): (max, avg, imbalance) across
    ranks; call inside shard_map."""
    n = num_local.astype(jnp.float32)
    mx = jax.lax.pmax(n, axis_name)
    total = jax.lax.psum(n, axis_name)
    R = jax.lax.axis_size(axis_name)
    avg = total / R
    return mx, avg, jnp.where(avg > 0, mx / avg, 1.0)
