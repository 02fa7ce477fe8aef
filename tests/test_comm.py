"""Comm-layer unit tests — the ViewComm_test.cpp analog (SURVEY.md §4):
exercises the collective primitives the framework builds on (psum/pmax/
all_to_all/all_gather/ppermute under shard_map) plus our wrappers, on the
8-virtual-device CPU mesh.  This is how the reference tests GPU-aware comm
without special hardware — MPI itself (here: XLA collectives) is the
simulator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pumipic_jax.parallel.mesh_axis import (
    RANK_AXIS,
    make_device_mesh,
    num_ranks,
    particle_sharding,
    replicated,
)

R = 8


def _mesh():
    return make_device_mesh(R)


def _smap(mesh, f, in_specs, out_specs):
    return jax.jit(
        jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)
    )


def test_mesh_helpers():
    mesh = _mesh()
    assert num_ranks(mesh) == R
    assert particle_sharding(mesh).spec == P(RANK_AXIS)
    assert replicated(mesh).spec == P()


def test_psum_allreduce():
    mesh = _mesh()
    x = jax.device_put(
        jnp.arange(R, dtype=jnp.float32), NamedSharding(mesh, P(RANK_AXIS))
    )
    f = _smap(mesh, lambda v: jax.lax.psum(v, RANK_AXIS), (P(RANK_AXIS),), P())
    out = f(x)
    assert float(out[0]) == sum(range(R))


def test_all_to_all_transpose():
    """all_to_all with (R, K) send rows delivers row j to rank j — the
    exchange pattern migration and reduceCommArray rely on."""
    mesh = _mesh()
    K = 4
    # send[r, d, k] = r*100 + d  (payload labels source and destination)
    send = np.zeros((R, R, K), np.float32)
    for r in range(R):
        for d in range(R):
            send[r, d] = r * 100 + d
    x = jax.device_put(jnp.asarray(send), NamedSharding(mesh, P(RANK_AXIS)))

    def body(v):
        out = jax.lax.all_to_all(v[0], RANK_AXIS, split_axis=0, concat_axis=0)
        return out[None]

    f = _smap(mesh, body, (P(RANK_AXIS),), P(RANK_AXIS))
    out = np.asarray(f(x))
    # on rank d, row s must be s*100 + d
    for d in range(R):
        for s in range(R):
            assert (out[d, s] == s * 100 + d).all()


def test_all_gather():
    mesh = _mesh()
    x = jax.device_put(
        jnp.arange(R, dtype=jnp.float32)[:, None],
        NamedSharding(mesh, P(RANK_AXIS)),
    )

    def body(v):
        return jax.lax.all_gather(v[0], RANK_AXIS)[None]

    f = _smap(mesh, body, (P(RANK_AXIS),), P(RANK_AXIS))
    out = np.asarray(f(x))
    for r in range(R):
        np.testing.assert_array_equal(
            out[r].ravel(), np.arange(R, dtype=np.float32)
        )


def test_ppermute_ring():
    """ppermute ring shift — the Distributor-style neighbor exchange."""
    mesh = _mesh()
    x = jax.device_put(
        jnp.arange(R, dtype=jnp.float32)[:, None],
        NamedSharding(mesh, P(RANK_AXIS)),
    )

    def body(v):
        out = jax.lax.ppermute(
            v[0], RANK_AXIS, [(i, (i + 1) % R) for i in range(R)]
        )
        return out[None]

    f = _smap(mesh, body, (P(RANK_AXIS),), P(RANK_AXIS))
    out = np.asarray(f(x))[:, 0]
    np.testing.assert_array_equal(out, np.roll(np.arange(R), 1))


def test_pmax_pmin():
    mesh = _mesh()
    x = jax.device_put(
        jnp.arange(R, dtype=jnp.float32), NamedSharding(mesh, P(RANK_AXIS))
    )

    def body(v):
        return jnp.stack([
            jax.lax.pmax(v[0], RANK_AXIS), jax.lax.pmin(v[0], RANK_AXIS)
        ])

    f = _smap(mesh, body, (P(RANK_AXIS),), P())
    out = np.asarray(f(x))
    assert out[0] == R - 1 and out[1] == 0


# ---------------------------------------------------------------------------
# Tests of THIS repo's comm code (not raw jax collectives): reduce_comm_array
# on hand-built exchange tables, GID->LID translation, payload pack/unpack,
# and the neighbor-plan scheduler.  (The tests above are the ViewComm_test
# analog proving the primitive semantics we build on.)
# ---------------------------------------------------------------------------

def test_reduce_comm_array_synthetic_tables():
    """reduceCommArray on a hand-built 2-rank ownership: entity 0 owned by
    rank 0 with a copy on rank 1, entity 1 owned by rank 1 with a copy on
    rank 0.  SUM must add copies at the owner and rebroadcast; MAX/MIN and
    BCAST follow the same routes (pumipic_comm.cpp:222-440)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pumipic_jax.parallel import reduce as red
    from pumipic_jax.parallel.mesh_axis import RANK_AXIS, make_device_mesh

    R, K, V = 2, 1, 2
    mesh = make_device_mesh(R)
    # local entity layout per rank: slot0 = my owned entity, slot1 = my copy
    # of the peer's entity.
    send_ids = np.full((R, R, K), -1, np.int64)   # my copies grouped by owner
    recv_ids = np.full((R, R, K), -1, np.int64)   # my owned grouped by holder
    send_ids[0, 1, 0] = 1      # rank0 holds a copy (local slot 1) owned by 1
    send_ids[1, 0, 0] = 1      # rank1 holds a copy (local slot 1) owned by 0
    recv_ids[0, 1, 0] = 0      # rank0's owned slot 0 has a holder at rank 1
    recv_ids[1, 0, 0] = 0

    field = np.asarray([[10.0, 2.0],     # rank0: owned=10, copy-of-peer=2
                        [20.0, 5.0]])    # rank1: owned=20, copy-of-peer=5
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    args = [jax.device_put(jnp.asarray(a), sharding)
            for a in (send_ids, recv_ids, field)]

    def run(op):
        @jax.jit
        @lambda f: jax.shard_map(
            f, mesh=mesh, in_specs=(P(RANK_AXIS),) * 3,
            out_specs=P(RANK_AXIS), check_vma=False)
        def go(s, r, fld):
            out = red.reduce_comm_array(s[0], r[0], fld[0], op)
            return out[None]
        return np.asarray(go(*args))

    out = run(red.Op.SUM)
    # owner sums: rank0's entity: 10 + (rank1's copy 5) = 15; rank1's: 20+2=22
    np.testing.assert_allclose(out[0], [15.0, 22.0])
    np.testing.assert_allclose(out[1], [22.0, 15.0][::-1][::-1])  # [22, 15]
    assert out[1][0] == 22.0 and out[1][1] == 15.0

    out = run(red.Op.MAX)
    np.testing.assert_allclose(out[0], [10.0, 20.0])
    out = run(red.Op.MIN)
    np.testing.assert_allclose(out[0], [5.0, 2.0])
    out = run(red.Op.BCAST)   # owners' values overwrite copies
    np.testing.assert_allclose(out[0], [10.0, 20.0])
    np.testing.assert_allclose(out[1], [20.0, 10.0])


def test_gid_to_lid_translation():
    from pumipic_jax.parallel import migrate as mig
    import numpy as np

    gids = jnp.asarray([40, 10, 30, 20])    # local order
    perm = jnp.argsort(gids).astype(jnp.int32)
    srt = gids[perm]
    q = jnp.asarray([10, 20, 25, 40, -1, 99])
    out = np.asarray(mig.gid_to_lid(srt, perm, q))
    np.testing.assert_array_equal(out, [1, 3, -1, 0, -1, -1])


def test_migrate_payload_pack_unpack_types():
    """The packed-s32 single-buffer payload (floats bitcast, bools as 0/1;
    the s32 carrier is required — f32 lanes can flush small-int denormal
    bit patterns) round-trips every supported dtype (SendViews/RecvViews
    parity, SCS_migrate.h:147-175)."""
    import numpy as np
    from pumipic_jax.parallel import migrate as mig

    state = {
        "elem": jnp.zeros((4,), jnp.int32),
        "active": jnp.ones((4,), bool),
        "x": jnp.asarray([1.5, -2.5, 3.25, 0.0], jnp.float32),
        "pid": jnp.asarray([7, -8, 2**30, 0], jnp.int32),
        "flag": jnp.asarray([True, False, True, False]),
        "vec": jnp.arange(8, dtype=jnp.float32).reshape(4, 2),
        "J": jnp.arange(16, dtype=jnp.float32).reshape(4, 2, 2),
    }
    leaving = jnp.ones((4,), bool)
    gid = jnp.asarray([3, 1, 0, 2], jnp.int32)
    payload, slices = mig._pack_payload(state, leaving, gid)
    assert payload.shape == (4, 1 + 1 + 1 + 1 + 2 + 4)
    assert payload.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(payload[:, 0]), np.asarray(gid))
    for name in ("x", "pid", "flag", "vec", "J"):
        lo, hi, dtype, inner = slices[name]
        assert inner == state[name].shape[1:]
        lanes = payload[:, lo:hi]
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
        np.testing.assert_array_equal(np.asarray(vals), np.asarray(state[name]))


def test_neighbor_plan_ring_topology():
    """Edge coloring of a ring: 8 ranks each with 2 neighbors needs only a
    handful of rounds (payload O(degree), not O(R))."""
    import numpy as np
    from pumipic_jax.parallel import distributor as dst
    from pumipic_jax.parallel import migrate as mig

    R = 8
    nb = np.zeros((R, R), bool)
    for r in range(R):
        nb[r, r] = True
        nb[r, (r + 1) % R] = True
        nb[r, (r - 1) % R] = True
    plan = mig.build_neighbor_plan(
        dst.Distributor(is_neighbor=jnp.asarray(nb), num_ranks=R)
    )
    assert plan.num_rounds <= 3       # degree-2 digraph
    rod = np.asarray(plan.round_of_dest)
    for r in range(R):
        assert rod[r, (r + 1) % R] >= 0
        assert rod[r, (r + 4) % R] == -1


# ---------------------------------------------------------------------------
# round-5 multi-slice topology (("slice", "ranks") device mesh — the
# reference's multi-node MPI envelope, support/ViewComm.h:16-293)
# ---------------------------------------------------------------------------

def test_hier_all_to_all_matches_flat():
    """The DCN-aware two-stage exchange must be BIT-IDENTICAL to the flat
    all_to_all over the combined axis."""
    from functools import partial

    from pumipic_jax.parallel.mesh_axis import hier_all_to_all

    mesh2 = make_device_mesh(8, slices=2)
    AX = ("slice", "ranks")
    rng = np.random.default_rng(0)
    # global (R*R, 5): block r = rank r's (R, 5) send matrix (local view
    # inside shard_map is the (R, 5) per-destination payload)
    x = jnp.asarray(rng.normal(size=(64, 5)).astype(np.float32))

    @partial(jax.shard_map, mesh=mesh2, in_specs=P(AX), out_specs=P(AX))
    def flat(x):
        return jax.lax.all_to_all(x, AX, split_axis=0, concat_axis=0,
                                  tiled=False)

    @partial(jax.shard_map, mesh=mesh2, in_specs=P(AX), out_specs=P(AX))
    def hier(x):
        return hier_all_to_all(x, AX)

    np.testing.assert_array_equal(np.asarray(flat(x)), np.asarray(hier(x)))


def test_reduce_comm_array_hier_matches_flat():
    from functools import partial

    from pumipic_jax.parallel import reduce as red

    mesh2 = make_device_mesh(8, slices=2)
    AX = ("slice", "ranks")
    R, K, V = 8, 3, 12
    rng = np.random.default_rng(1)
    # synthetic exchange tables: entity g owned by rank g % R; each rank
    # holds copies of a few entities (local id == global id here)
    send = np.full((R, R, K), -1, np.int64)
    recv = np.full((R, R, K), -1, np.int64)
    for r in range(R):
        for g in range(V):
            o = g % R
            if o != r and rng.random() < 0.5:
                k = int((send[r, o] >= 0).sum())
                if k < K:
                    send[r, o, k] = g
                    kk = int((recv[o, r] >= 0).sum())
                    recv[o, r, kk] = g
    field = jnp.asarray(rng.normal(size=(R, V)).astype(np.float32))
    send_j = jnp.asarray(send)
    recv_j = jnp.asarray(recv)

    def run(hier):
        @partial(jax.shard_map, mesh=mesh2,
                 in_specs=(P(AX), P(AX), P(AX)), out_specs=P(AX),
                 check_vma=False)
        def f(s, rv, fld):
            out = red.reduce_comm_array(s[0], rv[0], fld[0], red.Op.SUM,
                                        axis_name=AX, hier=hier)
            return out[None]
        return np.asarray(f(send_j, recv_j, field))

    np.testing.assert_array_equal(run(False), run(True))


def test_migrate_world_hier_matches_flat():
    from functools import partial

    from pumipic_jax.parallel import migrate as mig

    mesh2 = make_device_mesh(8, slices=2)
    AX = ("slice", "ranks")
    R, N, E = 8, 16, 4
    rng = np.random.default_rng(2)
    elem_gid = jnp.asarray(
        np.stack([np.arange(E) + r * E for r in range(R)]), jnp.int32)
    # every rank's gid table covers all ranks' elements so arrivals resolve
    all_gids = np.arange(R * E, dtype=np.int32)
    gid_sorted = jnp.asarray(np.tile(all_gids, (R, 1)))
    gid_perm = jnp.asarray(np.tile(np.arange(R * E, dtype=np.int32), (R, 1)))

    state = {
        "elem": jnp.asarray(rng.integers(0, E, (R, N)), jnp.int32),
        "active": jnp.ones((R, N), bool),
        "pid": jnp.asarray(np.arange(R * N, dtype=np.int32).reshape(R, N)),
        "w": jnp.asarray(rng.normal(size=(R, N)).astype(np.float32)),
    }
    dest = jnp.asarray(rng.integers(0, R, (R, N)), jnp.int32)

    def run(hier):
        @partial(jax.shard_map, mesh=mesh2,
                 in_specs=(P(AX),) * 7, out_specs=(P(AX), P()),
                 check_vma=False)
        def f(elem, active, pid, w, dests, eg, gs):
            me = jax.lax.axis_index(AX).astype(jnp.int32)
            s = {"elem": elem[0], "active": active[0], "pid": pid[0],
                 "w": w[0]}
            res = mig.migrate(
                s, s["elem"], dests[0], eg[0], gs[0],
                gid_perm[0], me, R, cap=N, axis_name=AX, hier=hier)
            tot = jax.lax.psum(
                jnp.sum(res.state["active"].astype(jnp.int32)), AX)
            out = {k: v[None] for k, v in res.state.items()}
            return out, tot

        out, tot = f(state["elem"], state["active"], state["pid"],
                     state["w"], dest, elem_gid, gid_sorted)
        return jax.tree_util.tree_map(np.asarray, out), int(tot)

    a, ta = run(False)
    b, tb = run(True)
    assert ta == tb == 8 * N          # conservation
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_neighbor_plan_slice_split():
    """The DCN-aware schedule (slice_of_rank) must color within-slice edges
    into the leading rounds, cross-slice edges after, and stay a valid
    edge coloring (each round a partial permutation)."""
    from types import SimpleNamespace

    from pumipic_jax.parallel.migrate import build_neighbor_plan

    Rn = 8
    nb = np.zeros((Rn, Rn), bool)
    for r in range(Rn):
        nb[r, (r + 1) % Rn] = nb[r, (r - 1) % Rn] = True     # ring
        nb[r, (r + 4) % Rn] = True                           # cross pair
    dist = SimpleNamespace(is_neighbor=nb)
    sl = np.repeat(np.arange(2), 4)
    plan = build_neighbor_plan(dist, slice_of_rank=sl)
    assert 0 < plan.num_intra_rounds < plan.num_rounds
    for k, perm in enumerate(plan.perms):
        srcs = [p[0] for p in perm]
        dsts = [p[1] for p in perm]
        assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
        for (r, s) in perm:
            if k < plan.num_intra_rounds:
                assert sl[r] == sl[s], (k, r, s)
            else:
                assert sl[r] != sl[s], (k, r, s)
    # every edge colored exactly once
    assert sum(len(p) for p in plan.perms) == int(nb.sum())
    # flat plan unchanged semantics
    flat = build_neighbor_plan(dist)
    assert flat.num_intra_rounds == flat.num_rounds
    assert sum(len(p) for p in flat.perms) == int(nb.sum())
