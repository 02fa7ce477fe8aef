"""PICparts distributed tests on the 8-virtual-device CPU mesh — analogs of
the reference's partition/comm/migration integration suite
(test/input_construct, test/test_comm_array.cpp, pseudoXGCm 4-rank configs).
Correctness is invariant-based: min-ownership, fan-in/out sums, global
particle conservation (SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pumipic_jax.mesh import generate as gen
from pumipic_jax.parallel import migrate as mig
from pumipic_jax.parallel import picparts as ppm
from pumipic_jax.parallel import reduce as red
from pumipic_jax.parallel.mesh_axis import RANK_AXIS, make_device_mesh

R = 4


def _full_mesh():
    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    return coords, tris, cls


def _build(buffer_method=ppm.BufferMethod.BFS, layers=3, safe=1):
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, R)
    pp = ppm.build_picparts(
        coords, tris, owners, R,
        ppm.PicPartsInput(buffer_method, layers, safe), cls,
    )
    return coords, tris, owners, pp


def test_partition_rcb_balance():
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, 8)
    counts = np.bincount(owners, minlength=8)
    assert counts.min() > 0
    assert counts.max() - counts.min() <= 1


def test_picparts_build_invariants():
    coords, tris, owners, pp = _build()
    E_g = tris.shape[0]
    eg = np.asarray(pp.elem_gid)
    eo = np.asarray(pp.elem_owner)
    es = np.asarray(pp.elem_safe)

    covered = np.zeros(E_g, bool)
    for r in range(R):
        valid = eg[r] >= 0
        # owner recorded correctly for every local element
        np.testing.assert_array_equal(eo[r][valid], owners[eg[r][valid]])
        # core elements are all present and safe
        core = np.nonzero(owners == r)[0]
        assert set(core).issubset(set(eg[r][valid]))
        core_local = np.isin(eg[r], core)
        assert es[r][core_local].all()
        covered[eg[r][valid]] = True
    assert covered.all()

    # safe zone is a subset of the picpart and includes at most
    # core + safe_layers rings (every safe elem's owner-or-neighbor is local)
    for r in range(R):
        valid = eg[r] >= 0
        safe_gids = eg[r][np.asarray(es[r]) & valid]
        # a safe non-core element must be within 1 BFS layer of the core
        dist = ppm._bfs_layers(tris, coords.shape[0], owners == r, 10)
        assert (dist[safe_gids] <= 1).all()

    # vertex min-ownership (comm_array test analog: test_comm_array.cpp:48-61)
    vo = np.asarray(pp.vert_owner)
    vg = np.asarray(pp.vert_gid)
    V_g = coords.shape[0]
    vo_global = np.full(V_g, 10**9)
    for k in range(3):
        np.minimum.at(vo_global, tris[:, k], owners)
    for r in range(R):
        valid = vg[r] >= 0
        np.testing.assert_array_equal(vo[r][valid], vo_global[vg[r][valid]])


def test_picparts_full_mode():
    coords, tris, owners, pp = _build(ppm.BufferMethod.FULL)
    eg = np.asarray(pp.elem_gid)
    for r in range(R):
        assert (eg[r] >= 0).all()
        assert np.asarray(pp.elem_safe)[r].all()


def test_reduce_comm_array_sum():
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)

    V = pp.mesh.nverts
    vg = np.asarray(pp.vert_gid)
    # field = 1.0 on every valid local vertex
    field = jnp.asarray((vg >= 0).astype(np.float32))
    field = jax.device_put(field, sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        out = red.reduce_comm_array(
            lpp.vert_send_ids, lpp.vert_recv_ids, fld[0], red.Op.SUM
        )
        return out[None]

    out = np.asarray(run(pp_d, field))
    # expected: every copy of global vertex v holds (#ranks holding v)
    V_g = coords.shape[0]
    copies = np.zeros(V_g, np.int64)
    for r in range(R):
        valid = vg[r] >= 0
        np.add.at(copies, vg[r][valid], 1)
    for r in range(R):
        valid = vg[r] >= 0
        np.testing.assert_allclose(out[r][valid], copies[vg[r][valid]])


def test_reduce_comm_array_max():
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    vg = np.asarray(pp.vert_gid)
    # rank-valued field -> after MAX reduce+bcast every copy holds the max
    # rank holding that vertex
    field = np.where(vg >= 0, np.arange(R)[:, None].astype(np.float32), -np.inf)
    field = jax.device_put(jnp.asarray(field, jnp.float32), sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        return red.reduce_comm_array(
            lpp.vert_send_ids, lpp.vert_recv_ids, fld[0], red.Op.MAX
        )[None]

    out = np.asarray(run(pp_d, field))
    V_g = coords.shape[0]
    maxrank = np.full(V_g, -1.0)
    for r in range(R):
        valid = vg[r] >= 0
        np.maximum.at(maxrank, vg[r][valid], float(r))
    for r in range(R):
        valid = vg[r] >= 0
        np.testing.assert_allclose(out[r][valid], maxrank[vg[r][valid]])


def test_route_pack_matches_explicit_gathers():
    """The packed one-gather routing must reproduce set_unsafe_procs,
    the LB's sbar lookup, and the noncore flag exactly."""
    rng = np.random.default_rng(17)
    E, N, Rn, S = 500, 4000, 6, 37
    safe = jnp.asarray(rng.uniform(size=E) < 0.6)
    owner = jnp.asarray(rng.integers(0, Rn, E), jnp.int32)
    sbar = jnp.asarray(
        np.where(rng.uniform(size=E) < 0.7, rng.integers(0, S, E), -1),
        jnp.int32)
    new_elem = jnp.asarray(
        np.where(rng.uniform(size=N) < 0.9, rng.integers(0, E, N), -1),
        jnp.int32)
    active = jnp.asarray(rng.uniform(size=N) < 0.95)
    me = jnp.int32(2)

    assert mig.route_pack_bound_ok(S, Rn)
    route = mig.pack_route(safe, owner, sbar, Rn)
    dest, sbar_p, noncore = mig.route_particles(
        route, new_elem, active, me, Rn)

    want_dest = mig.set_unsafe_procs(safe, owner, new_elem, active, me)
    np.testing.assert_array_equal(np.asarray(dest), np.asarray(want_dest))
    ok = np.asarray(active) & (np.asarray(new_elem) >= 0)
    e_c = np.maximum(np.asarray(new_elem), 0)
    np.testing.assert_array_equal(
        np.asarray(sbar_p), np.where(ok, np.asarray(sbar)[e_c], -1))
    np.testing.assert_array_equal(
        np.asarray(noncore), ok & (np.asarray(owner)[e_c] != 2))


def test_side_comm_ownership_invariants():
    """Per-dim setupComm parity (src/pumipic_comm.cpp:12-184): edge-dim
    (dim-1) ownership must be the min adjacent element owner, and every
    local side must map to a real global side."""
    coords, tris, owners, pp = _build()
    sg = np.asarray(pp.side_gid)
    so = np.asarray(pp.side_owner)

    # independent global edge ownership
    pairs = np.concatenate([
        np.sort(tris[:, c], axis=1) for c in ((0, 1), (0, 2), (1, 2))
    ])
    keys = pairs[:, 0] * coords.shape[0] + pairs[:, 1]
    uniq, inv = np.unique(keys, return_inverse=True)
    own_g = np.full(len(uniq), 10**9)
    np.minimum.at(own_g, inv, np.tile(owners, 3))

    vg = np.asarray(pp.vert_gid)
    ev = np.asarray(pp.mesh.edge2verts)
    for r in range(R):
        valid = sg[r] >= 0
        assert valid.sum() > 0
        # recompute gid from local edge verts -> global verts
        lv = ev[r][: valid.sum()]
        gkeys = np.sort(vg[r][lv], axis=1)
        gkeys = gkeys[:, 0] * coords.shape[0] + gkeys[:, 1]
        pos = np.searchsorted(uniq, gkeys)
        np.testing.assert_array_equal(uniq[pos], gkeys)
        np.testing.assert_array_equal(sg[r][valid], pos)
        np.testing.assert_array_equal(so[r][valid], own_g[pos])


@pytest.mark.parametrize("dim", [1])
def test_reduce_comm_array_edge_dim(dim):
    """reduceCommArray on dim-1 entities: SUM fan-in/fan-out over buffered
    copies — every copy of a global edge ends with its copy count (the
    comm_array test invariant, test/test_comm_array.cpp:48-61, on edges)."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)

    sg = np.asarray(pp.side_gid)
    field = jnp.asarray((sg >= 0).astype(np.float32))
    field = jax.device_put(field, sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        send, recv = lpp.side_send_ids, lpp.side_recv_ids
        out = red.reduce_comm_array(send, recv, fld[0], red.Op.SUM)
        return out[None]

    out = np.asarray(run(pp_d, field))
    n_gl = int(sg.max()) + 1
    copies = np.zeros(n_gl, np.int64)
    for r in range(R):
        valid = sg[r] >= 0
        np.add.at(copies, sg[r][valid], 1)
    for r in range(R):
        valid = sg[r] >= 0
        np.testing.assert_allclose(out[r][valid], copies[sg[r][valid]])


def test_picparts_3d_per_dim_comm():
    """3D picparts: face (dim-2... dim-1=2) and edge (dim-1) comm tables
    exist, obey min-ownership, and reduce correctly on the edge dim —
    the reference builds comm for every dim (pumipic_comm.cpp:12-184)."""
    from pumipic_jax.mesh.core import Mesh3D

    coords, tets = gen.box_tet_mesh(4, 4, 4)
    owners = ppm.partition_rcb(coords, tets, R)
    pp = ppm.build_picparts(
        coords, tets, owners, R,
        ppm.PicPartsInput(ppm.BufferMethod.BFS, 2, 1),
        mesh_cls=Mesh3D,
    )
    assert pp.side_send_ids is not None        # faces
    assert pp.edge_send_ids is not None        # edges
    assert pp.comm_array_size(2) == pp.mesh.nfaces
    assert pp.comm_array_size(1) == pp.edge2verts.shape[1]

    # edge ownership = min adjacent element owner (global recompute)
    from itertools import combinations
    V_g = coords.shape[0]
    pairs = np.concatenate([
        np.sort(tets[:, c], axis=1) for c in combinations(range(4), 2)
    ])
    keys = pairs[:, 0].astype(np.int64) * V_g + pairs[:, 1]
    uniq, inv = np.unique(keys, return_inverse=True)
    own_g = np.full(len(uniq), 10**9)
    np.minimum.at(own_g, inv, np.tile(owners, 6))

    eg = np.asarray(pp.edge_gid)
    eo = np.asarray(pp.edge_owner)
    e2v = np.asarray(pp.edge2verts)
    vg = np.asarray(pp.vert_gid)
    for r in range(R):
        valid = eg[r] >= 0
        assert valid.sum() > 0
        lv = e2v[r][valid]
        gk = np.sort(vg[r][lv], axis=1)
        gk = gk[:, 0].astype(np.int64) * V_g + gk[:, 1]
        pos = np.searchsorted(uniq, gk)
        np.testing.assert_array_equal(eg[r][valid], pos)
        np.testing.assert_array_equal(eo[r][valid], own_g[pos])

    # SUM fan-in/out on the edge dim
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    field = jax.device_put(jnp.asarray((eg >= 0).astype(np.float32)),
                           sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        return red.reduce_comm_array(
            lpp.edge_send_ids, lpp.edge_recv_ids, fld[0], red.Op.SUM
        )[None]

    out = np.asarray(run(pp_d, field))
    copies = np.zeros(len(uniq), np.int64)
    for r in range(R):
        valid = eg[r] >= 0
        np.add.at(copies, eg[r][valid], 1)
    for r in range(R):
        valid = eg[r] >= 0
        np.testing.assert_allclose(out[r][valid], copies[eg[r][valid]])


def test_migrate_roundtrip():
    """Send particles sitting in buffered (unsafe) elements to their owners;
    total count conserved, arrivals land on the owning rank with the right
    global element."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    n_cap = 64
    state_h = {
        "x": np.zeros((R, n_cap, 2), np.float32),
        "pid": np.full((R, n_cap), -1, np.int32),
        "elem": np.full((R, n_cap), -1, np.int32),
        "active": np.zeros((R, n_cap), bool),
    }
    # each rank: 8 particles in safe elems, 8 in unsafe buffered elems
    pid = 0
    expect_dest = {}
    for r in range(R):
        safe_l = np.nonzero(es[r] & (eg[r] >= 0))[0]
        unsafe_l = np.nonzero(~es[r] & (eg[r] >= 0))[0]
        sl = np.concatenate([safe_l[:8], unsafe_l[:8]])
        for i, le in enumerate(sl):
            state_h["pid"][r, i] = pid
            state_h["elem"][r, i] = le
            state_h["active"][r, i] = True
            dest = r if es[r][le] else owners[eg[r][le]]
            expect_dest[pid] = (int(dest), int(eg[r][le]))
            pid += 1
    total = pid

    state = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in state_h.items()}

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=(P(RANK_AXIS), P()), check_vma=False,
    )
    def run(pp_l, s):
        lpp = ppm.local_view(pp_l)
        s = ppm.local_view(s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        dest = mig.set_unsafe_procs(
            lpp.elem_safe, lpp.elem_owner, s["elem"], s["active"], me
        )
        res = mig.migrate(
            s, s["elem"], dest, lpp.elem_gid, lpp.elem_gid_sorted,
            lpp.elem_gid_perm, me, R, 32,
        )
        stats = {
            "alive": jax.lax.psum(jnp.sum(res.state["active"].astype(jnp.int32)), RANK_AXIS),
            "overflow": jax.lax.pmax(res.overflow.astype(jnp.int32), RANK_AXIS),
        }
        return jax.tree_util.tree_map(lambda a: a[None], res.state), stats

    out, stats = run(pp_d, state)
    assert int(stats["overflow"]) == 0
    assert int(stats["alive"]) == total

    out = {k: np.asarray(v) for k, v in out.items()}
    eg_np = eg
    seen = {}
    for r in range(R):
        for s in range(n_cap):
            if out["active"][r, s]:
                p = int(out["pid"][r, s])
                le = int(out["elem"][r, s])
                seen[p] = (r, int(eg_np[r][le]))
    assert len(seen) == total
    for p, (dest, gid) in expect_dest.items():
        assert seen[p] == (dest, gid), (p, expect_dest[p], seen[p])


def _check_layout_invariants(ps_h, layout, elem_offsets, row_to_elem,
                             soa_width, sigma, num_elems):
    """Post-rebuild layout invariants on host views (test_structure.cpp
    rebuild checks / SCS_buildFns layout contracts)."""
    elem, active = ps_h["elem"], ps_h["active"]
    n = int(active.sum())
    if layout == "csr":
        off = elem_offsets
        assert off[-1] == n
        for e in range(num_elems):
            seg = elem[off[e]:off[e + 1]]
            assert np.all(seg == e)
            assert np.all(active[off[e]:off[e + 1]])
    elif layout == "cabm":
        off = elem_offsets
        assert np.all(off % soa_width == 0)
        for e in range(num_elems):
            seg_a = active[off[e]:off[e + 1]]
            assert np.all(elem[off[e]:off[e + 1]][seg_a] == e)
    elif layout == "dps":
        # actives-first compaction
        assert np.all(active[:n]) and not active[n:].any()
    elif layout == "scs":
        ppe = np.zeros(num_elems, np.int64)
        live = elem[active]
        np.add.at(ppe, live, 1)
        counts = np.zeros(len(row_to_elem), np.int64)
        valid = row_to_elem < num_elems
        counts[valid] = ppe[row_to_elem[valid]]
        sig = min(sigma, len(row_to_elem))
        for w0 in range(0, len(row_to_elem), sig):
            wc = counts[w0:w0 + sig]
            assert np.all(np.diff(wc) <= 0)


@pytest.mark.parametrize("layout", ["dps", "csr", "cabm", "scs"])
@pytest.mark.parametrize("neighbor", [False, True])
def test_migrate_structure_all_layouts(layout, neighbor):
    """Structure-integrated distributed migration: every container layout
    rides the collective and rebuilds its layout invariant on arrival —
    the reference's per-structure migrate (scs/SCS_migrate.h:4-221,
    csr/CSR_migrate.hpp, cabm/cabm_migrate.hpp, dps/dps_migrate.hpp)."""
    from pumipic_jax.particles import CSR, DPS, CabM, SellCSigma, SCSInput

    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    plan = None
    if neighbor:
        from pumipic_jax.parallel import distributor as dstm

        plan = mig.build_neighbor_plan(dstm.from_picparts(pp))

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    E_l = pp.mesh.nelems
    # CabM pads every occupied element's segment to the SoA width (8), so it
    # needs room for 2*16 distinct elements x 8 slots after migration
    cap = 256 if layout == "cabm" else 64

    builders = {
        "dps": lambda elems, fields: DPS(E_l, elems, fields=fields,
                                         capacity=cap),
        "csr": lambda elems, fields: CSR(E_l, elems, fields=fields,
                                         capacity=cap),
        "cabm": lambda elems, fields: CabM(E_l, elems, fields=fields,
                                           capacity=cap, soa_width=8),
        "scs": lambda elems, fields: SellCSigma(
            E_l, elems, fields=fields, capacity=cap,
            scs_input=SCSInput(chunk_size=4, sigma=8)),
    }

    pid = 0
    expect_dest = {}
    pos_of = {}
    ps_list = []
    for r in range(R):
        safe_l = np.nonzero(es[r] & (eg[r] >= 0))[0]
        unsafe_l = np.nonzero(~es[r] & (eg[r] >= 0))[0]
        sl = np.concatenate([safe_l[:8], unsafe_l[:8]])
        elems = np.asarray(sl, np.int64)
        pids = np.arange(pid, pid + len(sl), dtype=np.int32)
        pos = np.stack([pids.astype(np.float32),
                        pids.astype(np.float32) * 2 + 1], axis=1)
        for i, le in enumerate(sl):
            dest = r if es[r][le] else owners[eg[r][le]]
            expect_dest[pid + i] = (int(dest), int(eg[r][le]))
            pos_of[pid + i] = tuple(pos[i])
        pid += len(sl)
        ps_list.append(builders[layout](
            elems, {"pos": jnp.asarray(pos), "pid": jnp.asarray(pids)}
        ))
    total = pid

    ps_stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *ps_list)
    ps_stacked = jax.device_put(ps_stacked, sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS), P()),
        out_specs=(P(RANK_AXIS), P()), check_vma=False,
    )
    def run(pp_l, ps_s, plan_r):
        lpp = ppm.local_view(pp_l)
        ps = ppm.local_view(ps_s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        dest = mig.set_unsafe_procs(
            lpp.elem_safe, lpp.elem_owner, ps.elem, ps.active, me
        )
        ps2, res = mig.migrate_structure(
            ps, ps.elem, dest, lpp.elem_gid, lpp.elem_gid_sorted,
            lpp.elem_gid_perm, me, R, 32, plan=plan_r,
        )
        stats = {
            "alive": jax.lax.psum(
                jnp.sum(ps2.active.astype(jnp.int32)), RANK_AXIS),
            "overflow": jax.lax.pmax(
                (res.overflow | ps2.overflowed).astype(jnp.int32), RANK_AXIS),
            "unresolved": jax.lax.psum(res.num_recv_unresolved, RANK_AXIS),
            "illegal": jax.lax.psum(res.num_illegal_dest, RANK_AXIS),
        }
        return jax.tree_util.tree_map(lambda a: a[None], ps2), stats

    out, stats = run(pp_d, ps_stacked, plan)
    assert int(stats["overflow"]) == 0
    assert int(stats["unresolved"]) == 0
    assert int(stats["illegal"]) == 0
    assert int(stats["alive"]) == total

    seen = {}
    for r in range(R):
        ps_r = jax.tree_util.tree_map(lambda a, _r=r: a[_r], out)
        h = ps_r.copy_to_host()
        for s in range(cap):
            if h["active"][s]:
                p = int(h["pid"][s])
                le = int(h["elem"][s])
                assert p not in seen
                seen[p] = (r, int(eg[r][le]))
                np.testing.assert_allclose(h["pos"][s], pos_of[p])
        _check_layout_invariants(
            h, layout,
            None if ps_r.elem_offsets is None else np.asarray(ps_r.elem_offsets),
            None if ps_r.row_to_elem is None else np.asarray(ps_r.row_to_elem),
            8, 8, E_l,
        )
    assert len(seen) == total
    for p, want in expect_dest.items():
        assert seen[p] == want, (p, want, seen[p])


@pytest.mark.parametrize("layout", ["csr", "scs"])
def test_pseudo_push_and_search_distributed_3d(layout):
    """Distributed 3D mini-app at 8 ranks: straight push + 3D search +
    LB'd safe-zone migration with structure rebuild on arrival — the
    reference's 2-rank pseudoPushAndSearch with migrate_lb_ptcls
    (test/pseudoPushAndSearch.cpp:204-206,524).  Counts conserved modulo
    genuine domain exits; migration must actually fire."""
    from pumipic_jax.models.pseudo_push_and_search import (
        PushSearchConfig, make_picparts_setup_3d,
    )

    R8 = 8
    coords, tets = gen.box_tet_mesh(6, 6, 6)
    cfg = PushSearchConfig(
        num_ptcls=800, num_iterations=4, distance=0.12,
        push_dir=(1.0, 0.7, 0.4), structure=layout, use_locator=False,
    )
    mesh = make_device_mesh(R8)
    pp, ps, step = make_picparts_setup_3d(
        coords, tets, cfg, mesh, use_lb=True,
    )
    total_sent = 0
    alive_hist = []
    for _ in range(cfg.num_iterations):
        ps, stats = step(ps)
        assert int(stats["overflow"]) == 0
        assert int(stats["unresolved"]) == 0
        assert int(stats["illegal_dest"]) == 0
        total_sent += int(stats["sent"])
        alive_hist.append(int(stats["alive"]))
    # particles only leave by genuine domain exit
    assert alive_hist == sorted(alive_hist, reverse=True)
    assert alive_hist[-1] > 0
    assert total_sent > 0, "no cross-picpart migration exercised"

    # pid uniqueness and element validity across ranks
    eg = np.asarray(pp.elem_gid)
    seen = set()
    for r in range(R8):
        ps_r = jax.tree_util.tree_map(lambda a, _r=r: a[_r], ps)
        h = ps_r.copy_to_host()
        for s in range(ps_r.capacity):
            if h["active"][s]:
                p = int(h["pid"][s])
                assert p not in seen
                seen.add(p)
                assert eg[r][int(h["elem"][s])] >= 0
    assert len(seen) == alive_hist[-1]


def test_picparts_3d_kuhn_matches_walk():
    """The distributed 3D Kuhn analytic path (global box locate + g2l
    gather) must evolve identically to the per-rank walk: same alive
    counts and the same (pid -> global elem, position) assignment across
    ranks under migration + LB."""
    import dataclasses

    from pumipic_jax.models.pseudo_push_and_search import (
        PushSearchConfig, make_picparts_setup_3d,
    )

    R8 = 8
    coords, tets = gen.box_tet_mesh(6, 6, 6)
    cfg = PushSearchConfig(
        num_ptcls=800, num_iterations=4, distance=0.12,
        push_dir=(1.0, 0.7, 0.4), structure="csr", use_locator=False,
    )
    mesh = make_device_mesh(R8)

    def run(c):
        pp, ps, step = make_picparts_setup_3d(
            coords, tets, c, mesh, use_lb=True)
        for _ in range(cfg.num_iterations):
            ps, stats = step(ps)
        eg = np.asarray(pp.elem_gid)
        out = {}
        for r in range(R8):
            h = jax.tree_util.tree_map(
                lambda a, _r=r: a[_r], ps).copy_to_host()
            for s in range(len(h["active"])):
                if h["active"][s]:
                    out[int(h["pid"][s])] = (
                        int(eg[r][int(h["elem"][s])]),
                        tuple(np.asarray(h["x"][s]).tolist()))
        return out, int(stats["alive"])

    out_k, alive_k = run(cfg)
    out_w, alive_w = run(dataclasses.replace(cfg, kuhn="off"))
    assert alive_k == alive_w
    assert out_k == out_w


def test_picparts_analytic_matches_walk():
    """The detection-gated SPMD analytic path (global annulus locate + one
    g2l gather, gather-free ring rotation on the carried global elem id)
    must produce bit-identical particle state and synced fields to the
    per-rank walk across multi-step runs with migration + LB."""
    import dataclasses

    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=1200,
        mdl_face=4,
        deg_per_push=15.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    pp_a, st_a, _, step_a = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200)
    assert "gelem" in st_a  # the analytic path actually engaged
    pp_w, st_w, _, step_w = make_picparts_setup(
        coords, tris, cls,
        dataclasses.replace(cfg, analytic_locate="off"), mesh, use_lb=True,
        migrate_cap=1200)
    assert "gelem" not in st_w
    for i in range(4):
        st_a, fwd_a, stats_a = step_a(st_a)
        st_w, fwd_w, stats_w = step_w(st_w)
        assert int(stats_a["alive"]) == int(stats_w["alive"])
        assert int(stats_a["overflow"]) == 0
    for k in st_w:
        np.testing.assert_array_equal(
            np.asarray(st_a[k]), np.asarray(st_w[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(fwd_a), np.asarray(fwd_w))
    # the carried global elem id is consistent with the local id
    eg = np.asarray(pp_a.elem_gid)
    lid = np.asarray(st_a["elem"])
    gid = np.asarray(st_a["gelem"])
    act = np.asarray(st_a["active"])
    for r in range(R):
        np.testing.assert_array_equal(eg[r][lid[r][act[r]]], gid[r][act[r]])


def test_pseudo_xgcm_picparts_end_to_end():
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=800,
        mdl_face=4,
        deg_per_push=5.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    pp, state, gyro_map, step = make_picparts_setup(
        coords, tris, cls, cfg, mesh
    )
    alive_prev = None
    for i in range(3):
        state, fwd, stats = step(state)
        assert int(stats["overflow"]) == 0
        alive = int(stats["alive"])
        if alive_prev is not None:
            assert alive <= alive_prev  # only boundary exits remove particles
        assert alive > 0.8 * cfg.num_ptcls
        alive_prev = alive

    # synced field consistency: copies of the same global vertex agree
    vg = np.asarray(pp.vert_gid)
    fwd = np.asarray(fwd)
    V_g = coords.shape[0]
    val = {}
    for r in range(R):
        for lv in range(vg.shape[1]):
            g = vg[r, lv]
            if g >= 0:
                if g in val:
                    np.testing.assert_allclose(
                        fwd[r, lv], val[g], rtol=1e-4, atol=1e-4
                    )
                else:
                    val[g] = fwd[r, lv]


def test_distributor_and_ptn_files(tmp_path):
    from pumipic_jax.parallel import distributor as dist

    coords, tris, owners, pp = _build()
    d = dist.from_picparts(pp)
    nb = np.asarray(d.is_neighbor)
    assert nb.shape == (R, R)
    assert np.all(np.diag(nb))
    # neighbor relation covers every buffered owner
    eo = np.asarray(pp.elem_owner)
    for r in range(R):
        for o in np.unique(eo[r][eo[r] >= 0]):
            assert nb[r, o]
    w = dist.world_distributor(R)
    assert bool(np.asarray(w.is_neighbor).all())

    # .ptn / .cpn round trip
    p = str(tmp_path / "mesh.ptn")
    ppm.write_ptn(p, owners)
    np.testing.assert_array_equal(ppm.read_ptn(p), owners)
    c = str(tmp_path / "mesh.cpn")
    ppm.write_cpn(c, {1: 0, 2: 1, 3: 1})
    assert ppm.read_cpn(c) == {1: 0, 2: 1, 3: 1}


def test_reduce_comm_array_elem_dim():
    """Element-dimension comm arrays reduce the same way (the reference's
    per-dim reduceCommArray; elem copies -> owner -> broadcast)."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    eg = np.asarray(pp.elem_gid)
    field = jnp.asarray((eg >= 0).astype(np.float32))
    field = jax.device_put(field, sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        return red.reduce_comm_array(
            lpp.elem_send_ids, lpp.elem_recv_ids, fld[0], red.Op.SUM
        )[None]

    out = np.asarray(run(pp_d, field))
    E_g = tris.shape[0]
    copies = np.zeros(E_g, np.int64)
    for r in range(R):
        valid = eg[r] >= 0
        np.add.at(copies, eg[r][valid], 1)
    for r in range(R):
        valid = eg[r] >= 0
        np.testing.assert_allclose(out[r][valid], copies[eg[r][valid]])


def test_reduce_comm_array_vector_field():
    """(V, k) comm arrays (gyroSync syncs a 2-component array,
    gyroScatter.hpp:233-259)."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    vg = np.asarray(pp.vert_gid)
    V = pp.mesh.nverts
    f = np.zeros((R, V, 2), np.float32)
    f[:, :, 0] = (vg >= 0)
    f[:, :, 1] = 2.0 * (vg >= 0)
    field = jax.device_put(jnp.asarray(f), sharding)

    @jax.jit
    @lambda fn: jax.shard_map(
        fn, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        return red.reduce_comm_array(
            lpp.vert_send_ids, lpp.vert_recv_ids, fld[0], red.Op.SUM
        )[None]

    out = np.asarray(run(pp_d, field))
    V_g = coords.shape[0]
    copies = np.zeros(V_g, np.int64)
    for r in range(R):
        valid = vg[r] >= 0
        np.add.at(copies, vg[r][valid], 1)
    for r in range(R):
        valid = vg[r] >= 0
        np.testing.assert_allclose(out[r][valid, 0], copies[vg[r][valid]])
        np.testing.assert_allclose(out[r][valid, 1], 2 * copies[vg[r][valid]])


def test_picparts_3d():
    """3D picparts: build, invariants, and buffered migration on a tet mesh."""
    from pumipic_jax.mesh.core import Mesh3D

    coords, tets = gen.box_tet_mesh(6, 6, 6)
    owners = ppm.partition_rcb(coords, tets, R)
    pp = ppm.build_picparts(
        coords, tets, owners, R, ppm.PicPartsInput(), None, mesh_cls=Mesh3D
    )
    eg = np.asarray(pp.elem_gid)
    eo = np.asarray(pp.elem_owner)
    covered = np.zeros(tets.shape[0], bool)
    for r in range(R):
        valid = eg[r] >= 0
        np.testing.assert_array_equal(eo[r][valid], owners[eg[r][valid]])
        covered[eg[r][valid]] = True
    assert covered.all()

    # migration of unsafe particles to owners, 3D
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    es = np.asarray(pp.elem_safe)
    n_cap = 32
    state_h = {
        "elem": np.full((R, n_cap), -1, np.int32),
        "active": np.zeros((R, n_cap), bool),
    }
    total = 0
    for r in range(R):
        unsafe_l = np.nonzero(~es[r] & (eg[r] >= 0))[0][:8]
        for i, le in enumerate(unsafe_l):
            state_h["elem"][r, i] = le
            state_h["active"][r, i] = True
            total += 1
    state = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in state_h.items()}

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(), check_vma=False,
    )
    def run(pp_l, s):
        lpp = ppm.local_view(pp_l)
        s = ppm.local_view(s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        dest = mig.set_unsafe_procs(
            lpp.elem_safe, lpp.elem_owner, s["elem"], s["active"], me
        )
        res = mig.migrate(
            s, s["elem"], dest, lpp.elem_gid, lpp.elem_gid_sorted,
            lpp.elem_gid_perm, me, R, 16,
        )
        return {
            "alive": jax.lax.psum(
                jnp.sum(res.state["active"].astype(jnp.int32)), RANK_AXIS),
            "overflow": jax.lax.pmax(res.overflow.astype(jnp.int32), RANK_AXIS),
        }

    stats = run(pp_d, state)
    assert int(stats["overflow"]) == 0
    assert int(stats["alive"]) == total


def test_buffer_modes_minimum_none():
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, R)
    # NONE: picpart == core, safe == core
    pp_none = ppm.build_picparts(
        coords, tris, owners, R,
        ppm.PicPartsInput(ppm.BufferMethod.NONE), cls,
    )
    eg = np.asarray(pp_none.elem_gid)
    es = np.asarray(pp_none.elem_safe)
    for r in range(R):
        valid = eg[r] >= 0
        np.testing.assert_array_equal(np.sort(eg[r][valid]),
                                      np.nonzero(owners == r)[0])
        assert es[r][valid].all()
    # MINIMUM: one buffer layer, safe == core only
    pp_min = ppm.build_picparts(
        coords, tris, owners, R,
        ppm.PicPartsInput(ppm.BufferMethod.MINIMUM), cls,
    )
    eg = np.asarray(pp_min.elem_gid)
    es = np.asarray(pp_min.elem_safe)
    for r in range(R):
        valid = eg[r] >= 0
        gids = eg[r][valid]
        core = owners[gids] == r
        # strictly more than core, and safe exactly on core
        assert core.sum() == (owners == r).sum()
        assert (~core).sum() > 0
        np.testing.assert_array_equal(es[r][valid], core)


def test_reduce_comm_array_bcast():
    """BCAST: owner's value overwrites every copy (no fan-in reduce)."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    vg = np.asarray(pp.vert_gid)
    vo = np.asarray(pp.vert_owner)
    # every rank writes its own rank id; after BCAST copies hold owner's id
    field = np.where(vg >= 0, float(1), 0) * np.arange(R)[:, None]
    field = jax.device_put(jnp.asarray(field, jnp.float32), sharding)

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=P(RANK_AXIS), check_vma=False,
    )
    def run(pp_l, fld):
        lpp = ppm.local_view(pp_l)
        return red.reduce_comm_array(
            lpp.vert_send_ids, lpp.vert_recv_ids, fld[0], red.Op.BCAST
        )[None]

    out = np.asarray(run(pp_d, field))
    for r in range(R):
        valid = vg[r] >= 0
        np.testing.assert_allclose(out[r][valid], vo[r][valid].astype(float))


def test_checkpoint_resume_continuation():
    """Checkpoint mid-run, restore, and verify the continuation matches an
    uninterrupted run exactly (the file_rw + resume semantics)."""
    from pumipic_jax.io import checkpoint as ckpt
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )
    import tempfile

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=400, mdl_face=4, deg_per_push=5.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    pp, state, gyro_map, step = make_picparts_setup(coords, tris, cls, cfg, mesh)

    # run 2 steps, checkpoint, run 2 more
    for _ in range(2):
        state, fwd, stats = step(state)
    with tempfile.TemporaryDirectory() as d:
        ppath = ckpt.write_picparts(f"{d}/pp", pp)
        spath = ckpt.write_particles(f"{d}/state", state, step=2)
        ref_state = state
        for _ in range(2):
            ref_state, ref_fwd, _ = step(ref_state)

        # restore and continue
        state2, at_step = ckpt.read_particles(spath)
        assert at_step == 2
        from jax.sharding import NamedSharding, PartitionSpec as P2
        sharding = NamedSharding(mesh, P2(RANK_AXIS))
        state2 = {k: jax.device_put(jnp.asarray(v), sharding)
                  for k, v in state2.items()}
        for _ in range(2):
            state2, fwd2, _ = step(state2)
    np.testing.assert_allclose(
        np.asarray(ref_fwd), np.asarray(fwd2), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(ref_state["elem"]), np.asarray(state2["elem"])
    )


@pytest.mark.parametrize("method,layers,safe", [
    (ppm.BufferMethod.BFS, 3, 1),
    (ppm.BufferMethod.MINIMUM, 1, 0),
    (ppm.BufferMethod.NONE, 0, 0),
])
def test_neighbor_migrate_matches_world(method, layers, safe):
    """Neighbor-scoped ppermute migration (Distributor subset exchange,
    SCS_migrate.h:41-62) is bit-identical to the world all_to_all, with a
    payload that scales with the neighbor count, not R."""
    from pumipic_jax.parallel import distributor as dst

    coords, tris, owners, pp = _build(method, layers, safe)
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)

    dist = dst.from_picparts(pp)
    plan = mig.build_neighbor_plan(dist)
    # payload scaling: rounds bounded by neighbor degree, not world size
    deg = int(np.asarray(dist.is_neighbor).sum(axis=1).max()) - 1
    assert plan.num_rounds <= max(2 * deg - 1, 1)

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    n_cap = 64
    state_h = {
        "x": np.zeros((R, n_cap, 2), np.float32),
        "pid": np.full((R, n_cap), -1, np.int32),
        "elem": np.full((R, n_cap), -1, np.int32),
        "active": np.zeros((R, n_cap), bool),
    }
    pid = 0
    for r in range(R):
        valid = np.nonzero(eg[r] >= 0)[0]
        unsafe_first = valid[np.argsort(es[r][valid])]  # unsafe first
        for i, le in enumerate(unsafe_first[:16]):
            state_h["pid"][r, i] = pid
            state_h["elem"][r, i] = le
            state_h["active"][r, i] = True
            state_h["x"][r, i] = (pid * 0.5, -pid)
            pid += 1
    total = pid
    state = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in state_h.items()}

    def make_run(use_plan):
        @jax.jit
        @lambda f: jax.shard_map(
            f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
            out_specs=(P(RANK_AXIS), P()), check_vma=False,
        )
        def run(pp_l, s):
            lpp = ppm.local_view(pp_l)
            s = ppm.local_view(s)
            me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
            dest = mig.set_unsafe_procs(
                lpp.elem_safe, lpp.elem_owner, s["elem"], s["active"], me
            )
            res = mig.migrate(
                s, s["elem"], dest, lpp.elem_gid, lpp.elem_gid_sorted,
                lpp.elem_gid_perm, me, R, 32,
                plan=plan if use_plan else None,
            )
            stats = {
                "alive": jax.lax.psum(
                    jnp.sum(res.state["active"].astype(jnp.int32)), RANK_AXIS),
                "overflow": jax.lax.pmax(
                    res.overflow.astype(jnp.int32), RANK_AXIS),
                "illegal": jax.lax.psum(res.num_illegal_dest, RANK_AXIS),
                "unresolved": jax.lax.psum(res.num_recv_unresolved, RANK_AXIS),
            }
            return jax.tree_util.tree_map(lambda a: a[None], res.state), stats

        return run

    out_w, st_w = make_run(False)(pp_d, state)
    out_n, st_n = make_run(True)(pp_d, state)
    assert int(st_w["overflow"]) == 0 and int(st_n["overflow"]) == 0
    assert int(st_n["illegal"]) == 0
    assert int(st_w["unresolved"]) == 0 and int(st_n["unresolved"]) == 0
    assert int(st_w["alive"]) == total and int(st_n["alive"]) == total
    for k in out_w:
        np.testing.assert_array_equal(
            np.asarray(out_w[k]), np.asarray(out_n[k]), err_msg=k
        )


def test_neighbor_plan_coloring():
    """Every directed neighbor edge gets exactly one round; rounds are
    partial permutations (each rank <=1 send and <=1 recv per round)."""
    from pumipic_jax.parallel import distributor as dst

    coords, tris, owners, pp = _build()
    plan = mig.build_neighbor_plan(dst.from_picparts(pp))
    rod = np.asarray(plan.round_of_dest)
    nb = np.asarray(dst.from_picparts(pp).is_neighbor)
    for r in range(R):
        for s in range(R):
            if r != s and nb[r, s]:
                assert rod[r, s] >= 0
            else:
                assert rod[r, s] == -1
    for k, perm in enumerate(plan.perms):
        srcs = [p[0] for p in perm]
        dsts = [p[1] for p in perm]
        assert len(set(srcs)) == len(srcs)
        assert len(set(dsts)) == len(dsts)
        for s, d in perm:
            assert int(np.asarray(plan.src_of_round)[d, k]) == s


@pytest.mark.parametrize("bridge_dim", [0, 1])
def test_bridge_dim_buffers(bridge_dim):
    """BFS bridge dimension option (pumipic_input.hpp:20-26): edge bridges
    grow buffers no faster than vertex bridges, and every picpart still
    contains its core + a conforming buffer."""
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, R)
    pp = ppm.build_picparts(
        coords, tris, owners, R,
        ppm.PicPartsInput(ppm.BufferMethod.BFS, 2, 1, bridge_dim=bridge_dim),
        cls,
    )
    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    for r in range(R):
        valid = eg[r] >= 0
        core = np.isin(eg[r], np.nonzero(owners == r)[0])
        assert core[valid].sum() == (owners == r).sum()
        assert es[r][core].all()


def test_edge_bridge_grows_slower():
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, R)
    sizes = {}
    for bd in (0, 1):
        pp = ppm.build_picparts(
            coords, tris, owners, R,
            ppm.PicPartsInput(ppm.BufferMethod.BFS, 2, 1, bridge_dim=bd), cls,
        )
        eg = np.asarray(pp.elem_gid)
        sizes[bd] = (eg >= 0).sum()
    # an edge is shared by <= 2 triangles, a vertex by ~6: edge-bridged
    # buffers must be strictly smaller for the same layer count
    assert sizes[1] < sizes[0], sizes


def test_bridge_dim_3d_face():
    from pumipic_jax.mesh.core import Mesh3D

    coords, tets = gen.box_tet_mesh(4, 4, 4)
    owners = ppm.partition_rcb(coords, tets, R)
    for bd in (0, 1, 2):
        pp = ppm.build_picparts(
            coords, tets, owners, R,
            ppm.PicPartsInput(ppm.BufferMethod.MINIMUM, 1, 0, bridge_dim=bd),
            mesh_cls=Mesh3D,
        )
        eg = np.asarray(pp.elem_gid)
        assert (eg >= 0).any()
    with pytest.raises(ValueError):
        ppm.build_picparts(
            coords, tris if False else tets[:, :4], owners, R,
            ppm.PicPartsInput(ppm.BufferMethod.BFS, 1, 0, bridge_dim=3),
            mesh_cls=Mesh3D,
        )


def test_picparts_single_rank_early_out():
    """R=1 picparts must take the reference's comm-size-1 migrate path
    (SCS_migrate.h single-rank early-out; LB no-op) and still run the full
    step (search + scatter + owner sync) correctly."""
    import jax
    from jax.sharding import Mesh as JMesh
    from pumipic_jax.mesh import generate as gen
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )

    dm = JMesh(np.array(jax.devices()[:1]), ("ranks",))
    coords, tris, cls = gen.annulus_mesh(8, 48, 0.3, 1.0)
    cfg = XGCmConfig(num_ptcls=5000, mdl_face=2, deg_per_push=15.0,
                     gyro=GyroConfig(num_rings=2, points_per_ring=4))
    pp, state, gmap, step = make_picparts_setup(
        coords, tris, cls, cfg, dm, use_lb=True)
    s = state
    for _ in range(3):
        s, fwd, stats = step(s)
    assert int(stats["sent"]) == 0          # no exchange on one rank
    assert int(stats["overflow"]) == 0
    assert int(stats["alive"]) > 4500       # only boundary exits lost
    assert float(jnp.sum(fwd)) > 0


@pytest.mark.parametrize("neighbor", [False, True])
def test_migrate_lossless_under_cap1_overflow(neighbor):
    """Forced bucket overflow must never drop a particle (the reference's
    ragged exchange is exactly sized, SCS_migrate.h:39-175): with cap=1 and
    many leavers per destination, beyond-quota leavers stay HOME (active,
    ``num_kept_home``) and retry next step — the particle (pid, multiset)
    is conserved across 5 steps on 8 ranks, and kept counts drain as the
    one-per-pair quota admits more each step."""
    R8 = 8
    coords, tris, cls = _full_mesh()
    owners = ppm.partition_rcb(coords, tris, R8)
    pp = ppm.build_picparts(
        coords, tris, owners, R8,
        ppm.PicPartsInput(ppm.BufferMethod.BFS, 3, 1), cls,
    )
    mesh = make_device_mesh(R8)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)
    plan = None
    if neighbor:
        from pumipic_jax.parallel import distributor as dstm

        plan = mig.build_neighbor_plan(dstm.from_picparts(pp))

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    n_cap = 128
    state_h = {
        "pid": np.full((R8, n_cap), -1, np.int32),
        "elem": np.full((R8, n_cap), -1, np.int32),
        "active": np.zeros((R8, n_cap), bool),
    }
    pid = 0
    for r in range(R8):
        unsafe_l = np.nonzero(~es[r] & (eg[r] >= 0))[0]
        # 16 leavers per rank, all funneled through cap=1 buckets
        for i, le in enumerate(unsafe_l[:16]):
            state_h["pid"][r, i] = pid
            state_h["elem"][r, i] = le
            state_h["active"][r, i] = True
            pid += 1
    total = pid
    state = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in state_h.items()}

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=(P(RANK_AXIS), P()), check_vma=False,
    )
    def step(pp_l, s):
        lpp = ppm.local_view(pp_l)
        s = ppm.local_view(s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        dest = mig.set_unsafe_procs(
            lpp.elem_safe, lpp.elem_owner, s["elem"], s["active"], me
        )
        res = mig.migrate(
            s, s["elem"], dest, lpp.elem_gid, lpp.elem_gid_sorted,
            lpp.elem_gid_perm, me, R8, 1, plan=plan,
        )
        stats = {
            "alive": jax.lax.psum(
                jnp.sum(res.state["active"].astype(jnp.int32)), RANK_AXIS),
            "kept": jax.lax.psum(res.num_kept_home, RANK_AXIS),
            "sent": jax.lax.psum(res.num_sent, RANK_AXIS),
            "unresolved": jax.lax.psum(res.num_recv_unresolved, RANK_AXIS),
        }
        return jax.tree_util.tree_map(lambda a: a[None], res.state), stats

    kept_history = []
    for it in range(5):
        state, stats = step(pp_d, state)
        assert int(stats["alive"]) == total, (it, stats)
        assert int(stats["unresolved"]) == 0, (it, stats)
        kept_history.append(int(stats["kept"]))
        # pid multiset conserved exactly (no drops, no duplicates)
        pids = np.asarray(state["pid"])[np.asarray(state["active"])]
        assert len(pids) == total
        assert np.array_equal(np.sort(pids), np.arange(total))
    # cap=1 with 16 leavers/rank must actually exercise the quota path
    assert kept_history[0] > 0, kept_history
    # quotas admit at least one particle per sending pair per step
    assert kept_history[-1] < kept_history[0], kept_history


def test_shrink_picparts_capacity_conserves():
    """Adaptive capacity shrink: live particles compact to a slot prefix,
    pid multiset conserved, refusal when new_cap < live width."""
    from pumipic_jax.models.pseudo_xgcm import shrink_picparts_capacity

    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    rng = np.random.default_rng(5)
    n_cap = 256
    act = rng.uniform(size=(R, n_cap)) < 0.4
    state = {
        "active": jnp.asarray(act),
        "elem": jnp.asarray(np.where(act, rng.integers(0, 50, (R, n_cap)),
                                     -1).astype(np.int32)),
        "pid": jnp.asarray(np.where(
            act, np.arange(R * n_cap).reshape(R, n_cap), -1).astype(np.int32)),
        "x0": jnp.asarray(rng.normal(size=(R, n_cap)).astype(np.float32)),
    }
    state = {k: jax.device_put(v, sharding) for k, v in state.items()}
    live_max = int(act.sum(axis=1).max())
    new_cap = live_max + 8
    out = shrink_picparts_capacity(state, new_cap)
    assert out["active"].shape == (R, new_cap)
    pids_in = np.sort(np.asarray(state["pid"])[act])
    act_out = np.asarray(out["active"])
    pids_out = np.sort(np.asarray(out["pid"])[act_out])
    np.testing.assert_array_equal(pids_in, pids_out)
    # per-rank live set and field values preserved
    for r in range(R):
        in_r = np.asarray(state["pid"])[r][act[r]]
        out_r = np.asarray(out["pid"])[r][act_out[r]]
        np.testing.assert_array_equal(np.sort(in_r), np.sort(out_r))
    with pytest.raises(ValueError):
        shrink_picparts_capacity(state, live_max - 1)


def test_capacity_monitor_end_to_end_matches_unresized():
    """Telemetry-driven capacity resize (parallel/capacity.py): after a
    monitor-recommended SHRINK the step must keep producing the same
    physics — pid-keyed particle state and synced fields identical to the
    never-resized run — and a subsequent GROW must also be value-neutral
    (idle slots are pure width).  The reference re-sizes its views from
    padding inputs under the same misfit conditions (SCS_rebuild.h:3-120,
    scs_input.hpp:15-64)."""
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )
    from pumipic_jax.parallel.capacity import (
        CapacityMonitor, CapacityPolicy, resize_capacity,
    )

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=1200,
        mdl_face=4,
        deg_per_push=10.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    # generous capacity so the shrink recommendation actually fires
    _, st_a, _, step_a = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200,
        cap_factor=3.0)
    pp_b, st_b, _, step_b = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200,
        cap_factor=3.0)

    mon = CapacityMonitor(CapacityPolicy(sent_factor=2, slack=16))
    for _ in range(2):
        st_a, fwd_a, stats_a = step_a(st_a)
        st_b, fwd_b, stats_b = step_b(st_b)
        assert "kept_home" in stats_b and int(stats_b["kept_home"]) == 0
        mon.observe(stats_b)
    cap0 = st_b["active"].shape[1]
    st_b = mon.apply(st_b)
    cap1 = st_b["active"].shape[1]
    assert cap1 < cap0, (cap0, cap1)  # the shrink fired
    assert mon.steps == 0            # window reset after a resize

    def by_pid(state):
        act = np.asarray(state["active"])
        pid = np.asarray(state["pid"])[act]
        order = np.argsort(pid)
        cols = {k: np.asarray(state[k])[act][order]
                for k in ("x0", "x1", "gelem")}
        return np.sort(pid), cols

    for i in range(3):
        st_a, fwd_a, stats_a = step_a(st_a)
        st_b, fwd_b, stats_b = step_b(st_b)
        assert int(stats_a["alive"]) == int(stats_b["alive"])
        assert int(stats_b["overflow"]) == 0
    pid_a, cols_a = by_pid(st_a)
    pid_b, cols_b = by_pid(st_b)
    np.testing.assert_array_equal(pid_a, pid_b)
    for k in cols_a:
        np.testing.assert_array_equal(cols_a[k], cols_b[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(fwd_a), np.asarray(fwd_b))

    # GROW back above the original width: values must not move
    st_c = resize_capacity(st_b, cap0 + 32)
    assert st_c["active"].shape[1] == cap0 + 32
    st_b2, fwd_b2, _ = step_b(st_b)
    st_c2, fwd_c2, _ = step_b(st_c)
    pid_b2, cols_b2 = by_pid(st_b2)
    pid_c2, cols_c2 = by_pid(st_c2)
    np.testing.assert_array_equal(pid_b2, pid_c2)
    for k in cols_b2:
        np.testing.assert_array_equal(cols_b2[k], cols_c2[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(fwd_b2), np.asarray(fwd_c2))


def test_capacity_monitor_recommendations():
    """Policy unit checks: shrink only past the hysteresis gain, grow on
    observed need or on admission-quota pressure (kept_home)."""
    from pumipic_jax.parallel.capacity import CapacityMonitor, CapacityPolicy

    pol = CapacityPolicy(alive_headroom=1.0, sent_factor=1, sent_floor=0,
                         slack=0, shrink_min_gain=0.1, grow_factor=1.5)

    def stats(alive, sent, kept=0):
        return {"alive_per_rank": jnp.asarray([alive], jnp.int32),
                "sent_per_rank": jnp.asarray([sent], jnp.int32),
                "kept_home": jnp.asarray(kept, jnp.int32)}

    mon = CapacityMonitor(pol)
    assert mon.recommend(1000) is None            # no observations yet
    mon.observe(stats(500, 10))
    assert mon.recommend(1000) == 510             # clear shrink
    assert mon.recommend(550) is None             # within hysteresis band
    mon.observe(stats(990, 40))                   # need 1030 > cap
    assert mon.recommend(1000) == int(1030 * 1.5)
    mon2 = CapacityMonitor(pol)
    mon2.observe(stats(100, 0, kept=3))           # quota pressure => grow
    rec = mon2.recommend(1000)
    assert rec is not None and rec > 1000


def test_banded_route_derivation_decode_and_negatives():
    """Gather-free banded routing (parallel/banded_route.py): derivation
    verifies exhaustively on a sector-band partition of a proven annulus,
    its decode matches the packed-gather route (lid/dest/sbar/noncore) for
    EVERY global element at every rank, and non-band partitions (RCB) are
    rejected so callers keep the always-correct gather."""
    from pumipic_jax.mesh.locator import detect_annulus_structured
    from pumipic_jax.parallel import balancer as lbm
    from pumipic_jax.parallel import banded_route as brm
    from pumipic_jax.parallel import migrate as mig

    coords, tris, cls = _full_mesh()
    an = detect_annulus_structured(coords, tris, cls=cls)
    assert an is not None
    owners = brm.sector_band_owners(an.n_rings, an.n_sectors, R)
    pp = ppm.build_picparts(coords, tris, owners, R, ppm.PicPartsInput(), cls)
    bt = lbm.build_balancer(pp, R)
    br = brm.derive_banded_route(pp, owners, an, bt, R)
    assert br is not None
    assert len(br.sbar_runs) >= R  # one bar region per band boundary

    # negative: RCB partition is not sector-banded
    owners_rcb = ppm.partition_rcb(coords, tris, R)
    pp2 = ppm.build_picparts(coords, tris, owners_rcb, R,
                             ppm.PicPartsInput(), cls)
    bt2 = lbm.build_balancer(pp2, R)
    assert brm.derive_banded_route(pp2, owners_rcb, an, bt2, R) is None

    # decode equality against the gather route for EVERY global element
    E_g = tris.shape[0]
    gid = np.arange(E_g)
    ring_f = jnp.asarray(gid // (2 * an.n_sectors), jnp.float32)
    sec_f = jnp.asarray((gid // 2) % an.n_sectors, jnp.float32)
    tri_f = jnp.asarray(gid & 1, jnp.float32)
    active = jnp.ones(E_g, bool)
    eg = np.asarray(pp.elem_gid)
    for r in range(R):
        me = jnp.int32(r)
        lid, dest, sbar, noncore = brm.banded_decode(
            br, ring_f, sec_f, tri_f, jnp.ones(E_g, bool), active, me,
            br.win_a[r], br.win_w[r], br.win_w0[r], br.win_nsa[r],
            br.safe_a[r], br.safe_len[r])
        # reference path: host g2l + pack_route gather + route_decode
        g2l = np.full(E_g, -1, np.int64)
        valid = eg[r] >= 0
        g2l[eg[r][valid]] = np.nonzero(valid)[0]
        route = np.asarray(mig.pack_route(
            pp.elem_safe[r], pp.elem_owner[r], bt.sbar_of_elem[r], R))
        lid_ref = g2l[gid]
        np.testing.assert_array_equal(np.asarray(lid), lid_ref, err_msg="lid")
        rv = jnp.asarray(np.where(lid_ref >= 0,
                                  route[np.maximum(lid_ref, 0)], 0.0),
                         jnp.float32)
        ok = jnp.asarray(lid_ref >= 0)
        dest_ref, sbar_ref, noncore_ref = mig.route_decode(rv, ok, me, R)
        np.testing.assert_array_equal(np.asarray(dest), np.asarray(dest_ref))
        np.testing.assert_array_equal(np.asarray(sbar), np.asarray(sbar_ref))
        np.testing.assert_array_equal(
            np.asarray(noncore), np.asarray(noncore_ref))


def test_picparts_banded_route_matches_gather_route():
    """End-to-end: the banded gather-free step must be bit-identical to
    the packed [lid|route] gather step across multi-step runs with LB +
    migration (same picparts, same numbering — only the routing
    arithmetic differs)."""
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=1200, mdl_face=4, deg_per_push=15.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    _, st_b, _, step_b = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200)
    _, st_g, _, step_g = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200,
        banded_route="off")
    for _ in range(4):
        st_b, fwd_b, stats_b = step_b(st_b)
        st_g, fwd_g, stats_g = step_g(st_g)
        assert int(stats_b["alive"]) == int(stats_g["alive"])
        assert int(stats_b["sent"]) == int(stats_g["sent"])
        assert int(stats_b["overflow"]) == 0
    for k in st_g:
        np.testing.assert_array_equal(
            np.asarray(st_b[k]), np.asarray(st_g[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(fwd_b), np.asarray(fwd_g))


def test_migrate_tensor_valued_field():
    """REGRESSION (round-5 review): _pack_payload handled only scalar and
    (N, k) member fields — a tensor-valued field ((N,)+shape, which the
    containers accept via field_spec) produced a wrong lane count and a
    trace-time concatenate error in distributed migrate.  Tensor fields
    must ride the s32 carrier bit-exactly like the rest."""
    coords, tris, owners, pp = _build()
    mesh = make_device_mesh(R)
    sharding = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sharding)

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    n_cap = 64
    state_h = {
        "J": np.zeros((R, n_cap, 2, 2), np.float32),
        "pid": np.full((R, n_cap), -1, np.int32),
        "elem": np.full((R, n_cap), -1, np.int32),
        "active": np.zeros((R, n_cap), bool),
    }
    stamp = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
    pid = 0
    for r in range(R):
        safe_l = np.nonzero(es[r] & (eg[r] >= 0))[0]
        unsafe_l = np.nonzero(~es[r] & (eg[r] >= 0))[0]
        sl = np.concatenate([safe_l[:6], unsafe_l[:6]])
        for i, le in enumerate(sl):
            state_h["pid"][r, i] = pid
            state_h["elem"][r, i] = le
            state_h["active"][r, i] = True
            state_h["J"][r, i] = (pid + 1) * stamp
            pid += 1
    total = pid
    state = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in state_h.items()}

    @jax.jit
    @lambda f: jax.shard_map(
        f, mesh=mesh, in_specs=(P(RANK_AXIS), P(RANK_AXIS)),
        out_specs=(P(RANK_AXIS), P()), check_vma=False,
    )
    def run(pp_l, s):
        lpp = ppm.local_view(pp_l)
        s = ppm.local_view(s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        dest = mig.set_unsafe_procs(
            lpp.elem_safe, lpp.elem_owner, s["elem"], s["active"], me
        )
        res = mig.migrate(
            s, s["elem"], dest, lpp.elem_gid, lpp.elem_gid_sorted,
            lpp.elem_gid_perm, me, R, 32,
        )
        alive = jax.lax.psum(
            jnp.sum(res.state["active"].astype(jnp.int32)), RANK_AXIS)
        return jax.tree_util.tree_map(lambda a: a[None], res.state), alive

    out, alive = run(pp_d, state)
    assert int(alive) == total
    out = {k: np.asarray(v) for k, v in out.items()}
    assert out["J"].shape == (R, n_cap, 2, 2)
    seen = 0
    for r in range(R):
        for s in range(n_cap):
            if out["active"][r, s]:
                p = int(out["pid"][r, s])
                np.testing.assert_array_equal(out["J"][r, s], (p + 1) * stamp)
                seen += 1
    assert seen == total


def test_picparts_per_particle_radius_engages():
    """REGRESSION (round-5 review): make_picparts_setup silently ignored
    GyroConfig.per_particle_radius — no 'rg' field was seeded and the
    deposition always used the uniform placeholder radius, so the
    distributed arm disagreed with the dp/single-device arms for identical
    configs.  The per-particle radius must ride the state (incl. through
    migration) and change the deposition."""
    import dataclasses

    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )

    coords, tris, cls = _full_mesh()
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=1200,
        mdl_face=4,
        deg_per_push=15.0,
        # rmax spans element size (~0.1 on this mesh) so different bracket
        # rings genuinely map to different vertices — at small rmax all
        # ring points share the vertex's element and the per-particle
        # bracketing is (correctly) invisible in the deposition
        gyro=GyroConfig(rmax=0.12, num_rings=3, points_per_ring=4,
                        per_particle_radius=True),
        max_search_iters=64,
    )
    pp_p, st_p, _, step_p = make_picparts_setup(
        coords, tris, cls, cfg, mesh, use_lb=True, migrate_cap=1200)
    assert "rg" in st_p
    rg0 = np.sort(np.asarray(st_p["rg"])[np.asarray(st_p["active"])])
    cfg_u = dataclasses.replace(
        cfg, gyro=dataclasses.replace(cfg.gyro, per_particle_radius=False))
    pp_u, st_u, _, step_u = make_picparts_setup(
        coords, tris, cls, cfg_u, mesh, use_lb=True,
        migrate_cap=1200)
    for _ in range(3):
        st_p, fwd_p, stats_p = step_p(st_p)
        st_u, fwd_u, stats_u = step_u(st_u)
    assert int(stats_p["alive"]) == int(stats_u["alive"])
    # the radius multiset is conserved through migration
    act = np.asarray(st_p["active"])
    rg3 = np.sort(np.asarray(st_p["rg"])[act])
    np.testing.assert_allclose(rg3, rg0)
    # and the per-particle bracketing actually changes the deposition
    assert not np.allclose(np.asarray(fwd_p), np.asarray(fwd_u))
    # total deposited weight is radius-independent (each particle deposits
    # into exactly two bracket rings before the ring-point mapping): compare
    # against the uniform arm at matched survivor counts
    np.testing.assert_allclose(float(np.asarray(fwd_p).sum()),
                               float(np.asarray(fwd_u).sum()), rtol=0.2)
