"""Search tests — analogs of the reference's search2d / test_adj drivers
(test/search2d.cpp, test/test_adj.cpp): walk particles from a wrong starting
element to the element containing their destination, verify containment and
boundary-exit behavior against an exhaustive numpy point-location oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from pumipic_jax.mesh import generate as gen
from pumipic_jax.mesh.core import Mesh2D, Mesh3D
from pumipic_jax.ops import search


def _cross2(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def test_search_2d_rectangle():
    coords, tris = gen.rectangle_mesh(8, 8)
    m = Mesh2D.from_arrays(coords, tris)
    rng = np.random.default_rng(0)
    n = 256
    pts = rng.uniform(0.02, 0.98, size=(n, 2))
    elem_init = jnp.zeros(n, jnp.int32)  # deliberately wrong start
    active = jnp.ones(n, bool)
    res = search.search_mesh_2d(
        m, jnp.asarray(pts), jnp.asarray(pts), elem_init, active
    )
    assert bool(res.all_found)
    got = np.asarray(res.elem_ids)
    # verify containment (the oracle may pick the twin triangle on edges)
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in range(n):
        t = ev[got[i]]
        a, b, c = cz[t[0]], cz[t[1]], cz[t[2]]
        p = pts[i]
        d1 = _cross2(b - a, p - a)
        d2 = _cross2(c - b, p - b)
        d3 = _cross2(a - c, p - c)
        assert d1 >= -1e-5 and d2 >= -1e-5 and d3 >= -1e-5, (i, got[i])


def test_search_2d_exit_domain():
    coords, tris = gen.rectangle_mesh(4, 4)
    m = Mesh2D.from_arrays(coords, tris)
    pts = jnp.asarray([[2.0, 0.5], [-1.0, 0.5], [0.5, 0.5]])
    elem_init = jnp.zeros(3, jnp.int32)
    active = jnp.ones(3, bool)
    res = search.search_mesh_2d(m, pts, pts, elem_init, active)
    assert bool(res.all_found)
    ids = np.asarray(res.elem_ids)
    assert ids[0] == -1 and ids[1] == -1 and ids[2] >= 0


def test_search_2d_inactive_particles():
    coords, tris = gen.rectangle_mesh(4, 4)
    m = Mesh2D.from_arrays(coords, tris)
    pts = jnp.asarray([[0.5, 0.5], [0.6, 0.6]])
    active = jnp.asarray([True, False])
    res = search.search_mesh_2d(m, pts, pts, jnp.zeros(2, jnp.int32), active)
    ids = np.asarray(res.elem_ids)
    assert ids[0] >= 0 and ids[1] == -1


def test_search_2d_reflect_boundary():
    coords, tris = gen.rectangle_mesh(4, 4)
    m = Mesh2D.from_arrays(coords, tris)
    # target outside across x=1 wall: reflected destination should be inside
    pts_tgt = jnp.asarray([[1.3, 0.52]])
    res = search.search_mesh_2d(
        m,
        jnp.asarray([[0.9, 0.52]]),
        pts_tgt,
        jnp.zeros(1, jnp.int32),
        jnp.ones(1, bool),
        boundary_handler=search.reflect_on_exit_2d,
    )
    assert bool(res.all_found)
    assert int(res.elem_ids[0]) >= 0
    np.testing.assert_allclose(np.asarray(res.dest)[0], [0.7, 0.52], atol=1e-5)


def test_search_3d_box():
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    m = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(1)
    n = 128
    pts = rng.uniform(0.05, 0.95, size=(n, 3))
    res = search.search_mesh_3d(
        m, jnp.asarray(pts), jnp.asarray(pts),
        jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
    )
    assert bool(res.all_found)
    got = np.asarray(res.elem_ids)
    assert np.all(got >= 0)
    # containment check via volumes
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in range(n):
        t = ev[got[i]]
        v = cz[t]
        p = pts[i]
        vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
        for k in range(4):
            vv = v.copy()
            vv[k] = p
            w = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
            assert w / vol >= -1e-4, (i, got[i], k)


def test_search_3d_exit_domain():
    coords, tets = gen.box_tet_mesh(2, 2, 2)
    m = Mesh3D.from_arrays(coords, tets)
    pts = jnp.asarray([[0.5, 0.5, 3.0]])
    res = search.search_mesh_3d(
        m, pts, pts, jnp.zeros(1, jnp.int32), jnp.ones(1, bool)
    )
    assert int(res.elem_ids[0]) == -1


def test_trace_dispatch():
    coords, tris = gen.rectangle_mesh(2, 2)
    m2 = Mesh2D.from_arrays(coords, tris)
    pts = jnp.asarray([[0.5, 0.5]])
    res = search.trace_particle_through_mesh(
        m2, pts, pts, jnp.zeros(1, jnp.int32), jnp.ones(1, bool)
    )
    assert int(res.elem_ids[0]) >= 0


def test_search_2d_accel_matches_plain():
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    m = Mesh2D.from_arrays(coords, tris, cls)
    grid = build_locator_grid(coords, tris)
    rng = np.random.default_rng(5)
    n = 512
    # starts at random element centroids; targets = jittered nearby points,
    # some pushed outside the domain to exercise genuine exits
    elems = rng.integers(0, m.nelems, n)
    orig = np.asarray(m.elem_centroids)[elems]
    tgt = orig + rng.normal(scale=0.08, size=(n, 2))
    res_plain = search.search_mesh_2d(
        m, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    res_accel = search.search_mesh_2d_accel(
        m, grid, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_accel.elem_ids)
    )
    # boundary exits present in this fixture (sanity that we exercised them)
    assert (np.asarray(res_plain.elem_ids) == -1).sum() > 0


def test_search_2d_accel_polar_grid_matches_cartesian():
    """Polar-aligned locator cells (the shaped-annular-mesh policy) must
    produce identical search results to cartesian cells — the grid only
    seeds candidates/guesses; containment and the walk decide.  Also pins
    the auto heuristic: annular meshes go polar, disks stay cartesian."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, cls = gen.tokamak_mesh(10, 48)
    m = Mesh2D.from_arrays(coords, tris, cls)
    g_cart = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                                polar=False)
    g_pol = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                               polar=True)
    assert not g_cart.polar and g_pol.polar
    rng = np.random.default_rng(11)
    n = 1024
    elems = rng.integers(0, m.nelems, n)
    orig = np.asarray(m.elem_centroids)[elems]
    tgt = orig + rng.normal(scale=0.1, size=(n, 2))
    args = (jnp.asarray(orig), jnp.asarray(tgt),
            jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100)
    res_c = search.search_mesh_2d_accel(m, g_cart, *args)
    res_p = search.search_mesh_2d_accel(m, g_pol, *args)
    np.testing.assert_array_equal(
        np.asarray(res_c.elem_ids), np.asarray(res_p.elem_ids))
    assert bool(res_p.all_found)
    # auto heuristic: a genuine annulus goes polar; the tokamak meshes'
    # near-closed core (r_min/r_max ~ 0.056) and shaped flux surfaces make
    # polar cells LOSE there (72.9 vs 78.9% host-measured hit rate at cpe4
    # on the 120k mesh), so they stay cartesian; disks too
    ac, at, _ = gen.annulus_mesh(6, 32, 0.3, 1.0)
    assert build_locator_grid(ac, at).polar
    assert not build_locator_grid(coords, tris).polar
    dc, dt, _ = gen.disk_mesh(8, 8)
    assert not build_locator_grid(dc, dt).polar


def test_locator_grid_guess_quality():
    from pumipic_jax.mesh.locator import build_locator_grid
    from pumipic_jax.ops import geometry as geo

    coords, tris, cls = gen.disk_mesh(8, 8)
    m = Mesh2D.from_arrays(coords, tris, cls)
    grid = build_locator_grid(coords, tris)
    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.6, 0.6, size=(256, 2))
    g = np.asarray(grid.guess(jnp.asarray(pts)))
    assert (g >= 0).all() and (g < m.nelems).all()
    # guesses should mostly be within a couple of hops: verify that walking
    # from the guess converges fast
    res = search.search_mesh_2d(
        m, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(g, jnp.int32),
        jnp.ones(256, bool), 20,
    )
    assert bool(res.all_found)


def test_search_3d_intersection_method():
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    m = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(2)
    n = 128
    orig = rng.uniform(0.05, 0.95, size=(n, 3))
    tgt = np.clip(orig + rng.normal(scale=0.2, size=(n, 3)), -0.5, 1.5)
    # locate starting elements first
    res0 = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(orig),
        jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
    )
    start = res0.elem_ids
    kw = dict(max_iters=200)
    res_bcc = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(tgt), start, jnp.ones(n, bool), **kw
    )
    res_mt = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(tgt), start, jnp.ones(n, bool),
        method="intersection", **kw
    )
    a, b = np.asarray(res_bcc.elem_ids), np.asarray(res_mt.elem_ids)
    # both must agree on found/lost status; found elements must both
    # contain the target (they can differ only on exact-boundary ties)
    np.testing.assert_array_equal(a < 0, b < 0)
    cz = np.asarray(m.coords)
    ev = np.asarray(m.elem2verts)
    for i in np.nonzero(a >= 0)[0]:
        for got in {a[i], b[i]}:
            v = cz[ev[got]]
            vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
            for k in range(4):
                vv = v.copy()
                vv[k] = tgt[i]
                w = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
                assert w / vol >= -1e-4, (i, got)


def test_search_3d_hybrid_method():
    """Hybrid BCC+segment-clip walk (search_mesh's interleaved fallback,
    adjacency.hpp:558-768): must agree with both pure methods on found/lost
    status and produce containing elements."""
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    m = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(13)
    n = 256
    orig = rng.uniform(0.05, 0.95, size=(n, 3))
    tgt = np.clip(orig + rng.normal(scale=0.25, size=(n, 3)), -0.5, 1.5)
    res0 = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(orig),
        jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
    )
    start = res0.elem_ids
    res_bcc = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(tgt), start, jnp.ones(n, bool), 200,
    )
    res_hyb = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(tgt), start, jnp.ones(n, bool), 200,
        method="hybrid",
    )
    a, b = np.asarray(res_bcc.elem_ids), np.asarray(res_hyb.elem_ids)
    np.testing.assert_array_equal(a < 0, b < 0)
    assert (a < 0).sum() > 0                       # exits exercised
    # found elements must contain the target (tie-tolerant)
    cz = np.asarray(m.coords)
    ev = np.asarray(m.elem2verts)
    for i in np.nonzero(b >= 0)[0]:
        v = cz[ev[b[i]]]
        vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
        for k in range(4):
            vv = v.copy()
            vv[k] = tgt[i]
            w = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
            assert w / vol >= -1e-4, (i, b[i])
    # accel path accepts the hybrid core too
    from pumipic_jax.mesh.locator import build_locator_grid_3d

    grid = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom)
    res_acc = search.search_mesh_3d_accel(
        m, grid, jnp.asarray(orig), jnp.asarray(tgt), start,
        jnp.ones(n, bool), 200, method="hybrid",
    )
    np.testing.assert_array_equal(b, np.asarray(res_acc.elem_ids))


def test_search_2d_pt():
    coords, tris = gen.rectangle_mesh(4, 4)
    m = Mesh2D.from_arrays(coords, tris)
    e = search.search_mesh_2d_pt(m, [0.55, 0.55], 0)
    assert int(e) >= 0
    e2 = search.search_mesh_2d_pt(m, [2.5, 0.5], 0)
    assert int(e2) == -1


def test_search_3d_accel_matches_plain():
    from pumipic_jax.mesh.locator import build_locator_grid_3d

    coords, tets = gen.box_tet_mesh(5, 5, 5)
    m = Mesh3D.from_arrays(coords, tets)
    grid = build_locator_grid_3d(coords, tets)
    rng = np.random.default_rng(9)
    n = 256
    elems = rng.integers(0, m.nelems, n)
    orig = np.asarray(m.elem_centroids)[elems]
    tgt = orig + rng.normal(scale=0.15, size=(n, 3))  # some exit the box
    res_plain = search.search_mesh_3d(
        m, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    res_accel = search.search_mesh_3d_accel(
        m, grid, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_accel.elem_ids)
    )
    assert (np.asarray(res_plain.elem_ids) == -1).sum() > 0

    # cell-resident candidate rows (one-gather peel) must match exactly too
    grid_rows = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom,
                                      peel="rows")
    assert grid_rows.cell_rows is not None
    res_peel = search.search_mesh_3d_accel(
        m, grid_rows, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_peel.elem_ids)
    )

    # slim separating-plane peel must match exactly too
    grid_lines = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom,
                                       peel="lines")
    assert grid_lines.cell_lines is not None
    assert grid_lines.cell_lines.shape[1] == 6
    res_lines = search.search_mesh_3d_accel(
        m, grid_lines, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_lines.elem_ids)
    )

    # split-rows peel (two independent 13-col tables) must match exactly too
    grid_split = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom,
                                       peel="rows_split")
    assert grid_split.cell_rows_b is not None
    assert grid_split.cell_rows.shape[1] == 13
    res_split = search.search_mesh_3d_accel(
        m, grid_split, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_split.elem_ids)
    )

    # rows_ab peel (A's row + B as a start hint, 14 cols) must match too
    grid_ab = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom,
                                    peel="rows_ab")
    assert grid_ab.cell_rows.shape[1] == 14
    assert grid_ab.cell_rows_b is None
    res_ab = search.search_mesh_3d_accel(
        m, grid_ab, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_ab.elem_ids)
    )

    # rows_abc peel (A + B provable, C as a third-ranked start hint,
    # 27 cols) must match too
    grid_abc = build_locator_grid_3d(coords, tets, walk_geom=m.walk_geom,
                                     peel="rows_abc")
    assert grid_abc.cell_rows.shape[1] == 27
    res_abc = search.search_mesh_3d_accel(
        m, grid_abc, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
    )
    np.testing.assert_array_equal(
        np.asarray(res_plain.elem_ids), np.asarray(res_abc.elem_ids)
    )

    # id-diet peel (k candidate ids + chained walk_geom gathers) must
    # match too, at k=2 and k=4
    for peel, kk in (("ids", 2), ("ids4", 4)):
        grid_ids = build_locator_grid_3d(coords, tets,
                                         walk_geom=m.walk_geom, peel=peel)
        assert grid_ids.cell_ids is not None
        assert grid_ids.cell_ids.shape[1] == kk
        assert grid_ids.cell_ids.dtype == jnp.int32
        res_ids = search.search_mesh_3d_accel(
            m, grid_ids, jnp.asarray(orig), jnp.asarray(tgt),
            jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 100,
        )
        np.testing.assert_array_equal(
            np.asarray(res_plain.elem_ids), np.asarray(res_ids.elem_ids)
        )


def test_search_3d_reflect_boundary():
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    m = Mesh3D.from_arrays(coords, tets)
    # aim past the z=1 wall; reflected destination must be back inside
    orig = jnp.asarray([[0.52, 0.52, 0.9]])
    tgt = jnp.asarray([[0.52, 0.52, 1.3]])
    res0 = search.search_mesh_3d(m, orig, orig, jnp.zeros(1, jnp.int32),
                                 jnp.ones(1, bool))
    res = search.search_mesh_3d(
        m, orig, tgt, res0.elem_ids, jnp.ones(1, bool),
        boundary_handler=search.reflect_on_exit_3d,
    )
    assert bool(res.all_found)
    assert int(res.elem_ids[0]) >= 0
    np.testing.assert_allclose(
        np.asarray(res.dest)[0], [0.52, 0.52, 0.7], atol=1e-5
    )


def test_compact_idx_contract():
    """_compact_idx: first-m not-done slot ids in slot order, n beyond the
    survivor count — the packed-sort path and its >2^24 argsort fallback
    must agree with a numpy oracle."""
    rng = np.random.default_rng(21)
    for n, m in ((10_000, 1_000), (257, 200), (64, 32)):
        done = rng.uniform(size=n) < 0.8
        got = np.asarray(search._compact_idx(jnp.asarray(done), m))
        want = np.full(m, n, np.int64)
        surv = np.nonzero(~done)[0][:m]
        want[: len(surv)] = surv
        np.testing.assert_array_equal(got, want)


def test_search_2d_accel_with_rows_and_compacted_guess_retry():
    """The one-gather peel + fused guess/fallback carry must survive the
    compaction pyramid: narrow widths force guess-trajectory walkers
    (including boundary-hitting guesses that retry from their true previous
    element) through compacted levels, and results must still equal the
    plain walk exactly."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    m = Mesh2D.from_arrays(coords, tris, cls)
    grid = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                              peel="rows")
    assert grid.cell_rows is not None and grid.cell_rows.shape[1] == 14
    grid_lines = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                                    peel="lines")
    assert grid_lines.cell_lines is not None
    assert grid_lines.cell_lines.shape[1] == 5
    grid_split = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                                    peel="rows_split")
    assert grid_split.cell_rows.shape[1] == 7
    assert grid_split.cell_rows_b is not None
    grid_ab = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                                 peel="rows_ab")
    assert grid_ab.cell_rows.shape[1] == 8
    assert grid_ab.cell_rows_b is None
    rng = np.random.default_rng(6)
    n = 2048
    elems = rng.integers(0, m.nelems, n)
    orig = np.asarray(m.elem_centroids)[elems]
    # long jittered moves: many guess misses, genuine exits, long walks
    tgt = orig + rng.normal(scale=0.2, size=(n, 2))
    res_plain = search.search_mesh_2d(
        m, jnp.asarray(orig), jnp.asarray(tgt),
        jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 200,
    )
    for g in (grid, grid_lines, grid_split, grid_ab):
        for widths in ((256, 32), (512,), ()):
            res_accel = search.search_mesh_2d_accel(
                m, g, jnp.asarray(orig), jnp.asarray(tgt),
                jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 200,
                widths=widths,
            )
            np.testing.assert_array_equal(
                np.asarray(res_plain.elem_ids), np.asarray(res_accel.elem_ids)
            )
    assert (np.asarray(res_plain.elem_ids) == -1).sum() > 0


def test_cell_lines_decision_exactness():
    """The separating-line decision must pick the candidate that actually
    contains the point whenever the point is in A∪B (A's barycentric
    coordinate toward a NEIGHBOR B is exact on A∪B)."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, cls = gen.annulus_mesh(8, 48, 0.3, 1.0)
    m = Mesh2D.from_arrays(coords, tris, cls)
    grid = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                              peel="lines")
    rows = np.asarray(grid.cell_lines)
    geom = np.asarray(m.walk_geom)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.0, 1.0, size=(4096, 2)).astype(np.float32)
    r = np.hypot(pts[:, 0], pts[:, 1])
    keep = (r > 0.32) & (r < 0.98)
    pts = pts[keep]
    cell = np.asarray(grid.cell_of((jnp.asarray(pts[:, 0]),
                                    jnp.asarray(pts[:, 1]))))
    g = rows[cell]

    def inside(e, px, py):
        gg = geom[e]
        l1 = gg[:, 0] * px + gg[:, 1] * py + gg[:, 2]
        l2 = gg[:, 3] * px + gg[:, 4] * py + gg[:, 5]
        w0 = 1.0 - l1 - l2
        return np.minimum(np.minimum(l1, l2), w0) >= 1e-7   # strict interior

    ea = g[:, 3].astype(np.int64)
    eb = g[:, 4].astype(np.int64)
    in_a = inside(ea, pts[:, 0], pts[:, 1])
    in_b = inside(eb, pts[:, 0], pts[:, 1])
    pick_a = g[:, 0] * pts[:, 0] + g[:, 1] * pts[:, 1] + g[:, 2] >= 0
    picked = np.where(pick_a, ea, eb)
    # wherever the point is strictly inside exactly one candidate AND the
    # cell carries a real separating line (A,B adjacent — non-adjacent pairs
    # get the always-A fallback and resolve in the walk), the line must pick
    # that candidate
    nontrivial = ~((g[:, 0] == 0) & (g[:, 1] == 0))
    one = (in_a ^ in_b) & nontrivial
    assert one.sum() > 100
    want = np.where(in_a, ea, eb)[one]
    np.testing.assert_array_equal(picked[one], want)


def test_search_aux_capture_matches_final_element():
    """aux_capture: the walk must return the aux table rows of each
    particle's FINAL element, whether it resolved in the peel (either
    candidate) or deep in the compaction pyramid."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    m = Mesh2D.from_arrays(coords, tris, cls)
    rng = np.random.default_rng(8)
    aux = jnp.asarray(rng.normal(size=(m.nelems, 3)), jnp.float32)
    grid = build_locator_grid(coords, tris, walk_geom=m.walk_geom,
                              aux=np.asarray(aux))
    n = 2048
    elems = rng.integers(0, m.nelems, n)
    orig = np.asarray(m.elem_centroids)[elems]
    tgt = orig + rng.normal(scale=0.15, size=(n, 2))
    for widths in (None, (256, 32)):
        res = search.search_mesh_2d_accel(
            m, grid, jnp.asarray(orig), jnp.asarray(tgt),
            jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 200,
            widths=widths, aux_capture=aux,
        )
        got = np.stack([np.asarray(a) for a in res.aux_c], axis=1)
        eid = np.asarray(res.elem_ids)
        found = eid >= 0
        assert found.sum() > 0 and (~found).sum() > 0
        np.testing.assert_array_equal(
            got[found], np.asarray(aux)[eid[found]]
        )
    # mismatched aux widths must be rejected loudly
    import pytest as _pytest
    with _pytest.raises(ValueError):
        search.search_mesh_2d_accel(
            m, grid, jnp.asarray(orig), jnp.asarray(tgt),
            jnp.asarray(elems, jnp.int32), jnp.ones(n, bool), 200,
            aux_capture=aux[:, :2],
        )


# ---------------------------------------------------------------------------
# round-5 walk robustness: initial-parent validation/repair + stranded
# recovery (check_initial_parents, adjacency.tpp:72-151; sliver recovery,
# adjacency.hpp:470-516, 910-1009)
# ---------------------------------------------------------------------------

def _points_in_elems(coords, tris, te, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet((1.0, 1.0, 1.0), len(te))
    return (coords[tris[te]] * w[:, :, None]).sum(axis=1)


def test_check_initial_parents_repair_2d():
    # distorted stitched mesh (the sliver-prone gmsh-import analog)
    coords, tris, _cls = gen.tokamak_mesh(10, 48)
    m = Mesh2D.from_arrays(coords, tris)
    rng = np.random.default_rng(7)
    n = 200
    te = rng.integers(0, len(tris), n)
    pts = _points_in_elems(coords, tris, te)
    # wrong parents: shifted ids, plus a few off-mesh origins
    wrong = (te + 7) % len(tris)
    pts[:5] = np.array([50.0, 50.0])          # far outside the domain
    elem, num_bad, num_rep = search.check_initial_parents(
        m, jnp.asarray(pts, jnp.float32), jnp.asarray(wrong, jnp.int32),
        jnp.ones(n, bool), mode="repair")
    elem = np.asarray(elem)
    assert int(num_bad) >= n - 20             # nearly all parents are wrong
    # off-mesh origins: deleted, not repaired
    assert np.all(elem[:5] == -1)
    assert int(num_rep) == int(num_bad) - 5
    # every repaired parent CONTAINS its origin (edge ties may differ from
    # the seeding element)
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in range(5, n):
        assert elem[i] >= 0, i
        a, b, c = cz[ev[elem[i]]]
        p = pts[i]
        s = _cross2(b - a, c - a)
        assert _cross2(b - a, p - a) * np.sign(s) >= -1e-5 * abs(s)
        assert _cross2(c - b, p - b) * np.sign(s) >= -1e-5 * abs(s)
        assert _cross2(a - c, p - c) * np.sign(s) >= -1e-5 * abs(s)


def test_check_initial_parents_delete_mode():
    coords, tris = gen.rectangle_mesh(6, 6)
    m = Mesh2D.from_arrays(coords, tris)
    n = 50
    rng = np.random.default_rng(11)
    te = rng.integers(0, len(tris), n)
    pts = _points_in_elems(coords, tris, te, seed=12)
    wrong = te.copy()
    wrong[::2] = (te[::2] + 9) % len(tris)    # half the parents are wrong
    elem, num_bad, num_rep = search.check_initial_parents(
        m, jnp.asarray(pts, jnp.float32), jnp.asarray(wrong, jnp.int32),
        jnp.ones(n, bool), mode="delete")
    elem = np.asarray(elem)
    # reference semantics: bad parents deleted with a count, good kept
    assert int(num_rep) == 0
    assert int(num_bad) == int((elem == -1).sum())
    good = elem >= 0
    assert np.array_equal(elem[good], wrong[good])
    assert int(num_bad) > 0


def test_check_initial_parents_3d():
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    m = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(5)
    n = 100
    te = rng.integers(0, len(tets), n)
    w = rng.dirichlet((1.0,) * 4, n)
    pts = (coords[tets[te]] * w[:, :, None]).sum(axis=1)
    wrong = (te + 13) % len(tets)
    elem, num_bad, num_rep = search.check_initial_parents(
        m, jnp.asarray(pts, jnp.float32), jnp.asarray(wrong, jnp.int32),
        jnp.ones(n, bool), mode="repair")
    elem = np.asarray(elem)
    assert int(num_bad) > 0
    assert np.all(elem >= 0)
    # containment of every origin in its (repaired) parent
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in range(n):
        v = cz[ev[elem[i]]]
        vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
        for k in range(4):
            vv = v.copy()
            vv[k] = pts[i]
            wk = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
            assert wk / vol >= -1e-4, (i, elem[i], k)


def test_trace_validate_parents_repair_recovers_destinations():
    # convex mesh: repair succeeds for EVERY in-domain origin
    coords, tris = gen.rectangle_mesh(10, 10)
    m = Mesh2D.from_arrays(coords, tris)
    rng = np.random.default_rng(21)
    n = 128
    te = rng.integers(0, len(tris), n)
    orig = _points_in_elems(coords, tris, te, seed=22)
    # small push
    tgt = np.clip(orig + rng.normal(0, 0.01, orig.shape), 0.001, 0.999)
    good = search.trace_particle_through_mesh(
        m, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(te, jnp.int32), jnp.ones(n, bool))
    bad_parents = (te + 11) % len(tris)
    fixed = search.trace_particle_through_mesh(
        m, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(bad_parents, jnp.int32), jnp.ones(n, bool),
        validate_parents="repair")
    # identical results to the correctly-parented walk (modulo edge ties:
    # require containment-equivalence via element equality here — the
    # repaired parent is the walk's own choice for the same origin)
    ga = np.asarray(good.elem_ids)
    fa = np.asarray(fixed.elem_ids)
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in range(n):
        if ga[i] == fa[i]:
            continue
        # differing ids must both contain the destination (edge tie)
        assert ga[i] >= 0 and fa[i] >= 0, (i, ga[i], fa[i])
        for e in (ga[i], fa[i]):
            a, b, c = cz[ev[e]]
            p = tgt[i]
            s = _cross2(b - a, c - a)
            assert _cross2(b - a, p - a) * np.sign(s) >= -1e-4 * abs(s)


def test_check_initial_parents_locator_robust_on_nonconvex():
    """Without a locator the repair walk can cross the annulus hole and
    delete (greedy-walk non-convexity, documented); WITH the model's
    locator every in-domain origin is repaired."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, _cls = gen.tokamak_mesh(8, 40)
    m = Mesh2D.from_arrays(coords, tris)
    rng = np.random.default_rng(21)
    n = 128
    te = rng.integers(0, len(tris), n)
    orig = _points_in_elems(coords, tris, te, seed=22)
    bad_parents = (te + 11) % len(tris)
    loc = build_locator_grid(coords, tris)
    elem, num_bad, num_rep = search.check_initial_parents(
        m, jnp.asarray(orig, jnp.float32),
        jnp.asarray(bad_parents, jnp.int32), jnp.ones(n, bool),
        mode="repair", locator=loc)
    elem = np.asarray(elem)
    assert np.all(elem >= 0)                  # every origin repaired
    assert int(num_rep) == int(num_bad)


def test_recover_project_accepts_adjacent_strand_rejects_far():
    coords, tris = gen.rectangle_mesh(8, 8)
    m = Mesh2D.from_arrays(coords, tris)
    # particle 0: dest one hop away — with max_iters=1 the walker crosses
    # into the right element but the loop limit fires before its containment
    # test: stranded-but-contained, recovery must accept it.
    # particle 1: dest many hops away — stranded far from its element,
    # recovery must REJECT it (reference deletion semantics preserved).
    orig = jnp.asarray([[0.19, 0.05], [0.05, 0.05]], jnp.float32)
    tgt = jnp.asarray([[0.30, 0.05], [0.95, 0.95]], jnp.float32)
    e0 = search.search_mesh_2d(
        m, orig, orig, jnp.zeros(2, jnp.int32), jnp.ones(2, bool)).elem_ids
    res_off = search.search_mesh_2d(
        m, orig, tgt, e0, jnp.ones(2, bool), max_iters=1)
    assert int(res_off.elem_ids[0]) == -1     # loop-limit deletion today
    assert not bool(res_off.all_found)
    res_on = search.search_mesh_2d(
        m, orig, tgt, e0, jnp.ones(2, bool), max_iters=1, recover="project")
    assert int(res_on.num_recovered) == 1
    assert int(res_on.elem_ids[0]) >= 0
    assert int(res_on.elem_ids[1]) == -1      # far strand stays deleted
    # recovered (elem, dest) pair passes containment
    e = int(res_on.elem_ids[0])
    p = np.asarray(res_on.dest)[0]
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    a, b, c = cz[ev[e]]
    s = _cross2(b - a, c - a)
    assert _cross2(b - a, p - a) * np.sign(s) >= -1e-6 * abs(s)
    assert _cross2(c - b, p - b) * np.sign(s) >= -1e-6 * abs(s)
    assert _cross2(a - c, p - c) * np.sign(s) >= -1e-6 * abs(s)


def test_recover_project_parity_when_converged():
    """Recovery must be a no-op when every walker converges."""
    coords, tris, _cls = gen.tokamak_mesh(8, 40)
    m = Mesh2D.from_arrays(coords, tris)
    rng = np.random.default_rng(31)
    n = 512
    te = rng.integers(0, len(tris), n)
    orig = _points_in_elems(coords, tris, te, seed=32)
    tgt = orig + rng.normal(0, 0.02, orig.shape)
    a = search.search_mesh_2d(
        m, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(te, jnp.int32), jnp.ones(n, bool))
    b = search.search_mesh_2d(
        m, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(te, jnp.int32), jnp.ones(n, bool), recover="project")
    assert bool(a.all_found) and bool(b.all_found)
    assert int(b.num_recovered) == 0
    np.testing.assert_array_equal(np.asarray(a.elem_ids),
                                  np.asarray(b.elem_ids))
    np.testing.assert_array_equal(np.asarray(a.dest), np.asarray(b.dest))


def test_recover_project_3d_contained_strand():
    coords, tets = gen.box_tet_mesh(6, 6, 6)
    m = Mesh3D.from_arrays(coords, tets)
    # one-hop destination with max_iters=1: crossed but untested (see 2D)
    orig = jnp.asarray([[0.10, 0.05, 0.05]], jnp.float32)
    tgt = jnp.asarray([[0.20, 0.05, 0.05]], jnp.float32)
    e0 = search.search_mesh_3d(
        m, orig, orig, jnp.zeros(1, jnp.int32), jnp.ones(1, bool)).elem_ids
    ref = search.search_mesh_3d(m, orig, tgt, e0, jnp.ones(1, bool))
    assert int(ref.elem_ids[0]) >= 0
    res_off = search.search_mesh_3d(m, orig, tgt, e0, jnp.ones(1, bool),
                                    max_iters=1)
    res_on = search.search_mesh_3d(m, orig, tgt, e0, jnp.ones(1, bool),
                                   max_iters=1, recover="project")
    if int(res_off.elem_ids[0]) == -1:        # genuinely stranded at limit
        assert int(res_on.num_recovered) == 1
        assert int(res_on.elem_ids[0]) >= 0
        # containment of the recovered pair
        ev = np.asarray(m.elem2verts)
        cz = np.asarray(m.coords)
        v = cz[ev[int(res_on.elem_ids[0])]]
        p = np.asarray(res_on.dest)[0]
        vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
        for k in range(4):
            vv = v.copy()
            vv[k] = p
            wk = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
            assert wk / vol >= -1e-5


# ---------------------------------------------------------------------------
# round-5 ragged flux-band locator (mesh.locator.BandGrid2D)
# ---------------------------------------------------------------------------

def test_band_locator_detection_and_walk_parity():
    """On a stitched flux-band mesh (tokamak), the band-aligned locator must
    drive search_mesh_2d_accel to walk-identical results."""
    from pumipic_jax.mesh.locator import detect_banded_locator

    # detection needs enough ring vertices to fit the D-shapes; coarse
    # meshes legitimately return None (cartesian fallback)
    coords, tris, cls = gen.tokamak_mesh(24, 120)
    m = Mesh2D.from_arrays(coords, tris, cls)
    bg = detect_banded_locator(np.asarray(coords), np.asarray(tris),
                               np.asarray(cls), m.walk_geom)
    assert bg is not None
    assert bg.n_bands == 24
    coarse_c, coarse_t, coarse_cls = gen.tokamak_mesh(8, 40)
    mc = Mesh2D.from_arrays(coarse_c, coarse_t, coarse_cls)
    assert detect_banded_locator(
        np.asarray(coarse_c), np.asarray(coarse_t), np.asarray(coarse_cls),
        mc.walk_geom) is None
    rng = np.random.default_rng(9)
    n = 5000
    te = rng.integers(0, len(tris), n)
    orig = _points_in_elems(coords, tris, te, seed=10)
    tgt = orig + rng.normal(0, 0.02, orig.shape)   # some boundary exits too
    plain = search.search_mesh_2d(
        m, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(te, jnp.int32), jnp.ones(n, bool), 64)
    accel = search.search_mesh_2d_accel(
        m, bg, jnp.asarray(orig, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(te, jnp.int32), jnp.ones(n, bool), 64)
    pa = np.asarray(plain.elem_ids)
    aa = np.asarray(accel.elem_ids)
    # identical removals; found elements equal or edge-tie equivalents
    np.testing.assert_array_equal(pa < 0, aa < 0)
    diff = np.nonzero(pa != aa)[0]
    ev = np.asarray(m.elem2verts)
    cz = np.asarray(m.coords)
    for i in diff:
        for e in (pa[i], aa[i]):
            a, b, c = cz[ev[e]]
            p = tgt[i]
            s = _cross2(b - a, c - a)
            # the walk's containment tolerance is relative to the affine
            # FMA magnitudes, which exceeds an area-relative check on
            # slivers — allow a small absolute slack on top
            tol = 1e-4 * abs(s) + 2e-7
            assert _cross2(b - a, p - a) * np.sign(s) >= -tol, i
            assert _cross2(c - b, p - b) * np.sign(s) >= -tol, i
            assert _cross2(a - c, p - c) * np.sign(s) >= -tol, i


def test_band_locator_detection_negatives():
    """Meshes without the stitched band structure must be rejected (callers
    fall back to the cartesian grid)."""
    from pumipic_jax.mesh.locator import detect_banded_locator

    # rectangle: classification all ones, no rings
    coords, tris = gen.rectangle_mesh(8, 8)
    m = Mesh2D.from_arrays(coords, tris)
    assert detect_banded_locator(
        np.asarray(coords), np.asarray(tris),
        np.asarray(m.class_id), m.walk_geom) is None
    # disk: ring counts vary but the innermost fan has a center vertex
    coords, tris, cls = gen.disk_mesh(8, 8)
    m2 = Mesh2D.from_arrays(coords, tris, cls)
    assert detect_banded_locator(
        np.asarray(coords), np.asarray(tris), np.asarray(cls),
        m2.walk_geom) is None
    # shuffled classification (not band-ordered)
    coords, tris, cls = gen.tokamak_mesh(6, 24)
    cls2 = np.asarray(cls).copy()
    cls2[::7] = 1
    m3 = Mesh2D.from_arrays(coords, tris, cls2)
    assert detect_banded_locator(
        np.asarray(coords), np.asarray(tris), cls2, m3.walk_geom) is None


def test_band_locator_in_dp_model_matches_cartesian():
    """The dp step with the band locator must produce the same physics as
    with the cartesian locator (walk results are locator-independent)."""
    import dataclasses as dc

    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_dp_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    coords, tris, cls = gen.tokamak_mesh(24, 120)
    m = Mesh2D.from_arrays(coords, tris, cls)
    from pumipic_jax.mesh.locator import detect_banded_locator
    assert detect_banded_locator(
        np.asarray(coords), np.asarray(tris), np.asarray(cls),
        m.walk_geom) is not None     # the band path is actually taken
    cfg = XGCmConfig(
        num_ptcls=4096, mdl_face=12, deg_per_push=10.0,
        max_search_iters=64,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
    )
    mesh_dev = make_device_mesh(1)
    # 'force' bypasses the measured-cost adoption gate (round 5): at this
    # mesh size both locator tables are small, so the gather cost model
    # predicts band == cart + the band-eval overhead and auto correctly
    # keeps the cartesian grid — the parity arm must force the band path
    s_band, step_band = make_dp_setup(
        m, dc.replace(cfg, band_locator="force"), mesh_dev)
    s_cart, step_cart = make_dp_setup(
        m, dc.replace(cfg, band_locator="off"), mesh_dev)
    for _ in range(3):
        s_band, f_band = step_band(s_band)
        s_cart, f_cart = step_cart(s_cart)
    np.testing.assert_array_equal(np.asarray(s_band["elem"]),
                                  np.asarray(s_cart["elem"]))
    np.testing.assert_allclose(np.asarray(f_band["fwd"]),
                               np.asarray(f_cart["fwd"]), rtol=1e-6)


def test_band_locator_cost_gate():
    """Without a measured cost model, band adoption is explicit: the
    detection itself still proves band structure, 'auto' keeps the
    cartesian grid and 'force' builds the band grid."""
    import dataclasses as dc

    from pumipic_jax.mesh.locator import (
        BandGrid2D, LocatorGrid2D, detect_banded_locator,
    )
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, PseudoXGCm, XGCmConfig,
    )

    coords, tris, cls = gen.tokamak_mesh(16, 96)
    m = Mesh2D.from_arrays(coords, tris, cls)
    a = np.asarray
    assert detect_banded_locator(a(coords), a(tris), a(cls),
                                 m.walk_geom) is not None
    cfg = XGCmConfig(num_ptcls=512, mdl_face=8, deg_per_push=10.0,
                     max_search_iters=64,
                     gyro=GyroConfig(rmax=0.05, num_rings=2,
                                     points_per_ring=4))
    assert isinstance(PseudoXGCm(m, cfg).locator, LocatorGrid2D)
    assert isinstance(
        PseudoXGCm(m, dc.replace(cfg, band_locator="force")).locator,
        BandGrid2D)


def test_band_adoption_gate_wired_into_model_setups(monkeypatch):
    """Every model entry point builds the band grid only under
    band_locator='force': make_dp_setup (the bench.py metric-of-record
    path) and the PseudoXGCm class never run band detection under 'auto'
    or 'off'."""
    import dataclasses as dc

    import pumipic_jax.mesh.locator as loc
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, PseudoXGCm, XGCmConfig, make_dp_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    coords, tris, cls = gen.tokamak_mesh(16, 96)
    m = Mesh2D.from_arrays(coords, tris, cls)
    cfg = XGCmConfig(num_ptcls=512, mdl_face=8, deg_per_push=10.0,
                     max_search_iters=64,
                     gyro=GyroConfig(rmax=0.05, num_rings=2,
                                     points_per_ring=4))
    seen = []
    real = loc.detect_banded_locator

    def spy(*a, **kw):
        seen.append(kw.get("n_theta"))
        return real(*a, **kw)

    monkeypatch.setattr(loc, "detect_banded_locator", spy)

    mesh_dev = make_device_mesh(1)
    make_dp_setup(m, cfg, mesh_dev)                       # auto (default)
    PseudoXGCm(m, dc.replace(cfg, band_locator="off"))
    assert seen == []

    make_dp_setup(m, dc.replace(cfg, band_locator="force"), mesh_dev)
    PseudoXGCm(m, dc.replace(cfg, band_locator="force"))
    assert len(seen) == 2


def test_band_locator_config_validation():
    """Unknown band_locator strings must raise in every entry point, and
    'force' must raise (not be silently ignored) when rot_aux_capture
    claims the peel's aux channel."""
    import dataclasses as dc

    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, PseudoXGCm, XGCmConfig, make_dp_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    coords, tris, cls = gen.tokamak_mesh(8, 48)
    m = Mesh2D.from_arrays(coords, tris, cls)
    cfg = XGCmConfig(num_ptcls=256, mdl_face=4, deg_per_push=10.0,
                     max_search_iters=64,
                     gyro=GyroConfig(rmax=0.05, num_rings=2,
                                     points_per_ring=4))
    mesh_dev = make_device_mesh(1)
    with pytest.raises(ValueError, match="band_locator"):
        make_dp_setup(m, dc.replace(cfg, band_locator="on"), mesh_dev)
    with pytest.raises(ValueError, match="band_locator"):
        PseudoXGCm(m, dc.replace(cfg, band_locator="banded"))
    # rot_analytic=False keeps banded-rotation detection off so the aux
    # channel is actually claimed (use_aux True) — the conflicting config
    with pytest.raises(ValueError, match="rot_aux_capture"):
        make_dp_setup(m, dc.replace(cfg, band_locator="force",
                                    rot_aux_capture=True,
                                    rot_analytic=False), mesh_dev)


def test_band_locator_rejects_f32_inexact_n_theta():
    """An explicit n_theta pushing K*T past 2^24 must raise: band cell ids
    ride f32 peel columns and would silently round."""
    from pumipic_jax.mesh.locator import detect_banded_locator

    coords, tris, cls = gen.tokamak_mesh(16, 96)
    m = Mesh2D.from_arrays(coords, tris, cls)
    a = np.asarray
    with pytest.raises(ValueError, match="2\\^24"):
        detect_banded_locator(a(coords), a(tris), a(cls), m.walk_geom,
                              n_theta=1 << 20)


def test_2d_locator_rejects_3d_only_peels():
    """build_locator_grid (2D) must reject the 3D-only id-diet peels
    instead of silently attaching plain rows."""
    from pumipic_jax.mesh.locator import build_locator_grid

    coords, tris, _ = gen.annulus_mesh(5, 16, 0.3, 1.0)
    m = Mesh2D.from_arrays(coords, tris)
    for p in ("ids", "ids4"):
        with pytest.raises(ValueError, match="3D-only"):
            build_locator_grid(np.asarray(coords), np.asarray(tris),
                               walk_geom=m.walk_geom, peel=p)


def test_annulus_detection_permutation_and_rotation_tolerant():
    """Imported structured annuli (shuffled vertex/element order + a rigid
    rotation — the gmsh round-trip class) must still be detection-proven;
    locate maps canonical ids through the recovered permutation."""
    from pumipic_jax.mesh.locator import detect_annulus_structured

    coords, tris, cls = gen.annulus_mesh(12, 64, 0.3, 1.0)
    rng = np.random.default_rng(3)
    pv = rng.permutation(len(coords))
    rot = 0.37
    R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
    coords2 = np.empty_like(coords)
    coords2[pv] = coords @ R.T
    pe = rng.permutation(len(tris))
    tris2 = pv[tris][pe]
    cls2 = np.asarray(cls)[pe]
    loc = detect_annulus_structured(coords2, tris2, cls=cls2)
    assert loc is not None and loc.perm is not None
    assert not loc.ring_class          # actual ids not analytic in ring
    n = 20000
    te = rng.integers(0, len(tris2), n)
    pts = _points_in_elems(coords2, tris2, te, seed=44).astype(np.float32)
    e_an, _ins = loc.locate(jnp.asarray(pts))
    e_an = np.asarray(e_an)
    mism = np.nonzero(e_an != te)[0]
    # mismatches must be edge ties (containment holds)
    for i in mism:
        assert e_an[i] >= 0
        a, b, c = coords2[tris2[e_an[i]]]
        p = pts[i]
        s = _cross2(b - a, c - a)
        tol = 1e-5 * abs(s) + 1e-9
        assert _cross2(b - a, p - a) * np.sign(s) >= -tol, i
        assert _cross2(c - b, p - b) * np.sign(s) >= -tol, i
        assert _cross2(a - c, p - c) * np.sign(s) >= -tol, i


def test_kuhn_detection_permutation_tolerant():
    from pumipic_jax.mesh.locator import detect_box_kuhn

    coords, tets = gen.box_tet_mesh(6, 5, 4)
    rng = np.random.default_rng(4)
    pv = rng.permutation(len(coords))
    coords2 = np.empty_like(coords)
    coords2[pv] = coords
    tets2 = pv[tets][rng.permutation(len(tets))]
    loc = detect_box_kuhn(coords2, tets2)
    assert loc is not None and loc.perm is not None
    n = 5000
    pts = rng.uniform(0.02, 0.98, (n, 3))
    e, ins = loc.locate(tuple(jnp.asarray(pts[:, i], jnp.float32)
                              for i in range(3)))
    e = np.asarray(e)
    assert np.asarray(ins).all() and (e >= 0).all()
    for i in range(0, n, 7):           # containment spot check
        v = coords2[tets2[e[i]]]
        vol = np.dot(v[3] - v[0], np.cross(v[1] - v[0], v[2] - v[0]))
        for k in range(4):
            vv = v.copy()
            vv[k] = pts[i]
            w = np.dot(vv[3] - vv[0], np.cross(vv[1] - vv[0], vv[2] - vv[0]))
            assert w / vol >= -1e-5, (i, k)


def test_strict_detection_still_identity():
    """The generator's own output must keep the gather-free identity path
    (perm None, ring_class proven) — the flagship bench contract."""
    from pumipic_jax.mesh.locator import (
        detect_annulus_structured, detect_box_kuhn,
    )

    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    loc = detect_annulus_structured(coords, tris, cls=np.asarray(cls))
    assert loc is not None and loc.perm is None and loc.ring_class
    c3, t3 = gen.box_tet_mesh(4, 4, 4)
    k3 = detect_box_kuhn(c3, t3)
    assert k3 is not None and k3.perm is None


def test_stationary_walkers_from_wrong_parent_3d():
    """REGRESSION (round-5 review): zero-displacement walkers (x_orig ==
    x_tgt) started at a WRONG element — any accel peel miss of a particle
    that didn't move — were (a) silently accepted at the wrong parent by
    method='intersection' (v == 0 makes every n·v zero, t_exit stays inf,
    and the never-exits disjunct forced inside=True) and (b) cycled to the
    loop limit and deleted by method='hybrid' (the lo-ld denominator is
    1-ulp fusion noise at v == 0).  Both must walk to the true containing
    element like method='bcc' does."""
    from pumipic_jax.mesh.generate import box_tet_mesh

    coords, tets = gen.box_tet_mesh(5, 5, 5)
    mesh = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(23)
    n = 1024
    e_true = rng.integers(0, mesh.nelems, n)
    w = rng.dirichlet([2, 2, 2, 2], n)
    pts = np.einsum("nk,nkd->nd", w,
                    np.asarray(mesh.coords)[np.asarray(mesh.elem2verts)[e_true]])
    pts = jnp.asarray(pts, jnp.float32)
    e_wrong = jnp.asarray((e_true + 137) % mesh.nelems, jnp.int32)
    active = jnp.ones(n, bool)
    x = (pts[:, 0], pts[:, 1], pts[:, 2])

    ref = search.search_mesh_3d(mesh, x, x, e_wrong, active, 300,
                                    method="bcc")
    assert bool(ref.all_found)
    for method in ("intersection", "hybrid"):
        res = search.search_mesh_3d(mesh, x, x, e_wrong, active, 300,
                                        method=method)
        assert bool(res.all_found), method
        # every answer must CONTAIN the point (shared-face tolerance ties
        # may pick either adjacent tet, so compare by containment not id)
        vv = np.asarray(mesh.coords)[
            np.asarray(mesh.elem2verts)[np.asarray(res.elem_ids)]]
        T = np.stack([vv[:, 1] - vv[:, 0], vv[:, 2] - vv[:, 0],
                      vv[:, 3] - vv[:, 0]], axis=-1).astype(np.float64)
        lam = np.linalg.solve(T, (np.asarray(pts) - vv[:, 0]).astype(
            np.float64)[..., None])[..., 0]
        bc = np.concatenate([1 - lam.sum(-1, keepdims=True), lam], axis=-1)
        assert bc.min(axis=-1).min() > -1e-4, method
