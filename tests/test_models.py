"""Mini-app end-to-end tests (pseudoXGCm / pseudoPushAndSearch / search2d),
the analogs of the reference's integration suite (testing.cmake:96-130).
Distributed correctness is invariant-based: deterministic seeds + conserved
particle counts + all-found checks, not golden outputs (SURVEY.md §4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pumipic_jax.mesh import generate as gen
from pumipic_jax.mesh.core import Mesh2D, Mesh3D
from pumipic_jax.models import search2d
from pumipic_jax.models.pseudo_push_and_search import (
    PseudoPushAndSearch,
    PushSearchConfig,
)
from pumipic_jax.models.pseudo_xgcm import (
    GyroConfig,
    PseudoXGCm,
    XGCmConfig,
    build_gyro_mapping,
    make_default_mesh,
)


def _small_mesh():
    coords, tris, cls = gen.annulus_mesh(6, 24, 0.3, 1.0)
    return Mesh2D.from_arrays(coords, tris, cls)


def test_search2d_driver():
    # convex domain: the greedy BCC walk reaches any destination (an annulus
    # would legitimately delete walks aimed across its inner hole, exactly
    # like the reference's walk on non-convex domains)
    coords, tris, cls = gen.disk_mesh(8, 8)
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    failures = search2d.run(mesh, num_ptcls=500)
    assert failures == 0


def test_gyro_mapping_build():
    mesh = _small_mesh()
    gyro = GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4)
    m = build_gyro_mapping(mesh, gyro)
    assert m.shape == (mesh.nverts * 2 * 4 * 3,)
    m_np = np.asarray(m)
    # interior ring points must map to valid vertices; some boundary-vertex
    # rings fall outside the annulus and are -1
    valid = m_np >= 0
    assert valid.mean() > 0.5
    assert np.all(m_np[valid] < mesh.nverts)


def test_gyro_scatter_matches_naive_oracle():
    """pseudoXGCm_scatter analog (testing.cmake:96-113): the fused
    accumulate_to_rings + scatter_to_mapped_verts pipeline must equal a
    per-particle/per-ring-point python loop implementing the reference
    semantics literally (gyroScatter.hpp:169-232), for both the uniform
    placeholder radius and a per-particle radius."""
    from pumipic_jax.ops import scatter as sc

    mesh = _small_mesh()
    R, P = 3, 4
    rmax = 0.06
    gyro = GyroConfig(rmax=rmax, num_rings=R, points_per_ring=P)
    gmap = np.asarray(build_gyro_mapping(mesh, gyro))
    V = mesh.nverts
    e2v = np.asarray(mesh.elem2verts)
    rng = np.random.default_rng(3)
    n = 500
    elem = rng.integers(0, mesh.nelems, n)
    active = rng.uniform(size=n) > 0.2
    radius = rng.uniform(0, rmax, n).astype(np.float32)

    for rad in (None, radius):
        got = np.asarray(sc.gyro_scatter(
            jnp.asarray(elem, jnp.int32), jnp.asarray(active),
            mesh.elem2verts, jnp.asarray(gmap), V, R, P, rmax,
        )) if rad is None else np.asarray(sc.scatter_to_mapped_verts(
            sc.accumulate_to_rings(
                jnp.asarray(elem, jnp.int32), jnp.asarray(active),
                mesh.elem2verts, V, R, rmax,
                ptcl_radius=jnp.asarray(rad)),
            jnp.asarray(gmap), V, R, P,
        ))

        # naive oracle: accumulateToRings (gyroScatter.hpp:183-205)
        ring_width = rmax / R
        acc = np.zeros((V, R))
        for i in range(n):
            if not active[i]:
                continue
            if rad is None:
                rd = min(max(int(1.125) - 1, 0), R - 2)
            else:
                rd = min(max(int(rad[i] / np.float32(ring_width)) - 1, 0),
                         R - 2)
            for v in e2v[elem[i]]:
                acc[v, rd] += 1.0
                acc[v, rd + 1] += 1.0
        # scatterToMappedVerts (gyroScatter.hpp:207-225)
        want = np.zeros(V)
        for v in range(V):
            for r in range(R):
                val = acc[v, r] / P
                for p in range(P):
                    base = ((v * R + r) * P + p) * 3
                    for j in range(3):
                        m = gmap[base + j]
                        if m >= 0:
                            want[m] += val
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pseudo_xgcm_runs_and_conserves():
    mesh = _small_mesh()
    cfg = XGCmConfig(
        num_ptcls=2000,
        num_iterations=3,
        mdl_face=3,
        deg_per_push=10.0,
        structure="csr",
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
    )
    app = PseudoXGCm(mesh, cfg)
    n0 = app.ptcls.n_ptcls()
    assert n0 == cfg.num_ptcls
    fwd, bwd = app.run(verbose=False)
    n1 = app.ptcls.n_ptcls()
    # particles only vanish by leaving the domain; most should survive
    assert 0 < n1 <= n0
    assert n1 > 0.5 * n0
    # scatter deposits every surviving particle twice (ringUp+ringDown) at
    # 3 verts each, averaged over points_per_ring then mapped to <=3 verts:
    # total deposited weight is bounded by 2*3*3*n (loose sanity bound)
    assert 0 < float(fwd.sum()) <= 2 * 3 * 3 * n1
    # determinism: same seeds -> same result
    app2 = PseudoXGCm(mesh, cfg)
    fwd2, _ = app2.run(verbose=False)
    np.testing.assert_allclose(np.asarray(fwd), np.asarray(fwd2), atol=1e-5)


@pytest.mark.parametrize("structure", ["csr", "dps"])
def test_pseudo_push_and_search(structure):
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = PushSearchConfig(
        num_ptcls=500, num_iterations=4, distance=0.05, structure=structure
    )
    app = PseudoPushAndSearch(mesh, cfg)
    assert app.ptcls.n_ptcls() == 500
    history = app.run()
    # history holds post-step counts: monotone decreasing as particles exit
    # through the +x,+y,+z faces, some already on the first push
    assert all(history[i] >= history[i + 1] for i in range(len(history) - 1))
    assert history[0] <= 500
    assert 0 < history[-1] < 500


@pytest.mark.parametrize("wall", ["periodic", "reflect"])
def test_pseudo_push_and_search_walls(wall):
    """Non-default wall modes sustain the population: periodic wraps the
    pushed position (torus topology, steady-state benchmark mode) and
    reflect bounces it; both keep every particle alive in a valid element
    inside the box."""
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = PushSearchConfig(
        num_ptcls=400, num_iterations=6, distance=0.11, structure="dps",
        wall=wall,
    )
    app = PseudoPushAndSearch(mesh, cfg)
    history = app.run()
    assert history == [400] * 6
    h = app.ptcls.copy_to_host()
    elem = h["elem"][h["active"]]
    assert ((elem >= 0) & (elem < mesh.nelems)).all()
    x = h["x"][h["active"]]
    assert (x >= -1e-5).all() and (x <= 1 + 1e-5).all()


def test_gitr_like_app():
    from pumipic_jax.models.gitr_like import GitrConfig, GitrLike

    coords, tets = gen.box_tet_mesh(3, 3, 3, 0.01, 0.01, 0.01)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = GitrConfig(num_ptcls=300, num_iterations=5, dt=5e-10,
                     b_field=(0.0, 0.0, 0.5))
    app = GitrLike(mesh, cfg, seed=3)
    history = app.run()
    assert history[0] <= 300
    assert history[-1] >= 0
    # wall tally only counts exits
    lost = 300 - history[-1]
    assert abs(float(app.wall_hits.sum()) - lost) < 1e-3
    # energy shouldn't blow up with pure B rotation + zero E
    v = np.asarray(app.state["v"])[np.asarray(app.state["active"])]
    assert np.isfinite(v).all()
    assert (np.linalg.norm(v, axis=1) < 1e5).all()


def test_vtk_writer(tmp_path):
    from pumipic_jax.io import vtk

    coords, tris, cls = gen.disk_mesh(3, 6)
    p = str(tmp_path / "m.vtk")
    vtk.write_vtk(p, coords, tris,
                  elem_fields={"class_id": cls},
                  vert_fields={"w": np.zeros(len(coords))})
    text = open(p).read()
    assert "UNSTRUCTURED_GRID" in text
    assert f"POINTS {len(coords)}" in text
    assert "SCALARS class_id" in text and "SCALARS w" in text
    vtk.write_particles_vtk(str(tmp_path / "p.vtk"),
                            np.random.rand(10, 2), {"pid": np.arange(10)})
    assert "POLYDATA" in open(str(tmp_path / "p.vtk")).read()


def test_library_context():
    from pumipic_jax.library import Library

    lib = Library(num_devices=4)
    assert lib.world_size == 4
    lib.finalize()


def test_gitr_like_reflecting_walls():
    from pumipic_jax.models.gitr_like import GitrConfig, GitrLike

    coords, tets = gen.box_tet_mesh(3, 3, 3, 0.01, 0.01, 0.01)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = GitrConfig(num_ptcls=200, num_iterations=6, dt=5e-10,
                     b_field=(0.0, 0.0, 0.5), wall="reflect",
                     count_wall_hits=False)
    app = GitrLike(mesh, cfg, seed=4)
    history = app.run()
    # reflecting box: no particle is ever lost
    assert history[-1] == history[0]


def test_elliptical_push_rot_matches_trig():
    """The trig-free rotation push (per-element (cosΔ, sinΔ) table applied to
    carried (cosφ, sinφ)) must match the reference-order trig push
    (ellipticalPush.hpp:36-71) to f32 accuracy over many steps."""
    from pumipic_jax.ops import push as push_ops
    import jax

    rng = np.random.default_rng(7)
    n = 4096
    phi = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    b = jnp.asarray(rng.uniform(0.3, 1.0, n), jnp.float32)
    cls = jnp.asarray(rng.integers(1, 7, n), jnp.int32)
    deg, h, k, d = 15.0, 0.0, 0.0, 0.9

    # the rot table is per-element; use identity elem=arange so each particle
    # indexes its own class row
    rot = push_ops.elliptical_rot_table(cls, deg)
    elem = jnp.arange(n, dtype=jnp.int32)

    trig = jax.jit(lambda p: push_ops.elliptical_push_components(
        p, b, cls, deg, h, k, d))
    rotf = jax.jit(lambda c, s: push_ops.elliptical_push_rot(
        c, s, b, elem, rot, h, k, d))

    c, s = jnp.cos(phi), jnp.sin(phi)
    p = phi
    for _ in range(200):
        tx, ty, p = trig(p)
        rx, ry, c, s = rotf(c, s)
    np.testing.assert_allclose(np.asarray(rx), np.asarray(tx), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ry), np.asarray(ty), atol=2e-4)
    # carried unit vector stays normalized (Newton renorm)
    norm = np.asarray(c * c + s * s)
    assert np.abs(norm - 1.0).max() < 1e-5


@pytest.mark.parametrize("structure", ["scs", "cabm"])
def test_pseudo_push_and_search_reshuffle_mode(structure):
    """rebuild_mode="auto" (the reference's reshuffle-or-rebuild,
    SCS_rebuild.h) conserves the population in periodic steady state and
    produces the same per-step counts as the sort path."""
    coords, tets = gen.box_tet_mesh(4, 4, 4)
    mesh = Mesh3D.from_arrays(coords, tets)
    kw = dict(num_ptcls=400, num_iterations=6, distance=0.11,
              structure=structure, wall="periodic")
    a = PseudoPushAndSearch(mesh, PushSearchConfig(**kw), seed=2)
    b = PseudoPushAndSearch(
        mesh, PushSearchConfig(**kw, rebuild_mode="auto"), seed=2)
    assert a.run() == [400] * 6
    assert b.run() == [400] * 6
    # same physics: the particle->element assignment agrees pid-for-pid
    ha, hb = a.ptcls.copy_to_host(), b.ptcls.copy_to_host()
    ma = dict(zip(ha["pid"][ha["active"]].tolist(),
                  ha["elem"][ha["active"]].tolist()))
    mb = dict(zip(hb["pid"][hb["active"]].tolist(),
                  hb["elem"][hb["active"]].tolist()))
    assert ma == mb


def test_flagship_per_particle_gyro_radius():
    """GyroConfig(per_particle_radius=True) end-to-end: the flagship step
    carries a per-particle radius field and its deposition equals the
    ops-level per-particle bracketing pipeline (itself oracle-verified in
    test_gyro_scatter_matches_naive_oracle) — completing the reference's
    'TODO compute the radius' placeholder (gyroScatter.hpp:185)."""
    import jax
    from jax.sharding import Mesh as JMesh
    from pumipic_jax.models.pseudo_xgcm import make_dp_setup
    from pumipic_jax.ops import scatter as sc

    mesh = _small_mesh()
    gyro = GyroConfig(rmax=0.2, num_rings=3, points_per_ring=4,
                      per_particle_radius=True)
    cfg = XGCmConfig(num_ptcls=4000, mdl_face=3, deg_per_push=15.0,
                     max_search_iters=64, gyro=gyro)
    dm = JMesh(np.array(jax.devices()[:1]), ("ranks",))
    state, step = make_dp_setup(mesh, cfg, dm)
    assert "rg" in state
    state, fields = step(state)
    fwd = np.asarray(fields["fwd"])

    # recompute the deposition from the post-step state via the ops path
    from pumipic_jax.models.pseudo_xgcm import build_gyro_mappings
    gmap, _ = build_gyro_mappings(mesh, gyro)
    want = np.asarray(sc.scatter_to_mapped_verts(
        sc.accumulate_to_rings(
            state["elem"], state["active"], mesh.elem2verts,
            mesh.nverts, gyro.num_rings, gyro.rmax,
            ptcl_radius=state["rg"]),
        gmap, mesh.nverts, gyro.num_rings, gyro.points_per_ring,
    ))
    np.testing.assert_allclose(fwd, want, rtol=1e-6, atol=1e-6)

    # the per-particle bracketing must actually differ from the uniform
    # placeholder (radii span several rings)
    state_u, step_u = make_dp_setup(
        mesh, XGCmConfig(num_ptcls=4000, mdl_face=3, deg_per_push=15.0,
                         max_search_iters=64,
                         gyro=GyroConfig(rmax=0.2, num_rings=3,
                                         points_per_ring=4)), dm)
    _, fields_u = step_u(state_u)
    assert not np.allclose(fwd, np.asarray(fields_u["fwd"]))


@pytest.mark.parametrize("hkd", [(0.0, 0.0, 0.0), (0.2, -0.15, 0.3)])
def test_annulus_analytic_locate_matches_walk(hkd):
    """The structured-annulus analytic locate (detect_annulus_structured
    proves applicability by connectivity equality) must reproduce the
    grid-accelerated walk's dp step bit-for-bit — element assignments,
    activity (boundary-exit removals), positions, and the gyro-averaged
    deposition — on both the circular and a distorted elliptical push
    (the latter drives real boundary exits)."""
    import jax
    from jax.sharding import Mesh as JMesh
    from pumipic_jax.mesh.generate import annulus_mesh
    from pumipic_jax.models.pseudo_xgcm import make_dp_setup

    h, k, d = hkd
    coords, tris, cls = annulus_mesh(8, 48, 0.3, 1.0)
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    kw = dict(num_ptcls=8000, mdl_face=4, deg_per_push=21.0,
              max_search_iters=64, h=h, k=k, d=d)
    dm = JMesh(np.array(jax.devices()[:1]), ("ranks",))
    state_a, step_a = make_dp_setup(
        mesh, XGCmConfig(analytic_locate="force", **kw), dm)
    state_w, step_w = make_dp_setup(
        mesh, XGCmConfig(analytic_locate="off", **kw), dm)
    for i in range(3):
        state_a, fa = step_a(state_a)
        state_w, fw = step_w(state_w)
        act_a = np.asarray(state_a["active"])
        act_w = np.asarray(state_w["active"])
        np.testing.assert_array_equal(act_a, act_w, err_msg=f"step {i}")
        np.testing.assert_array_equal(
            np.asarray(state_a["elem"])[act_a],
            np.asarray(state_w["elem"])[act_w], err_msg=f"step {i}")
        np.testing.assert_allclose(
            np.asarray(fa["fwd"]), np.asarray(fw["fwd"]), rtol=1e-6,
            err_msg=f"step {i}")
    if (h, k, d) != (0.0, 0.0, 0.0):
        assert not np.asarray(state_a["active"]).all(), \
            "distorted push should produce boundary exits"


def test_annulus_detection_negatives():
    """Detection must refuse shaped meshes (tokamak flux surfaces) and
    perturbed annuli — those keep the general walk."""
    from pumipic_jax.mesh.generate import annulus_mesh, tokamak_mesh
    from pumipic_jax.mesh.locator import detect_annulus_structured
    from pumipic_jax.models.pseudo_xgcm import make_default_mesh

    tc, tt, _ = tokamak_mesh(10, 40)
    assert detect_annulus_structured(tc, tt) is None
    c2, t2, _ = annulus_mesh(5, 16, 0.3, 1.0)
    c2[3] += 1e-3
    assert detect_annulus_structured(c2, t2) is None
    # the flagship bench mesh IS a structured annulus (positive control)
    m = make_default_mesh(2000)
    assert detect_annulus_structured(
        np.asarray(m.coords), np.asarray(m.elem2verts)) is not None


def test_detection_rejects_same_geometry_different_ids():
    """The equality proofs must reject meshes with IDENTICAL geometry but
    DIFFERENT connectivity (a flipped quad diagonal: same vertices,
    different triangle point sets) — admitting one would silently relocate
    particles.  A pure RELABELING (shuffled element order, same tets) is a
    different case: since round 5 the proofs are permutation-tolerant
    (lattice recovery + exact connectivity matching) and must ACCEPT it
    while mapping canonical ids through the recovered permutation — so the
    shuffle arm asserts id CORRECTNESS against a barycentric containment
    oracle instead of rejection (full permutation coverage:
    tests/test_search.py::test_kuhn_detection_permutation_tolerant)."""
    from pumipic_jax.mesh.generate import annulus_mesh, box_tet_mesh
    from pumipic_jax.mesh.locator import (
        detect_annulus_structured, detect_box_kuhn,
    )

    c, t, _ = annulus_mesh(5, 16, 0.3, 1.0)
    t2 = t.copy()
    # flip one quad's diagonal: triangles [a,b,d],[a,d,c] -> [a,b,c],[b,d,c]
    a, b, d = t2[0]
    (_a2, d2, cv) = t2[1]
    t2[0] = (a, b, cv)
    t2[1] = (b, d, cv)
    assert detect_annulus_structured(c, t2) is None

    c3, t3 = box_tet_mesh(3, 3, 3)
    perm = np.random.default_rng(3).permutation(t3.shape[0])
    t3p = t3[perm]
    loc = detect_box_kuhn(c3, t3p)
    assert loc is not None, "relabeled Kuhn mesh must still be proven"
    rng = np.random.default_rng(0)
    pts = (rng.uniform(0.05, 0.95, size=(2000, 3)) * c3.max(0)).astype(
        np.float32)
    ids, inside = loc.locate(jnp.asarray(pts))
    assert bool(np.asarray(inside).all())
    # ids must be in the PERMUTED numbering: the claimed tet contains the pt
    verts = c3[t3p[np.asarray(ids)]].astype(np.float64)
    av, bv, cvv, dv = (verts[:, i] for i in range(4))
    T = np.stack([bv - av, cvv - av, dv - av], axis=-1)
    lam = np.linalg.solve(T, (pts - av)[..., None])[..., 0]
    bary = np.concatenate([1 - lam.sum(-1, keepdims=True), lam], axis=-1)
    assert (bary.min(axis=-1) > -1e-4).all()
    # positive control: the unshuffled mesh passes
    assert detect_box_kuhn(c3, t3) is not None


def test_annulus_ring_class_proof():
    """ring_class (analytic classification -> gather-free rotation) is
    proven ONLY when cls matches annulus_mesh's per-ring classification;
    a custom classification keeps the locator but not the rotation
    shortcut, and class_of reproduces the mesh table exactly."""
    from pumipic_jax.mesh.generate import annulus_mesh
    from pumipic_jax.mesh.locator import detect_annulus_structured
    from pumipic_jax.ops import push as push_ops

    c, t, cls = annulus_mesh(6, 20, 0.3, 1.0)
    loc = detect_annulus_structured(c, t, cls=cls)
    assert loc is not None and loc.ring_class
    # analytic classification == the mesh table, element for element
    elems = jnp.arange(t.shape[0], dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(loc.class_of(elems)), cls)
    # gather-free rotation values == the table rows, bitwise
    table = np.asarray(push_ops.elliptical_rot_table(
        jnp.asarray(cls), 21.0))
    cd, sd = push_ops.rot_vals_from_class(loc.class_of(elems), 21.0)
    np.testing.assert_array_equal(np.asarray(cd), table[:, 0])
    np.testing.assert_array_equal(np.asarray(sd), table[:, 1])
    # custom classification: locator yes, ring_class no
    loc2 = detect_annulus_structured(c, t, cls=np.ones_like(cls))
    assert loc2 is not None and not loc2.ring_class
    # no cls given: ring_class defaults off
    loc3 = detect_annulus_structured(c, t)
    assert loc3 is not None and not loc3.ring_class


def test_banded_class_detection_and_values():
    """Band-ordered classification (nondecreasing class_id — every stitched
    ring/flux-band mesh): detect_banded_class finds the band starts, and
    class_from_bands reproduces the class table element-for-element (so the
    gather-free rotation values are bit-identical via rot_vals_from_class).
    Shuffled classification is rejected."""
    from pumipic_jax.mesh.generate import tokamak_mesh
    from pumipic_jax.ops import push as push_ops

    c, t, cls = tokamak_mesh(10, 48)
    starts = push_ops.detect_banded_class(cls)
    assert starts is not None and starts[0] == 1
    elems = jnp.arange(t.shape[0], dtype=jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(push_ops.class_from_bands(elems, starts)), cls)
    # rotation values == the table rows, bitwise
    table = np.asarray(push_ops.elliptical_rot_table(jnp.asarray(cls), 15.0))
    cd, sd = push_ops.rot_vals_from_class(
        push_ops.class_from_bands(elems, starts), 15.0)
    np.testing.assert_array_equal(np.asarray(cd), table[:, 0])
    np.testing.assert_array_equal(np.asarray(sd), table[:, 1])
    # non-band-ordered classification is rejected
    rng = np.random.default_rng(3)
    assert push_ops.detect_banded_class(rng.permutation(cls)) is None
    # non-consecutive values are rejected (no affine class_of)
    assert push_ops.detect_banded_class(cls * 2) is None


def test_dp_step_banded_rotation_matches_table():
    """The DP step on a band-ordered (non-annulus) mesh takes the banded
    gather-free rotation and produces bit-identical state to the
    rot-table-gather arm (rot_analytic=False)."""
    import dataclasses

    from pumipic_jax.mesh.generate import tokamak_mesh
    from pumipic_jax.models.pseudo_xgcm import XGCmConfig, make_dp_setup
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    coords, tris, cls = tokamak_mesh(8, 40)
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    dm = make_device_mesh()
    cfg = XGCmConfig(num_ptcls=4096, mdl_face=4, deg_per_push=15.0,
                     num_iterations=3)
    state_b, step_b = make_dp_setup(mesh, cfg, dm)
    state_t, step_t = make_dp_setup(
        mesh, dataclasses.replace(cfg, rot_analytic=False), dm)
    for _ in range(3):
        state_b, out_b = step_b(state_b)
        state_t, out_t = step_t(state_t)
    for k in state_b:
        np.testing.assert_array_equal(
            np.asarray(state_b[k]), np.asarray(state_t[k]), err_msg=k)
    np.testing.assert_array_equal(
        np.asarray(out_b["fwd"]), np.asarray(out_t["fwd"]))


@pytest.mark.parametrize("wall", ["periodic", "remove"])
def test_kuhn_analytic_locator_matches_walk(wall):
    """The structured-Kuhn analytic locate (detect_box_kuhn proves
    applicability by connectivity equality) must reproduce the
    grid-accelerated walk bit-for-bit on a box mesh, for both convex-exact
    wall modes."""
    from pumipic_jax.mesh.generate import box_tet_mesh

    coords, tets = box_tet_mesh(5, 4, 6, 1.0, 0.8, 1.2)
    mesh = Mesh3D.from_arrays(coords, tets)
    kw = dict(num_ptcls=20_000, structure="dps", wall=wall,
              distance=0.07, max_search_iters=64)
    app_k = PseudoPushAndSearch(mesh, PushSearchConfig(kuhn="force", **kw))
    app_w = PseudoPushAndSearch(mesh, PushSearchConfig(kuhn="off", **kw))
    pk, pw = app_k.ptcls, app_w.ptcls
    for _ in range(3):
        pk, _ = app_k._step(pk)
        pw, _ = app_w._step(pw)
    np.testing.assert_array_equal(np.asarray(pk.active), np.asarray(pw.active))
    act = np.asarray(pk.active)
    np.testing.assert_array_equal(np.asarray(pk.elem)[act],
                                  np.asarray(pw.elem)[act])
    np.testing.assert_allclose(np.asarray(pk.get("x"))[act],
                               np.asarray(pw.get("x"))[act])
    if wall == "periodic":
        assert act.all()


def test_gyro_scatter_one_ring():
    """REGRESSION (round-5 review): num_rings=1 hit two R>=2 assumptions in
    accumulate_to_rings — the uniform path's rd=-1 wrapped `.at[:, -1]`
    onto ring 0 (double count) and the per-particle path's clip(0, R-2=-1)
    shifted keys to elem-1 (neighbor corruption, element 0's deposits
    vanishing).  With one ring each active particle must deposit exactly
    once into its own element's vertices."""
    from pumipic_jax.ops import scatter as sc

    mesh = _small_mesh()
    V = mesh.nverts
    rng = np.random.default_rng(11)
    n = 400
    elem = rng.integers(0, mesh.nelems, n)
    active = rng.uniform(size=n) > 0.3
    radius = rng.uniform(0, 0.06, n).astype(np.float32)

    e2v = np.asarray(mesh.elem2verts)
    expect = np.zeros((V, 1), np.float32)
    for i in range(n):
        if active[i]:
            for v in e2v[elem[i]]:
                expect[v, 0] += 1.0

    for rad in (None, radius):
        got = np.asarray(sc.accumulate_to_rings(
            jnp.asarray(elem, jnp.int32), jnp.asarray(active),
            mesh.elem2verts, V, 1, 0.06,
            ptcl_radius=None if rad is None else jnp.asarray(rad)))
        np.testing.assert_array_equal(got, expect)


def test_gitr_reflect_reflects_velocity():
    """REGRESSION (round-5 review): wall='reflect' mirrored the position
    but kept the wall-ward velocity, so reflected particles re-entered the
    wall every step (pinned at the surface, inflating the flux tally).
    Specular reflection must flip the normal velocity component and
    conserve speed: a zero-field particle aimed at the +x wall of the unit
    box must come back with v_x < 0 and |v| unchanged."""
    from pumipic_jax.models.gitr_like import GitrConfig, GitrLike

    coords, tets = gen.box_tet_mesh(3, 3, 3)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = GitrConfig(num_ptcls=4, num_iterations=1, dt=5e-4,
                     b_field=(0.0, 0.0, 0.0), wall="reflect")
    app = GitrLike(mesh, cfg, seed=1)

    # place all 4 particles near the +x wall, aimed straight at it
    start = np.array([0.7, 0.52, 0.47], np.float32)
    cz, ev = np.asarray(mesh.coords), np.asarray(mesh.elem2verts)
    # host locate: containing tet by barycentric solve
    vv = cz[ev]
    T = np.stack([vv[:, 1] - vv[:, 0], vv[:, 2] - vv[:, 0],
                  vv[:, 3] - vv[:, 0]], axis=-1)
    lam = np.linalg.solve(T, np.broadcast_to(
        start - vv[:, 0], (len(ev), 3))[..., None])[..., 0]
    bc = np.concatenate([1 - lam.sum(-1, keepdims=True), lam], axis=-1)
    e0 = int(np.argmax(bc.min(axis=-1)))
    assert bc[e0].min() > -1e-6

    v0 = np.array([1000.0, 0.0, 0.0], np.float32)   # hits x=1 mid-step
    app.state = {
        "x": jnp.broadcast_to(jnp.asarray(start), (4, 3)),
        "v": jnp.broadcast_to(jnp.asarray(v0), (4, 3)),
        "elem": jnp.full((4,), e0, jnp.int32),
        "active": jnp.ones((4,), bool),
    }
    history = app.run()
    assert history == [4]                            # nobody deleted
    v1 = np.asarray(app.state["v"])
    x1 = np.asarray(app.state["x"])
    assert (v1[:, 0] < 0).all(), v1                  # normal component flipped
    np.testing.assert_allclose(np.linalg.norm(v1, axis=1),
                               np.linalg.norm(v0), rtol=1e-5)
    assert (x1[:, 0] <= 1.0 + 1e-5).all()            # back inside
    # and the next step moves AWAY from the wall instead of re-reflecting
    app.run(1)
    x2 = np.asarray(app.state["x"])
    assert (x2[:, 0] < x1[:, 0]).all()


def test_kuhn_force_incompatible_wall_raises():
    """REGRESSION (round-5 review): kuhn='force' with wall='reflect' was
    silently ignored (the analytic locate only services periodic/remove) —
    a benchmark believed to be on the analytic path silently measured the
    walk.  'force' must error for unsupported walls."""
    coords, tets = gen.box_tet_mesh(3, 3, 3)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = PushSearchConfig(num_ptcls=64, num_iterations=1, distance=0.05,
                           structure="dps", wall="reflect", kuhn="force")
    with pytest.raises(ValueError, match="reflect"):
        PseudoPushAndSearch(mesh, cfg)
