"""The float64 references that chip_smoke.py checks the GPU run against,
checked here against the package on small meshes, plus the smoke's own
phases and device gate on the CPU."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pumipic_jax import reference as ref
from pumipic_jax.mesh import generate as gen
from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.models.pseudo_xgcm import GyroConfig, build_gyro_mapping
from pumipic_jax.ops import scatter as scatter_ops
from pumipic_jax.ops import search as search_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _annulus():
    coords, tris, cls = gen.annulus_mesh(6, 24, 0.3, 1.0)
    return coords, tris, cls, Mesh2D.from_arrays(coords, tris, cls)


def _points_in(mesh, elem, rng):
    cz = np.asarray(mesh.coords, np.float64)
    p = cz[np.asarray(mesh.elem2verts)[elem]]
    w = rng.dirichlet(np.ones(3), size=len(elem))
    return np.einsum("nk,nkd->nd", w, p)


def test_containment_oracle_agrees_with_walk():
    """Every walk result is contained to the oracle's tolerance, and a
    point reported in a wrong element is caught."""
    _, _, _, mesh = _annulus()
    rng = np.random.default_rng(3)
    n = 2000
    e0 = rng.integers(0, mesh.nelems, n)
    start = _points_in(mesh, e0, rng)
    tgt_elem = rng.integers(0, mesh.nelems, n)
    tgt = _points_in(mesh, tgt_elem, rng)
    res = search_ops.search_mesh_2d(
        mesh, jnp.asarray(start, jnp.float32), jnp.asarray(tgt, jnp.float32),
        jnp.asarray(e0, jnp.int32), jnp.ones(n, bool), 500)
    found = np.asarray(res.elem_ids)
    ok = found >= 0
    assert ok.mean() > 0.5
    cz = np.asarray(mesh.coords, np.float64)
    ev = np.asarray(mesh.elem2verts)
    dest = np.asarray(res.dest)
    margin = ref.containment_margin(cz, ev, found[ok], dest[ok])
    assert (margin >= 0).all()
    wrong = (found[ok] + mesh.nelems // 2) % mesh.nelems
    assert (ref.containment_margin(cz, ev, wrong, dest[ok]) < 0).all()


def test_containment_oracle_tets():
    coords, tets = gen.box_tet_mesh(3, 3, 3)
    rng = np.random.default_rng(5)
    elem = rng.integers(0, len(tets), 500)
    w = rng.dirichlet(np.ones(4), size=500)
    pts = np.einsum("nk,nkd->nd", w, coords[tets[elem]])
    assert (ref.containment_margin(coords, tets, elem, pts) >= 0).all()
    far = pts + 10.0
    assert (ref.containment_margin(coords, tets, elem, far) < 0).all()


def test_outside_domain_annulus():
    coords, tris, _, _ = _annulus()
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    ring = np.stack([np.cos(th), np.sin(th)], axis=1)
    assert not ref.outside_domain(coords, tris, 0.65 * ring).any()
    assert ref.outside_domain(coords, tris, 0.1 * ring).all()    # the hole
    assert ref.outside_domain(coords, tris, 1.5 * ring).all()
    assert len(ref.boundary_edges(tris)) == 2 * 24


@pytest.mark.parametrize("num_rings,per_particle", [
    (3, False), (1, False), (4, True),
])
def test_literal_deposition_matches_package(num_rings, per_particle):
    """np.add.at deposition particle by particle equals the package's
    histogram + segment_sum pipeline, counts exactly and fields to f32
    rounding, and the field sum equals the conserved charge."""
    _, _, _, mesh = _annulus()
    gyro = GyroConfig(rmax=0.05, num_rings=num_rings, points_per_ring=4)
    gmap = np.asarray(build_gyro_mapping(mesh, gyro))
    rng = np.random.default_rng(num_rings)
    n = 5000
    elem = rng.integers(0, mesh.nelems, n).astype(np.int32)
    active = rng.random(n) < 0.8
    rad = (rng.uniform(0.0, 1.2 * gyro.rmax, n).astype(np.float32)
           if per_particle else None)
    ring_dev = np.asarray(scatter_ops.accumulate_to_rings(
        jnp.asarray(elem), jnp.asarray(active), mesh.elem2verts,
        mesh.nverts, gyro.num_rings, gyro.rmax,
        ptcl_radius=None if rad is None else jnp.asarray(rad)))
    field_dev = np.asarray(scatter_ops.scatter_to_mapped_verts(
        jnp.asarray(ring_dev), jnp.asarray(gmap), mesh.nverts,
        gyro.num_rings, gyro.points_per_ring))
    ring, field = ref.literal_deposition(
        elem, active, np.asarray(mesh.elem2verts), mesh.nverts,
        gyro.num_rings, gyro.rmax, gmap, gyro.points_per_ring,
        ptcl_radius=rad)
    np.testing.assert_array_equal(ring_dev.astype(np.int64), ring)
    np.testing.assert_allclose(field_dev, field, rtol=1e-6)
    per = 2 if num_rings > 1 else 1
    assert ring.sum() == active.sum() * 3 * per
    total = ref.deposited_charge(ring, gmap, gyro.points_per_ring)
    assert abs(field.sum() - total) <= 1e-9 * total


def test_chip_smoke_dp_phase_small():
    """The smoke's dp phase, with every check, on a small tokamak mesh."""
    coords, tris, cls = gen.tokamak_mesh(16, 96)
    orig = chip_smoke.peak_bytes
    chip_smoke.peak_bytes = lambda: 0        # the CPU keeps no statistics
    try:
        out = chip_smoke.phase_dp((coords, tris, cls), 4096, steps=2)
    finally:
        chip_smoke.peak_bytes = orig
    assert out["alive"] > 4000


def test_chip_smoke_four_card_comparison_small():
    """picparts R=4 against dp over four virtual devices, as the smoke's
    --four-cards phase checks it."""
    coords, tris, cls = gen.tokamak_mesh(16, 96)
    out = chip_smoke.phase_four_cards((coords, tris, cls), 2048, steps=2)
    assert out["sent"] > 0


def test_chip_smoke_path_comparison_one_card():
    """The same comparison at R=1: picparts over one device against dp."""
    coords, tris, cls = gen.tokamak_mesh(16, 96)
    out = chip_smoke.phase_four_cards((coords, tris, cls), 4096, steps=3,
                                      cards=1)
    assert out["alive"] > 4000 and out["diverged"] == 0


def _class_edge(tris, cls):
    """Two elements of different classes sharing an edge, and the edge's
    two vertices."""
    sets = [set(t) for t in tris.tolist()]
    for a in range(len(tris)):
        for b in range(a + 1, len(tris)):
            common = sets[a] & sets[b]
            if len(common) == 2 and cls[a] != cls[b]:
                return a, b, sorted(common)
    raise AssertionError("no edge between classes")


def test_compare_particles_explains_differences():
    """Identical particles pass, a tie on an edge between classes is
    counted, a later divergence of that particle is accepted, and a
    divergence without an earlier tie fails."""
    coords, tris, cls, _ = _annulus()
    ea, eb, (v0, v1) = _class_edge(tris, cls)
    rng = np.random.default_rng(0)
    n = 3
    elem = np.array([ea, ea, eb])
    pts = _points_in(Mesh2D.from_arrays(coords, tris, cls), elem, rng)
    pts[1] = 0.5 * (coords[v0] + coords[v1])            # on the shared edge

    def state(elems, xy):
        xy = np.asarray(xy, np.float32)
        return {"elem": np.asarray(elems, np.int64), "x0": xy[:, 0].copy(),
                "x1": xy[:, 1].copy(), "cphi": np.ones(n, np.float32),
                "sphi": np.zeros(n, np.float32)}

    cz = np.asarray(coords, np.float64)
    tied = np.zeros(n, bool)
    d = state(elem, pts)
    p = state([ea, eb, eb], pts)                        # particle 1: a tie
    c = chip_smoke.compare_particles(p, d, cz, tris, cls, tied)
    assert c == {"ties": 1, "class_ties": 1, "diverged": 0}
    assert tied.tolist() == [False, True, False]

    # next step particle 1 moved differently, each inside its element
    q = _points_in(Mesh2D.from_arrays(coords, tris, cls),
                   np.array([ea, eb]), rng)
    d = state(elem, [pts[0], q[0], pts[2]])
    p = state([ea, eb, eb], [pts[0], q[1], pts[2]])
    c = chip_smoke.compare_particles(p, d, cz, tris, cls, tied)
    assert c["diverged"] == 1

    # particle 2 differs without an earlier tie
    p["cphi"][2] = np.nextafter(np.float32(1), np.float32(0))
    with pytest.raises(chip_smoke.CheckFailed, match="between classes"):
        chip_smoke.compare_particles(p, d, cz, tris, cls, tied)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU (and, copied alone, no package): non-zero exit, no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_get_mem_usage_raises_without_stats():
    from pumipic_jax.utils.memory import get_mem_usage

    assert jax.devices()[0].memory_stats() is None
    with pytest.raises(RuntimeError, match="memory statistics"):
        get_mem_usage()
