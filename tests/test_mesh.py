"""Mesh core tests: adjacency derivation invariants on generated meshes.

Mirrors the reference's reliance on Omega_h invariants (manifoldness,
exposed-side marking, measures) that pumi-pic assumes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pumipic_jax.mesh import adjacency as adj
from pumipic_jax.mesh import generate as gen
from pumipic_jax.mesh.core import Mesh2D, Mesh3D


def test_rectangle_adjacency():
    coords, tris = gen.rectangle_mesh(4, 3)
    a = adj.build_tri_adjacency(coords, tris)
    E = tris.shape[0]
    assert E == 2 * 4 * 3
    # Euler: V - E + F = 1 for a disk-like region (without outer face)
    V, Ned = coords.shape[0], a["edge2verts"].shape[0]
    assert V - Ned + E == 1
    # every interior edge has 2 elems, boundary edges 1
    exposed = a["side_is_exposed"]
    assert np.all((a["edge2elems"][:, 1] == -1) == exposed)
    assert exposed.sum() == 2 * (4 + 3)
    # total area
    assert np.isclose(a["elem_area"].sum(), 1.0)
    assert np.all(a["elem_area"] > 0)


def test_disk_mesh_valid():
    coords, tris, cls = gen.disk_mesh(5, 8)
    a = adj.build_tri_adjacency(coords, tris)
    assert np.isclose(a["elem_area"].sum(), np.pi, rtol=0.15)
    # boundary edge count == outermost ring vertex count
    assert a["side_is_exposed"].sum() == 8 * 5
    assert cls.min() == 1 and cls.max() == 5


def test_annulus_mesh_valid():
    coords, tris, cls = gen.annulus_mesh(4, 16, 0.5, 1.0)
    a = adj.build_tri_adjacency(coords, tris)
    exact = np.pi * (1.0**2 - 0.5**2)
    assert np.isclose(a["elem_area"].sum(), exact, rtol=0.1)
    assert a["side_is_exposed"].sum() == 2 * 16  # inner + outer boundary


def test_box_tet_adjacency():
    coords, tets = gen.box_tet_mesh(2, 2, 2)
    a = adj.build_tet_adjacency(coords, tets)
    assert tets.shape[0] == 6 * 8
    assert np.isclose(a["elem_volume"].sum(), 1.0)
    assert np.all(a["elem_volume"] > 0)
    # boundary faces: each box face has 2*n^2 triangles = 2*4=8, 6 faces
    assert a["side_is_exposed"].sum() == 6 * 8
    exposed = a["side_is_exposed"]
    assert np.all((a["face2elems"][:, 1] == -1) == exposed)


def test_mesh2d_device_build():
    coords, tris, cls = gen.disk_mesh(3, 6)
    m = Mesh2D.from_arrays(coords, tris, cls)
    assert m.nelems == tris.shape[0]
    assert m.elem_inv_basis.shape == (m.nelems, 2, 2)
    # inverse basis actually inverts: bcc of centroid == (1/3, 1/3)
    import jax.numpy as jnp

    cent = m.elem_centroids
    rel = cent - m.elem_v0
    lam = jnp.einsum("eij,ej->ei", m.elem_inv_basis, rel)
    assert np.allclose(np.asarray(lam), 1.0 / 3.0, atol=1e-5)


def test_mesh3d_device_build():
    coords, tets = gen.box_tet_mesh(2, 1, 1)
    m = Mesh3D.from_arrays(coords, tets)
    import jax.numpy as jnp

    cent = m.elem_centroids
    rel = cent - m.elem_v0
    lam = jnp.einsum("eij,ej->ei", m.elem_inv_basis, rel)
    assert np.allclose(np.asarray(lam), 0.25, atol=1e-5)


def test_tags_roundtrip():
    coords, tris = gen.rectangle_mesh(2, 2)
    m = Mesh2D.from_arrays(coords, tris)
    import jax.numpy as jnp

    m2 = m.set_tag(2, "has_particles", jnp.zeros(m.nelems, jnp.int32))
    assert m2.get_tag(2, "has_particles").shape == (m.nelems,)
    m3 = m2.set_tag(0, "w", jnp.ones(m.nverts))
    assert m3.get_tag(0, "w").shape == (m.nverts,)


def test_tokamak_mesh_valid():
    """XGC-like D-shaped mesh: conforming, positively oriented, flux-band
    classified, with the sliver elements real XGC meshes have."""
    coords, tris, cls = gen.tokamak_mesh(16, 48)
    m = Mesh2D.from_arrays(coords, tris, cls)
    area = np.asarray(m.elem_area)
    assert (area > 0).all()
    assert cls.min() == 1 and cls.max() == 16
    # ragged ring counts -> genuinely irregular triangles (sliver presence)
    ev = np.asarray(m.elem2verts)
    p = np.asarray(m.coords)[ev]
    e = np.stack([
        np.linalg.norm(p[:, 1] - p[:, 0], axis=1),
        np.linalg.norm(p[:, 2] - p[:, 1], axis=1),
        np.linalg.norm(p[:, 0] - p[:, 2], axis=1),
    ])
    aspect = e.max(axis=0) / e.min(axis=0)
    assert aspect.max() > 5.0
    # conforming: every interior edge has exactly 2 elements
    e2e = np.asarray(m.edge2elems)
    exposed = np.asarray(m.side_is_exposed)
    assert ((e2e >= 0).sum(axis=1) == np.where(exposed, 1, 2)).all()


def test_xgc_mesh_file_loads_and_search_oracle():
    """The shipped XGC-like 24k mesh file loads through the gzip'd Gmsh path
    and the search proves containment on it (the 120k config is the same
    generator/format at scale; see scripts/make_xgc_mesh.py and BENCH_MESH)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "xgc_like_24k.msh.gz")
    from pumipic_jax.mesh.gmsh import read_msh
    from pumipic_jax.mesh.locator import build_locator_grid
    from pumipic_jax.ops import search as search_ops

    coords, tris, cls = read_msh(path)
    assert tris.shape[0] > 20_000
    m = Mesh2D.from_arrays(coords, tris, cls)
    assert (np.asarray(m.elem_area) > 0).all()

    # oracle containment: locate random points inside random elements, then
    # verify the walk's answer contains them exactly
    rng = np.random.default_rng(11)
    n = 2000
    el = rng.integers(0, m.nelems, n)
    w = rng.dirichlet(np.ones(3), size=n)
    pts = np.einsum("nk,nkd->nd", w, coords[tris[el]]).astype(np.float32)
    grid = build_locator_grid(coords, tris)
    res = search_ops.search_mesh_2d_accel(
        m, grid,
        (jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])),
        (jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])),
        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool), 200,
    )
    got = np.asarray(res.elem_ids)
    assert (got >= 0).all()
    # containment oracle (points strictly inside, so the found element must
    # contain them; ties on shared edges can legitimately pick a neighbor)
    g = np.asarray(m.walk_geom)
    l1 = g[got, 0] * pts[:, 0] + g[got, 1] * pts[:, 1] + g[got, 2]
    l2 = g[got, 3] * pts[:, 0] + g[got, 4] * pts[:, 1] + g[got, 5]
    w0 = 1.0 - l1 - l2
    assert (np.minimum(np.minimum(l1, l2), w0) > -1e-4).all()


def test_xgc_120k_mesh_loads_and_search_oracle():
    """The 120k-element config (reference testing.cmake:123-130 analog):
    loads from file, valid geometry, ~120k elements, and the
    grid-accelerated search proves containment on it."""
    import os
    from pumipic_jax.io.osh import load_mesh
    from pumipic_jax.mesh.locator import build_locator_grid
    from pumipic_jax.ops import search as search_ops

    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "xgc_like_120k.msh.gz")
    coords, tris, cls = load_mesh(path)
    assert tris.shape[0] > 115_000
    m = Mesh2D.from_arrays(coords, tris, cls)
    assert (np.asarray(m.elem_area) > 0).all()
    assert int(np.asarray(m.class_id).max()) >= 100   # deep flux banding

    # oracle containment at scale (same as the 24k test): random interior
    # points must be found in an element that actually contains them
    rng = np.random.default_rng(13)
    n = 2000
    el = rng.integers(0, m.nelems, n)
    w = rng.dirichlet(np.ones(3), size=n)
    pts = np.einsum("nk,nkd->nd", w, coords[tris[el]]).astype(np.float32)
    grid = build_locator_grid(coords, tris)
    res = search_ops.search_mesh_2d_accel(
        m, grid,
        (jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])),
        (jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])),
        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool), 200,
    )
    got = np.asarray(res.elem_ids)
    assert (got >= 0).all()
    g = np.asarray(m.walk_geom)
    l1 = g[got, 0] * pts[:, 0] + g[got, 1] * pts[:, 1] + g[got, 2]
    l2 = g[got, 3] * pts[:, 0] + g[got, 4] * pts[:, 1] + g[got, 5]
    w0 = 1.0 - l1 - l2
    # containment up to the walk's own f32 tolerance model: on sliver
    # elements (this mesh has areas down to ~3e-7) the affine-form
    # evaluation error is BCC_REL_TOL * |terms|, so "inside the found
    # element" means within that slack (ops/search.py BCC_REL_TOL)
    m1 = (np.abs(g[got, 0] * pts[:, 0]) + np.abs(g[got, 1] * pts[:, 1])
          + np.abs(g[got, 2]))
    m2 = (np.abs(g[got, 3] * pts[:, 0]) + np.abs(g[got, 4] * pts[:, 1])
          + np.abs(g[got, 5]))
    tol = 4.0 * search_ops.BCC_REL_TOL * (m1 + m2) + 1e-4
    assert (np.minimum(np.minimum(l1, l2), w0) > -tol).all()


@pytest.mark.quick
def test_gmsh_rejects_corrupt_and_unsupported(tmp_path):
    """REGRESSION (round-5 review): (a) elements referencing node ids
    absent from $Nodes mapped to -1 and numpy fancy indexing silently
    wrapped them to the LAST vertex — a geometrically corrupt but
    structurally plausible mesh; must raise.  (b) MSH 3.x/4.0 block
    layouts differ from both the 2.2 and 4.1 parsers; routing them into
    the 4.1 parser crashed uninformatively — must report the version."""
    from pumipic_jax.mesh.gmsh import read_msh

    # (a) a 2.2 file whose triangle references node 99 (never listed)
    msh = "\n".join([
        "$MeshFormat", "2.2 0 8", "$EndMeshFormat",
        "$Nodes", "4",
        "1 0 0 0", "2 1 0 0", "3 0 1 0", "4 1 1 0",
        "$EndNodes",
        "$Elements", "2",
        "1 2 2 1 1 1 2 3",
        "2 2 2 1 1 2 99 3",
        "$EndElements", "",
    ])
    p = tmp_path / "bad_node.msh"
    p.write_text(msh)
    with pytest.raises(ValueError, match="Nodes"):
        read_msh(str(p))

    # (b) MSH 4.0 must be rejected by version, not by a parse crash
    p2 = tmp_path / "v40.msh"
    p2.write_text("$MeshFormat\n4 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="4.0|version"):
        read_msh(str(p2))
