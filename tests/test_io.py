"""Checkpoint + mesh I/O round-trip tests — the reference's file_rw suite
(testing.cmake:49-78: write+read round-trip at 1/4 ranks) plus Gmsh interop
and golden particle files."""
import jax.numpy as jnp
import numpy as np
import pytest

from pumipic_jax.io import checkpoint as ckpt
from pumipic_jax.mesh import generate as gen, gmsh
from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.parallel import picparts as ppm
from pumipic_jax.particles import CSR, SellCSigma, SCSInput, distribute, pfile


def test_picparts_roundtrip(tmp_path):
    coords, tris, cls = gen.annulus_mesh(4, 16, 0.3, 1.0)
    owners = ppm.partition_rcb(coords, tris, 4)
    pp = ppm.build_picparts(coords, tris, owners, 4,
                            ppm.PicPartsInput(), cls)
    path = ckpt.write_picparts(str(tmp_path / "ck"), pp)
    assert path.endswith("_4.ppm.npz")
    pp2 = ckpt.read_picparts(path)
    assert pp2.num_ranks == pp.num_ranks
    np.testing.assert_array_equal(np.asarray(pp2.elem_gid), np.asarray(pp.elem_gid))
    np.testing.assert_array_equal(np.asarray(pp2.elem_safe), np.asarray(pp.elem_safe))
    np.testing.assert_allclose(
        np.asarray(pp2.mesh.walk_geom), np.asarray(pp.mesh.walk_geom)
    )
    np.testing.assert_array_equal(
        np.asarray(pp2.vert_send_ids), np.asarray(pp.vert_send_ids)
    )
    assert pp2.mesh.nelems == pp.mesh.nelems


def test_particle_structure_roundtrip(tmp_path):
    ppe, elems = distribute.distribute_particles(10, 64, "gaussian", seed=1)
    fields = {
        "x": jnp.asarray(np.random.default_rng(0).normal(size=(64, 3)), jnp.float32),
        "pid": jnp.arange(64, dtype=jnp.int32),
    }
    ps = SellCSigma(10, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=4))
    path = ckpt.write_particle_structure(str(tmp_path / "ptcls"), ps, step=7)
    ps2, step = ckpt.read_particle_structure(path)
    assert step == 7
    assert ps2.layout == "scs" and ps2.n_ptcls() == 64
    h1, h2 = ps.copy_to_host(), ps2.copy_to_host()
    # same multiset of (pid -> elem, x)
    def state(h, cap):
        return {
            int(h["pid"][s]): (int(h["elem"][s]), tuple(h["x"][s]))
            for s in range(cap) if h["active"][s]
        }
    assert state(h1, ps.capacity) == state(h2, ps2.capacity)


def test_flat_state_roundtrip(tmp_path):
    state = {
        "x": jnp.ones((4, 8, 2), jnp.float32),
        "active": jnp.zeros((4, 8), bool),
    }
    p = ckpt.write_particles(str(tmp_path / "st"), state, step=3)
    out, step = ckpt.read_particles(p)
    assert step == 3
    np.testing.assert_array_equal(out["x"], np.ones((4, 8, 2), np.float32))


def test_gmsh_roundtrip(tmp_path):
    coords, tris, cls = gen.disk_mesh(3, 6)
    p = str(tmp_path / "disk.msh")
    gmsh.write_msh2(p, coords, tris, cls)
    c2, ev2, cls2 = gmsh.read_msh(p)
    assert c2.shape == (coords.shape[0], 2)
    np.testing.assert_allclose(c2, coords)
    np.testing.assert_array_equal(ev2, tris)
    np.testing.assert_array_equal(cls2, cls)
    # and it builds a valid device mesh
    m = Mesh2D.from_arrays(c2, ev2, cls2)
    assert m.nelems == tris.shape[0]


def test_gmsh_tet_roundtrip(tmp_path):
    coords, tets = gen.box_tet_mesh(2, 2, 2)
    p = str(tmp_path / "box.msh")
    gmsh.write_msh2(p, coords, tets)
    c2, ev2, cls2 = gmsh.read_msh(p)
    assert c2.shape == coords.shape
    np.testing.assert_array_equal(ev2, tets)


def test_golden_particle_file(tmp_path):
    ne, n = 12, 100
    ppe, elems = distribute.distribute_particles(ne, n, "exponential", seed=2)
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(n, 3))
    vals = rng.normal(size=(n, 3))
    p = str(tmp_path / "ptcl.txt")
    pfile.write_particle_file(p, ne, np.arange(ne), elems, pos, vals)
    d = pfile.read_particle_file(p)
    assert d["num_elems"] == ne
    np.testing.assert_array_equal(d["ptcl_elems"], elems)
    np.testing.assert_allclose(d["pos"], pos)
    np.testing.assert_array_equal(
        d["ptcls_per_elem"], np.bincount(elems, minlength=ne)
    )
    # the same golden file builds identical structures for every layout
    ps_a = CSR(ne, d["ptcl_elems"], fields={"pos": jnp.asarray(d["pos"], jnp.float32)})
    ps_b = SellCSigma(ne, d["ptcl_elems"],
                      fields={"pos": jnp.asarray(d["pos"], jnp.float32)})
    np.testing.assert_array_equal(np.asarray(ps_a.ppe()), np.asarray(ps_b.ppe()))


def test_osh_roundtrip(tmp_path):
    """Omega_h-style .osh directory round-trip: compressed + uncompressed,
    tags, classification (pumipic_file.cpp:46-207 design)."""
    import numpy as np
    from pumipic_jax.io import osh
    from pumipic_jax.mesh import generate as gen

    coords, tris, cls = gen.tokamak_mesh(6, 24)
    vt = {"potential": np.linspace(0, 1, coords.shape[0])}
    et = {"bfield": np.random.default_rng(0).normal(
        size=(tris.shape[0], 3))}

    for compress in (True, False):
        path = str(tmp_path / f"mesh_c{compress}.osh")
        osh.write_osh(path, coords, tris, cls, vert_tags=vt, elem_tags=et,
                      compress=compress)
        c2, ev2, cls2, vt2, et2 = osh.read_osh(path)
        np.testing.assert_allclose(c2, coords)
        np.testing.assert_array_equal(ev2, tris)
        np.testing.assert_array_equal(cls2, cls)
        np.testing.assert_allclose(vt2["potential"], vt["potential"])
        np.testing.assert_allclose(et2["bfield"], et["bfield"])


def test_osh_multipart_and_dispatch(tmp_path):
    import numpy as np
    from pumipic_jax.io import osh
    from pumipic_jax.mesh import generate as gen

    coords, tris, cls = gen.annulus_mesh(3, 12, 0.3, 1.0)
    path = str(tmp_path / "multi.osh")
    half = tris.shape[0] // 2
    osh.write_osh(path, coords, tris[:half], cls[:half], nparts=2, rank=0)
    osh.write_osh(path, coords, tris[half:], cls[half:], nparts=2, rank=1)
    _, ev0, _, _, _ = osh.read_osh(path, rank=0)
    _, ev1, _, _, _ = osh.read_osh(path, rank=1)
    assert ev0.shape[0] + ev1.shape[0] == tris.shape[0]
    import pytest
    with pytest.raises(ValueError):
        osh.read_osh(path, rank=2)

    # load_mesh dispatch: .osh and .msh.gz through one entry point
    c, ev, cl = osh.load_mesh(path)
    np.testing.assert_array_equal(ev, tris[:half])
    from pumipic_jax.mesh.gmsh import write_msh2
    gz = str(tmp_path / "round.msh.gz")
    write_msh2(gz, coords, tris, cls)
    c3, ev3, cl3 = osh.load_mesh(gz)
    assert ev3.shape == tris.shape
    np.testing.assert_array_equal(cl3, cls)


def test_osh_rejects_garbage(tmp_path):
    import pytest
    from pumipic_jax.io import osh

    bad = tmp_path / "bad.osh"
    bad.write_bytes(b"\x00\x01 definitely not a mesh")
    with pytest.raises(ValueError):
        osh.read_osh(str(bad))
