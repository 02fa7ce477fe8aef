"""Geometry kernel tests — analogs of the reference's barycentric,
linetri_intersection and moller_trumbore single-element analytic tests
(test/test_barycentric.cpp, testing.cmake:2-10)."""
import jax.numpy as jnp
import numpy as np

from pumipic_jax.ops import geometry as geo


def _tri_inv_basis(a, b, c):
    basis = np.stack([np.subtract(b, a), np.subtract(c, a)], axis=-1)
    return np.linalg.inv(basis)


def test_bcc_2d_analytic():
    a, b, c = (0.0, 0.0), (1.0, 0.0), (0.0, 1.0)
    inv = _tri_inv_basis(a, b, c)
    pts = np.array([
        [1 / 3, 1 / 3],   # centroid
        [0.0, 0.0],       # vertex a
        [1.0, 0.0],       # vertex b
        [0.5, 0.5],       # midpoint bc
        [2.0, 2.0],       # outside
    ])
    inv_b = jnp.asarray(np.broadcast_to(inv, (5, 2, 2)))
    v0 = jnp.zeros((5, 2))
    w = np.asarray(geo.bcc_2d(inv_b, v0, jnp.asarray(pts)))
    np.testing.assert_allclose(w[0], [1 / 3, 1 / 3, 1 / 3], atol=1e-6)
    np.testing.assert_allclose(w[1], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(w[2], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(w[3], [0, 0.5, 0.5], atol=1e-6)
    assert not bool(geo.all_positive(jnp.asarray(w))[4])
    # outside point beyond edge bc -> most negative weight is vertex a
    assert int(geo.min_index(jnp.asarray(w[4:]))[0]) == 0
    # crossing edge opposite vertex 0 is local edge 1 (verts 1-2)
    assert int(geo.exit_edge_2d(jnp.asarray(w[4:]))[0]) == 1


def test_bcc_3d_analytic():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    basis = np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]], axis=-1)
    inv = np.linalg.inv(basis)
    pts = np.array([[0.25, 0.25, 0.25], [0, 0, 0], [0.9, 0.9, 0.9]])
    inv_b = jnp.asarray(np.broadcast_to(inv, (3, 3, 3)))
    v0 = jnp.zeros((3, 3))
    w = np.asarray(geo.bcc_3d(inv_b, v0, jnp.asarray(pts)))
    np.testing.assert_allclose(w[0], [0.25] * 4, atol=1e-6)
    np.testing.assert_allclose(w[1], [1, 0, 0, 0], atol=1e-6)
    assert not bool(geo.all_positive(jnp.asarray(w))[2])


def test_moller_trumbore():
    va = jnp.asarray([[0.0, 0.0, 1.0]])
    vb = jnp.asarray([[1.0, 0.0, 1.0]])
    vc = jnp.asarray([[0.0, 1.0, 1.0]])
    orig = jnp.asarray([[0.2, 0.2, 0.0]])
    # straight up: hits at t=1 (direction is unit z)
    hit, t = geo.moller_trumbore(orig, jnp.asarray([[0.0, 0.0, 1.0]]), va, vb, vc)
    assert bool(hit[0]) and np.isclose(float(t[0]), 1.0)
    # pointing away: no hit
    hit, t = geo.moller_trumbore(orig, jnp.asarray([[0.0, 0.0, -1.0]]), va, vb, vc)
    assert not bool(hit[0])
    # parallel ray: no hit
    hit, t = geo.moller_trumbore(orig, jnp.asarray([[1.0, 0.0, 0.0]]), va, vb, vc)
    assert not bool(hit[0])
    # outside triangle bounds
    hit, t = geo.moller_trumbore(
        jnp.asarray([[0.9, 0.9, 0.0]]), jnp.asarray([[0.0, 0.0, 1.0]]), va, vb, vc
    )
    assert not bool(hit[0])


def test_closest_point_on_triangle():
    va = jnp.asarray([[0.0, 0.0, 0.0]])
    vb = jnp.asarray([[1.0, 0.0, 0.0]])
    vc = jnp.asarray([[0.0, 1.0, 0.0]])
    # above interior -> projects straight down
    p = geo.closest_point_on_triangle(jnp.asarray([[0.2, 0.2, 5.0]]), va, vb, vc)
    np.testing.assert_allclose(np.asarray(p)[0], [0.2, 0.2, 0.0], atol=1e-6)
    # beyond vertex b -> clamps to b
    p = geo.closest_point_on_triangle(jnp.asarray([[2.0, -1.0, 0.0]]), va, vb, vc)
    np.testing.assert_allclose(np.asarray(p)[0], [1.0, 0.0, 0.0], atol=1e-6)
    # beyond edge ab -> clamps onto ab
    p = geo.closest_point_on_triangle(jnp.asarray([[0.5, -1.0, 0.0]]), va, vb, vc)
    np.testing.assert_allclose(np.asarray(p)[0], [0.5, 0.0, 0.0], atol=1e-6)
    # beyond edge bc -> clamps onto bc
    p = geo.closest_point_on_triangle(jnp.asarray([[1.0, 1.0, 0.0]]), va, vb, vc)
    np.testing.assert_allclose(np.asarray(p)[0], [0.5, 0.5, 0.0], atol=1e-6)


def test_segment_edge_intersect_2d():
    p0 = jnp.asarray([[0.0, 0.0]])
    p1 = jnp.asarray([[1.0, 1.0]])
    a = jnp.asarray([[0.0, 1.0]])
    b = jnp.asarray([[1.0, 0.0]])
    hit, t = geo.segment_edge_intersect_2d(p0, p1, a, b)
    assert bool(hit[0]) and np.isclose(float(t[0]), 0.5)
    hit, _ = geo.segment_edge_intersect_2d(p0, jnp.asarray([[0.2, 0.2]]), a, b)
    assert not bool(hit[0])
