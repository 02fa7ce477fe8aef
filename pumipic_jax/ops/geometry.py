"""Batched geometric kernels for particle-mesh interaction.

Reference parity (``src/pumipic_adjacency.hpp``): ``barycentric_tri`` (:75-94),
``find_barycentric_tet`` (:97-133), ``line_triangle_intx_simple`` (:230-273),
``ray_intersects_triangle`` Möller–Trumbore (``adjacency.tpp:152-178``),
``closest_point_on_triangle`` (:910-1009), plus ``all_positive/min_index``
helpers from ``pumipic_utils.hpp``.

Every function is *batched over particles* (leading axis N) and built from
fused elementwise ops — no per-particle control flow.  Barycentric
coordinates use per-element precomputed inverse affine bases
(``Mesh*.elem_inv_basis``), turning each evaluation into a 2x2/3x3 matvec,
written as a multiply and a sum: a float32 contraction may run in TF32 on a
GPU, which would decide containment with three decimal digits.

Local conventions (see :mod:`pumipic_jax.mesh.core`):
- 2D: ``w[k]`` is the weight of local vertex ``k``; the side opposite vertex
  ``k`` is edge ``(k+1) % 3``.
- 3D: face ``i`` is opposite vertex ``i``.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def bcc_2d(inv_basis: jax.Array, v0: jax.Array, pts: jax.Array) -> jax.Array:
    """Barycentric vertex weights in triangles.

    inv_basis: (N, 2, 2) per-particle gathered element inverse bases;
    v0: (N, 2) element origin vertex; pts: (N, 2) query points.
    Returns (N, 3) weights summing to 1; all >= 0 iff point inside.
    """
    lam = jnp.sum(inv_basis * (pts - v0)[:, None, :], axis=-1)
    w0 = 1.0 - lam[:, 0] - lam[:, 1]
    return jnp.stack([w0, lam[:, 0], lam[:, 1]], axis=-1)


def bcc_3d(inv_basis: jax.Array, v0: jax.Array, pts: jax.Array) -> jax.Array:
    """Barycentric vertex weights in tets: (N, 4)."""
    lam = jnp.sum(inv_basis * (pts - v0)[:, None, :], axis=-1)
    w0 = 1.0 - lam.sum(axis=-1)
    return jnp.concatenate([w0[:, None], lam], axis=-1)


def all_positive(bcc: jax.Array, tol: float = 0.0) -> jax.Array:
    """(N,) bool: point inside element (``pumipic_utils.hpp`` all_positive)."""
    return jnp.all(bcc >= -tol, axis=-1)


def min_index(bcc: jax.Array) -> jax.Array:
    """(N,) index of smallest coordinate (most violated side)."""
    return jnp.argmin(bcc, axis=-1).astype(jnp.int32)


def exit_edge_2d(bcc: jax.Array) -> jax.Array:
    """Local edge index to cross in a triangle: edge opposite argmin vertex."""
    return ((min_index(bcc) + 1) % 3).astype(jnp.int32)


def tri_area_2d(a: jax.Array, b: jax.Array, c: jax.Array) -> jax.Array:
    """Signed area of 2D triangles, batched (N, 2) inputs -> (N,)."""
    ab = b - a
    ac = c - a
    return 0.5 * (ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0])


def moller_trumbore(
    orig: jax.Array,
    direc: jax.Array,
    va: jax.Array,
    vb: jax.Array,
    vc: jax.Array,
    tol: float = 1e-10,
) -> Tuple[jax.Array, jax.Array]:
    """Batched Möller–Trumbore ray/triangle intersection.

    orig, direc: (N, 3) ray origin and direction (not normalized);
    va, vb, vc: (N, 3) triangle vertices.
    Returns (hit (N,) bool, t (N,) ray parameter; inf where no hit).
    Matches ``ray_intersects_triangle`` (adjacency.tpp:152-178): a hit
    requires 0<=u,v,u+v<=1 and t >= 0.
    """
    e1 = vb - va
    e2 = vc - va
    pvec = jnp.cross(direc, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    near_zero = jnp.abs(det) < tol
    inv_det = jnp.where(near_zero, 0.0, 1.0 / jnp.where(near_zero, 1.0, det))
    tvec = orig - va
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direc * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (~near_zero)
        & (u >= -tol)
        & (v >= -tol)
        & (u + v <= 1.0 + tol)
        & (t >= -tol)
    )
    return hit, jnp.where(hit, t, jnp.inf)


def closest_point_on_triangle(
    p: jax.Array, va: jax.Array, vb: jax.Array, vc: jax.Array
) -> jax.Array:
    """Batched closest point on triangle to p; (N, 3) -> (N, 3).

    Branch-free version of the region-based algorithm the reference uses
    (``pumipic_adjacency.hpp:910-1009``, after Ericson RTCD §5.1.5).
    """
    ab = vb - va
    ac = vc - va
    ap = p - va

    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)

    bp = p - vb
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)

    cp = p - vc
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    va_ = d3 * d6 - d5 * d4
    vb_ = d5 * d2 - d1 * d6
    vc_ = d1 * d4 - d3 * d2

    t_ab = jnp.clip(d1 / jnp.where(d1 - d3 == 0, 1.0, d1 - d3), 0.0, 1.0)

    # Default: interior projection
    denom = va_ + vb_ + vc_
    denom = jnp.where(denom == 0, 1.0, denom)
    v = vb_ / denom
    w = vc_ / denom
    res = va + v[..., None] * ab + w[..., None] * ac

    # Edge BC region
    num_bc = d4 - d3
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = jnp.clip(num_bc / jnp.where(den_bc == 0, 1.0, den_bc), 0.0, 1.0)
    on_bc = (va_ <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    res = jnp.where(on_bc[..., None], vb + t_bc[..., None] * (vc - vb), res)

    # Edge AC region
    t_ac = jnp.clip(d2 / jnp.where(d2 - d6 == 0, 1.0, d2 - d6), 0.0, 1.0)
    on_ac = (vb_ <= 0) & (d2 >= 0) & (d6 <= 0)
    res = jnp.where(on_ac[..., None], va + t_ac[..., None] * ac, res)

    # Edge AB region
    on_ab = (vc_ <= 0) & (d1 >= 0) & (d3 <= 0)
    res = jnp.where(on_ab[..., None], va + t_ab[..., None] * ab, res)

    # Vertex regions
    res = jnp.where(((d6 >= 0) & (d5 <= d6))[..., None], vc, res)
    res = jnp.where(((d3 >= 0) & (d4 <= d3))[..., None], vb, res)
    res = jnp.where(((d1 <= 0) & (d2 <= 0))[..., None], va, res)
    return res


def segment_edge_intersect_2d(
    p0: jax.Array, p1: jax.Array, a: jax.Array, b: jax.Array, tol: float = 1e-12
) -> Tuple[jax.Array, jax.Array]:
    """Batched 2D segment (p0->p1) vs segment (a->b) intersection.

    Returns (hit (N,), t (N,)) with t the parameter along p0->p1.
    Used for boundary-crossing point computation in 2D wall interaction.
    """
    r = p1 - p0
    s = b - a
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    near0 = jnp.abs(denom) < tol
    inv = jnp.where(near0, 0.0, 1.0 / jnp.where(near0, 1.0, denom))
    qp = a - p0
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) * inv
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) * inv
    hit = (~near0) & (t >= -tol) & (t <= 1 + tol) & (u >= -tol) & (u <= 1 + tol)
    return hit, jnp.where(hit, t, jnp.inf)
