"""Plain float64 references for what a particle step produces.

Each function re-derives one property of a step's output from the mesh
arrays alone, in numpy float64, independent of the jitted code under test:

- :func:`containment_margin`: barycentric containment of every particle in
  its reported parent element, against a stated tolerance;
- :func:`outside_domain`: whether a point lies outside the mesh (ray
  casting over the boundary edges), for checking that every particle the
  walk removed really left the domain;
- :func:`literal_deposition`: the gyro-ring deposition built particle by
  particle with ``np.add.at`` (``accumulateToRings`` +
  ``scatterToMappedVerts``, test/gyroScatter.hpp:183-225);
- :func:`deposited_charge`: the total charge that deposition must conserve.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# The walk accepts a point when every barycentric affine form is
# >= -(8 ulp(f32) of its largest term + 1e-7) (ops/search.py BCC_*_TOL).
# The reference recomputes the forms exactly, from f32 positions; the
# slack must cover the walk's own acceptance band, the rounding of its f32
# coefficients (one more ulp per term), and fused multiply-adds on the GPU
# that round differently from the CPU.  32 ulp of the largest term plus an
# absolute 1e-6 bounds all three.
CONTAINMENT_REL_TOL = 32.0 * 2.0 ** -24
CONTAINMENT_ABS_TOL = 1e-6


def _affine_forms(coords: np.ndarray, cells: np.ndarray, elem: np.ndarray):
    """(A, c) with barycentric weights l_k(x) = A[:, k] @ x + c[:, k] for
    the non-zeroth vertices of ``cells[elem]`` (float64)."""
    p = np.asarray(coords, np.float64)[np.asarray(cells)[elem]]  # (N, d+1, d)
    basis = np.swapaxes(p[:, 1:] - p[:, :1], 1, 2)             # (N, d, d)
    inv = np.linalg.inv(basis)
    c = -np.einsum("nij,nj->ni", inv, p[:, 0])
    return inv, c


def containment_margin(coords: np.ndarray, cells: np.ndarray,
                       elem: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Per particle: min over vertices of (barycentric weight + tolerance).

    A value >= 0 means the point lies in its element to the stated
    tolerance (:data:`CONTAINMENT_REL_TOL` of each weight's largest term plus
    :data:`CONTAINMENT_ABS_TOL`).  Works for triangles and tets."""
    pts = np.asarray(pts, np.float64)
    inv, c = _affine_forms(coords, cells, elem)
    terms = np.abs(inv * pts[:, None, :])                       # (N, d, d)
    lam = np.einsum("nij,nj->ni", inv, pts) + c                  # (N, d)
    mag = terms.sum(axis=2) + np.abs(c)
    tol = CONTAINMENT_REL_TOL * mag + CONTAINMENT_ABS_TOL
    lam0 = 1.0 - lam.sum(axis=1)
    margin = np.minimum((lam + tol).min(axis=1), lam0 + tol.sum(axis=1))
    return margin


def boundary_edges(tris: np.ndarray) -> np.ndarray:
    """(B, 2) vertex pairs of the triangle edges used by one element."""
    tris = np.asarray(tris, np.int64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, count = np.unique(e, axis=0, return_counts=True)
    return uniq[count == 1]


def outside_domain(coords: np.ndarray, tris: np.ndarray, pts: np.ndarray,
                   tol: float = 1e-6, chunk: int = 4096) -> np.ndarray:
    """True where a 2D point lies outside the triangulated domain, or within
    ``tol`` (relative to the domain's extent) of its boundary, where an f32
    walk may decide either way.  Ray-casting parity over the boundary
    edges, so domains with holes are handled."""
    coords = np.asarray(coords, np.float64)
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    be = boundary_edges(tris)
    a, b = coords[be[:, 0]], coords[be[:, 1]]
    scale = float(np.ptp(coords, axis=0).max())
    out = np.empty(len(pts), bool)
    for s in range(0, len(pts), chunk):
        p = pts[s:s + chunk, None, :]                           # (n, 1, 2)
        ay, by = a[None, :, 1], b[None, :, 1]
        straddle = (ay > p[..., 1]) != (by > p[..., 1])
        with np.errstate(divide="ignore", invalid="ignore"):
            xc = a[None, :, 0] + (p[..., 1] - ay) * (
                (b[None, :, 0] - a[None, :, 0]) / (by - ay))
        crossings = (straddle & (xc > p[..., 0])).sum(axis=1)
        d = b - a
        t = np.clip(((p - a[None]) * d[None]).sum(-1)
                    / np.maximum((d * d).sum(-1), 1e-300)[None], 0.0, 1.0)
        near = np.linalg.norm(a[None] + t[..., None] * d[None] - p, axis=-1)
        out[s:s + chunk] = (crossings % 2 == 0) | (near.min(axis=1)
                                                    <= tol * scale)
    return out


def ring_brackets(num_rings: int, gyro_rmax: float, n: int,
                  ptcl_radius: Optional[np.ndarray] = None):
    """The two gyro rings bracketing each particle's radius (the reference's
    uniform placeholder radius is 1.125 ring widths, gyroScatter.hpp:185)."""
    width = gyro_rmax / num_rings
    r = (np.full(n, 1.125 * width) if ptcl_radius is None
         else np.asarray(ptcl_radius, np.float64))
    lo = np.clip(np.floor(r / width) - 1, 0, max(num_rings - 2, 0))
    lo = lo.astype(np.int64)
    return lo, np.minimum(lo + 1, num_rings - 1)


def literal_deposition(elem: np.ndarray, active: np.ndarray,
                       elem2verts: np.ndarray, num_verts: int,
                       num_rings: int, gyro_rmax: float,
                       gyro_map: np.ndarray, points_per_ring: int,
                       ptcl_radius: Optional[np.ndarray] = None):
    """Deposit particle by particle; returns (ring_accum (V, R) int64 counts,
    field (V,) float64).

    Every active particle adds 1 to the two rings bracketing its gyro
    radius at each vertex of its element (one ring when ``num_rings`` is
    1); each (vertex, ring) value, averaged over the ring's points, then
    goes to the three vertices of the element holding each ring point
    (``gyro_map`` entry -1: the point is outside the domain)."""
    act = np.asarray(active, bool)
    e = np.asarray(elem, np.int64)[act]
    verts = np.asarray(elem2verts, np.int64)[e]                  # (n, k)
    rad = None if ptcl_radius is None else np.asarray(ptcl_radius)[act]
    lo, hi = ring_brackets(num_rings, gyro_rmax, len(e), rad)
    ring = np.zeros((num_verts, num_rings), np.int64)
    for k in range(verts.shape[1]):
        np.add.at(ring, (verts[:, k], lo), 1)
        if num_rings > 1:
            np.add.at(ring, (verts[:, k], hi), 1)
    gm = np.asarray(gyro_map, np.int64).reshape(
        num_verts, num_rings, points_per_ring, 3)
    src = np.broadcast_to((ring / points_per_ring)[:, :, None, None],
                          gm.shape)
    ok = gm >= 0
    field = np.zeros(num_verts, np.float64)
    np.add.at(field, gm[ok], src[ok])
    return ring, field


def deposited_charge(ring_accum: np.ndarray, gyro_map: np.ndarray,
                     points_per_ring: int) -> float:
    """Total charge the mapped scatter conserves: each (vertex, ring) count
    times its ring weight, 3 mapped vertices per ring point inside the
    domain over the ring's points."""
    V, R = ring_accum.shape
    gm = np.asarray(gyro_map).reshape(V, R, points_per_ring, 3)
    weight = 3.0 * (gm[..., 0] >= 0).sum(axis=2) / points_per_ring
    return float((np.asarray(ring_accum, np.float64) * weight).sum())
