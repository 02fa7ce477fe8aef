"""Particle push kernels.

Reference parity:
- elliptical push (``test/ellipticalPush.hpp:36-71``): advance particles along
  ellipses centered at (h, k) with minor/major ratio d; angular speed scales
  with the element's geometric-model classification (inner regions slower by
  the 0.01 center factor).
- Boris push (``src/pumipic_push.hpp:17-74``): magnetized velocity update —
  half electric kick, magnetic rotation, half kick; then position update.
- straight-line push (``test/pseudoPushAndSearch.cpp:87-118``): displace along
  a fixed unit vector.

All kernels are fused elementwise maps over the flat particle axis (the
``ps::parallel_for`` analog).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# physical constants as used by the reference Boris push
ELEMENTARY_CHARGE = 1.60217662e-19
PROTON_MASS = 1.6737236e-27


def elliptical_setup(
    x: jax.Array, h: float, k: float, d: float
) -> Tuple[jax.Array, jax.Array]:
    """Compute each particle's polar angle ``phi`` and major-axis ``b`` from
    its position (``ellipticalPush::setup``, ellipticalPush.hpp:10-34)."""
    w = x[:, 0]
    z = x[:, 1]
    phi = jnp.arctan2(d * (z - k), w - h)
    sin_phi = jnp.sin(phi)
    # b = (z - k)/sin(phi); guard the sin==0 axis like the reference relies
    # on IEEE division (inf*0 handled by downstream cos/sin products).
    safe = jnp.where(jnp.abs(sin_phi) < 1e-12, 1e-12, sin_phi)
    b = (z - k) / safe
    return phi, b


def elliptical_push_components(
    phi: jax.Array,
    b: jax.Array,
    elem_class_id: jax.Array,
    deg: float,
    h: float,
    k: float,
    d: float,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Component form of :func:`elliptical_push`: returns (x, y, new_phi)
    as separate (N,) arrays — the flat layout the whole step keeps, so no
    (N, 2) intermediate is materialized."""
    cid = jnp.maximum(elem_class_id, 1).astype(phi.dtype)
    center_factor = jnp.where(elem_class_id == 1, 0.01, 1.0)
    dist_by_class = center_factor / cid
    deg_p = deg * dist_by_class
    rad = phi + deg_p * jnp.pi / 180.0
    a = b * d
    return a * jnp.cos(rad) + h, b * jnp.sin(rad) + k, rad


def elliptical_rot_table(
    elem_class_id: jax.Array, deg: float
) -> jax.Array:
    """Per-ELEMENT rotation table for the trig-free push: row e holds
    (cos Δe, sin Δe) where Δe is the per-step angle advance of particles in
    element e (deg · center_factor / class_id, ellipticalPush.hpp:36-71).

    The per-step trig then collapses to a 2×2 rotation of carried
    (cos φ, sin φ) — one 2-wide f32 row gather replaces class-id gather +
    sin/cos at particle rate.  The rows are :func:`rot_vals_from_class` of
    the element classes, so the table and gather-free arms agree bit for
    bit.
    """
    cd, sd = rot_vals_from_class(jnp.asarray(elem_class_id), deg)
    return jnp.stack([cd, sd], axis=1)


def rot_vals_from_class(cid_int: jax.Array, deg: float
                        ) -> Tuple[jax.Array, jax.Array]:
    """Elementwise (cos Δ, sin Δ) from integer class ids at particle rate —
    the gather-free form of :func:`elliptical_rot_table` for meshes whose
    classification is analytic in the element id
    (``AnnulusLocator2D.class_of`` on a ring_class-proven mesh, or
    :func:`class_from_bands`): the particle-rate rotation-table gather
    becomes elementwise arithmetic that fuses into the push."""
    cid = jnp.maximum(cid_int, 1).astype(jnp.float32)
    center_factor = jnp.where(cid_int == 1, 0.01, 1.0)
    delta = deg * center_factor / cid * (jnp.pi / 180.0)
    return jnp.cos(delta), jnp.sin(delta)


def detect_banded_class(cls) -> Optional[Tuple[int, ...]]:
    """Band-start element ids iff per-element classification is BAND-ORDERED:
    nondecreasing in the element id with consecutive integer values
    v0..v0+K-1.  True for every ring/flux-band stitched mesh whose elements
    are appended band by band (annulus_mesh, tokamak_mesh, the gmsh XGC
    imports: 52 bands at 24k elems, 120 at 120k) — the geometric-model
    classification pseudoXGCm drives (test/ellipticalPush.hpp:36-71).

    Returns ``starts`` with ``starts[j]`` = first element of band v0+j
    (``starts[0]`` is v0 itself, NOT an element id), or None if the mesh is
    not band-ordered.  Consumers evaluate class ids with
    :func:`class_from_bands` — pure fused compares, no table gather."""
    import numpy as np

    cls = np.asarray(cls).ravel()
    if cls.size == 0 or not np.issubdtype(cls.dtype, np.integer):
        return None
    if np.any(np.diff(cls) < 0):
        return None
    v0 = int(cls[0])
    vals = np.unique(cls)
    if not np.array_equal(vals, np.arange(v0, v0 + vals.size)):
        return None
    starts = np.searchsorted(cls, vals[1:])
    return (v0,) + tuple(int(s) for s in starts)


def class_from_bands(elem: jax.Array, starts: Tuple[int, ...]) -> jax.Array:
    """Per-particle class ids on a band-ordered mesh (detect_banded_class):
    cid = v0 + #{band starts <= elem}.  The K-1 compares against SCALAR
    constants fuse into one elementwise pass over ``elem`` — replacing the
    particle-rate class/rotation table gather with elementwise arithmetic
    (no table traffic; K <= ~120 on the XGC workloads)."""
    v0 = starts[0]
    cid = jnp.full(elem.shape, v0, jnp.int32)
    for s in starts[1:]:
        cid = cid + (elem >= s).astype(jnp.int32)
    return cid


def elliptical_push_rot_vals(
    cphi: jax.Array,
    sphi: jax.Array,
    b: jax.Array,
    cd: jax.Array,
    sd: jax.Array,
    h: float,
    k: float,
    d: float,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Trig-free elliptical push on pre-gathered per-particle rotation
    values (cd, sd) — pure elementwise, zero gathers.  The flagship step
    gets (cd, sd) captured by the previous search's walk
    (``search_mesh_2d_accel(aux_capture=rot_table)``), which removes the
    particle-rate rotation gather from the push entirely.

    Returns (x, y, new_cphi, new_sphi).  A Newton renormalization step
    (f = 1.5 - 0.5·(c²+s²)) keeps the carried unit vector from drifting in
    f32 across steps; equivalent to :func:`elliptical_push_components` to
    ~1e-5 over hundreds of steps (tests/test_models.py parity test).
    """
    c2 = cphi * cd - sphi * sd
    s2 = sphi * cd + cphi * sd
    f = 1.5 - 0.5 * (c2 * c2 + s2 * s2)
    c2 = c2 * f
    s2 = s2 * f
    return b * d * c2 + h, b * s2 + k, c2, s2


def elliptical_push_rot(
    cphi: jax.Array,
    sphi: jax.Array,
    b: jax.Array,
    elem: jax.Array,
    rot_table: jax.Array,
    h: float,
    k: float,
    d: float,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Trig-free elliptical push gathering the element's rotation row; see
    :func:`elliptical_push_rot_vals` for the gather-free capture variant.
    ``rot_table`` is the (E, 2) (cosΔ, sinΔ) table of
    :func:`elliptical_rot_table`."""
    r = rot_table[jnp.maximum(elem, 0)]
    return elliptical_push_rot_vals(
        cphi, sphi, b, r[:, 0], r[:, 1], h, k, d
    )


def elliptical_push(
    phi: jax.Array,
    b: jax.Array,
    elem_class_id: jax.Array,
    deg: float,
    h: float,
    k: float,
    d: float,
) -> Tuple[jax.Array, jax.Array]:
    """Advance along the ellipse by ``deg`` degrees scaled per classification.

    elem_class_id: (N,) class id of each particle's current element.
    Returns (new_xy (N,2), new_phi (N,)).
    """
    x, y, rad = elliptical_push_components(phi, b, elem_class_id, deg, h, k, d)
    return jnp.stack([x, y], axis=-1), rad


def boris_push(
    x: jax.Array,
    v: jax.Array,
    e_field: jax.Array,
    b_field: jax.Array,
    dt: float,
    charge: float = 1.0,
    amu: float = 10.0,
) -> Tuple[jax.Array, jax.Array]:
    """Boris rotation velocity update + position step, batched (N, 3).

    Follows ``pushBoris`` (pumipic_push.hpp:17-74): with
    q' = q·e/(amu·m_p)·dt/2 and coeff = 2q'/(1+(q'|B|)^2),
    v⁻ = v - q'E; v' = v⁻ + q'(v⁻×B); v⁺ = v⁻ + coeff(v'×B) + q'E;
    x ← x + v⁺ dt.

    Note: the reference *subtracts* the first half-kick (vel - qpE) and adds
    it back after rotation; we reproduce that exactly for parity.
    """
    b_mag = jnp.linalg.norm(b_field, axis=-1, keepdims=True)
    q_prime = charge * ELEMENTARY_CHARGE / (amu * PROTON_MASS) * dt * 0.5
    coeff = 2.0 * q_prime / (1.0 + (q_prime * b_mag) ** 2)

    qp_e = q_prime * e_field
    v_minus = v - qp_e
    v_prime = v_minus + q_prime * jnp.cross(v_minus, b_field)
    v_new = v_minus + coeff * jnp.cross(v_prime, b_field) + qp_e
    x_new = x + v_new * dt
    return x_new, v_new


def straight_line_push(
    x: jax.Array, direction: jax.Array, distance: float
) -> jax.Array:
    """x_tgt = x + distance * direction (pseudoPushAndSearch push)."""
    d = jnp.asarray(direction, dtype=x.dtype)
    return x + distance * d
