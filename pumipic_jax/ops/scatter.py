"""Charge scatter / deposition kernels.

Reference parity: ``test/gyroScatter.hpp`` —
- ``accumulateToRings`` (:183-205): every particle deposits into the two gyro
  rings bracketing its gyro-radius, at each vertex of its parent element
  (device atomics in the reference).
- ``scatterToMappedVerts`` (:207-225): per-(vertex, ring, ring-point), the
  accumulated value (averaged over points-per-ring) is scattered to the three
  vertices of the element containing the projected ring point, via the
  precomputed gyro-avg map.

The particle-rate stage is an int32 histogram, exact in any order of
addition.  The mesh-rate stages are f32 ``segment_sum`` scatters; on a GPU
they lower to atomic adds whose order can change from run to run, so the
deposited field is reproducible to rounding, not bit for bit (as with the
reference's atomics).  Both phases are linear operators with *static*
index structure, so the framework also exposes a fused path where the
ring-point map is applied as a single gather/segment-sum pipeline.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def count_per_key(key: jax.Array, num_keys: int) -> jax.Array:
    """Histogram of int keys in [0, num_keys) as int32 counts; keys outside
    that range (callers pass ``num_keys`` as the overflow bucket for
    inactive particles) are ignored.

    One integer scatter-add: exact, and independent of the order in which
    the adds land (GPU atomics included)."""
    key = jnp.where((key >= 0) & (key < num_keys), key, num_keys)
    counts = jnp.zeros((num_keys + 1,), jnp.int32).at[key].add(1)
    return counts[:num_keys]


def particles_per_element(
    elem: jax.Array, active: jax.Array, num_elems: int, weights: jax.Array | None = None
) -> jax.Array:
    """Count (or weight-sum) particles per element as f32.  Counts use the
    integer histogram; weighted sums use a segment_sum."""
    if weights is None:
        key = jnp.where(active, elem, num_elems).astype(jnp.int32)
        return count_per_key(key, num_elems).astype(jnp.float32)
    w = jnp.where(active, weights, 0.0)
    seg = jnp.where(active, elem, num_elems)  # inactive -> overflow bucket
    out = jax.ops.segment_sum(w, seg, num_segments=num_elems + 1)
    return out[:num_elems]


def accumulate_to_rings(
    elem: jax.Array,
    active: jax.Array,
    elem2verts: jax.Array,
    num_verts: int,
    num_rings: int,
    gyro_rmax: float,
    ptcl_radius: jax.Array | None = None,
) -> jax.Array:
    """Deposit particles into the two rings bracketing their gyro radius at
    each vertex of their parent element.  Returns (num_verts, num_rings).

    ``ptcl_radius``: per-particle gyro radius; defaults to the reference's
    placeholder 1.125×ring-width (gyroScatter.hpp:185 'TODO compute the
    radius').
    """
    ring_width = gyro_rmax / num_rings
    num_elems = elem2verts.shape[0]
    nvpe = elem2verts.shape[1]
    R = num_rings

    # Stage 1: per-(element, ring) counts — O(N) scatter-adds.  The naive
    # per-particle-per-vertex scatter costs 2*nvpe*N adds; counting at
    # element granularity first cuts the particle-rate scatter 6x, and the
    # vertex expansion then runs at mesh size (E*nvpe*R adds, negligible).
    if R == 1:
        # degenerate single-ring config: both brackets coincide, deposit
        # each particle ONCE.  (The general paths assume R >= 2: rd=-1
        # would wrap `.at[:, -1]` onto ring 0 and double-count, and the
        # per-particle clip(lo=0, hi=R-2=-1) would shift keys to elem-1 —
        # round-5 review finding, regression test_gyro_scatter_one_ring.)
        key = jnp.where(active, elem, num_elems).astype(jnp.int32)
        elem_ring = count_per_key(key, num_elems).astype(jnp.float32)[:, None]
    elif ptcl_radius is None:
        # uniform radius (the reference's 1.125*ringWidth placeholder,
        # gyroScatter.hpp:185): ring pair is the same for every particle
        rd = min(max(int(1.125) - 1, 0), R - 2)
        ru = rd + 1
        key = jnp.where(active, elem, num_elems).astype(jnp.int32)
        counts = count_per_key(key, num_elems).astype(jnp.float32)
        elem_ring = (
            jnp.zeros((num_elems, R), jnp.float32)
            .at[:, rd].add(counts)
            .at[:, ru].add(counts)
        )
    else:
        # per-particle radius: each particle counts at its two bracketing
        # (element, ring) keys of one E·R histogram
        rd = jnp.clip(
            jnp.floor(ptcl_radius / jnp.float32(ring_width)) - 1.0,
            0.0, R - 2,
        ).astype(jnp.int32)
        ER = num_elems * R
        key = jnp.where(active, elem.astype(jnp.int32) * R + rd, ER)
        counts = count_per_key(key, ER) + count_per_key(key + 1, ER)
        elem_ring = counts.astype(jnp.float32).reshape(num_elems, R)

    # Stage 2: expand per-element ring counts to the element's vertices
    # (mesh-sized segment_sum in place of the reference's atomics)
    keys = (elem2verts[:, :, None] * R
            + jnp.arange(R, dtype=elem2verts.dtype)[None, None, :])  # (E,nvpe,R)
    vals = jnp.broadcast_to(elem_ring[:, None, :], (num_elems, nvpe, R))
    out = jax.ops.segment_sum(
        vals.reshape(-1), keys.reshape(-1), num_segments=num_verts * R
    )
    return out.reshape(num_verts, num_rings)


def scatter_to_mapped_verts(
    ring_accum: jax.Array,
    gyro_map: jax.Array,
    num_verts: int,
    num_rings: int,
    points_per_ring: int,
) -> jax.Array:
    """Apply the gyro-average map: (V, R) ring accumulation -> (V,) weights.

    gyro_map: (V * R * P * 3,) vertex ids (-1 = ring point outside domain),
    laid out [vertex][ring][point][3 mapped verts] exactly like the
    reference's ``gyro_avg_map`` (gyroScatter.hpp:70-92).
    """
    V, R, P = num_verts, num_rings, points_per_ring
    vals = ring_accum / P                                # (V, R)
    # expand to (V, R, P, 3)
    vals_exp = jnp.broadcast_to(vals[:, :, None, None], (V, R, P, 3)).reshape(-1)
    idx = gyro_map.astype(jnp.int32)
    idx = jnp.where(idx >= 0, idx, V)                    # invalid -> overflow
    out = jax.ops.segment_sum(vals_exp, idx, num_segments=V + 1)
    return out[:V]


def gyro_scatter(
    elem: jax.Array,
    active: jax.Array,
    elem2verts: jax.Array,
    gyro_map: jax.Array,
    num_verts: int,
    num_rings: int,
    points_per_ring: int,
    gyro_rmax: float,
) -> jax.Array:
    """Full gyroScatter (gyroScatter.hpp:169-232): ring accumulate + mapped
    scatter, returning the (V,) vertex tag array."""
    ring_accum = accumulate_to_rings(
        elem, active, elem2verts, num_verts, num_rings, gyro_rmax
    )
    return scatter_to_mapped_verts(
        ring_accum, gyro_map, num_verts, num_rings, points_per_ring
    )


def scatter_to_verts_bcc(
    elem: jax.Array,
    active: jax.Array,
    bcc: jax.Array,
    elem2verts: jax.Array,
    num_verts: int,
    charge: jax.Array | None = None,
) -> jax.Array:
    """Standard PIC charge deposition: barycentric-weighted scatter of
    particle charge to parent-element vertices.  (N,), (N,k) -> (V,)."""
    verts = elem2verts[jnp.maximum(elem, 0)]            # (N, k)
    q = jnp.ones(elem.shape, bcc.dtype) if charge is None else charge
    w = bcc * q[:, None]
    idx = jnp.where(active[:, None], verts, num_verts)
    out = jax.ops.segment_sum(
        w.reshape(-1), idx.reshape(-1), num_segments=num_verts + 1
    )
    return out[:num_verts]
