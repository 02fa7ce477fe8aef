"""Field interpolation kernels.

Reference parity: ``src/pumipic_adjacency.hpp:772-799``
(``interpolateTetVtx`` barycentric vertex-field interpolation) and
``src/pumipic_utils.hpp:186-457`` (2D/3D structured-grid field interpolation
``interpolate2d*/interpolate3d_field/interp2dVector`` used by GITR-style
inputs).  All batched over particles.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def interpolate_vtx_field(
    field: jax.Array,
    elem2verts: jax.Array,
    elem: jax.Array,
    bcc: jax.Array,
) -> jax.Array:
    """Barycentric interpolation of a per-vertex field to particle positions.

    field: (V,) or (V, k); elem: (N,); bcc: (N, nvpe) vertex weights.
    Returns (N,) or (N, k).
    """
    verts = elem2verts[jnp.maximum(elem, 0)]        # (N, nvpe)
    vals = field[verts]                             # (N, nvpe[, k])
    if vals.ndim == 3:
        return jnp.sum(bcc[:, :, None] * vals, axis=1)
    return jnp.sum(bcc * vals, axis=-1)


def interpolate_2d_grid(
    grid: jax.Array,
    origin: jax.Array,
    dx: jax.Array,
    pts: jax.Array,
) -> jax.Array:
    """Bilinear interpolation on a uniform 2D grid.

    grid: (nx, ny[, k]); origin: (2,); dx: (2,) spacing; pts: (N, 2).
    Out-of-range points clamp to the boundary (reference clamps indices).
    """
    nx, ny = grid.shape[0], grid.shape[1]
    rel = (pts - origin) / dx
    i = jnp.clip(jnp.floor(rel[:, 0]).astype(jnp.int32), 0, nx - 2)
    j = jnp.clip(jnp.floor(rel[:, 1]).astype(jnp.int32), 0, ny - 2)
    fx = jnp.clip(rel[:, 0] - i, 0.0, 1.0)
    fy = jnp.clip(rel[:, 1] - j, 0.0, 1.0)
    if grid.ndim == 3:
        fx = fx[:, None]
        fy = fy[:, None]
    g00 = grid[i, j]
    g10 = grid[i + 1, j]
    g01 = grid[i, j + 1]
    g11 = grid[i + 1, j + 1]
    return (
        g00 * (1 - fx) * (1 - fy)
        + g10 * fx * (1 - fy)
        + g01 * (1 - fx) * fy
        + g11 * fx * fy
    )


def interpolate_3d_grid(
    grid: jax.Array,
    origin: jax.Array,
    dx: jax.Array,
    pts: jax.Array,
) -> jax.Array:
    """Trilinear interpolation on a uniform 3D grid.

    grid: (nx, ny, nz[, k]); origin: (3,); dx: (3,); pts: (N, 3).
    """
    nx, ny, nz = grid.shape[0], grid.shape[1], grid.shape[2]
    rel = (pts - origin) / dx
    i = jnp.clip(jnp.floor(rel[:, 0]).astype(jnp.int32), 0, nx - 2)
    j = jnp.clip(jnp.floor(rel[:, 1]).astype(jnp.int32), 0, ny - 2)
    k = jnp.clip(jnp.floor(rel[:, 2]).astype(jnp.int32), 0, nz - 2)
    f = jnp.stack(
        [
            jnp.clip(rel[:, 0] - i, 0.0, 1.0),
            jnp.clip(rel[:, 1] - j, 0.0, 1.0),
            jnp.clip(rel[:, 2] - k, 0.0, 1.0),
        ],
        axis=-1,
    )
    if grid.ndim == 4:
        f = f[:, :, None]
    out = 0.0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = (
                    (f[:, 0] if di else 1 - f[:, 0])
                    * (f[:, 1] if dj else 1 - f[:, 1])
                    * (f[:, 2] if dk else 1 - f[:, 2])
                )
                out = out + grid[i + di, j + dj, k + dk] * w
    return out


def interp_2d_vector(
    grid_rz: jax.Array,
    origin: jax.Array,
    dx: jax.Array,
    pts: jax.Array,
    cylindrical: bool = True,
) -> jax.Array:
    """2D (r,z)-grid vector field evaluated at 3D points, with cylindrical
    (r,theta,z) -> cartesian rotation (``interp2dVector``,
    pumipic_utils.hpp:~420-457)."""
    r = jnp.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    rz = jnp.stack([r, pts[:, 2]], axis=-1)
    v = interpolate_2d_grid(grid_rz, origin, dx, rz)  # (N, 3): (vr, vt, vz)
    if not cylindrical:
        return v
    theta = jnp.arctan2(pts[:, 1], pts[:, 0])
    ct, st = jnp.cos(theta), jnp.sin(theta)
    vx = v[:, 0] * ct - v[:, 1] * st
    vy = v[:, 0] * st + v[:, 1] * ct
    return jnp.stack([vx, vy, v[:, 2]], axis=-1)
