"""Core scalar types and small helpers.

Reference parity: ``support/ppTypes.h`` (lid_t=int, gid_t=long) and
``src/pumipic_kktypes.hpp`` (fp_t FP32/FP64 switch).  We default to
int32 local ids, int64 global ids (kept on host / as int32 pairs where
possible) and float32 reals; float64 is available by flipping
``jax_enable_x64`` plus these constants.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Local (on-device) id type: indexes elements/particles within one picpart.
LID_DTYPE = jnp.int32
# Global id type. Device code runs without jax_enable_x64; global ids live mostly in
# host-side numpy (partitioning, checkpointing). On device we carry them as
# int32 when the mesh is < 2^31 entities (asserted at build time).
GID_DTYPE = jnp.int32
GID_HOST_DTYPE = np.int64
# Real type for coordinates/fields.
REAL_DTYPE = jnp.float32

INVALID = -1  # sentinel for "no element / removed particle", as in reference


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (lane/row alignment of padded arrays)."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
