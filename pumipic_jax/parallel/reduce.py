"""Mesh-field reduction across buffered picpart copies.

Reference parity: ``Mesh::reduceCommArray`` (``src/pumipic_comm.cpp:222-440``)
— fan-in: every rank sends its copies of non-owned boundary entities to the
owner, which applies SUM/MAX/MIN as receives complete; fan-out: the owner
broadcasts the reduced core values back to the copy holders.  Ops enum
SUM/MAX/MIN/BCAST (src/pumipic_mesh.hpp:65-70).

The reference's per-neighbor Isend/Irecv + MPI_Waitany unpack
loop becomes ONE ``lax.all_to_all`` over fixed-shape per-rank-pair exchange
tables precomputed at picpart build (``vert_send_ids``/``vert_recv_ids``),
followed by a segment reduction.  Call these inside a ``shard_map`` body with the
LOCAL views (see :func:`pumipic_jax.parallel.picparts.local_view`).
"""
from __future__ import annotations

from enum import Enum
import jax
import jax.numpy as jnp

from pumipic_jax.parallel.mesh_axis import RANK_AXIS, hier_all_to_all


class Op(Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    BCAST = "bcast"


def _exchange(vals, axis_name, hier: bool):
    """(R, K[, k]) pairwise exchange: flat all_to_all, or the DCN-aware
    two-stage route on a ("slice", "ranks") mesh (bit-identical;
    mesh_axis.hier_all_to_all)."""
    if hier and not isinstance(axis_name, str) and len(axis_name) == 2:
        return hier_all_to_all(vals, axis_name)
    return jax.lax.all_to_all(
        vals, axis_name, split_axis=0, concat_axis=0, tiled=False)


def _gather_rows(field, ids, fill_value):
    """field[(ids)] with -1 ids producing fill_value."""
    safe = jnp.maximum(ids, 0)
    vals = field[safe]
    mask = (ids >= 0)
    if vals.ndim > mask.ndim:
        mask = mask[..., None]
    return jnp.where(mask, vals, fill_value)


def reduce_comm_array(
    send_ids: jax.Array,     # (R, Kv) local: my copies' ids grouped by owner
    recv_ids: jax.Array,     # (R, Kv) local: my owned ids grouped by holder
    field: jax.Array,        # (V[, k]) local per-vertex array
    op: Op = Op.SUM,
    axis_name=RANK_AXIS,
    hier: bool = False,
) -> jax.Array:
    """Fan-in + fan-out owner reduction of a per-entity array (call inside
    shard_map).  Returns the reduced-and-rebroadcast field, identical on
    every rank holding a copy of each entity.

    ``axis_name`` may be the ("slice", "ranks") tuple of a multi-slice
    mesh (flat-rank semantics).  ``hier=True`` additionally routes both
    exchanges through the two-stage within-slice/across-slice collective
    (ICI redistribution + one aggregated DCN transpose per direction) —
    bit-identical results, DCN-friendly traffic shape."""
    V = field.shape[0]
    R, K = send_ids.shape

    if op is not Op.BCAST:
        neutral = {
            Op.SUM: 0.0,
            Op.MAX: -jnp.inf,
            Op.MIN: jnp.inf,
        }[op]
        if not jnp.issubdtype(field.dtype, jnp.floating):
            info = jnp.iinfo(field.dtype)
            neutral = {Op.SUM: 0, Op.MAX: info.min, Op.MIN: info.max}[op]

        # fan-in: my copies -> owners
        send_vals = _gather_rows(field, send_ids, neutral)      # (R, K[, k])
        recv_vals = _exchange(send_vals, axis_name, hier)
        # (R, K[, k]) row s = copies of my owned entities held by rank s

        keys = jnp.where(recv_ids >= 0, recv_ids, V).reshape(-1)
        flat = recv_vals.reshape((R * K,) + recv_vals.shape[2:])
        if op is Op.SUM:
            contrib = jax.ops.segment_sum(flat, keys, num_segments=V + 1)[:V]
            field = field + contrib
        elif op is Op.MAX:
            contrib = jax.ops.segment_max(flat, keys, num_segments=V + 1)[:V]
            field = jnp.maximum(field, contrib)
        else:
            contrib = jax.ops.segment_min(flat, keys, num_segments=V + 1)[:V]
            field = jnp.minimum(field, contrib)

    # fan-out: owners broadcast reduced values back along the same routes
    out_vals = _gather_rows(field, recv_ids, 0.0 if jnp.issubdtype(field.dtype, jnp.floating) else 0)
    back = _exchange(out_vals, axis_name, hier)
    # (R, K[, k]) row o = my copies' reduced values from owner o

    tgt = jnp.where(send_ids >= 0, send_ids, V).reshape(-1)
    flat_back = back.reshape((R * K,) + back.shape[2:])
    field = field.at[tgt].set(flat_back, mode="drop")
    return field
