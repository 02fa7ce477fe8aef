"""Device-mesh helpers: the JAX analog of the reference's MPI communicator
setup (``pumipic::Library``, src/pumipic_library.cpp:5-30).

A flat axis ``"ranks"`` plays the role of MPI_COMM_WORLD: each device holds
one PICpart (or one particle shard in FULL-buffer mode).  Multi-slice
topologies (several ICI-connected slices joined by DCN — the reference's
multi-node MPI envelope, support/ViewComm.h:16-293) reshape the devices
into ("slice", "ranks"); every collective in this package goes through the
axis NAMES, so the same step runs on either topology:

- JAX collectives accept the axis-name tuple directly (``psum``,
  ``all_to_all``, ``ppermute``, ``all_gather``, ``axis_index`` all treat
  ("slice", "ranks") as the flattened rank axis, row-major) — flat-rank
  semantics are free.
- :func:`hier_all_to_all` additionally provides the DCN-aware two-stage
  routing (within-slice redistribution over ICI, then ONE aggregated
  slice-transpose over DCN) used by ``reduce_comm_array``/``migrate`` when
  asked — the hierarchical-collective recipe, bit-identical to the flat
  exchange.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RANK_AXIS = "ranks"
SLICE_AXIS = "slice"

AxisName = Union[str, Tuple[str, ...]]


def make_device_mesh(num_devices: Optional[int] = None, devices=None,
                     slices: int = 1) -> Mesh:
    """Build the device mesh.  ``slices > 1`` splits the devices into a
    ("slice", "ranks") topology of ``slices`` groups (devices are assumed
    ordered so consecutive blocks share a slice, which is how JAX enumerates
    multi-slice platforms)."""
    devs = devices if devices is not None else jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    devs = np.asarray(devs)
    if slices > 1:
        if len(devs) % slices:
            raise ValueError(
                f"{len(devs)} devices do not split into {slices} slices")
        return Mesh(devs.reshape(slices, -1), (SLICE_AXIS, RANK_AXIS))
    return Mesh(devs, (RANK_AXIS,))


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axis-name tuple to use as ``axis_name`` in collectives and as the
    (single-dim) sharding spec: ("ranks",) or ("slice", "ranks")."""
    return tuple(mesh.axis_names)


def num_ranks(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Particles sharded along their flat axis (over every mesh axis)."""
    return NamedSharding(mesh, P(mesh_axes(mesh)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def hier_all_to_all(x: jax.Array, axis_name: AxisName,
                    ranks_per_slice: Optional[int] = None) -> jax.Array:
    """All-to-all over the flattened rank axis, routed hierarchically when
    ``axis_name`` is a ("slice", "ranks") pair: stage A redistributes rows
    WITHIN each slice (ICI) so each rank holds the blocks destined to its
    rank-coordinate, stage B is one aggregated slice transpose (DCN).
    Bit-identical to ``lax.all_to_all(x, axis_name, 0, 0)`` — verified in
    tests/test_comm.py — but the inter-slice traffic moves as one
    contiguous block per slice pair instead of R_total scattered rows.

    ``x``: (R_total, ...) with row p = payload for flat rank p (row-major
    (slice, rank) order).  Returns (R_total, ...) with row q = payload from
    flat rank q.
    """
    if isinstance(axis_name, str) or len(axis_name) == 1:
        ax = axis_name if isinstance(axis_name, str) else axis_name[0]
        return jax.lax.all_to_all(x, ax, split_axis=0, concat_axis=0,
                                  tiled=False)
    if len(axis_name) != 2:
        raise ValueError(f"expected 1 or 2 axis names, got {axis_name!r}")
    slice_axis, rank_axis = axis_name
    rs = ranks_per_slice if ranks_per_slice is not None else (
        jax.lax.axis_size(rank_axis))
    s = x.shape[0] // rs
    xr = x.reshape((s, rs) + x.shape[1:])
    # stage A (ICI): in-slice redistribution by destination rank-coordinate
    y = jax.lax.all_to_all(xr, rank_axis, split_axis=1, concat_axis=1,
                           tiled=False)
    # stage B (DCN): one aggregated slice transpose
    z = jax.lax.all_to_all(y, slice_axis, split_axis=0, concat_axis=0,
                           tiled=False)
    # z[s1, r1] = payload from flat rank s1*rs + r1 — flat source order
    return z.reshape(x.shape)
