"""FULL-buffer distributed mode: pure particle data-parallelism.

Reference parity: ``Input::FULL`` — every rank holds the complete mesh, the
whole domain is the safe zone, so particles never migrate and mesh-field
reductions collapse to a host ``MPI_Allreduce``
(``src/pumipic_comm.cpp:233-247``).  This is the reference's easiest
distribution and the most natural one here: particles are sharded along
their flat axis over the device mesh, the mesh is replicated, and every
per-step field reduction is a single ``psum`` (on a multi-slice
("slice", "ranks") mesh XLA lowers the tuple-axis psum to the hierarchical
reduce itself).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pumipic_jax.parallel.mesh_axis import RANK_AXIS, mesh_axes, num_ranks


def reduce_vertex_field(field: jax.Array, axis_name=RANK_AXIS) -> jax.Array:
    """reduceCommArray(FULL, SUM) analog: allreduce over the rank axis (or
    axes).  Call inside a shard_map body."""
    return jax.lax.psum(field, axis_name)


def shard_particles(mesh: Mesh, arrays, pad_value=0):
    """Place flat particle arrays (leading axis N) sharded over ranks,
    padding N up to a multiple of the rank count."""
    n_ranks = num_ranks(mesh)
    spec = P(mesh_axes(mesh))

    def place(x):
        n = x.shape[0]
        rem = (-n) % n_ranks
        if rem:
            pad = jnp.full((rem,) + x.shape[1:], pad_value, x.dtype)
            x = jnp.concatenate([x, pad])
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, arrays)


def make_dp_step(mesh: Mesh, per_device_step: Callable):
    """Wrap a single-device step ``(local_state) -> (local_state, fields)``
    into an SPMD step where ``fields`` (per-vertex arrays) are psummed.

    ``per_device_step`` must be shape-local (it is — all our kernels are).
    Works unchanged on a multi-slice ("slice", "ranks") mesh: the axis-name
    tuple is the flattened rank axis.
    """
    ax = mesh_axes(mesh)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(ax),),
        out_specs=(P(ax), P()),
        check_vma=False,
    )
    def step(local_state):
        new_state, fields = per_device_step(local_state)
        fields = jax.tree_util.tree_map(
            lambda f: jax.lax.psum(f, ax), fields
        )
        return new_state, fields

    return jax.jit(step)
