"""Distributor: neighbor-subset communicator metadata.

Reference parity: ``Distributor<Space>`` (particle_structs/src/support/
psDistributor.hpp:9-137) — the rank list a structure's migrate may exchange
with (buffered peers), so exchanges are O(neighbors) instead of O(world)
(SCS_migrate.h:41-62).

A collective all_to_all already moves empty buckets at little cost, so
the Distributor's role shifts to (a) declaring which destinations are LEGAL
(a particle routed to a non-neighbor is a correctness bug caught here) and
(b) sizing per-destination bucket capacities from the neighbor structure
rather than the world.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np



def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Distributor:
    """is_neighbor[r, s]: rank r may send particles to rank s."""

    is_neighbor: jax.Array    # (R, R) bool, diagonal always True
    num_ranks: int = _static_field(default=1)

    def neighbor_counts(self) -> jax.Array:
        return jnp.sum(self.is_neighbor, axis=1)

    def validate_dests(self, dest_rank: jax.Array, active: jax.Array,
                       me: jax.Array) -> jax.Array:
        """() int32 count of illegally-routed particles (should be 0)."""
        legal = self.is_neighbor[me, jnp.clip(dest_rank, 0, self.num_ranks - 1)]
        return jnp.sum((active & ~legal).astype(jnp.int32))


def world_distributor(num_ranks: int) -> Distributor:
    """Default world communicator (Distributor() with no rank list)."""
    return Distributor(
        is_neighbor=jnp.ones((num_ranks, num_ranks), bool),
        num_ranks=num_ranks,
    )


def from_picparts(pp) -> Distributor:
    """Neighbors = ranks owning any element buffered in my picpart (the
    reference builds this from the buffered-parts list)."""
    eo = np.asarray(pp.elem_owner)
    R = pp.num_ranks
    nb = np.zeros((R, R), bool)
    for r in range(R):
        owners = np.unique(eo[r][eo[r] >= 0])
        nb[r, owners] = True
        nb[r, r] = True
    return Distributor(is_neighbor=jnp.asarray(nb), num_ranks=R)
