"""Adaptive per-rank slot capacity for distributed particle state.

Every particle-rate op in a jitted SPMD step runs at CAPACITY width (static
shapes): idle headroom is pure per-step cost.  The reference sizes its structures from
extra-padding inputs and re-allocates views when a rebuild's counts misfit
(particle_structs/src/scs/scs_input.hpp:15-64, SCS_rebuild.h:3-120); the
JAX analog is a HOST-side resize between steps — the jitted step simply
re-traces at the new width — driven by the step's own telemetry:

- ``alive_per_rank`` / ``sent_per_rank``: observed peak live width and
  migration volume size the needed capacity;
- ``kept_home``: the lossless admission quotas (parallel/migrate.py) park
  beyond-quota leavers at home when receivers lack free slots — sustained
  pressure means capacity is too tight and triggers growth.

Use :class:`CapacityMonitor`: feed it each step's stats, then call
``monitor.apply(state)`` at resize points (every K steps, or after load
shifts).  Resizes are rare by hysteresis; each one costs one re-jit —
the same economics as particle-structure capacity growth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CapacityPolicy",
    "CapacityMonitor",
    "resize_capacity",
]

# particle-id-like integer fields whose padding value is -1 (everything
# else pads with zeros; "active" pads False)
_ID_FIELDS = ("elem", "pid", "gelem")


def resize_capacity(state: Dict[str, jax.Array], new_cap: int
                    ) -> Dict[str, jax.Array]:
    """Resize a (R, cap, ...) flat particle-state dict to ``new_cap`` slots.

    Shrinking compacts each rank's live particles to a slot prefix first
    (stable order) so no live particle can fall off; growing appends empty
    slots.  Host-side by design — capacity is a static shape, so the jitted
    step re-traces at the new width (the reference re-allocates its views
    under the same conditions, SCS_rebuild.h:3-120).
    """
    sharding = state["active"].sharding
    act = np.asarray(jax.device_get(state["active"]))
    live_max = int(act.sum(axis=1).max())
    if new_cap < live_max:
        raise ValueError(f"new_cap {new_cap} < max live {live_max}")
    cur_cap = act.shape[1]
    if new_cap == cur_cap:
        return state
    out = {}
    if new_cap < cur_cap:
        order = np.argsort(~act, axis=1, kind="stable")[:, :new_cap]
        for k, v in state.items():
            vh = np.asarray(jax.device_get(v))
            a = np.take_along_axis(vh, order, axis=1)
            keep = np.take_along_axis(act, order, axis=1)
            if k in _ID_FIELDS:
                a = np.where(keep, a, -1)
            elif k == "active":
                a = keep
            out[k] = jax.device_put(jnp.asarray(a), sharding)
    else:
        pad = new_cap - cur_cap
        for k, v in state.items():
            vh = np.asarray(jax.device_get(v))
            widths = ((0, 0), (0, pad)) + ((0, 0),) * (vh.ndim - 2)
            fill = -1 if k in _ID_FIELDS else (
                False if k == "active" else 0)
            a = np.pad(vh, widths, constant_values=fill)
            out[k] = jax.device_put(jnp.asarray(a), sharding)
    return out


@dataclass(frozen=True)
class CapacityPolicy:
    """Hysteresis rules for telemetry-driven capacity resizes.

    needed = max_alive * alive_headroom + sent_factor * max(max_sent,
    sent_floor) + slack — the peak live width plus room for several steps'
    worth of simultaneous arrivals (arrivals land before leavers' slots are
    observed free by OTHER ranks' quota negotiation, so one step's volume
    is not enough headroom).
    """

    alive_headroom: float = 1.02
    sent_factor: int = 4
    sent_floor: int = 16
    slack: int = 64
    # shrink only when it saves at least this fraction of current capacity
    # (a resize costs one re-jit; don't chase single-digit slot savings)
    shrink_min_gain: float = 0.05
    # grow when needed exceeds capacity, or quota pressure parked leavers
    grow_factor: float = 1.25

    def needed(self, max_alive: int, max_sent: int) -> int:
        return (int(max_alive * self.alive_headroom)
                + self.sent_factor * max(max_sent, self.sent_floor)
                + self.slack)


class CapacityMonitor:
    """Accumulates per-step telemetry and recommends capacity resizes.

    >>> mon = CapacityMonitor()
    >>> for _ in range(3):
    ...     state, fwd, stats = step(state)
    ...     mon.observe(stats)
    >>> state = mon.apply(state)        # shrink/grow if warranted
    """

    def __init__(self, policy: CapacityPolicy = CapacityPolicy()):
        self.policy = policy
        self.max_alive = 0
        self.max_sent = 0
        self.kept_home = 0
        self.steps = 0

    def observe(self, stats: Dict[str, jax.Array]) -> None:
        """Feed one step's stats dict (needs ``alive_per_rank`` and
        ``sent_per_rank``; ``kept_home`` when the step reports it)."""
        self.max_alive = max(self.max_alive, int(np.asarray(
            jax.device_get(stats["alive_per_rank"])).max()))
        self.max_sent = max(self.max_sent, int(np.asarray(
            jax.device_get(stats["sent_per_rank"])).max()))
        if "kept_home" in stats:
            self.kept_home += int(jax.device_get(stats["kept_home"]))
        self.steps += 1

    def recommend(self, cur_cap: int) -> Optional[int]:
        """New capacity, or None to keep the current one."""
        if self.steps == 0:
            return None
        need = self.policy.needed(self.max_alive, self.max_sent)
        if need > cur_cap or self.kept_home > 0:
            # under-capacity: observed need exceeds width, or admission
            # quotas had to park leavers — grow with headroom so the next
            # burst fits without an immediate second re-jit.  Growth is
            # taken from CURRENT capacity too: under receiver-side quota
            # pressure ``need`` (sized from max_alive/max_sent) can sit at
            # or below cur_cap, and a +1-slot resize per window would pay
            # a full re-jit for nothing (ADVICE r4).
            return max(int(need * self.policy.grow_factor),
                       int(cur_cap * self.policy.grow_factor), cur_cap + 1)
        if need <= cur_cap * (1.0 - self.policy.shrink_min_gain):
            return need
        return None

    def apply(self, state: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
        """Resize ``state`` per :meth:`recommend` and reset the window
        (telemetry from the old width doesn't describe the new one)."""
        cur_cap = state["active"].shape[1]
        new_cap = self.recommend(cur_cap)
        if new_cap is None:
            return state
        out = resize_capacity(state, new_cap)
        self.max_alive = self.max_sent = self.kept_home = self.steps = 0
        return out
