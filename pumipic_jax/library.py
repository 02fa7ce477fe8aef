"""Framework initialization: the ``pumipic::Library`` analog.

The reference's Library nests MPI/PCU/Kokkos/Omega_h init+finalize with
ownership flags (src/pumipic_library.cpp:5-30).  In single-controller JAX
the runtime is already alive; this object pins the session-level choices —
device mesh, timing registry, debug checks — and is the one-stop context an
application holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from pumipic_jax.parallel.mesh_axis import make_device_mesh
from pumipic_jax.utils import timing


@dataclasses.dataclass
class Library:
    """Session context: device mesh + observability switches.

    ``debug_checks`` enables jax_debug_nans (the reference's closest analog
    to its Valgrind/assert builds, SURVEY.md §5 'race detection').
    """

    num_devices: Optional[int] = None
    enable_timing: bool = True
    debug_checks: bool = False

    def __post_init__(self):
        self.device_mesh = make_device_mesh(self.num_devices)
        if self.enable_timing:
            timing.enable_timing()
        else:
            timing.disable_timing()
        if self.debug_checks:
            jax.config.update("jax_debug_nans", True)

    @property
    def world_size(self) -> int:
        return int(self.device_mesh.size)

    def summarize(self) -> str:
        return timing.summarize_time()

    def finalize(self) -> None:
        """Print timing summary; mirror of the reference's teardown order."""
        if self.enable_timing:
            self.summarize()
        if self.debug_checks:
            jax.config.update("jax_debug_nans", False)
