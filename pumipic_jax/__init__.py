"""pumipic_jax — an unstructured-mesh Particle-In-Cell framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of SCOREC/pumi-pic
(reference layout documented in SURVEY.md):

- ``mesh``       device-resident unstructured simplex meshes (tri/tet) with
                 precomputed adjacencies (replaces the used subset of Omega_h).
- ``particles``  mesh-aware particle containers (SCS / CSR / CabM / DPS
                 analogs) as fixed-capacity structure-of-arrays pytrees.
- ``ops``        particle-mesh compute: adjacency-walk search, pushes, field
                 interpolation, charge scatter — all jittable.
- ``parallel``   PICpart mesh distribution, particle migration, owner
                 reductions and diffusive load balancing over a
                 ``jax.sharding.Mesh`` (replaces MPI/EnGPar).
- ``models``     mini-app workloads (pseudoXGCm, pseudoPushAndSearch, search2d).
- ``utils``      timing registry, logging, configs, RNG, memory telemetry.
"""

__version__ = "0.1.0"

from pumipic_jax.utils import timing, plog  # noqa: F401
