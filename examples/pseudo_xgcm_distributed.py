"""Distributed pseudoXGCm demo: BFS-buffered PICparts over a device mesh.

On real hardware the mesh axis spans the GPUs; without them, run on 8
virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/pseudo_xgcm_distributed.py [num_ptcls] [iters]

Per jitted SPMD step: rotation push -> grid-accelerated local search ->
safe-zone migration (neighbor-scoped ppermute) + diffusion load balancing ->
gyro-ring scatter -> fan-in/fan-out owner field sync.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from pumipic_jax.mesh import annulus_mesh
from pumipic_jax.models.pseudo_xgcm import GyroConfig, XGCmConfig, make_picparts_setup
from pumipic_jax.parallel.mesh_axis import make_device_mesh


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    device_mesh = make_device_mesh()
    coords, tris, cls = annulus_mesh(16, 96, 0.3, 1.0)
    cfg = XGCmConfig(
        num_ptcls=n,
        mdl_face=max(int(cls.max()) // 2, 2),
        deg_per_push=15.0,
        gyro=GyroConfig(num_rings=2, points_per_ring=4),
    )
    pp, state, gyro_map, step = make_picparts_setup(
        coords, tris, cls, cfg, device_mesh, use_lb=True
    )

    for i in range(iters):
        state, fwd, stats = step(state)
        jax.block_until_ready(fwd)
        print(
            f"iter {i}: alive={int(stats['alive'])} "
            f"migrated={int(stats['sent'])} "
            f"imbalance={float(jax.numpy.max(stats['imbalance'])):.3f} "
            f"overflow={int(stats['overflow'])}"
        )
    print("done:", len(device_mesh.devices.flat), "devices")


if __name__ == "__main__":
    main()
