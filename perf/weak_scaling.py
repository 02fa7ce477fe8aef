"""Weak scaling of the full BFS-picparts step on virtual CPU devices.

Fixed
particles per rank, rank counts 1/2/4/8, full pipeline (push → local
search → neighbor-scoped migration + LB → gyro scatter → fan-in/fan-out
sync).  CPU timings say nothing of a GPU; this validates collective
structure, migration volume and imbalance stay bounded as ranks grow.

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python perf/weak_scaling.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from pumipic_jax.mesh.generate import annulus_mesh
from pumipic_jax.models.pseudo_xgcm import (
    GyroConfig, XGCmConfig, make_picparts_setup,
)
from pumipic_jax.parallel.mesh_axis import make_device_mesh


def main():
    per_rank = int(os.environ.get("WS_PTCLS_PER_RANK", 20_000))
    elems = int(os.environ.get("WS_ELEMS", 4_800))
    steps = int(os.environ.get("WS_STEPS", 5))
    ranks = [int(r) for r in os.environ.get("WS_RANKS", "1,2,4,8").split(",")]

    n_rings = max(int(np.sqrt(elems / 8)), 2)
    n_sectors = elems // (2 * n_rings)
    coords, tris, cls = annulus_mesh(n_rings, n_sectors, 0.3, 1.0)

    print(f"{'ranks':>5} {'ptcls':>9} {'ms/step':>8} {'migr/step':>10} "
          f"{'imb':>6} {'ovf':>4}")
    for R in ranks:
        if R > len(jax.devices()):
            continue
        cfg = XGCmConfig(
            num_ptcls=per_rank * R,
            mdl_face=max(int(cls.max()) // 2, 2),
            deg_per_push=15.0,
            max_search_iters=64,
            gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        )
        mesh = make_device_mesh(R)
        pp, state, gyro_map, step = make_picparts_setup(
            coords, tris, cls, cfg, mesh, use_lb=True,
        )
        state, fwd, stats = step(state)
        jax.block_until_ready(fwd)
        t0 = time.perf_counter()
        sent = 0
        ovf = 0
        for _ in range(steps):
            state, fwd, stats = step(state)
            sent += int(stats["sent"])
            ovf += int(stats["overflow"])
        jax.block_until_ready(fwd)
        dt = (time.perf_counter() - t0) / steps * 1e3
        print(f"{R:>5} {per_rank * R:>9} {dt:>8.1f} {sent // steps:>10} "
              f"{float(stats['imbalance']):>6.2f} {ovf:>4}", flush=True)


if __name__ == "__main__":
    main()
