"""Distributed 3D pseudoPushAndSearch demo: tet-mesh PICparts + LB +
structure-integrated migration (the reference's 2-rank
test/pseudoPushAndSearch.cpp run, scaled over a device mesh).

On real hardware the mesh axis spans the GPUs; without them, run on 8
virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/pseudo_push_search_3d_distributed.py [num_ptcls] [iters]

Per jitted SPMD step: straight-line push -> 3D adjacency walk from the
previous element -> safe-zone routing + diffusion load balancing ->
bucketed neighbor migration with the chosen ParticleStructure layout
rebuilt on arrival.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

from pumipic_jax.mesh.generate import box_tet_mesh
from pumipic_jax.models.pseudo_push_and_search import (
    PushSearchConfig,
    make_picparts_setup_3d,
)
from pumipic_jax.parallel.mesh_axis import make_device_mesh


def main():
    num_ptcls = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    coords, tets = box_tet_mesh(6, 6, 6)
    cfg = PushSearchConfig(
        num_ptcls=num_ptcls,
        num_iterations=iters,
        distance=0.1,
        push_dir=(1.0, 0.7, 0.4),
        structure="csr",
        use_locator=False,
    )
    mesh = make_device_mesh()
    pp, ps, step = make_picparts_setup_3d(coords, tets, cfg, mesh, use_lb=True)

    for i in range(iters):
        ps, stats = step(ps)
        print(
            f"iter {i}: alive={int(stats['alive'])} "
            f"migrated={int(stats['sent'])} "
            f"imbalance={float(stats['imbalance']):.3f} "
            f"overflow={int(stats['overflow'])}"
        )
        assert int(stats["overflow"]) == 0
    print(f"done: {len(jax.devices())} devices")


if __name__ == "__main__":
    main()
