"""Benchmark: pseudoXGCm timestep throughput on one GPU.

Workload: push + search + rebuild + gyroScatter at 10M particles, whole
step as one jitted on-device function.  The metric-of-record arm is the
IMPORTED-MESH general-walk path — the 120k-element tokamak gmsh workload
(data/xgc_like_120k.msh.gz, the XGC-mesh analog of the reference's
production runs, test/testing.cmake:123-130) through the default auto
policy: cartesian locator peel + banded rotation + BCC walk.  No
detection-proof shortcut applies to imported meshes; the analytic
structured-annulus arm records via BENCH_MESH=annulus.  The particle
container is the DPS-equivalent flat layout, so "rebuild" is the DPS
semantics (parent-element + activity rewrite, dps_rebuild.hpp) — the
deposition is an order-free histogram.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

``detail`` names the device (platform, device_kind, count, and the
nvidia-smi name and power limit).  The benchmark refuses to run anywhere
but on a GPU.

vs_baseline: the reference publishes no in-tree numbers; the proxy
baseline is 2e7 particle-steps/s/GPU for the Kokkos pipeline on a V100
(order-of-magnitude from the SCALA'19 particle-structure paper's setup).
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

PROXY_BASELINE_PTCLS_PER_SEC = 2.0e7


def main():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    num_ptcls = int(os.environ.get("BENCH_PTCLS", 10_000_000))
    mesh_elems = int(os.environ.get("BENCH_ELEMS", 24_000))
    iters = int(os.environ.get("BENCH_ITERS", 20))

    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig,
        XGCmConfig,
        make_default_mesh,
        make_dp_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    mode = os.environ.get("BENCH_MODE", "dp")  # dp | picparts | pps3d
    # BENCH_MESH: path to a .msh/.msh.gz file, or "annulus" for the
    # in-memory structured generator (detection-proven analytic-locate
    # arm).  The dp default is the imported 120k tokamak workload — the
    # metric-of-record arm (see module docstring).
    mesh_path = os.environ.get("BENCH_MESH", "")
    if mesh_path in ("annulus", "gen", "none"):
        mesh_path = ""
    elif not mesh_path and mode == "dp":
        default_mesh = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "data", "xgc_like_120k.msh.gz")
        if os.path.exists(default_mesh):
            mesh_path = default_mesh
    if mesh_path:
        from pumipic_jax.mesh.core import Mesh2D
        from pumipic_jax.mesh.gmsh import read_msh

        m_coords, m_tris, m_cls = read_msh(mesh_path)
        mesh = Mesh2D.from_arrays(m_coords, m_tris, m_cls)
    else:
        mesh = make_default_mesh(mesh_elems)
    cfg = XGCmConfig(
        num_ptcls=num_ptcls,
        mdl_face=max(int(np.asarray(mesh.class_id).max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        # BENCH_GYRO_PPR=1: per-particle gyro radius carried in state and
        # bracketed per particle at deposition (cost-delta arm)
        gyro=GyroConfig(per_particle_radius=bool(int(
            os.environ.get("BENCH_GYRO_PPR", "0")))),
        # BENCH_ROT_AUX=1: rotation captured by the search's packed rec
        # channel instead of the push's rot-table gather
        rot_aux_capture=bool(int(os.environ.get("BENCH_ROT_AUX", "0"))),
        # BENCH_ANALYTIC=off forces the general walk even on the structured
        # annulus bench mesh (the analytic locate is the production default
        # when detect_annulus_structured proves it exact — the 2D analog of
        # BENCH_KUHN; gmsh workloads like the 120k tokamak mesh fail the
        # proof and always take the walk)
        analytic_locate=os.environ.get("BENCH_ANALYTIC", "auto"),
        # BENCH_ROT_ANALYTIC=0: keep the rotation-table gather even when
        # the analytic locator proves classification is per-ring (A/B arm
        # for the gather-free rotation)
        rot_analytic=bool(int(os.environ.get("BENCH_ROT_ANALYTIC", "1"))),
        # BENCH_BANDLOC=force: the BandGrid2D ragged flux-band locator on
        # a detection-proven flux-band mesh (auto/off keep cartesian
        # cells); BENCH_BANDT sweeps the θ-bins-per-band knob
        band_locator=os.environ.get("BENCH_BANDLOC", "auto"),
        band_theta=(int(os.environ["BENCH_BANDT"])
                    if os.environ.get("BENCH_BANDT") else None),
    )
    device_mesh = make_device_mesh()

    if mode == "picparts":
        # full spatial decomposition: BFS picparts + migration + owner
        # reductions (multi-chip path; also runs at R=1)
        from pumipic_jax.models.pseudo_xgcm import make_picparts_setup
        from pumipic_jax.mesh.generate import annulus_mesh

        if mesh_path:
            coords, tris, cls = m_coords, m_tris, m_cls
        else:
            n_rings = max(int(np.sqrt(mesh_elems / 8)), 2)
            n_sectors = mesh_elems // (2 * n_rings)
            coords, tris, cls = annulus_mesh(n_rings, n_sectors, 0.3, 1.0)
        # Slot capacity is pure per-step cost (every particle-rate op runs
        # at capacity width); at R=1 nothing migrates so tight headroom is
        # safe — overflow is counted and would invalidate the run loudly.
        capf = float(os.environ.get("BENCH_CAPF", 1.05))
        # BENCH_ROUTE=gather: keep the packed [lid|route] gather even when
        # the banded gather-free routing proofs hold (A/B arm)
        pp, state, gyro_map, pstep = make_picparts_setup(
            coords, tris, cls, cfg, device_mesh, use_lb=True,
            cap_factor=capf,
            banded_route=("off" if os.environ.get("BENCH_ROUTE", "auto")
                          == "gather" else "auto"),
        )

        def step(s):
            s, fwd, stats = pstep(s)
            return s, {"fwd": fwd, "overflow": stats["overflow"],
                       "kept_home": stats["kept_home"],
                       "alive_per_rank": stats["alive_per_rank"],
                       "sent_per_rank": stats["sent_per_rank"]}

        if os.environ.get("BENCH_ADAPT", "0") != "0":
            # adaptive capacity: observe live width + migration volume for
            # a few steps, then resize slots to the observed need — the
            # capacity headroom is pure per-step cost (every particle-rate
            # op runs at capacity width); lossless admission quotas are
            # the backstop if a later burst exceeds the shrunk free space
            from pumipic_jax.parallel.capacity import CapacityMonitor

            mon = CapacityMonitor()
            probe = state
            for _ in range(3):
                probe, f = step(probe)
                mon.observe(f)
            old_cap = state["active"].shape[1]
            state = mon.apply(probe)
            if state["active"].shape[1] != old_cap:
                print(f"# adaptive capacity: {old_cap} -> "
                      f"{state['active'].shape[1]} slots",
                      file=sys.stderr, flush=True)
            else:
                state = probe

    elif mode == "pps3d":
        # the reference's second headline workload: pseudoPushAndSearch
        # (3D straight-line push + tet adjacency search + layout rebuild,
        # test/pseudoPushAndSearch.cpp).  Benchmark config uses periodic
        # wrap so the 10M-particle population is steady across steps
        # (reference remove-on-exit semantics drain the box; wall physics
        # is exercised by gitr_like and the wall-mode tests).
        from pumipic_jax.mesh.core import Mesh3D
        from pumipic_jax.mesh.generate import box_tet_mesh
        from pumipic_jax.models.pseudo_push_and_search import (
            PseudoPushAndSearch, PushSearchConfig,
        )

        n_side = max(int(round((mesh_elems / 6) ** (1.0 / 3.0))), 2)
        coords3, tets = box_tet_mesh(n_side, n_side, n_side)
        mesh = Mesh3D.from_arrays(coords3, tets)
        cfg3 = PushSearchConfig(
            num_ptcls=num_ptcls,
            structure=os.environ.get("BENCH_STRUCT", "dps"),
            wall="periodic",
            distance=float(os.environ.get("BENCH_DIST", 0.05)),
            max_search_iters=64,
            rebuild_mode=os.environ.get("BENCH_REBUILD", "sort"),
            # BENCH_KUHN=off forces the general unstructured walk even on
            # the structured bench mesh (the structured analytic locate is
            # the production default when detect_box_kuhn proves it exact)
            kuhn=os.environ.get("BENCH_KUHN", "auto"),
        )
        app = PseudoPushAndSearch(mesh, cfg3)
        state = app.ptcls

        def step(ptcls):
            ptcls2, iters = app._step(ptcls)
            return ptcls2, {"iters": iters}

    else:
        state, step = make_dp_setup(mesh, cfg, device_mesh)

    # warmup/compile
    state, fields = step(state)
    jax.block_until_ready(fields)

    if os.environ.get("BENCH_PERIT", "0") != "0":
        # per-iteration diagnostics: each step blocked on BOTH the carried
        # state and the outputs (blocking on the small outputs alone can
        # under-measure)
        for i in range(iters):
            ti = time.perf_counter()
            state, fields = step(state)
            jax.block_until_ready((state, fields))
            print(f"# iter {i}: {(time.perf_counter() - ti) * 1e3:.3f} ms",
                  file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    for _ in range(iters):
        state, fields = step(state)
    jax.block_until_ready(fields)
    dt = (time.perf_counter() - t0) / iters

    if mode == "picparts":
        assert int(jax.device_get(fields["overflow"])) == 0, (
            "migration bucket overflow — BENCH_CAPF too tight")
    n_chips = len(device_mesh.devices.flat)
    ptcls_per_sec_per_chip = num_ptcls / dt / n_chips
    if mode == "pps3d":
        metric = "pseudoPushAndSearch 3D push+search+rebuild throughput"
        alive = int(jax.device_get(state.active).sum())
    else:
        metric = "pseudoXGCm push+search+rebuild+gyroScatter throughput"
        alive = int(jax.device_get(state["active"]).sum())
    out = {
        "metric": metric,
        "value": round(ptcls_per_sec_per_chip, 1),
        "unit": "particle-steps/s/chip",
        "vs_baseline": round(ptcls_per_sec_per_chip / PROXY_BASELINE_PTCLS_PER_SEC, 3),
        "detail": {
            "num_ptcls": num_ptcls,
            "mesh_elems": mesh.nelems,
            "ms_per_step": round(dt * 1e3, 3),
            "chips": n_chips,
            "alive": alive,
            "platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "nvidia_smi": gpu.strip().splitlines(),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
