"""walk_lab — THE parameterized in-process walk/locator A/B harness.

Every knob of the walk/locator design is an ARM SPEC here, and all arms of
one invocation run IN ONE PROCESS on one device with evolving state, on a
persistent compilation cache.

Arm spec grammar (semicolon-separated arms; each arm is +-joined k=v):
  analytic=auto|off|force      structured-annulus exact locate
  bandloc=auto|off|force       ragged flux-band locator (BandGrid2D)
  bandT=<int>                  θ-bins per band
  cpe=<float>                  cartesian cells per element
  peel=auto|rows|lines|rows_split|rows_ab
  widths=<d0>/<d1>/...         pyramid widths as N-divisors (e.g. 8/128)
  rot=analytic|table           rotation source
  name=<label>                 record label (defaults to the spec)

Examples:
  # 120k band-vs-cartesian at three T values, one process:
  WL_MESH=data/xgc_like_120k.msh.gz WL_N=10000000 \
  WL_ARMS="analytic=off+bandloc=auto+bandT=1024;\
analytic=off+bandloc=auto+bandT=2048;analytic=off+bandloc=off" \
  python perf/walk_lab.py

With WL_OUT=<path>, records append to that JSON file keyed by
"<mesh>|N=<n>|<arm>" with ms/step + config — the RecordTime-table
discipline (reference performance_tests/output_compare.py role).
"""
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax
import jax.numpy as jnp
import numpy as np

N = int(os.environ.get("WL_N", 10_000_000))
ITERS = int(os.environ.get("WL_ITERS", 10))
MESH = os.environ.get("WL_MESH", "")          # "" = 24k annulus analog
MESH_E = int(os.environ.get("WL_ELEMS", 24_000))
ARMS = os.environ.get(
    "WL_ARMS", "analytic=off+bandloc=auto;analytic=off+bandloc=off")
OUT = os.environ.get("WL_OUT", "")


def parse_arm(spec: str):
    kv = dict(p.split("=", 1) for p in spec.split("+") if p)
    name = kv.pop("name", spec)
    return name, kv


def build_cfg(kv, mesh):
    from pumipic_jax.models.pseudo_xgcm import GyroConfig, XGCmConfig

    widths = None
    if "widths" in kv:
        divs = [int(d) for d in kv["widths"].split("/")]
        widths = tuple(max(N // d, 2048) for d in divs)
    return XGCmConfig(
        num_ptcls=N,
        mdl_face=max(int(np.asarray(mesh.class_id).max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(),
        analytic_locate=kv.get("analytic", "auto"),
        band_locator=kv.get("bandloc", "auto"),
        band_theta=int(kv["bandT"]) if "bandT" in kv else None,
        locator_cpe=float(kv["cpe"]) if "cpe" in kv else None,
        peel=kv.get("peel", "auto"),
        search_widths=widths,
        rot_analytic=kv.get("rot", "analytic") == "analytic",
    )


def main():
    from pumipic_jax.mesh.core import Mesh2D
    from pumipic_jax.models.pseudo_xgcm import make_default_mesh, make_dp_setup
    from pumipic_jax.parallel.mesh_axis import make_device_mesh
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(ROOT)
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    if MESH:
        from pumipic_jax.mesh.gmsh import read_msh

        coords, tris, cls = read_msh(MESH)
        mesh = Mesh2D.from_arrays(coords, tris, cls)
        mesh_tag = os.path.basename(MESH).split(".")[0]
    else:
        mesh = make_default_mesh(MESH_E)
        mesh_tag = f"annulus{MESH_E // 1000}k"
    dm = make_device_mesh(1)
    print(f"walk_lab: {mesh_tag} E={mesh.nelems} N={N} iters={ITERS}",
          flush=True)

    recs = {}
    if OUT and os.path.exists(OUT):
        try:
            with open(OUT) as f:
                recs = json.load(f)
        except Exception:
            recs = {}

    results = []
    for spec in ARMS.split(";"):
        spec = spec.strip()
        if not spec:
            continue
        name, kv = parse_arm(spec)
        cfg = build_cfg(kv, mesh)
        t_build = time.perf_counter()
        state, step = make_dp_setup(mesh, cfg, dm)
        # warmup/compile
        state, f = step(state)
        jax.block_until_ready(f)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, f = step(state)
        jax.block_until_ready(f)
        dt = (time.perf_counter() - t0) / ITERS * 1e3
        alive = int(jax.device_get(state["active"]).sum())
        print(f"  {name:52s} {dt:8.2f} ms/step  alive={alive}", flush=True)
        key = f"{mesh_tag}|N={N}|{name}"
        recs[key] = {
            "ms_per_step": round(dt, 3), "alive": alive, "iters": ITERS,
            "build_s": round(time.perf_counter() - t_build, 1),
            "spec": spec,
        }
        results.append((name, dt))
        # free the arm's tables before the next build
        del state, step, f

    if OUT:
        with open(OUT, "w") as f:
            json.dump(recs, f, indent=1, sort_keys=True)
            f.write("\n")
        print("\nrecorded to", OUT, flush=True)
    for name, dt in sorted(results, key=lambda x: x[1]):
        print(f"  {dt:8.2f} ms/step  {name}")


if __name__ == "__main__":
    main()
