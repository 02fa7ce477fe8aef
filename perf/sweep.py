"""smallE_largeP configuration sweep — the reference's
``performance_tests/test_smallE_largeP.sh`` (e in {1000..}, p = e*10000,
dist in {uniform, gaussian, exponential}, all four structures) run through
perf/ps_combo.py, recording the per-op table
(ps_combo264.cpp:151-232 / output_compare.py parity).

Usage: [SWEEP_OUT=<path>] python perf/sweep.py [--quick]
Prints one JSON line per configuration and a final markdown table.
"""
import json
import subprocess
import sys
import os

HERE = os.path.dirname(__file__)
OUT = os.environ.get("SWEEP_OUT", "")


def main():
    quick = "--quick" in sys.argv
    # reference sweep: e in {1000..5500}, p = e*10000
    # (test_smallE_largeP.sh:10-19).  Full grid at the reference's 100 iters
    # would be hours; 3 evolving iterations are enough for the
    # seconds-scale per-op numbers, and the top size runs one distribution.
    if quick:
        configs = [(1000, "uniform", 10_000)]
    elif "--large-e" in sys.argv:
        # largeE_smallP (test_largeE_smallP.sh): many elements, few
        # particles per element — stresses mesh-rate layout machinery
        configs = [(ne, d, 10) for ne in (50_000, 120_000)
                   for d in ("uniform", "exponential")]
    else:
        configs = [(ne, d, 10_000) for ne in (1000, 2400)
                   for d in ("uniform", "gaussian", "exponential")]
        configs.append((5500, "uniform", 10_000))
    structs = "scs,csr,cabm,dps"
    for a in sys.argv[1:]:
        if a.startswith("--structs="):
            structs = a.split("=", 1)[1]
    iters = 3

    # Run every configuration IN ONE PROCESS: one process per device, and
    # the jit cache carries shapes across distributions for free.
    sys.path.insert(0, os.path.join(HERE, ".."))
    from perf.ps_combo import run_config
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(os.path.join(HERE, ".."))

    rows = []
    if True:
        for ne, dist, ppe in configs:
            print(f"== ne={ne} np={ne * ppe} dist={dist}", flush=True)
            rec = run_config(ne, ne * ppe, dist, structs, iters)
            for struct, r in rec["results"].items():
                rows.append({
                    "ne": ne, "np": ne * ppe, "dist": dist,
                    "struct": struct, **{k: v for k, v in r.items()},
                })
            # incremental (AFTER appending, so an OOM on the next config
            # cannot lose this one)
            if OUT:
                with open(OUT, "w") as f:
                    json.dump(rows, f, indent=1)

    # markdown table
    print("\n| ne | np | dist | struct | push ms | rebuild ms | "
          "migrate-churn ms | padded % |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['ne']} | {r['np']} | {r['dist']} | {r['struct']} | "
              f"{r['pseudo_push_ms']:.2f} | {r['rebuild_ms']:.2f} | "
              f"{r['migrate_churn_ms']:.2f} | "
              f"{100 * r['padded_fraction']:.1f} |")
    if OUT:
        print(f"\nwrote {OUT}")


if __name__ == "__main__":
    main()
