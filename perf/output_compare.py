"""Structure-comparison report: ratios of per-op times vs the SCS layout.

Analog of the reference's perf-harness post-processor
(performance_tests/output_compare.py:24-27), which reformats ps_combo logs
into rebuild / pseudo-push / migration averages and compares structures
against Sell-C-sigma. Here the sweep harness (perf/sweep.py) already emits
structured JSON (SWEEP_OUT), so this reads that file and prints one table
per (ne, np, dist) configuration with each structure's absolute times and
its ratio vs SCS (ratio < 1 means faster than SCS).

  python perf/output_compare.py <sweep json>
"""
import json
import sys

OPS = [("pseudo_push_ms", "pseudo-push"),
       ("rebuild_ms", "rebuild"),
       ("migrate_churn_ms", "migration")]


def main():
    path = sys.argv[1]
    with open(path) as f:
        rows = json.load(f)

    configs = {}
    for r in rows:
        configs.setdefault((r["ne"], r["np"], r["dist"]), []).append(r)

    for (ne, np_, dist), group in sorted(configs.items()):
        scs = next((r for r in group if r["struct"] == "scs"), None)
        print(f"\nne={ne} np={np_} dist={dist}")
        hdr = f"  {'struct':<6}" + "".join(
            f" {name + ' ms':>16} {'vs_scs':>7}" for _, name in OPS)
        print(hdr)
        for r in sorted(group, key=lambda r: r["struct"]):
            cells = []
            for key, _ in OPS:
                v = r.get(key)
                ratio = (v / scs[key]) if (scs and scs.get(key)) else float("nan")
                cells.append(f" {v:>16.1f} {ratio:>7.2f}")
            print(f"  {r['struct']:<6}" + "".join(cells))


if __name__ == "__main__":
    main()
