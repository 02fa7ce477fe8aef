#!/usr/bin/env bash
# Run every bench mode sequentially: one process at a time, since a JAX
# process reserves most of the GPU's memory when it starts.  Each mode
# prints its own JSON line.
#
#   bash scripts/bench_all.sh
set -e
cd "$(dirname "$0")/.."

run() { echo "== $*" >&2; env "$@" python bench.py; }

run BENCH_MODE=dp                         # structured analytic locate
run BENCH_MODE=dp BENCH_ANALYTIC=off      # general unstructured walk
run BENCH_MODE=picparts BENCH_CAPF=1.05
run BENCH_MODE=picparts BENCH_CAPF=1.5
run BENCH_MODE=picparts BENCH_CAPF=1.5 BENCH_ADAPT=1
run BENCH_MODE=pps3d                      # structured analytic locate
run BENCH_MODE=pps3d BENCH_KUHN=off       # general unstructured walk
run BENCH_MODE=dp BENCH_MESH=data/xgc_like_120k.msh.gz
