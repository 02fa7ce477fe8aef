"""ps_combo — particle-structure stress harness.

Reference parity: ``performance_tests/ps_combo264.cpp`` — for each structure
(SCS / CSR / CabM / DPS): build from a chosen distribution, time N iterations
of a pseudo-push (``:151-187``), then N iterations of redistribute+migrate+
rebuild (``:206-232``); report per-op times via the RecordTime registry and
ratios vs SCS (``output_compare.py:24-27``).

Usage:
  python perf/ps_combo.py --ne 5000 --np 500000 --dist gaussian \
      --structs scs,csr,cabm,dps --iters 20

Timing methodology: state evolves every iteration (the rebuild permutes
slots), so executions are real; times are wall-clock around blocked jitted
calls, on a persistent compilation cache.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.particles import (
    CSR, DPS, CabM, SellCSigma, SCSInput, distribute,
)
from pumipic_jax.utils.timing import get_registry, record_time, summarize_time


def build(struct: str, ne: int, elems, fields):
    if struct == "scs":
        return SellCSigma(ne, elems, fields=fields,
                          scs_input=SCSInput(chunk_size=32, sigma=None))
    if struct == "csr":
        return CSR(ne, elems, fields=fields)
    if struct == "cabm":
        return CabM(ne, elems, fields=fields)
    if struct == "dps":
        return DPS(ne, elems, fields=fields)
    raise ValueError(struct)


def pseudo_push(elem, active, fields):
    """The reference's pseudo-push: writes per-particle values derived from
    ids + trig (ps_combo264.cpp:151-187)."""
    pid = fields["pid"].astype(jnp.float32)
    new = jnp.stack([
        10.3 * jnp.sin(pid),
        10.3 * jnp.cos(pid),
        10.3 * jnp.abs(jnp.tan(pid)),
    ], axis=1)
    return {"vals": jnp.where(active[:, None], new, fields["vals"])}


class _Cfg:
    def __init__(self, ne, nptcl, dist, structs, iters, seed=0):
        self.ne, self.nptcl, self.dist = ne, nptcl, dist
        self.structs, self.iters, self.seed = structs, iters, seed


def run_config(ne, nptcl, dist, structs="scs,csr,cabm,dps", iters=3,
               seed=0):
    """One sweep configuration in-process (callable from perf/sweep.py —
    avoids per-config process boundaries, which recompile everything)."""
    return _run(_Cfg(ne, nptcl, dist, structs, iters, seed))


def main():
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(str(Path(__file__).resolve().parent.parent))
    ap = argparse.ArgumentParser()
    ap.add_argument("--ne", type=int, default=5000)
    ap.add_argument("--np", dest="nptcl", type=int, default=500_000)
    ap.add_argument("--dist", default="gaussian",
                    choices=list(distribute.STRATEGIES))
    ap.add_argument("--structs", default="scs,csr,cabm,dps")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    _run(ap.parse_args())


def _run(args):
    ppe, elems = distribute.distribute_particles(
        args.ne, args.nptcl, args.dist, args.seed
    )
    n = len(elems)
    base_fields = {
        "vals": jnp.zeros((n, 3), jnp.float32),
        "pid": jnp.arange(n, dtype=jnp.int32),
    }

    results = {}
    for struct in args.structs.split(","):
        ps = build(struct, args.ne, elems, base_fields)
        cap = ps.capacity

        push = jax.jit(lambda p: p.map(pseudo_push))
        # shift rebuild: move every particle to (elem+1) % ne, evolving state
        shift = jax.jit(
            lambda p: p.rebuild(
                jnp.where(p.active, (p.elem + 1) % args.ne, -1)
            )
        )

        out = push(ps); jax.block_until_ready(out.fields["vals"])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            ps = push(ps)
        jax.block_until_ready(ps.fields["vals"])
        t_push = (time.perf_counter() - t0) / args.iters
        record_time(f"{struct} pseudo-push", t_push)

        out = shift(ps); jax.block_until_ready(out.elem)
        ps2 = out
        t0 = time.perf_counter()
        for _ in range(args.iters):
            ps2 = shift(ps2)
        jax.block_until_ready(ps2.elem)
        t_rebuild = (time.perf_counter() - t0) / args.iters
        record_time(f"{struct} rebuild", t_rebuild)
        assert ps2.n_ptcls() == n, (struct, ps2.n_ptcls())

        # migration churn (redistribute_particles analog): 10% of particles
        # "leave" (removed) and the same number arrive as new particles —
        # the single-rank projection of ps->migrate's remove+receive work
        churn = max(n // 10, 1)
        add_elems = jnp.asarray(np.arange(churn) % args.ne, jnp.int32)
        add_fields = {
            "vals": jnp.zeros((churn, 3), jnp.float32),
            "pid": jnp.arange(churn, dtype=jnp.int32),
        }

        @jax.jit
        def migrate_churn(p, key):
            drop = jax.random.uniform(key, (p.capacity,)) < 0.1
            new_elem = jnp.where(drop, -1, p.elem)
            return p.rebuild(new_elem, add_elems, add_fields)

        keys = jax.random.split(jax.random.PRNGKey(0), args.iters + 1)
        out = migrate_churn(ps2, keys[-1]); jax.block_until_ready(out.elem)
        ps3 = out
        t0 = time.perf_counter()
        for i in range(args.iters):
            ps3 = migrate_churn(ps3, keys[i])
        jax.block_until_ready(ps3.elem)
        t_migrate = (time.perf_counter() - t0) / args.iters
        record_time(f"{struct} migration churn", t_migrate)
        # a capacity overflow would silently drop added particles and skew
        # the structure comparison — fail loudly instead
        assert not bool(ps3.overflowed), (
            f"{struct}: migration churn overflowed capacity {ps3.capacity}"
        )

        results[struct] = {
            "pseudo_push_ms": t_push * 1e3,
            "rebuild_ms": t_rebuild * 1e3,
            "migrate_churn_ms": t_migrate * 1e3,
            "capacity": cap,
            "padded_fraction": float(ps.metrics()["padded_fraction"]),
        }

    summarize_time()
    ref = results.get("scs") or next(iter(results.values()))
    for struct, r in results.items():
        r["push_vs_scs"] = r["pseudo_push_ms"] / ref["pseudo_push_ms"]
        r["rebuild_vs_scs"] = r["rebuild_ms"] / ref["rebuild_ms"]
    rec = {
        "config": {"ne": args.ne, "np": args.nptcl, "dist": args.dist,
                   "iters": args.iters,
                   "device": str(jax.devices()[0])},
        "results": results,
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
