"""Row-gather cost surface: ms per 10M-index row gather vs {table rows} x
{consumed columns}, for the shapes the framework actually gathers from
(locator peel tables and walk tables):

  rows in {24k (3D walk_geom), 123k (2D walk_geom), 184k (band cells),
           490k (cart cpe4 cells), 1.96M (cart cpe16 cells)}
  consumed cols in {2, 8, 14}

All arms in ONE process, fori-fused, indices evolve per pass.

  python perf/gather_cost_surface.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax
import jax.numpy as jnp
import numpy as np

N = int(os.environ.get("GS_N", 10_000_000))
ITERS = int(os.environ.get("GS_ITERS", 10))
ROWS = [int(r) for r in os.environ.get(
    "GS_ROWS", "24576,122603,184320,489958,1961632").split(",")]
COLS = [int(c) for c in os.environ.get("GS_COLS", "2,8,14").split(",")]
W = int(os.environ.get("GS_W", 14))      # stored columns


def main():
    from pumipic_jax.utils.cache import enable_compile_cache

    enable_compile_cache(ROOT)
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    rng = np.random.default_rng(0)
    idx_base = {r: rng.integers(0, r, N).astype(np.int32) for r in ROWS}

    for r in ROWS:
        tab = jnp.asarray(rng.normal(size=(r, W)).astype(np.float32))
        idx0 = jnp.asarray(idx_base[r])
        jax.block_until_ready((tab, idx0))
        for c in COLS:
            @jax.jit
            def loop(idx, tab=tab, c=c, r=r):
                def body(i, carry):
                    idx, acc = carry
                    g = tab[idx]
                    s = g[:, 0]
                    for k in range(1, c):
                        s = s + g[:, k]
                    idx = jnp.clip(idx + (i % 3 - 1), 0, r - 1)
                    return idx, acc + s

                idx, acc = jax.lax.fori_loop(
                    0, ITERS, body, (idx, jnp.zeros((N,), jnp.float32)))
                return acc.sum() + idx.sum()

            jax.block_until_ready(loop(idx0))
            idx2 = jax.jit(lambda a, r=r: jnp.clip(a + 1, 0, r - 1))(idx0)
            jax.block_until_ready(idx2)
            t0 = time.perf_counter()
            out = loop(idx2)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / ITERS * 1e3
            mb = r * W * 4 / 1e6
            print(f"rows={r:8d} ({mb:7.1f} MB @ {W}col)  consume {c:2d} "
                  f"cols: {dt:8.2f} ms/pass", flush=True)


if __name__ == "__main__":
    main()
