"""Decision measurement for the round-3 peel design (VERDICT #2).

Questions, at the bench config (24k annulus, deg_per_push=15):
  1. What fraction of particles stay in their element per step (hop 0)?
     Within 1 hop?  -> viability of a previous-element-first peel.
  2. Miss rate of the current 2-candidate cell peel (A/B containment).
  3. Miss rate of a slim "separating-line" cell guess: cell stores
     (elemA, elemB, line) and the guess picks A or B by the line's sign —
     one narrow gather instead of the 14-col row, but no containment proof.

Run on CPU (host-side replica of the walk), modest N.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from pumipic_jax.models.pseudo_xgcm import (  # noqa: E402
    XGCmConfig, GyroConfig, make_default_mesh, seed_particles_per_element,
    uniform_points_in_elements,
)
from pumipic_jax.mesh.locator import build_locator_grid, _host_walk  # noqa: E402
from pumipic_jax.ops import push as push_ops  # noqa: E402


def main():
    n = int(os.environ.get("HOP_PTCLS", 500_000))
    mesh_elems = int(os.environ.get("HOP_ELEMS", 24_000))
    steps = int(os.environ.get("HOP_STEPS", 5))

    mesh = make_default_mesh(mesh_elems)
    cfg = XGCmConfig(
        num_ptcls=n,
        mdl_face=max(int(np.asarray(mesh.class_id).max()) // 2, 2),
        deg_per_push=15.0,
        gyro=GyroConfig(),
    )
    rng = np.random.default_rng(1024 * 1024)
    ppe = seed_particles_per_element(mesh, cfg, rng)
    elems = np.repeat(np.arange(mesh.nelems), ppe)
    pos = uniform_points_in_elements(
        mesh, elems, np.random.default_rng(512 * 512))
    phi, b = push_ops.elliptical_setup(jnp.asarray(pos), cfg.h, cfg.k, cfg.d)
    phi = np.asarray(phi, np.float64)
    b = np.asarray(b, np.float64)

    geom = np.asarray(mesh.walk_geom)
    nbrs = geom[:, 6:9].astype(np.int64)          # pre-permuted neighbor cols
    cls = np.asarray(mesh.class_id)

    grid = build_locator_grid(
        np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
        walk_geom=mesh.walk_geom)
    rows = np.asarray(grid.cell_rows)             # (C, 14)
    elem_a = rows[:, 6].astype(np.int64)
    elem_b = rows[:, 13].astype(np.int64)
    ox, oy = np.asarray(grid.origin, np.float64)
    ihx, ihy = np.asarray(grid.inv_h, np.float64)
    nx = int(np.asarray(grid.nx)); ny = int(np.asarray(grid.ny))

    def cell_of(px, py):
        ix = np.clip(np.floor((px - ox) * ihx), 0, nx - 1)
        iy = np.clip(np.floor((py - oy) * ihy), 0, ny - 1)
        return (ix * ny + iy).astype(np.int64)

    def inside(e, px, py, tol=1e-9):
        g = geom[np.maximum(e, 0)]
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
        l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
        w0 = 1.0 - l1 - l2
        return (e >= 0) & (np.minimum(np.minimum(l1, l2), w0) >= -tol)

    for s in range(steps):
        cid = cls[elems]
        cidf = np.maximum(cid, 1).astype(np.float64)
        cf = np.where(cid == 1, 0.01, 1.0)
        rad = phi + cfg.deg_per_push * cf / cidf * np.pi / 180.0
        px = b * cfg.d * np.cos(rad) + cfg.h
        py = b * np.sin(rad) + cfg.k

        # true element by walk from previous element
        true_e = _host_walk(geom, elems, px, py, iters=64)
        alive = true_e >= 0

        same = (true_e == elems) & alive
        nb = nbrs[elems]
        one_hop = alive & ~same & (nb == true_e[:, None]).any(axis=1)

        # current 2-candidate peel
        c = cell_of(px, py)
        in_a = inside(elem_a[c], px, py)
        in_b = inside(elem_b[c], px, py)
        peel_miss = alive & ~(in_a | in_b)

        # prev-elem containment (hop-0 test)
        in_prev = inside(elems, px, py)

        # line guess: pick A if inside_a else B -- proxy for separating-line
        # quality ceiling: a perfect line resolves exactly the in_a|in_b set
        line_resolved = in_a | in_b

        na = alive.sum()
        print(f"step {s}: alive {na}  same-elem {same.sum()/na:.3f}  "
              f"1-hop {(one_hop.sum())/na:.3f}  "
              f"<=1hop {(same.sum()+one_hop.sum())/na:.3f}  "
              f"in_prev {in_prev[alive].mean():.3f}  "
              f"peelAB-resolved {line_resolved[alive].mean():.4f}  "
              f"peel-miss {peel_miss.sum()/na:.4f}")

        phi = rad
        elems = np.where(alive, true_e, elems)
        keep = alive
        elems, phi, b = elems[keep], phi[keep], b[keep]

    # hop-length histogram on the last step state (BFS distance true vs prev)
    print("class-id range:", cls.min(), cls.max())


if __name__ == "__main__":
    main()
