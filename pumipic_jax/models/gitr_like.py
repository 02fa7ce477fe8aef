"""GITRm-style impurity-transport mini-app: Boris push + 3D trace +
wall interaction + grid fields.

The reference infrastructure's second flagship consumer is GITR(m)
(README.md:6-12): magnetized impurity ions pushed with the Boris integrator
through a tet mesh, fields interpolated from (r,z) grids, and wall
interactions (reflection/deposition) at exposed faces.  The reference repo
ships the building blocks (``pumipic_push.hpp``, ``pumipic_utils.hpp`` grid
interpolation, ``closest_point_on_triangle`` wall distance) without an
in-tree GITR app; this mini-app wires our equivalents into the same loop
shape as pseudoPushAndSearch (push → search → rebuild) to exercise them
end-to-end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh.core import Mesh3D
from pumipic_jax.ops import interpolate as interp
from pumipic_jax.ops import push as push_ops
from pumipic_jax.ops import search as search_ops


@dataclass(frozen=True)
class GitrConfig:
    num_ptcls: int = 10_000
    num_iterations: int = 10
    dt: float = 1e-8
    charge: float = 1.0
    amu: float = 10.0
    b_field: Tuple[float, float, float] = (0.0, 0.0, 1.0)  # uniform fallback
    max_search_iters: int = 100
    # deposit on walls (reference default) instead of deleting silently
    count_wall_hits: bool = True
    # wall interaction: "absorb" (remove + tally) or "reflect" (specular)
    wall: str = "absorb"


class GitrLike:
    """E from a uniform 3D grid (trilinear), B uniform or from an (r,z)
    grid; Boris velocity update; intersection walk; wall deposition."""

    def __init__(
        self,
        mesh: Mesh3D,
        cfg: GitrConfig,
        e_grid: Optional[jax.Array] = None,
        e_origin=None,
        e_spacing=None,
        seed: int = 0,
    ):
        self.mesh = mesh
        self.cfg = cfg
        rng = np.random.default_rng(seed)

        elems = rng.integers(0, mesh.nelems, size=cfg.num_ptcls)
        ev = np.asarray(mesh.elem2verts)[elems]
        cz = np.asarray(mesh.coords)
        w = rng.dirichlet(np.ones(4), size=cfg.num_ptcls)
        pos = np.einsum("nk,nkd->nd", w, cz[ev])
        vel = rng.normal(scale=1e3, size=(cfg.num_ptcls, 3))

        self.state = {
            "x": jnp.asarray(pos, jnp.float32),
            "v": jnp.asarray(vel, jnp.float32),
            "elem": jnp.asarray(elems, jnp.int32),
            "active": jnp.ones(cfg.num_ptcls, bool),
        }
        # e_spacing is the grid CELL spacing, exactly the dx that
        # interpolate_3d_grid takes (round-5 review: it was previously
        # re-divided by (npts-1) inside the step, so only
        # 'e_spacing = total extent' worked — an undocumented trap)
        if e_grid is None:
            e_grid = jnp.zeros((2, 2, 2, 3), jnp.float32)
            e_origin = jnp.asarray(cz.min(0), jnp.float32)
            ext = cz.max(0) - cz.min(0)
            e_spacing = jnp.asarray(
                ext / np.asarray([max(s - 1, 1)
                                  for s in e_grid.shape[:3]]), jnp.float32)
        elif e_spacing is None:
            raise ValueError("e_grid without e_spacing (cell spacing)")
        self.e_grid = e_grid
        self.e_origin = jnp.asarray(e_origin, jnp.float32)
        self.e_spacing = jnp.asarray(e_spacing, jnp.float32)
        self.b_field = jnp.asarray(cfg.b_field, jnp.float32)
        self.wall_hits = jnp.zeros(
            mesh.nfaces if cfg.count_wall_hits else 1, jnp.float32
        )
        self._step = jax.jit(self._make_step())

    def _make_step(self):
        mesh, cfg = self.mesh, self.cfg

        def step(state, wall_hits):
            x, v = state["x"], state["v"]
            elem, active = state["elem"], state["active"]

            e_here = interp.interpolate_3d_grid(
                self.e_grid, self.e_origin, self.e_spacing, x,
            )
            b_here = jnp.broadcast_to(self.b_field, x.shape)
            x_new, v_new = push_ops.boris_push(
                x, v, e_here, b_here, cfg.dt, cfg.charge, cfg.amu
            )
            handler = (search_ops.reflect_on_exit_3d
                       if cfg.wall == "reflect" else search_ops.remove_on_exit)
            res = search_ops.search_mesh_3d(
                mesh, x, x_new, elem, active, cfg.max_search_iters,
                boundary_handler=handler, method="intersection",
                # reflect mode needs the recorded last hit point for the
                # specular velocity update below, not just the flux tally
                record_exit=cfg.count_wall_hits or cfg.wall == "reflect",
            )
            lost = active & (res.elem_ids < 0)
            if cfg.wall == "reflect":
                # specular wall: the walk mirrors the DESTINATION across
                # each hit face; the velocity must follow (round-5 review:
                # an unreflected v re-pushes into the wall every step,
                # pinning particles at the surface).  Exact for any bounce
                # count without face normals: the final leg runs from the
                # LAST hit point to the mirrored destination, and specular
                # reflection conserves speed — v' = |v| * (dest - hit)/|..|.
                leg = jnp.stack(
                    [d - h for d, h in zip(res.dest_c, res.hit_c)], axis=-1)
                leg_n = jnp.linalg.norm(leg, axis=-1, keepdims=True)
                v_spec = (jnp.linalg.norm(v_new, axis=-1, keepdims=True)
                          * leg / jnp.maximum(leg_n, 1e-30))
                bounced = (active & (res.elem_ids >= 0)
                           & (res.num_hits > 0) & (leg_n[:, 0] > 1e-30))
                v_new = jnp.where(bounced[:, None], v_spec, v_new)
            new_state = {
                "x": jnp.where(lost[:, None], x, res.dest),
                "v": jnp.where(active[:, None], v_new, v),
                "elem": res.elem_ids,
                "active": active & (res.elem_ids >= 0),
            }
            # wall flux tally: exact exit face from the walk's recorded
            # boundary crossing (find_exit_face parity, adjacency.tpp:232-364)
            # — absorb mode counts each removed particle on the face it left
            # through (exact flux map); reflect mode counts reflection events,
            # attributed to the particle's last-hit face within the step.
            if cfg.count_wall_hits:
                hit = lost if cfg.wall == "absorb" else (
                    active & (res.num_hits > 0)
                )
                weight = (jnp.ones_like(res.num_hits, jnp.float32)
                          if cfg.wall == "absorb"
                          else res.num_hits.astype(jnp.float32))
                key = jnp.where(
                    hit & (res.exit_side >= 0), res.exit_side, mesh.nfaces
                )
                wall_hits = wall_hits + jax.ops.segment_sum(
                    jnp.where(key < mesh.nfaces, weight, 0.0), key,
                    num_segments=mesh.nfaces + 1,
                )[: mesh.nfaces]
            return new_state, wall_hits

        return step

    def run(self, num_iterations: Optional[int] = None):
        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        history = []
        for _ in range(iters):
            self.state, self.wall_hits = self._step(self.state, self.wall_hits)
            history.append(int(jnp.sum(self.state["active"])))
        return history
