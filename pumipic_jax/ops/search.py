"""Adjacency-walk particle search through unstructured meshes.

Reference parity:
- ``search_mesh_2d`` (``src/pumipic_adjacency.hpp:1011-1158``): per-particle
  BCC edge walk — check current element, mark boundary exits, cross the most
  violated edge; loop until a global min-reduce says everyone is done.
- ``search_mesh`` / ``search_mesh_3d`` (``:314-768``): tet BCC walk and the
  Möller–Trumbore intersection path.
- ``trace_particle_through_mesh`` (``src/pumipic_adjacency.tpp:460-615``):
  unified driver with a user-pluggable boundary handler (default
  ``RemoveParticleOnGeometricModelExit``, ``:617-639``) and exit intersection
  points (``find_exit_face``, ``:232-364``) — exposed here via
  ``record_exit=True`` → ``SearchResult.exit_side`` / ``hit_c`` /
  ``num_hits``.

Design:

- The whole walk is ``lax.while_loop``s whose body is a fully vectorized step
  over particles: ONE packed-row gather (``Mesh*.walk_geom`` holds the
  element's barycentric **affine forms** ``l_k(x) = A_k·x + c_k`` plus
  neighbor/edge ids *stored as floats* — ids < 2^24 are exact in f32, and an
  all-float row lets XLA fuse every consumer of the gather without the
  bitcast splits that tripled gather traffic in round 1) → FMAs → argmin
  side → dual-graph crossing.  The reference launches three kernels per step
  and reads a device-to-host min every iteration (adjacency.hpp:1120-1123);
  here convergence tests live in the loop condition, so the chip never
  stalls on the host.
- **Straggler compaction pyramid**: full width only while most walkers are
  live, then geometrically narrower loops, each level compacted from the
  previous level's arrays via stable argsort (bounded ``nonzero`` was
  far slower where this was first tuned) and merged back once at the end.  ``widths`` overrides the
  pyramid for tuning.
- **Flat state**: positions ride as separate (N,) component arrays, so the
  hot loop never materializes narrow multi-column particle temporaries
  (a layout that pads a narrow minor dimension multiplies their bytes).
- **Grid-guess fallback**: with ``use_guess`` the walker carries a
  from-guess flag; a boundary hit on a guess trajectory resets it to its
  true previous element mid-walk instead of invoking the handler.

Termination semantics (same as the reference): the greedy walk crosses the
most-violated side toward the destination, which reaches any destination on
a convex domain or for local (few-element) moves.  On a non-convex domain a
walk aimed across a hole hits the interior boundary and is handed to the
boundary handler (default: delete) — identical to the reference's
``checkExposedEdges`` behavior.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from pumipic_jax.mesh.core import Mesh2D, Mesh3D
from pumipic_jax.ops.geometry import closest_point_on_triangle

INVALID = -1
COMPACT_DIV = 16     # width pyramid ratio for straggler compaction
MAX_LEVELS = 3       # per-level fixed costs beat gather savings beyond this
TAIL_WIDTH = 1024    # narrowest pyramid level
# Containment tolerance: the reference compares exact zeros in f64
# (adjacency.hpp all_positive) and area-scales a tolerance in the .tpp path
# (compute_tolerance_from_area).  In f32 an exactly-on-edge point can be
# "outside" both neighboring elements and ping-pong forever.  The slack must
# cover the FLOAT EVALUATION ERROR of the affine form l = A·x + c, which
# scales with the term magnitudes (|A|·|x| ≈ |x|/h blows up on sliver
# elements) — so the tolerance is RELATIVE to the accumulated |terms|, with
# a small absolute floor.
BCC_REL_TOL = 8.0 * 2.0 ** -24      # ~8 ulps of the largest FMA term
BCC_ABS_TOL = 1e-7
# Intersection-walk plane tolerance is scaled by |plane offset| so it stays
# meaningful on meshes with coordinates >> 1 (the reference's
# compute_tolerance_from_area plays the same role, adjacency.tpp:419-428).
MT_TOL = 1e-6
# Stranded-walker recovery (``recover="project"``): a loop-limit survivor is
# recovered onto its current element iff its destination is within this
# fraction of the element's longest edge from the element's closure — the
# sliver/degenerate ping-pong class, where the point sits within float noise
# of a shared side yet fails both neighbors' tolerance tests.  Genuinely
# unreachable destinations (non-convex detours, bad configs) stay deleted.
RECOVER_REL_TOL = 1e-3
# how far the projected point is nudged toward the element centroid so the
# recovered (elem, dest) pair strictly passes later containment tests
RECOVER_NUDGE = 1e-5


class BoundaryCtx(NamedTuple):
    """What a boundary handler sees for particles that hit an exposed side."""

    elem: jax.Array      # (N,) element the particle is leaving
    side: jax.Array      # (N,) mesh edge/face id crossed
    orig: Tuple[jax.Array, ...]   # per-component (N,) walk origin
    dest: Tuple[jax.Array, ...]   # per-component (N,) current destination
    mesh: object
    # boundary intersection point and segment parameter (find_exit_face,
    # adjacency.tpp:232-364); None unless the handler sets ``needs_hit=True``
    # or the search was called with ``record_exit``
    hit: Optional[Tuple[jax.Array, ...]] = None
    t: Optional[jax.Array] = None


class BoundaryResult(NamedTuple):
    dest: Optional[Tuple[jax.Array, ...]]  # None = destination unchanged
    elem: jax.Array      # element to continue in (INVALID to remove)
    done: jax.Array      # True → stop walking this particle


def remove_on_exit(ctx: BoundaryCtx) -> BoundaryResult:
    """Default handler: particle leaves the domain and is deleted
    (``RemoveParticleOnGeometricModelExit``, adjacency.tpp:617-639)."""
    n = ctx.elem.shape[0]
    return BoundaryResult(
        dest=None,
        elem=jnp.full((n,), INVALID, dtype=ctx.elem.dtype),
        done=jnp.ones((n,), dtype=bool),
    )


remove_on_exit.modifies_dest = False


def reflect_on_exit_2d(ctx: BoundaryCtx) -> BoundaryResult:
    """Specular reflection off the boundary edge; the walk continues in the
    same element with the mirrored destination (GITR-style wall handler)."""
    mesh: Mesh2D = ctx.mesh
    ev = mesh.edge2verts[jnp.maximum(ctx.side, 0)]
    ax = mesh.coords[ev[:, 0], 0]
    ay = mesh.coords[ev[:, 0], 1]
    bx = mesh.coords[ev[:, 1], 0]
    by = mesh.coords[ev[:, 1], 1]
    tx, ty = bx - ax, by - ay
    inv = 1.0 / jnp.maximum(jnp.sqrt(tx * tx + ty * ty), 1e-30)
    tx, ty = tx * inv, ty * inv
    dx, dy = ctx.dest
    adx, ady = dx - ax, dy - ay
    along = adx * tx + ady * ty
    mx = ax + 2 * along * tx - adx
    my = ay + 2 * along * ty - ady
    return BoundaryResult(
        dest=(mx, my),
        elem=ctx.elem,
        done=jnp.zeros(ctx.elem.shape[0], dtype=bool),
    )


def reflect_on_exit_3d(ctx: BoundaryCtx) -> BoundaryResult:
    """Specular reflection off the boundary face (3D wall handler)."""
    mesh: Mesh3D = ctx.mesh
    fv = mesh.face2verts[jnp.maximum(ctx.side, 0)]
    ax, ay, az = (mesh.coords[fv[:, 0], i] for i in range(3))
    bx, by, bz = (mesh.coords[fv[:, 1], i] for i in range(3))
    cx, cy, cz = (mesh.coords[fv[:, 2], i] for i in range(3))
    # face normal
    ux, uy, uz = bx - ax, by - ay, bz - az
    vx, vy, vz = cx - ax, cy - ay, cz - az
    nx = uy * vz - uz * vy
    ny = uz * vx - ux * vz
    nz = ux * vy - uy * vx
    inv = 1.0 / jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-30)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    dx, dy, dz = ctx.dest
    s = (dx - ax) * nx + (dy - ay) * ny + (dz - az) * nz
    return BoundaryResult(
        dest=(dx - 2 * s * nx, dy - 2 * s * ny, dz - 2 * s * nz),
        elem=ctx.elem,
        done=jnp.zeros(ctx.elem.shape[0], dtype=bool),
    )


class SearchResult(NamedTuple):
    elem_ids: jax.Array   # (N,) parent element per particle; INVALID if removed
    dest_c: Tuple[jax.Array, ...]  # per-component (N,) final destination
    iters: jax.Array      # () number of walk steps taken
    all_found: jax.Array  # () bool: everyone finished within the loop limit
    # with record_exit=True (find_exit_face parity, adjacency.tpp:232-364):
    exit_side: Optional[jax.Array] = None  # (N,) side of last real boundary
    #                                        hit; -1 if the walk never hit one
    hit_c: Optional[Tuple[jax.Array, ...]] = None  # (N,) boundary crossing pt
    num_hits: Optional[jax.Array] = None   # (N,) real boundary hits taken
    # with aux_capture: per-particle columns of the aux table at the FINAL
    # element, captured during the walk (no post-search gather needed)
    aux_c: Optional[Tuple[jax.Array, ...]] = None
    # with recover="project": loop-limit walkers accepted by projecting the
    # destination onto their current element (sliver/degenerate recovery
    # instead of deletion); None when recovery is off
    num_recovered: Optional[jax.Array] = None

    @property
    def dest(self) -> jax.Array:
        """(N, dim) stacked destination.  Prefer ``dest_c`` inside jitted
        code, which keeps positions as flat per-component arrays."""
        return jnp.stack(self.dest_c, axis=-1)


# ---------------------------------------------------------------------------
# walk cores: per-dimension geometry.  Each returns
#   (inside, next_elem, side, w_dest, w_orig_or_t)
# where w_dest/w_orig feed the exit-parameter computation (2D/3D BCC:
# t = w_orig / (w_orig - w_dest) of the crossed side's weight function;
# 3D MT: t is returned directly in w_orig_or_t and w_dest is None).
# ---------------------------------------------------------------------------

def _row_core_2d(g, dest, orig, need_t):
    """2D walk math on an already-gathered affine row ``g`` (…, ≥12):
    [a11 a12 c1, a21 a22 c2, nbr0..2, edge0..2].  Shared by the table-gather
    core and the peeled locator-cell-row pass (cells carry the same columns).
    """
    dx, dy = dest
    l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2]
    l2 = g[:, 3] * dx + g[:, 4] * dy + g[:, 5]
    w0 = 1.0 - l1 - l2
    m1 = jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy) + jnp.abs(g[:, 2])
    m2 = jnp.abs(g[:, 3] * dx) + jnp.abs(g[:, 4] * dy) + jnp.abs(g[:, 5])
    t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
    t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
    inside = (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)

    # most negative vertex weight -> cross the opposite edge; the table
    # columns are pre-permuted so col 6+k IS the exit across vertex k
    # (no int mod/mul in the hot loop)
    wmin = jnp.minimum(w0, l1)
    kmin = jnp.where(w0 <= l1, 0, 1)
    kmin = jnp.where(l2 < wmin, 2, kmin)
    wmin = jnp.minimum(wmin, l2)
    next_elem = jnp.where(
        kmin == 0, g[:, 6],
        jnp.where(kmin == 1, g[:, 7], g[:, 8]),
    ).astype(jnp.int32)
    side = jnp.where(
        kmin == 0, g[:, 9],
        jnp.where(kmin == 1, g[:, 10], g[:, 11]),
    ).astype(jnp.int32)
    t = None
    if need_t:
        ox, oy = orig
        l1o = g[:, 0] * ox + g[:, 1] * oy + g[:, 2]
        l2o = g[:, 3] * ox + g[:, 4] * oy + g[:, 5]
        w0o = 1.0 - l1o - l2o
        wo = jnp.where(kmin == 0, w0o, jnp.where(kmin == 1, l1o, l2o))
        t = wo / jnp.where(wo - wmin == 0, 1.0, wo - wmin)
    return inside, next_elem, side, t


def _core_2d(mesh: Mesh2D):
    def core(e_safe, dest, orig, need_t):
        # affine row (all f32; ids as floats so every consumer fuses off one
        # gather — see Mesh2D.walk_geom)
        g = mesh.walk_geom[e_safe]                 # (N, 12)
        return _row_core_2d(g, dest, orig, need_t)

    return core


def _core_3d_bcc(mesh: Mesh3D):
    def core(e_safe, dest, orig, need_t):
        dx, dy, dz = dest
        # affine row: [A1 c1, A2 c2, A3 c3, nbr0..3] (N, 16)
        g = mesh.walk_geom[e_safe]
        l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2] * dz + g[:, 3]
        l2 = g[:, 4] * dx + g[:, 5] * dy + g[:, 6] * dz + g[:, 7]
        l3 = g[:, 8] * dx + g[:, 9] * dy + g[:, 10] * dz + g[:, 11]
        w0 = 1.0 - l1 - l2 - l3
        m1 = (jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy)
              + jnp.abs(g[:, 2] * dz) + jnp.abs(g[:, 3]))
        m2 = (jnp.abs(g[:, 4] * dx) + jnp.abs(g[:, 5] * dy)
              + jnp.abs(g[:, 6] * dz) + jnp.abs(g[:, 7]))
        m3 = (jnp.abs(g[:, 8] * dx) + jnp.abs(g[:, 9] * dy)
              + jnp.abs(g[:, 10] * dz) + jnp.abs(g[:, 11]))
        t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
        t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
        t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
        inside = (
            (w0 >= -(t1 + t2 + t3)) & (l1 >= -t1)
            & (l2 >= -t2) & (l3 >= -t3)
        )

        wmin = w0
        kmin = jnp.zeros(e_safe.shape, jnp.int32)
        for k, lk in ((1, l1), (2, l2), (3, l3)):
            take = lk < wmin
            wmin = jnp.where(take, lk, wmin)
            kmin = jnp.where(take, k, kmin)
        exit_local = kmin
        next_elem = jnp.where(
            exit_local == 0, g[:, 12],
            jnp.where(
                exit_local == 1, g[:, 13],
                jnp.where(exit_local == 2, g[:, 14], g[:, 15]),
            ),
        ).astype(jnp.int32)
        face4 = mesh.elem2faces[e_safe]
        side = jnp.take_along_axis(face4, exit_local[:, None], axis=1)[:, 0]
        t = None
        if need_t:
            ox, oy, oz = orig
            l1o = g[:, 0] * ox + g[:, 1] * oy + g[:, 2] * oz + g[:, 3]
            l2o = g[:, 4] * ox + g[:, 5] * oy + g[:, 6] * oz + g[:, 7]
            l3o = g[:, 8] * ox + g[:, 9] * oy + g[:, 10] * oz + g[:, 11]
            w0o = 1.0 - l1o - l2o - l3o
            wo = jnp.where(
                kmin == 0, w0o,
                jnp.where(kmin == 1, l1o, jnp.where(kmin == 2, l2o, l3o)),
            )
            t = wo / jnp.where(wo - wmin == 0, 1.0, wo - wmin)
        return inside, next_elem, side, t

    return core


def _core_3d_hybrid(mesh: Mesh3D):
    """Hybrid BCC + segment-clip core (``search_mesh``'s interleaved BCC
    descent with intersection fallback, adjacency.hpp:558-768).

    Key observation: the intersection ("Möller–Trumbore") exit choice
    can be computed from the SAME 16-col barycentric affine row as the BCC
    test — each face's plane crossing parameter along orig→dest is
    ``t_k = l_k(orig) / (l_k(orig) - l_k(dest))`` for faces whose
    coordinate decreases — so sliver-robust clipping costs the same gather
    as greedy BCC (the 20-col ``walk_planes`` table is never touched).
    Walkers fall back to the greedy most-negative-coordinate step when the
    segment yields no exiting face (degenerate direction, orig == dest, or
    a guess trajectory the segment never enters)."""

    def core(e_safe, dest, orig, need_t):
        dx, dy, dz = dest
        ox, oy, oz = orig
        g = mesh.walk_geom[e_safe]
        ld = []
        lo = []
        for k in range(3):
            c = 4 * k
            ld.append(g[:, c] * dx + g[:, c + 1] * dy + g[:, c + 2] * dz
                      + g[:, c + 3])
            lo.append(g[:, c] * ox + g[:, c + 1] * oy + g[:, c + 2] * oz
                      + g[:, c + 3])
        ld = [1.0 - ld[0] - ld[1] - ld[2]] + ld     # w0 first: k = 0..3
        lo = [1.0 - lo[0] - lo[1] - lo[2]] + lo
        mags = []
        for k in range(3):
            c = 4 * k
            mags.append(jnp.abs(g[:, c] * dx) + jnp.abs(g[:, c + 1] * dy)
                        + jnp.abs(g[:, c + 2] * dz) + jnp.abs(g[:, c + 3]))
        tols = [BCC_REL_TOL * m + BCC_ABS_TOL for m in mags]
        tols = [tols[0] + tols[1] + tols[2]] + tols
        inside = (
            (ld[0] >= -tols[0]) & (ld[1] >= -tols[1])
            & (ld[2] >= -tols[2]) & (ld[3] >= -tols[3])
        )

        # BCC choice: most negative destination coordinate
        wmin = ld[0]
        kmin_bcc = jnp.zeros(e_safe.shape, jnp.int32)
        for k in (1, 2, 3):
            take = ld[k] < wmin
            wmin = jnp.where(take, ld[k], wmin)
            kmin_bcc = jnp.where(take, k, kmin_bcc)

        # segment-clip choice: earliest crossing among exiting faces.
        # The falling-coordinate rate is computed as the DIRECTIONAL
        # DERIVATIVE -A_k·v (v = dest - orig), not as lo[k] - ld[k]: the
        # two dot-product chains fuse differently under XLA and can differ
        # by 1 ulp even when orig == dest exactly, turning denom into
        # sign-noise — stationary peel-miss walkers then clipped against a
        # noise-selected face and cycled to the loop limit (round-5
        # review, reproduced: same walker converges eagerly but cycles
        # compiled).  With v == 0 every lv is exactly 0 → seg_ok False →
        # the BCC fallback runs, which is the correct stationary walk.
        vx, vy, vz = dx - ox, dy - oy, dz - oz
        lv = []
        for k in range(3):
            c = 4 * k
            lv.append(g[:, c] * vx + g[:, c + 1] * vy + g[:, c + 2] * vz)
        lv = [-lv[0] - lv[1] - lv[2]] + lv
        t_exit = jnp.full(e_safe.shape, jnp.inf, dx.dtype)
        kmin_seg = jnp.zeros(e_safe.shape, jnp.int32)
        for k in range(4):
            denom = -lv[k]                           # > 0: coordinate falls
            t_k = lo[k] / jnp.where(denom == 0, 1.0, denom)
            valid = (denom > 0) & (t_k < t_exit)
            t_exit = jnp.where(valid, t_k, t_exit)
            kmin_seg = jnp.where(valid, k, kmin_seg)
        seg_ok = jnp.isfinite(t_exit)
        exit_local = jnp.where(seg_ok, kmin_seg, kmin_bcc)

        next_elem = jnp.where(
            exit_local == 0, g[:, 12],
            jnp.where(
                exit_local == 1, g[:, 13],
                jnp.where(exit_local == 2, g[:, 14], g[:, 15]),
            ),
        ).astype(jnp.int32)
        face4 = mesh.elem2faces[e_safe]
        side = jnp.take_along_axis(face4, exit_local[:, None], axis=1)[:, 0]
        t = None
        if need_t:
            t = jnp.where(seg_ok, t_exit, 1.0)
        return inside, next_elem, side, t

    return core


def _core_3d_mt(mesh: Mesh3D):
    """Intersection (trace-through) core: clip the orig→dest segment against
    the current tet's outward face planes and cross the exit face — the
    reference's Möller–Trumbore path (``search_mesh_3d``,
    adjacency.hpp:314-555; ``find_exit_face`` adjacency.tpp:232-364).
    Robust on sliver tets where greedy BCC descent can ping-pong."""

    def core(e_safe, dest, orig, need_t):
        dx, dy, dz = dest
        ox, oy, oz = orig
        g = mesh.walk_planes[e_safe]              # (N, 20)
        vx, vy, vz = dx - ox, dy - oy, dz - oz    # segment direction

        inside = jnp.ones(e_safe.shape, bool)
        t_exit = jnp.full(e_safe.shape, jnp.inf, dx.dtype)
        exit_local = jnp.zeros(e_safe.shape, jnp.int32)
        viol_best = jnp.full(e_safe.shape, -jnp.inf, dx.dtype)
        viol_local = jnp.zeros(e_safe.shape, jnp.int32)
        for i in range(4):
            n_x, n_y, n_z, off = (g[:, 4 * i], g[:, 4 * i + 1],
                                  g[:, 4 * i + 2], g[:, 4 * i + 3])
            s_dest = n_x * dx + n_y * dy + n_z * dz
            # scale-aware slack (reference compute_tolerance_from_area)
            inside = inside & (s_dest <= off + MT_TOL * (1.0 + jnp.abs(off)))
            # most-violated plane (signed distance, unit normals): the
            # greedy stationary fallback below
            viol = s_dest - off
            vtake = viol > viol_best
            viol_best = jnp.where(vtake, viol, viol_best)
            viol_local = jnp.where(vtake, i, viol_local)
            n_dot_d = n_x * vx + n_y * vy + n_z * vz
            s_orig = n_x * ox + n_y * oy + n_z * oz
            t_i = (off - s_orig) / jnp.where(n_dot_d == 0, 1.0, n_dot_d)
            valid = (n_dot_d > 0) & (t_i < t_exit)
            t_exit = jnp.where(valid, t_i, t_exit)
            exit_local = jnp.where(valid, i, exit_local)

        # a MOVING segment that never exits along its direction is at its
        # parent; a STATIONARY one (v == 0 — every n·v is 0, t_exit inf)
        # must NOT be declared inside (round-5 review: a stationary
        # particle started at a wrong element — any accel peel miss —
        # got that wrong parent back silently).  It walks by greedy
        # most-violated-plane descent toward containment instead.
        moving = (vx != 0.0) | (vy != 0.0) | (vz != 0.0)
        exit_local = jnp.where(jnp.isfinite(t_exit), exit_local, viol_local)
        inside = inside | (moving & ~jnp.isfinite(t_exit))

        next_elem = jnp.where(
            exit_local == 0, g[:, 16],
            jnp.where(
                exit_local == 1, g[:, 17],
                jnp.where(exit_local == 2, g[:, 18], g[:, 19]),
            ),
        ).astype(jnp.int32)

        face4 = mesh.elem2faces[e_safe]
        side = jnp.take_along_axis(face4, exit_local[:, None], axis=1)[:, 0]
        t = jnp.where(jnp.isfinite(t_exit), t_exit, 1.0) if need_t else None
        return inside, next_elem, side, t

    return core


# ---------------------------------------------------------------------------
# stranded-walker recovery (sliver/degenerate robustness)
# ---------------------------------------------------------------------------

def _make_recover(mesh):
    """Projection recovery for loop-limit survivors: closest point on the
    walker's CURRENT element to its destination, accepted when the distance
    is within ``RECOVER_REL_TOL`` of the element scale.

    The reference recovers sliver-stranded walkers with a max-projected-
    distance face fallback inside the loop (``search_mesh``/
    ``processUndetected``, adjacency.hpp:602-762, 470-516) and ships
    ``closest_point_on_triangle`` (adjacency.hpp:910-1009) as the
    projection primitive its apps use; here the projection runs ONCE on
    the (narrow) set of walkers that would otherwise be deleted at the
    loop limit, so the hot converged path pays nothing.

    Returns ``recover(e, dest) -> (ok, q)``: ``q`` is the projected
    destination nudged toward the element centroid so containment tests
    strictly hold for the recovered pair."""

    def recover(e, dest):
        ev = mesh.elem2verts[jnp.maximum(e, 0)]          # (w, nv)
        vs = mesh.coords[ev]                             # (w, nv, dim)
        if mesh.dim == 2:
            zero = jnp.zeros_like(dest[0])
            p3 = jnp.stack([dest[0], dest[1], zero], axis=-1)
            v3 = jnp.concatenate(
                [vs, jnp.zeros(vs.shape[:2] + (1,), vs.dtype)], axis=-1)
            q3 = closest_point_on_triangle(p3, v3[:, 0], v3[:, 1], v3[:, 2])
            qc = (q3[:, 0], q3[:, 1])
            d2 = jnp.sum((q3 - p3) ** 2, axis=-1)
        else:
            p3 = jnp.stack(dest, axis=-1)
            best = None
            d2 = None
            # tet surface = min over its four faces (face i opposite vtx i)
            for (i, j, k) in ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)):
                q = closest_point_on_triangle(p3, vs[:, i], vs[:, j],
                                              vs[:, k])
                qd = jnp.sum((q - p3) ** 2, axis=-1)
                if best is None:
                    best, d2 = q, qd
                else:
                    take = qd < d2
                    best = jnp.where(take[:, None], q, best)
                    d2 = jnp.minimum(qd, d2)
            # an INTERIOR point has positive distance to every face — a
            # stranded-but-contained walker (done flag lost to the loop
            # limit right after its crossing) must be accepted as-is
            def _det3(a, b, c):
                return (a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
                        - a[:, 1] * (b[:, 0] * c[:, 2] - b[:, 2] * c[:, 0])
                        + a[:, 2] * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]))

            v0 = vs[:, 0]
            vol = _det3(vs[:, 1] - v0, vs[:, 2] - v0, vs[:, 3] - v0)
            sgn = jnp.sign(jnp.where(vol == 0, 1.0, vol))
            tolv = 1e-6 * jnp.abs(vol)
            contained = jnp.ones(e.shape, bool)
            corners = (vs[:, 0], vs[:, 1], vs[:, 2], vs[:, 3])
            for k in range(4):
                reps = [p3 if m == k else corners[m] for m in range(4)]
                wk = _det3(reps[1] - reps[0], reps[2] - reps[0],
                           reps[3] - reps[0])
                contained = contained & (wk * sgn >= -tolv)
            d2 = jnp.where(contained, 0.0, d2)
            best = jnp.where(contained[:, None], p3, best)
            qc = tuple(best[:, i] for i in range(3))
        cent = vs.mean(axis=1)                           # (w, dim)
        # element scale from the longest edge
        scale2 = jnp.zeros(e.shape, vs.dtype)
        nv = vs.shape[1]
        for i in range(nv):
            for j in range(i + 1, nv):
                scale2 = jnp.maximum(
                    scale2, jnp.sum((vs[:, i] - vs[:, j]) ** 2, axis=-1))
        ok = d2 <= (RECOVER_REL_TOL ** 2) * scale2
        q_out = tuple(
            qi + (cent[:, i] - qi) * RECOVER_NUDGE
            for i, qi in enumerate(qc)
        )
        return ok, q_out

    return recover


# ---------------------------------------------------------------------------
# walk engine
# ---------------------------------------------------------------------------

def _to_i32(a: jax.Array) -> jax.Array:
    """s32 carrier for the packed walk-state rows: floats are BITCAST to
    int32 (bit-exact through int pipelines); int32 passes through.  Never
    the reverse — int32 values below 2^23 bitcast to f32 are denormals,
    which a backend may flush to zero in copy/fusion paths."""
    if a.dtype == jnp.int32:
        return a
    return jax.lax.bitcast_convert_type(a, jnp.int32)


def _from_i32(a: jax.Array, dtype) -> jax.Array:
    if dtype == jnp.int32:
        return a
    return jax.lax.bitcast_convert_type(a, dtype)


def _compact_idx(done: jax.Array, m: int) -> jax.Array:
    """Indices of the first ``m`` not-done slots in slot order; entries == n
    where fewer survivors exist.

    For n < 2^24 this is a SINGLE-WORD radix sort of ``done<<24 | slot``
    packed into uint32 — one key instead of the stable argsort-of-bool's
    pair sort, identical result.  Falls back to stable argsort above 2^24 slots.
    """
    n = done.shape[0]
    if n < (1 << 24):
        key = jnp.where(done, jnp.uint32(1 << 24), jnp.uint32(0)) | jnp.arange(
            n, dtype=jnp.uint32)
        sk = jnp.sort(key)[:m]
        return jnp.where(
            sk >> 24 > 0, n, sk & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
    sidx = jnp.argsort(done, stable=True)[:m]
    return jnp.where(done[sidx], n, sidx).astype(jnp.int32)


def _make_step(core, mesh, boundary_handler, use_guess: bool,
               record_exit: bool, aux_table=None, recover: str = "off"):
    """One vectorized walk step, width-agnostic.  State arrays are all (N,).

    ``rec`` threads the optional per-particle capture state through the
    walk: first ``aux_table.shape[1]`` entries hold per-element aux values
    captured AT WALK FINISH (e.g. the push's per-element rotation — kills a
    full-width particle-rate gather downstream), then the exit-recording
    entries (side, num_hits, hit components) when ``record_exit``."""
    modifies = getattr(boundary_handler, "modifies_dest", True)
    # dest-modifying handlers (reflection) need the crossing point even
    # without record_exit: the continuation segment restarts AT THE WALL
    # (round-5 fix below) and that requires t
    needs_hit = (record_exit or modifies
                 or getattr(boundary_handler, "needs_hit", False))
    n_aux = 0 if aux_table is None else aux_table.shape[1]

    def step(elem, dest, done, fbg, orig, rec):
        # ``fbg`` fuses the on-guess flag and the fallback element into one
        # carried int32 array: >= 0 — on a guess trajectory, value = the true
        # previous element to retry from; -2 — not on a guess trajectory.
        # (One array instead of two halves the walk-state extraction gathers
        # at pyramid compaction.)
        e_safe = jnp.maximum(elem, 0)
        inside, next_elem, side, t = core(e_safe, dest, orig, needs_hit)
        exposed = next_elem == INVALID

        walking = ~done
        hits_boundary = walking & ~inside & exposed
        if use_guess:
            fg = fbg >= 0
            retry = hits_boundary & fg
            real_hit = hits_boundary & ~fg
        else:
            retry = jnp.zeros_like(hits_boundary)
            real_hit = hits_boundary

        hit = None
        if needs_hit:
            tc = jnp.clip(t, 0.0, 1.0)
            hit = tuple(o + tc * (d - o) for o, d in zip(orig, dest))

        bres = boundary_handler(
            BoundaryCtx(elem=elem, side=side, orig=orig, dest=dest,
                        mesh=mesh, hit=hit, t=t)
        )

        if use_guess:
            new_elem = jnp.where(
                walking & ~inside,
                jnp.where(retry, fbg,
                          jnp.where(exposed, bres.elem, next_elem)),
                elem,
            )
            new_fbg = jnp.where(
                fg & ~retry & ~(walking & inside), fbg, jnp.int32(-2)
            )
        else:
            new_elem = jnp.where(
                walking & ~inside,
                jnp.where(exposed, bres.elem, next_elem),
                elem,
            )
            new_fbg = fbg
        new_done = done | (walking & inside) | (real_hit & bres.done)
        if bres.dest is not None:
            dest = tuple(
                jnp.where(real_hit, bd, d) for bd, d in zip(bres.dest, dest)
            )
            # the continuation segment starts AT the crossing point, not at
            # the original origin: a ray-marching core (method=
            # "intersection") otherwise keeps following the ORIGINAL
            # orig→dest direction after the mirror, re-hits the same wall
            # every iteration, and deletes the particle at the loop limit
            # (round-5 review: gitr_like reflect oscillated 98 bounces and
            # lost every walker).  Also makes multi-bounce recorded hit
            # points exact: each hit is measured on its own wall-to-wall
            # segment.
            orig = tuple(
                jnp.where(real_hit, h, o) for h, o in zip(hit, orig)
            )
        if n_aux or record_exit:
            rec = list(rec)
        if n_aux:
            av = aux_table[e_safe]                     # (w, n_aux)
            newly = walking & inside
            for k in range(n_aux):
                rec[k] = jnp.where(newly, av[:, k], rec[k])
        if record_exit:
            side_rec, nhits = rec[n_aux], rec[n_aux + 1]
            hit_rec = rec[n_aux + 2:]
            rec[n_aux] = jnp.where(real_hit, side, side_rec)
            rec[n_aux + 1] = nhits + real_hit.astype(nhits.dtype)
            rec[n_aux + 2:] = [
                jnp.where(real_hit, h, hr) for h, hr in zip(hit, hit_rec)
            ]
        if n_aux or record_exit:
            rec = tuple(rec)
        return new_elem, dest, new_done, new_fbg, orig, rec

    # handlers that never move the destination (e.g. remove-on-exit) let the
    # walk treat dest as a per-level constant: no dest in the loop carry, no
    # dest merge scatters
    step.modifies_dest = getattr(boundary_handler, "modifies_dest", True)
    if recover not in ("off", "project"):
        raise ValueError(f"unknown recover mode {recover!r}; "
                         f"expected 'off' or 'project'")
    if recover == "project" and n_aux:
        raise ValueError("recover='project' cannot be combined with "
                         "aux_capture (recovered walkers never trigger the "
                         "at-finish capture)")
    step.recover_fn = _make_recover(mesh) if recover == "project" else None
    return step


def _run_walk(step, elem0, dest0, done0, orig, max_iters: int,
              fallback=None, fg0=None, record_exit: bool = False,
              widths: Optional[Tuple[int, ...]] = None,
              it0: int = 0,
              aux0: Tuple[jax.Array, ...] = (),
              recover_fn=None) -> SearchResult:
    """Pyramid walk: run at full width only while most walkers are live, then
    repeatedly shrink the working width, each time compacting the survivors
    of the PREVIOUS level (one O(N) argsort total); all levels' results
    scatter back at the end, shallow to deep, so deeper (fresher) state wins.

    ``dest0``/``orig`` are tuples of per-component (N,) arrays (see module
    docstring on flat state).  ``widths`` overrides the default
    pyramid (entries must be decreasing and < N).
    """
    n = elem0.shape[0]
    if recover_fn is None:
        recover_fn = getattr(step, "recover_fn", None)
    if fallback is None:
        fallback = elem0
    if fg0 is None:
        fg0 = jnp.zeros((n,), bool)
    # fused on-guess-flag + fallback carry (see _make_step)
    fbg0 = jnp.where(fg0, fallback.astype(jnp.int32), jnp.int32(-2))
    n_aux = len(aux0)
    rec0 = tuple(aux0)
    if record_exit:
        rec0 = rec0 + (
            jnp.full((n,), INVALID, jnp.int32),
            jnp.zeros((n,), jnp.int32),
        ) + tuple(jnp.asarray(d) for d in dest0)

    if widths is None:
        # default width pyramid: n/16, n/256, ... down to a 1024-wide tail
        # loop (tuned at 10M particles)
        widths = []
        w = n
        while w > TAIL_WIDTH and len(widths) < MAX_LEVELS:
            w = max(w // COMPACT_DIV, TAIL_WIDTH)
            widths.append(w)
    else:
        widths = [w for w in widths if w < n]

    # handlers that never move the destination (remove-on-exit, the hot
    # case) let dest ride as a per-level CLOSURE CONSTANT instead of loop
    # state: no dest copies in the while carry and no dest merge scatters.
    carry_dest = getattr(step, "modifies_dest", True)

    def make_body(dest_arr, orig_arr):
        if carry_dest:
            # orig rides the carry too: dest-modifying handlers restart
            # the segment at the wall crossing (see _make_step)
            def body(s):
                elem, dest, orig_c, done, fbg, rec, it = s
                elem, dest, done, fbg, orig_c, rec = step(
                    elem, dest, done, fbg, orig_c, rec
                )
                return elem, dest, orig_c, done, fbg, rec, it + 1
        else:
            def body(s):
                elem, done, fbg, rec, it = s
                elem, _, done, fbg, _, rec = step(
                    elem, dest_arr, done, fbg, orig_arr, rec
                )
                return elem, done, fbg, rec, it + 1

        return body

    def run_level(dest_arr, orig_arr, thresh, state):
        elem, done, fbg, rec, it = state
        if carry_dest:
            def cond(s):
                return (s[-1] < max_iters) & (jnp.sum(~s[3]) > thresh)

            elem, dest_arr, orig_arr, done, fbg, rec, it = jax.lax.while_loop(
                cond, make_body(dest_arr, orig_arr),
                (elem, dest_arr, orig_arr, done, fbg, rec, it),
            )
        else:
            def cond(s):
                return (s[-1] < max_iters) & (jnp.sum(~s[1]) > thresh)

            elem, done, fbg, rec, it = jax.lax.while_loop(
                cond, make_body(dest_arr, orig_arr),
                (elem, done, fbg, rec, it),
            )
        return elem, dest_arr, orig_arr, done, fbg, rec, it

    # level 0: full width until survivors fit the first compacted width
    thresh0 = widths[0] if widths else 0
    elem, dest, orig, done, fbg, rec, it = run_level(
        dest0, orig, thresh0,
        (elem0, done0, fbg0, rec0, jnp.int32(it0)),
    )

    # compacted levels, each extracted from the level above
    prev = (elem, dest, done, fbg, rec, orig)
    levels = []                       # (global_idx, state) per level
    last_done = done
    for li, m in enumerate(widths):
        p_elem, p_dest, p_done, p_fbg, p_rec, p_orig = prev
        next_thresh = widths[li + 1] if li + 1 < len(widths) else 0

        # packed single-word sort puts undone slots first in slot order —
        # same compaction as nonzero(size=m) / stable argsort (see
        # _compact_idx)
        pn = p_elem.shape[0]
        sidx = _compact_idx(p_done, m)
        in_range = sidx < pn
        sidx = jnp.minimum(sidx, pn - 1)
        # extract the always-needed walk state through ONE row gather: the
        # per-indexed-op fixed cost dominates extraction, so
        # elem/fbg/dest AND the rec/aux channel ride as bitcast-int32 rows
        # of a packed (k, pn) array (s32 carrier — float payloads bitcast
        # to int is the denormal-safe direction).  orig stays
        # separate (unused components DCE away there).
        packed = jnp.stack(
            [p_elem, p_fbg]
            + [jax.lax.bitcast_convert_type(d, jnp.int32) for d in p_dest]
            + [_to_i32(r) for r in p_rec]
        )
        cols = jnp.take(packed, sidx, axis=1)          # (2+dim+rec, m)
        s_elem = jnp.where(in_range, cols[0], INVALID)
        s_fbg = jnp.where(in_range, cols[1], jnp.int32(-2))
        s_dest = tuple(
            jax.lax.bitcast_convert_type(cols[2 + i], d.dtype)
            for i, d in enumerate(p_dest)
        )
        s_done = ~in_range
        o_rec = 2 + len(p_dest)
        s_rec = tuple(
            _from_i32(cols[o_rec + i], r.dtype) for i, r in enumerate(p_rec)
        )
        s_orig = tuple(o[sidx] for o in p_orig)
        # compose to global slot ids (out-of-range -> n, dropped at merge)
        if li == 0:
            gidx = jnp.where(in_range, sidx, n)
        else:
            prev_gidx = levels[-1][0]
            gidx = jnp.where(in_range, prev_gidx[sidx], n)

        s_elem, s_dest, s_orig, s_done, s_fbg, s_rec, it = run_level(
            s_dest, s_orig, next_thresh,
            (s_elem, s_done, s_fbg, s_rec, it),
        )
        levels.append((gidx, (s_elem, s_dest, s_done, s_rec)))
        prev = (s_elem, s_dest, s_done, s_fbg, s_rec, s_orig)
        last_done = s_done

    # stranded-walker recovery (sliver/degenerate robustness): before the
    # loop-limit deletion, survivors whose destination sits within float
    # noise of their current element's closure are accepted with the
    # projected destination (see _make_recover).  Runs on the DEEPEST
    # pyramid level only — stranded walkers persist through every level, so
    # by the loop limit they have compacted into it (shallower unfinished
    # slots only exist when survivors exceed a level width at the limit;
    # those keep the reference's deletion semantics).
    num_recovered = jnp.int32(0)
    recover_scatter = None            # (gidx, ok, q) for the dest fix-up
    if recover_fn is not None:
        if levels:
            gidx_l, (s_elem, s_dest, s_done, s_rec) = levels[-1]
            und = ~s_done & (s_elem >= 0)
            r_ok, r_q = recover_fn(s_elem, s_dest)
            rec_ok = und & r_ok
            s_done = s_done | rec_ok
            levels[-1] = (gidx_l, (s_elem, s_dest, s_done, s_rec))
            last_done = s_done
            num_recovered = jnp.sum(rec_ok.astype(jnp.int32))
            recover_scatter = (gidx_l, rec_ok, r_q)
        else:
            und = ~done & (elem >= 0)
            r_ok, r_q = recover_fn(elem, dest)
            rec_ok = und & r_ok
            done = done | rec_ok
            last_done = done
            num_recovered = jnp.sum(rec_ok.astype(jnp.int32))
            dest = tuple(
                jnp.where(rec_ok, qi, d) for qi, d in zip(r_q, dest))

    # loop-limit fallback on the level-0 slots (deeper levels overwrite):
    # delete unfinished walkers (adjacency.hpp:1126-1149)
    elem = jnp.where(done, elem, INVALID)
    # merge: shallow -> deep so fresher (deeper) values overwrite.  Each
    # level scatters its FINAL elem (INVALID where its walkers didn't
    # finish) — replacing separate done merge scatters; all_found needs only the deepest
    # level's done (every shallower survivor is carried one level deeper).
    # elem + the rec/aux channel merge as ONE packed s32 column scatter per
    # level (the per-indexed-op fixed cost is per scatter, not per element
    # — the unpacked per-entry rec merges were what sank the round-2e
    # aux-capture attempt).
    if rec:
        merged = jnp.stack([elem] + [_to_i32(r) for r in rec])
        for gidx, (s_elem, s_dest, s_done, s_rec) in levels:
            src = jnp.stack(
                [jnp.where(s_done, s_elem, INVALID)]
                + [_to_i32(r) for r in s_rec]
            )
            merged = merged.at[:, gidx].set(src, mode="drop")
            if carry_dest:
                dest = tuple(
                    d.at[gidx].set(sd, mode="drop")
                    for d, sd in zip(dest, s_dest)
                )
        elem = merged[0]
        rec = tuple(
            _from_i32(merged[1 + i], r.dtype) for i, r in enumerate(rec)
        )
    else:
        for gidx, (s_elem, s_dest, s_done, s_rec) in levels:
            elem = elem.at[gidx].set(
                jnp.where(s_done, s_elem, INVALID), mode="drop")
            if carry_dest:
                dest = tuple(
                    d.at[gidx].set(sd, mode="drop")
                    for d, sd in zip(dest, s_dest)
                )

    if recover_scatter is not None:
        # recovered walkers' destinations move to the projected point (the
        # levels' dest merge wrote their LAST walk dest, which need not be
        # contained); a handful of slots, one narrow scatter per component
        gidx_l, rec_ok, r_q = recover_scatter
        gidx_r = jnp.where(rec_ok, gidx_l, n)
        dest = tuple(
            d.at[gidx_r].set(qi, mode="drop") for d, qi in zip(dest, r_q))

    all_found = jnp.all(last_done)
    num_rec = num_recovered if recover_fn is not None else None
    aux_c = rec[:n_aux] if n_aux else None
    if record_exit:
        return SearchResult(
            elem_ids=elem, dest_c=dest, iters=it, all_found=all_found,
            exit_side=rec[n_aux], num_hits=rec[n_aux + 1],
            hit_c=rec[n_aux + 2:], aux_c=aux_c, num_recovered=num_rec,
        )
    return SearchResult(
        elem_ids=elem, dest_c=dest, iters=it, all_found=all_found,
        aux_c=aux_c, num_recovered=num_rec,
    )


def _components(x) -> Tuple[jax.Array, ...]:
    """Split an (N, dim) array into per-component (N,) arrays; tuples pass
    through (callers may keep flat state end to end)."""
    if isinstance(x, tuple):
        return x
    return tuple(x[:, i] for i in range(x.shape[1]))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=(
    "max_iters", "boundary_handler", "record_exit", "widths", "recover"))
def search_mesh_2d(
    mesh: Mesh2D,
    x_orig: jax.Array,
    x_tgt: jax.Array,
    elem_init: jax.Array,
    active: jax.Array,
    max_iters: int = 200,
    boundary_handler: Callable[[BoundaryCtx], BoundaryResult] = remove_on_exit,
    record_exit: bool = False,
    widths: Optional[Tuple[int, ...]] = None,
    recover: str = "off",
) -> SearchResult:
    """Walk every active particle from ``elem_init`` to the element containing
    ``x_tgt``.  Inactive particles get ``elem_ids == INVALID``.

    Matches ``search_mesh_2d`` semantics (adjacency.hpp:1011-1158): boundary
    exits are delegated to ``boundary_handler``; particles still walking when
    ``max_iters`` is hit are deleted, as the reference does at its loop limit.
    ``recover="project"`` first projects loop-limit survivors onto their
    current element and deletes only genuinely unreachable ones (see
    :func:`_make_recover`; ``SearchResult.num_recovered`` counts them).
    """
    # clamp garbage starts so returned ids are always valid mesh elements
    elem0 = jnp.where(
        active, jnp.clip(elem_init.astype(jnp.int32), 0, mesh.nelems - 1),
        INVALID,
    )
    done0 = ~active
    step = _make_step(_core_2d(mesh), mesh, boundary_handler, False,
                      record_exit, recover=recover)
    return _run_walk(
        step, elem0, _components(x_tgt), done0, _components(x_orig),
        max_iters, record_exit=record_exit, widths=widths,
    )


@partial(jax.jit, static_argnames=(
    "max_iters", "boundary_handler", "method", "record_exit", "widths",
    "recover"))
def search_mesh_3d(
    mesh: Mesh3D,
    x_orig: jax.Array,
    x_tgt: jax.Array,
    elem_init: jax.Array,
    active: jax.Array,
    max_iters: int = 200,
    boundary_handler: Callable[[BoundaryCtx], BoundaryResult] = remove_on_exit,
    method: str = "bcc",
    record_exit: bool = False,
    widths: Optional[Tuple[int, ...]] = None,
    recover: str = "off",
) -> SearchResult:
    """Tet-mesh walk with the same boundary/loop-limit semantics as the
    reference's ``search_mesh`` (adjacency.hpp:558-768).

    ``method='bcc'``: greedy barycentric descent — cross the face opposite
    the most negative vertex weight (cheapest; one 16-col gather per step).
    ``method='intersection'``: clip the orig→dest segment against the tet's
    face planes and cross the exit face (the Möller–Trumbore trace of
    adjacency.tpp:232-364; robust on sliver tets, one 20-col gather).
    ``method='hybrid'``: the reference ``search_mesh``'s interleaved BCC +
    intersection-fallback walk (adjacency.hpp:558-768) — segment-clip exit
    computed from the SAME 16-col row as BCC (sliver-robust at BCC cost),
    greedy fallback when the segment has no exiting face."""
    elem0 = jnp.where(
        active, jnp.clip(elem_init.astype(jnp.int32), 0, mesh.nelems - 1),
        INVALID,
    )
    done0 = ~active
    core = {
        "intersection": _core_3d_mt, "hybrid": _core_3d_hybrid,
    }.get(method, _core_3d_bcc)(mesh)
    step = _make_step(core, mesh, boundary_handler, False, record_exit,
                      recover=recover)
    return _run_walk(
        step, elem0, _components(x_tgt), done0, _components(x_orig),
        max_iters, record_exit=record_exit, widths=widths,
    )


@partial(jax.jit, static_argnames=(
    "max_iters", "boundary_handler", "record_exit", "widths", "recover"))
def search_mesh_2d_accel(
    mesh: Mesh2D,
    grid,
    x_orig: jax.Array,
    x_tgt: jax.Array,
    elem_prev: jax.Array,
    active: jax.Array,
    max_iters: int = 200,
    boundary_handler: Callable[[BoundaryCtx], BoundaryResult] = remove_on_exit,
    record_exit: bool = False,
    widths: Optional[Tuple[int, ...]] = None,
    aux_capture: Optional[jax.Array] = None,
    recover: str = "off",
) -> SearchResult:
    """Grid-accelerated 2D search: walk from a background-grid guess of the
    DESTINATION (1-2 hops) instead of the previous element (one hop per
    element crossed).  Walkers whose guess-walk exits the domain — guess
    errors and genuine boundary exits alike — reset mid-walk to their true
    previous element with the real boundary handler, so results match
    :func:`search_mesh_2d` exactly.

    ``grid``: a :class:`pumipic_jax.mesh.locator.LocatorGrid2D` for ``mesh``.
    When the grid carries ``cell_rows`` (``attach_cell_rows``), the guess
    gather and the first containment pass collapse into ONE gather off the
    cell table — bit-identical results, minus one full-width walk-table
    gather.

    ``aux_capture``: optional (E, A) f32 table whose row at each particle's
    FINAL element is captured during the walk and returned as
    ``SearchResult.aux_c`` — e.g. the push's per-element rotation, saving a
    full-width particle-rate gather downstream.  With cell rows it requires
    a grid built with the same aux (``attach_cell_rows(..., aux=...)``).
    """
    step = _make_step(_core_2d(mesh), mesh, boundary_handler, True,
                      record_exit, aux_table=aux_capture, recover=recover)
    fallback = jnp.where(
        active, jnp.clip(elem_prev.astype(jnp.int32), 0, mesh.nelems - 1),
        INVALID,
    )
    dest = _components(x_tgt)
    n = elem_prev.shape[0]
    n_aux = 0 if aux_capture is None else aux_capture.shape[1]
    if grid.cell_lines is not None:
        # slim separating-line peel: a 5-col gather off the cell table picks
        # between the cell's two candidates exactly (A's barycentric
        # coordinate toward B — see attach_cell_lines), then ONE 12-col
        # gather off the SMALL walk_geom table proves containment inline —
        # same peel structure as the 14-col rows (no full-width walk pass;
        # a level-0 step costs several times its gather in elementwise
        # consumers) but the big-table traffic drops
        # from 14 to 5 columns.  Survivors sit on the picked candidate as
        # guess-trajectory walkers, exactly like the rows peel.
        g = grid.cell_lines[grid.cell_of(dest)]        # (N, 5)
        dx, dy = dest
        pick_a = g[:, 0] * dx + g[:, 1] * dy + g[:, 2] >= 0
        e0 = jnp.where(pick_a, g[:, 3], g[:, 4]).astype(jnp.int32)
        wg = mesh.walk_geom[e0]                        # (N, 12) small table
        l1 = wg[:, 0] * dx + wg[:, 1] * dy + wg[:, 2]
        l2 = wg[:, 3] * dx + wg[:, 4] * dy + wg[:, 5]
        w0 = 1.0 - l1 - l2
        m1 = (jnp.abs(wg[:, 0] * dx) + jnp.abs(wg[:, 1] * dy)
              + jnp.abs(wg[:, 2]))
        m2 = (jnp.abs(wg[:, 3] * dx) + jnp.abs(wg[:, 4] * dy)
              + jnp.abs(wg[:, 5]))
        t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
        t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
        inside = (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)
        elem0 = jnp.where(active, e0, INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        if n_aux:
            av = aux_capture[e0]
            aux0 = tuple(jnp.where(active & inside, av[:, k], 0.0)
                         for k in range(n_aux))
        else:
            aux0 = ()
        # it0=1: the peel containment test counts as one walk iteration
        # (the reference's per-containment-test budget)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1, aux0=aux0,
        )
    if grid.cell_rows is not None and grid.cell_rows_b is not None:
        # split-rows peel: candidate A and B live in two SEPARATE 7-col
        # tables gathered with the same index — two independent sub-cliff
        # gathers instead of one above-cliff 14-col gather (the gather
        # cliff is per-table; unlike the rejected "lines" chain these two
        # have no data dependency and can overlap).
        c = grid.cell_of(dest)
        ga_ = grid.cell_rows[c]                       # (N, 7)
        gb_ = grid.cell_rows_b[c]                     # (N, 7)
        elem_a = ga_[:, 6].astype(jnp.int32)
        elem_b = gb_[:, 6].astype(jnp.int32)
        dx, dy = dest

        def _inside_row(g):
            l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2]
            l2 = g[:, 3] * dx + g[:, 4] * dy + g[:, 5]
            w0 = 1.0 - l1 - l2
            m1 = (jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy)
                  + jnp.abs(g[:, 2]))
            m2 = (jnp.abs(g[:, 3] * dx) + jnp.abs(g[:, 4] * dy)
                  + jnp.abs(g[:, 5]))
            t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
            t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
            return (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)

        inside_a = _inside_row(ga_)
        inside_b = _inside_row(gb_)
        inside = inside_a | inside_b
        elem0 = jnp.where(
            active, jnp.where(inside_a | ~inside, elem_a, elem_b), INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        if n_aux:
            raise ValueError("aux_capture unsupported with split rows")
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1, aux0=(),
        )
    if grid.cell_rows is not None and grid.rows_layout == "rows_ab":
        # rows_ab peel: candidate A's full row + candidate B's id only
        # ([A affine 6 | elemA | elemB], attach_cell_rows(ab=True)) —
        # half the peel bytes; A-misses start the walk at B (their first
        # walk iteration is B's containment test)
        if n_aux:
            raise ValueError("aux_capture unsupported with rows_ab")
        g = grid.cell_rows[grid.cell_of(dest)]        # (N, 8)
        elem_a = g[:, 6].astype(jnp.int32)
        elem_b = g[:, 7].astype(jnp.int32)
        dx, dy = dest
        l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2]
        l2 = g[:, 3] * dx + g[:, 4] * dy + g[:, 5]
        w0 = 1.0 - l1 - l2
        m1 = jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy) + jnp.abs(g[:, 2])
        m2 = jnp.abs(g[:, 3] * dx) + jnp.abs(g[:, 4] * dy) + jnp.abs(g[:, 5])
        t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
        t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
        inside_a = (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)
        elem0 = jnp.where(
            active, jnp.where(inside_a, elem_a, elem_b), INVALID)
        fg0 = active & ~inside_a
        done0 = ~active | (active & inside_a)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1,
        )
    if grid.cell_rows is not None:
        # peeled first pass off the cell-resident candidate rows: the guess
        # gather, the containment test, and the edge-straddling second
        # candidate all ride ONE gather (gather cost scales with row
        # bytes).  Misses stay on candidate A as guess-trajectory survivors;
        # the pyramid's first narrow pass crosses or retries from the true
        # previous element — identical results, one deferred hop for the
        # ~5% miss tail.
        # Row layout (attach_cell_rows): [A affine 6 | elemA | auxA (A)]
        # then the same for candidate B.
        ga = (grid.cell_rows.shape[1] - 14) // 2      # aux cols per candidate
        if aux_capture is not None and ga != n_aux:
            raise ValueError(
                f"grid cell_rows carry {ga} aux columns but aux_capture has "
                f"{n_aux}; rebuild the locator with attach_cell_rows(aux=...)"
            )
        ob = 7 + ga                                    # candidate B offset
        g = grid.cell_rows[grid.cell_of(dest)]        # (N, 14 + 2*ga)
        elem_a = g[:, 6].astype(jnp.int32)
        elem_b = g[:, ob + 6].astype(jnp.int32)
        dx, dy = dest

        def _inside(o):
            l1 = g[:, o + 0] * dx + g[:, o + 1] * dy + g[:, o + 2]
            l2 = g[:, o + 3] * dx + g[:, o + 4] * dy + g[:, o + 5]
            w0 = 1.0 - l1 - l2
            m1 = (jnp.abs(g[:, o + 0] * dx) + jnp.abs(g[:, o + 1] * dy)
                  + jnp.abs(g[:, o + 2]))
            m2 = (jnp.abs(g[:, o + 3] * dx) + jnp.abs(g[:, o + 4] * dy)
                  + jnp.abs(g[:, o + 5]))
            t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
            t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
            return (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)

        inside_a = _inside(0)
        inside_b = _inside(ob)
        inside = inside_a | inside_b
        elem0 = jnp.where(
            active, jnp.where(inside_a | ~inside, elem_a, elem_b), INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        # NOTE: it0=1 below — the peeled containment test COUNTS as one walk
        # iteration, matching the reference's per-containment-test budget
        # (each loop turn of adjacency.hpp:1011-1158 is one test); a particle
        # may take one fewer adjacency hop than max_iters on this path.
        aux0 = tuple(
            jnp.where(inside_a, g[:, 7 + k],
                      jnp.where(inside_b, g[:, ob + 7 + k], 0.0))
            for k in range(n_aux)
        )
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1, aux0=aux0,
        )
    guess = grid.guess(x_tgt)
    elem0 = jnp.where(active, guess, INVALID)
    aux0 = tuple(jnp.zeros((n,), jnp.float32) for _ in range(n_aux))
    return _run_walk(
        step, elem0, dest, done0=~active,
        orig=_components(x_orig), max_iters=max_iters,
        fallback=fallback, fg0=active, record_exit=record_exit,
        widths=widths, aux0=aux0,
    )


@partial(jax.jit, static_argnames=(
    "max_iters", "boundary_handler", "method", "record_exit", "widths",
    "recover"))
def search_mesh_3d_accel(
    mesh: Mesh3D,
    grid,
    x_orig: jax.Array,
    x_tgt: jax.Array,
    elem_prev: jax.Array,
    active: jax.Array,
    max_iters: int = 200,
    boundary_handler: Callable[[BoundaryCtx], BoundaryResult] = remove_on_exit,
    method: str = "bcc",
    record_exit: bool = False,
    widths: Optional[Tuple[int, ...]] = None,
    recover: str = "off",
) -> SearchResult:
    """Grid-accelerated 3D search (see :func:`search_mesh_2d_accel`).

    ``grid``: a :class:`pumipic_jax.mesh.locator.LocatorGrid3D` for ``mesh``.
    When the grid carries ``cell_rows`` (``attach_cell_rows_3d``) the guess
    gather and the first containment test collapse into one gather with a
    second candidate for straddling cells (see the 2D path).
    """
    core = {
        "intersection": _core_3d_mt, "hybrid": _core_3d_hybrid,
    }.get(method, _core_3d_bcc)(mesh)
    step = _make_step(core, mesh, boundary_handler, True, record_exit,
                      recover=recover)
    fallback = jnp.where(
        active, jnp.clip(elem_prev.astype(jnp.int32), 0, mesh.nelems - 1),
        INVALID,
    )
    dest = _components(x_tgt)
    if getattr(grid, "cell_ids", None) is not None:
        # id-diet peel (attach_cell_ids_3d): the cell table carries ONLY
        # the top-k candidate ids (int32), and each candidate's
        # containment test chains a gather off the small per-element
        # walk_geom table — both gathers sub-cliff at ANY locator
        # resolution, so the grid can buy hit rate with cells that the
        # inline 26-col rows could never afford (cpe32: 6.2 MB vs 81 MB)
        c = grid.cell_of(dest)
        ids = grid.cell_ids[c]                         # (N, k) i32, tiny
        dx, dy, dz = dest
        wg12 = mesh.walk_geom[:, :12]                  # (E, 12) small

        def _inside_wg(wg):
            l1 = wg[:, 0] * dx + wg[:, 1] * dy + wg[:, 2] * dz + wg[:, 3]
            l2 = wg[:, 4] * dx + wg[:, 5] * dy + wg[:, 6] * dz + wg[:, 7]
            l3 = (wg[:, 8] * dx + wg[:, 9] * dy + wg[:, 10] * dz
                  + wg[:, 11])
            w0 = 1.0 - l1 - l2 - l3
            m1 = (jnp.abs(wg[:, 0] * dx) + jnp.abs(wg[:, 1] * dy)
                  + jnp.abs(wg[:, 2] * dz) + jnp.abs(wg[:, 3]))
            m2 = (jnp.abs(wg[:, 4] * dx) + jnp.abs(wg[:, 5] * dy)
                  + jnp.abs(wg[:, 6] * dz) + jnp.abs(wg[:, 7]))
            m3 = (jnp.abs(wg[:, 8] * dx) + jnp.abs(wg[:, 9] * dy)
                  + jnp.abs(wg[:, 10] * dz) + jnp.abs(wg[:, 11]))
            t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
            t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
            t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
            return ((w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2)
                    & (l3 >= -t3))

        kk = ids.shape[1]
        best = ids[:, 0]
        found = jnp.zeros(best.shape, bool)
        for j in range(kk):
            ej = ids[:, j]
            ins = _inside_wg(wg12[ej])
            best = jnp.where(ins & ~found, ej, best)
            found = found | ins
        elem0 = jnp.where(active, jnp.where(found, best, ids[:, 0]),
                          INVALID)
        fg0 = active & ~found
        done0 = ~active | (active & found)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=max(kk - 1, 1),
        )
    if grid.cell_lines is not None:
        # slim separating-plane peel with inline containment off the small
        # walk_geom table (see the 2D path / attach_cell_lines_3d)
        g = grid.cell_lines[grid.cell_of(dest)]        # (N, 6)
        dx, dy, dz = dest
        pick_a = g[:, 0] * dx + g[:, 1] * dy + g[:, 2] * dz + g[:, 3] >= 0
        e0 = jnp.where(pick_a, g[:, 4], g[:, 5]).astype(jnp.int32)
        wg = mesh.walk_geom[e0]                        # (N, 16) small table
        l1 = wg[:, 0] * dx + wg[:, 1] * dy + wg[:, 2] * dz + wg[:, 3]
        l2 = wg[:, 4] * dx + wg[:, 5] * dy + wg[:, 6] * dz + wg[:, 7]
        l3 = wg[:, 8] * dx + wg[:, 9] * dy + wg[:, 10] * dz + wg[:, 11]
        w0 = 1.0 - l1 - l2 - l3
        m1 = (jnp.abs(wg[:, 0] * dx) + jnp.abs(wg[:, 1] * dy)
              + jnp.abs(wg[:, 2] * dz) + jnp.abs(wg[:, 3]))
        m2 = (jnp.abs(wg[:, 4] * dx) + jnp.abs(wg[:, 5] * dy)
              + jnp.abs(wg[:, 6] * dz) + jnp.abs(wg[:, 7]))
        m3 = (jnp.abs(wg[:, 8] * dx) + jnp.abs(wg[:, 9] * dy)
              + jnp.abs(wg[:, 10] * dz) + jnp.abs(wg[:, 11]))
        t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
        t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
        t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
        inside = ((w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2)
                  & (l3 >= -t3))
        elem0 = jnp.where(active, e0, INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1,
        )
    if grid.cell_rows is not None and grid.cell_rows_b is not None:
        # split-rows peel (3D): candidates A and B in two separate 13-col
        # tables, two independent half-byte gathers at the same index
        # (see the 2D split branch; the gather cliff is per-table)
        c = grid.cell_of(dest)
        ga_ = grid.cell_rows[c]                        # (N, 13)
        gb_ = grid.cell_rows_b[c]                      # (N, 13)
        elem_a = ga_[:, 12].astype(jnp.int32)
        elem_b = gb_[:, 12].astype(jnp.int32)
        dx, dy, dz = dest

        def _inside_row3(g):
            l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2] * dz + g[:, 3]
            l2 = g[:, 4] * dx + g[:, 5] * dy + g[:, 6] * dz + g[:, 7]
            l3 = g[:, 8] * dx + g[:, 9] * dy + g[:, 10] * dz + g[:, 11]
            w0 = 1.0 - l1 - l2 - l3
            m1 = (jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy)
                  + jnp.abs(g[:, 2] * dz) + jnp.abs(g[:, 3]))
            m2 = (jnp.abs(g[:, 4] * dx) + jnp.abs(g[:, 5] * dy)
                  + jnp.abs(g[:, 6] * dz) + jnp.abs(g[:, 7]))
            m3 = (jnp.abs(g[:, 8] * dx) + jnp.abs(g[:, 9] * dy)
                  + jnp.abs(g[:, 10] * dz) + jnp.abs(g[:, 11]))
            t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
            t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
            t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
            return ((w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2)
                    & (l3 >= -t3))

        inside_a = _inside_row3(ga_)
        inside_b = _inside_row3(gb_)
        inside = inside_a | inside_b
        elem0 = jnp.where(
            active, jnp.where(inside_a | ~inside, elem_a, elem_b), INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1,
        )
    if grid.cell_rows is not None and grid.rows_layout == "rows_ab":
        # rows_ab peel: candidate A's full row + candidate B's id only
        # (attach_cell_rows_3d(ab=True)) — the peel proves containment in
        # A with a half-byte gather; A-misses start the walk at B, whose
        # containment test is their first walk iteration (it0=1 keeps the
        # reference's per-containment-test iteration budget)
        g = grid.cell_rows[grid.cell_of(dest)]          # (N, 14)
        elem_a = g[:, 12].astype(jnp.int32)
        elem_b = g[:, 13].astype(jnp.int32)
        dx, dy, dz = dest
        l1 = g[:, 0] * dx + g[:, 1] * dy + g[:, 2] * dz + g[:, 3]
        l2 = g[:, 4] * dx + g[:, 5] * dy + g[:, 6] * dz + g[:, 7]
        l3 = g[:, 8] * dx + g[:, 9] * dy + g[:, 10] * dz + g[:, 11]
        w0 = 1.0 - l1 - l2 - l3
        m1 = (jnp.abs(g[:, 0] * dx) + jnp.abs(g[:, 1] * dy)
              + jnp.abs(g[:, 2] * dz) + jnp.abs(g[:, 3]))
        m2 = (jnp.abs(g[:, 4] * dx) + jnp.abs(g[:, 5] * dy)
              + jnp.abs(g[:, 6] * dz) + jnp.abs(g[:, 7]))
        m3 = (jnp.abs(g[:, 8] * dx) + jnp.abs(g[:, 9] * dy)
              + jnp.abs(g[:, 10] * dz) + jnp.abs(g[:, 11]))
        t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
        t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
        t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
        inside_a = ((w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2)
                    & (l3 >= -t3))
        elem0 = jnp.where(
            active, jnp.where(inside_a, elem_a, elem_b), INVALID)
        fg0 = active & ~inside_a
        done0 = ~active | (active & inside_a)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1,
        )
    if grid.cell_rows is not None:
        # 26-col: [A affine 12 | elemA | B affine 12 | elemB]; 27-col
        # (rows_abc, attach_cell_rows_3d(abc=True)): + elemC, a third-ranked
        # walk START HINT for the A∪B both-miss tail (13.7% at cpe16 on
        # tets) — one extra gathered column against a shallower pyramid
        has_c = grid.rows_layout == "rows_abc"
        g = grid.cell_rows[grid.cell_of(dest)]          # (N, 26|27)
        elem_a = g[:, 12].astype(jnp.int32)
        elem_b = g[:, 25].astype(jnp.int32)
        dx, dy, dz = dest

        def _inside(o):
            l1 = (g[:, o + 0] * dx + g[:, o + 1] * dy + g[:, o + 2] * dz
                  + g[:, o + 3])
            l2 = (g[:, o + 4] * dx + g[:, o + 5] * dy + g[:, o + 6] * dz
                  + g[:, o + 7])
            l3 = (g[:, o + 8] * dx + g[:, o + 9] * dy + g[:, o + 10] * dz
                  + g[:, o + 11])
            w0 = 1.0 - l1 - l2 - l3
            m1 = (jnp.abs(g[:, o + 0] * dx) + jnp.abs(g[:, o + 1] * dy)
                  + jnp.abs(g[:, o + 2] * dz) + jnp.abs(g[:, o + 3]))
            m2 = (jnp.abs(g[:, o + 4] * dx) + jnp.abs(g[:, o + 5] * dy)
                  + jnp.abs(g[:, o + 6] * dz) + jnp.abs(g[:, o + 7]))
            m3 = (jnp.abs(g[:, o + 8] * dx) + jnp.abs(g[:, o + 9] * dy)
                  + jnp.abs(g[:, o + 10] * dz) + jnp.abs(g[:, o + 11]))
            t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
            t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
            t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
            return ((w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2)
                    & (l3 >= -t3))

        inside_a = _inside(0)
        inside_b = _inside(13)
        inside = inside_a | inside_b
        if has_c:
            miss_start = g[:, 26].astype(jnp.int32)   # third-ranked hint
        else:
            miss_start = elem_a                       # walk from A (as ever)
        elem0 = jnp.where(
            active,
            jnp.where(inside_a, elem_a,
                      jnp.where(inside_b, elem_b, miss_start)),
            INVALID)
        fg0 = active & ~inside
        done0 = ~active | (active & inside)
        return _run_walk(
            step, elem0, dest, done0=done0, orig=_components(x_orig),
            max_iters=max_iters, fallback=fallback, fg0=fg0,
            record_exit=record_exit, widths=widths, it0=1,
        )
    guess = grid.guess(x_tgt)
    elem0 = jnp.where(active, guess, INVALID)
    return _run_walk(
        step, elem0, dest, done0=~active,
        orig=_components(x_orig), max_iters=max_iters,
        fallback=fallback, fg0=active, record_exit=record_exit,
        widths=widths,
    )


def search_mesh_2d_pt(
    mesh: Mesh2D,
    pt: jax.Array,
    elem_init,
    max_iters: int = 100,
) -> jax.Array:
    """Single-point location (``search_mesh_2d_pt``, adjacency.hpp:1160-1252):
    returns the containing element id or -1."""
    pt = jnp.asarray(pt, jnp.float32).reshape(1, 2)
    res = search_mesh_2d(
        mesh, pt, pt, jnp.asarray([elem_init], jnp.int32),
        jnp.ones((1,), bool), max_iters,
    )
    return res.elem_ids[0]


def check_initial_parents(
    mesh,
    x_orig,
    elem_init: jax.Array,
    active: jax.Array,
    mode: str = "repair",
    max_iters: int = 32,
    locator=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Validate — and optionally repair — claimed parent elements on walk
    entry.

    The reference validates that every particle's ORIGIN lies in its claimed
    parent and DELETES violators with a warning count
    (``check_initial_parents``, adjacency.tpp:72-151; ``search_mesh_3d``'s
    ``checkParent`` hard-asserts instead, adjacency.hpp:371-383).  Bad
    parents happen with stale app state, after external pushes, or on
    imported meshes whose seeding disagrees with the walk tolerance — and a
    walk from a wrong parent can cross the domain boundary and silently
    delete an in-domain particle.

    ``mode="delete"``: reference semantics — invalid-parent particles get
    ``INVALID``.  ``mode="repair"``: relocate them first (a bounded walk
    toward the origin from the stale parent — or from ``locator``'s guess
    of the origin when given) and delete only off-mesh origins.

    Returns ``(elem, num_bad, num_repaired)``: ``elem`` is int32 with
    repaired/validated parents (``INVALID`` where inactive or deleted).
    Call before the search; cost is one particle-rate row gather, plus the
    repair walk when bad parents exist (it converges immediately for the
    all-good case).

    Non-convex caveat: without ``locator``, the repair walk starts from the
    stale parent and can hit an interior boundary when the straight path to
    the origin crosses a hole (greedy-walk semantics, module docstring) —
    those particles are deleted, the reference's behavior for ALL bad
    parents.  Pass the model's locator grid for full robustness (the guess
    starts 1-2 hops from the origin, so the walk never spans the domain).
    """
    if mode not in ("delete", "repair"):
        raise ValueError(f"unknown mode {mode!r}; expected 'delete' or "
                         f"'repair'")
    orig = _components(x_orig)
    e_raw = elem_init.astype(jnp.int32)
    in_table = (e_raw >= 0) & (e_raw < mesh.nelems)
    e_safe = jnp.clip(e_raw, 0, mesh.nelems - 1)
    core = _core_2d(mesh) if mesh.dim == 2 else _core_3d_bcc(mesh)
    inside, _, _, _ = core(e_safe, orig, orig, False)
    bad = active & (~inside | ~in_table)
    num_bad = jnp.sum(bad.astype(jnp.int32))
    if mode == "delete":
        elem = jnp.where(active & ~bad, e_safe, INVALID)
        return elem, num_bad, jnp.int32(0)
    # repair: walk toward the origin itself.  The stale parent is usually
    # near the true one, so the greedy descent converges in a few hops; a
    # locator guess shortcuts arbitrary displacements.
    start = locator.guess(orig) if locator is not None else e_safe
    search = search_mesh_2d if mesh.dim == 2 else search_mesh_3d
    res = search(mesh, x_orig, x_orig, start, bad, max_iters)
    repaired = bad & (res.elem_ids >= 0)
    elem = jnp.where(
        bad, res.elem_ids, jnp.where(active, e_safe, INVALID))
    return elem, num_bad, jnp.sum(repaired.astype(jnp.int32))


def trace_particle_through_mesh(
    mesh,
    x_orig: jax.Array,
    x_tgt: jax.Array,
    elem_init: jax.Array,
    active: jax.Array,
    max_iters: int = 200,
    boundary_handler: Callable[[BoundaryCtx], BoundaryResult] = remove_on_exit,
    record_exit: bool = False,
    validate_parents: str = "off",
    recover: str = "off",
) -> SearchResult:
    """Unified 2D/3D driver (``trace_particle_through_mesh``,
    adjacency.tpp:460-615): dispatches on mesh dimension.

    ``validate_parents``: "off" | "delete" | "repair" — run
    :func:`check_initial_parents` on entry (the reference driver's
    check_initial_parents call, adjacency.tpp:495-505; "repair" exceeds it
    by relocating instead of deleting).  ``recover``: "off" | "project" —
    sliver/degenerate loop-limit recovery (see :func:`search_mesh_2d`)."""
    if validate_parents != "off":
        elem_init, _, _ = check_initial_parents(
            mesh, x_orig, elem_init, active, mode=validate_parents)
        active = active & (elem_init >= 0)
    if mesh.dim == 2:
        return search_mesh_2d(
            mesh, x_orig, x_tgt, elem_init, active, max_iters,
            boundary_handler, record_exit, recover=recover,
        )
    return search_mesh_3d(
        mesh, x_orig, x_tgt, elem_init, active, max_iters, boundary_handler,
        record_exit=record_exit, recover=recover,
    )
