"""Uniform-grid point-location accelerator.

The reference walks every particle from its *previous* element
(``search_mesh_2d``), paying one adjacency hop per element crossed.  Each
hop is a full-width gather pass, so walk length directly multiplies device
memory traffic.  This module precomputes a uniform background grid mapping cells to
a nearby element; starting the walk from the grid guess of the *destination*
bounds walk length by the guess error (~1-2 hops) regardless of how far the
particle moved.

The guess is only an accelerator: the walk still proves containment, and
walkers whose guess-walk exits the domain are re-run from their true
previous element (so boundary-exit semantics stay exactly the reference's).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.utils.types import LID_DTYPE


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LocatorGrid2D:
    """Cell dims ride as data (not static) so per-rank grids can stack along
    a leading rank axis for the picparts SPMD path."""

    origin: jax.Array      # (2,)
    inv_h: jax.Array       # (2,) 1/cell size
    cell_elem: jax.Array   # (<= nx*ny padded,) nearest element per cell
    nx: jax.Array          # () int32
    ny: jax.Array          # () int32
    # optional cell-resident walk rows: per cell the TWO elements that cover
    # most of the cell (sample-calibrated), each as [walk_geom row (12) |
    # elem id as f32] → (n_cells, 26).  Lets the search collapse the guess
    # gather and the first containment pass into ONE gather, and resolves
    # edge-straddling cells (the dominant guess-miss mode) in the same
    # gather.  Layout: [A affine (6) | elemA | B affine (6) | elemB] →
    # (n_cells, 14) f32.  Gather cost scales with row BYTES, so only what
    # the peel consumes is stored:
    # misses keep walking from A in the pyramid instead of carrying
    # neighbor columns here.  Built by ``attach_cell_rows``; None =
    # guess-only locator.
    cell_rows: Optional[jax.Array] = None
    # optional slim separating-line rows [gx gy gc | elemA | elemB] →
    # (n_cells, 5) f32: pick A when gx·x + gy·y + gc >= 0 else B.  When A
    # and B share an edge the line is A's barycentric coordinate toward B,
    # which is an EXACT decision on A∪B (a triangle across an edge lies
    # entirely on the line's non-positive side) — so this resolves the same
    # ~95% as the 2-candidate containment rows at ~1/3 the gathered bytes;
    # containment itself moves to the walk's first (small-table) pass.
    # Built by ``attach_cell_lines``; preferred by the search when present.
    cell_lines: Optional[jax.Array] = None
    # optional split-rows layout (``attach_cell_rows(split=True)``): when
    # set, ``cell_rows`` holds candidate A's [affine 6 | elemA] and this
    # holds candidate B's — two INDEPENDENT 7-col gathers from two
    # sub-cliff tables instead of one 14-col above-cliff gather (the
    # gather-cost cliff is per-table size)
    cell_rows_b: Optional[jax.Array] = None
    # polar-aligned cells (build_locator_grid(polar=...)): cell axes are
    # (radius, angle) about ``center`` instead of (x, y).  On near-annular
    # meshes (tokamak flux surfaces) polar cells align with the element
    # anisotropy, so the same cells_per_elem budget yields far fewer
    # straddling cells (lower peel miss rate) — geometry only enters
    # ``cell_of`` and the host-side calibration sampling; the peel/walk
    # machinery is unchanged.  ``origin``/``inv_h`` are then in (r, θ)
    # units with θ ∈ [0, 2π) wrapping on the y axis.
    center: Optional[jax.Array] = None   # (2,) polar center, None = cartesian
    polar: bool = _static_field(default=False)
    # explicit cell_rows layout tag set by the attach functions — the peel
    # dispatch keys on THIS, never on column widths ("rows" 14+2·aux cols,
    # "rows_ab" 8, "rows_split" two (7+aux)-col tables)
    rows_layout: str = _static_field(default="rows")

    def cell_of(self, pts) -> jax.Array:
        """Points -> (N,) clamped cell ids (f32 index arithmetic, one cast)."""
        px, py = (pts[0], pts[1]) if isinstance(pts, tuple) else (pts[:, 0], pts[:, 1])
        if self.polar:
            dx = px - self.center[0]
            dy = py - self.center[1]
            two_pi = jnp.float32(2.0 * np.pi)
            th = jnp.arctan2(dy, dx)
            px = jnp.sqrt(dx * dx + dy * dy)
            py = jnp.where(th < 0, th + two_pi, th)
        rx = (px - self.origin[0]) * self.inv_h[0]
        ry = (py - self.origin[1]) * self.inv_h[1]
        nxf = self.nx.astype(jnp.float32)
        nyf = self.ny.astype(jnp.float32)
        ix = jnp.clip(jnp.floor(rx), 0.0, nxf - 1.0)
        iy = jnp.clip(jnp.floor(ry), 0.0, nyf - 1.0)
        return (ix * nyf + iy).astype(jnp.int32)

    def guess(self, pts) -> jax.Array:
        """Points -> (N,) element guesses (clamped to the grid).  Accepts an
        (N,2) array or a tuple of per-component (N,) arrays.

        Index arithmetic stays in f32 (exact for cell counts < 2^24) with a
        single int cast at the gather."""
        return self.cell_elem[self.cell_of(pts)]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LocatorGrid3D:
    origin: jax.Array      # (3,)
    inv_h: jax.Array       # (3,)
    cell_elem: jax.Array   # (nx*ny*nz,)
    nx: int = _static_field(default=1)
    ny: int = _static_field(default=1)
    nz: int = _static_field(default=1)
    # optional cell-resident candidate rows, the 3D analog of
    # LocatorGrid2D.cell_rows: [A affine (12) | elemA | B affine (12) |
    # elemB] → (n_cells, 26) f32 (see attach_cell_rows_3d)
    cell_rows: Optional[jax.Array] = None
    # optional slim separating-plane rows [gx gy gz gc | elemA | elemB] →
    # (n_cells, 6) f32, the 3D analog of LocatorGrid2D.cell_lines
    cell_lines: Optional[jax.Array] = None
    # optional split-rows layout (``attach_cell_rows_3d(split=True)``):
    # ``cell_rows`` holds candidate A's [affine 12 | elemA] (n_cells, 13)
    # and this holds candidate B's — two independent half-width gathers
    # instead of one 26-col gather (the gather cliff is per-table)
    cell_rows_b: Optional[jax.Array] = None
    # optional id-diet peel table (``attach_cell_ids_3d``): ONLY the top-k
    # candidate element ids per cell as int32 (n_cells, k); the peel
    # chains a second gather off the small per-element walk_geom table.
    # Decouples locator resolution from table bytes: cpe32 costs 6.2 MB
    # instead of the inline-rows 81 MB @26col (round-5 id-diet peel)
    cell_ids: Optional[jax.Array] = None
    # explicit cell_rows layout tag (see LocatorGrid2D.rows_layout):
    # "rows" 26 cols, "rows_ab" 14, "rows_abc" 27, "rows_split" two 13-col,
    # "ids" (n_cells, k) int32 + chained walk_geom gathers
    rows_layout: str = _static_field(default="rows")

    def cell_of(self, pts) -> jax.Array:
        if isinstance(pts, tuple):
            px, py, pz = pts
        else:
            px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
        # f32 index arithmetic, single int cast (see LocatorGrid2D.guess)
        ix = jnp.clip(jnp.floor((px - self.origin[0]) * self.inv_h[0]),
                      0.0, self.nx - 1.0)
        iy = jnp.clip(jnp.floor((py - self.origin[1]) * self.inv_h[1]),
                      0.0, self.ny - 1.0)
        iz = jnp.clip(jnp.floor((pz - self.origin[2]) * self.inv_h[2]),
                      0.0, self.nz - 1.0)
        return ((ix * self.ny + iy) * self.nz + iz).astype(jnp.int32)

    def guess(self, pts) -> jax.Array:
        return self.cell_elem[self.cell_of(pts)]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class KuhnLocator3D:
    """Analytic point location for structured Kuhn/Freudenthal tet meshes
    (6 tets per hex cell along vertex-permutation paths — the layout of
    ``mesh.generate.box_tet_mesh`` and of structured regions of production
    tet meshes).

    ``locate`` is pure elementwise arithmetic: cell from floor division,
    path index from the ORDERING of the fractional coordinates (the tet for
    path (a, b, c) is exactly the simplex where the fractional coordinates
    descend in that axis order), element id = cell_id·6 + path.  No table,
    no gather, no walk — the search collapses to one fused elementwise pass.  Exact
    up to f32 ties on shared faces, where either adjacent tet contains the
    point within the walk tolerance (the same ambiguity class the walk
    resolves by tolerance).  Built by :func:`detect_box_kuhn`, which proves
    applicability by reconstructing the connectivity bit-for-bit."""

    origin: jax.Array            # (3,)
    inv_h: jax.Array             # (3,)
    nx: int = _static_field(default=1)
    ny: int = _static_field(default=1)
    nz: int = _static_field(default=1)
    # canonical→actual element-id permutation for IMPORTED structured Kuhn
    # meshes with shuffled vertex/element order (see AnnulusLocator2D.perm)
    perm: Optional[jax.Array] = None

    def locate(self, pts, eps: float = 1e-6):
        """Points → (elem_ids, inside): analytic containing tet, and an
        in-box mask (points outside the box get elem INVALID — on the
        convex box domain, destination-outside ⟺ the path exits)."""
        if isinstance(pts, tuple):
            px, py, pz = pts
        else:
            px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
        rx = (px - self.origin[0]) * self.inv_h[0]
        ry = (py - self.origin[1]) * self.inv_h[1]
        rz = (pz - self.origin[2]) * self.inv_h[2]
        inside = (
            (rx >= -eps) & (rx <= self.nx + eps)
            & (ry >= -eps) & (ry <= self.ny + eps)
            & (rz >= -eps) & (rz <= self.nz + eps)
        )
        ix = jnp.clip(jnp.floor(rx), 0.0, self.nx - 1.0)
        iy = jnp.clip(jnp.floor(ry), 0.0, self.ny - 1.0)
        iz = jnp.clip(jnp.floor(rz), 0.0, self.nz - 1.0)
        fx, fy, fz = rx - ix, ry - iy, rz - iz
        b1 = fx >= fy
        b2 = fy >= fz
        b3 = fx >= fz
        # path order in box_tet_mesh: (x,y,z) (x,z,y) (y,x,z) (y,z,x)
        # (z,x,y) (z,y,x) — index by the descent ordering of (fx, fy, fz)
        idx = jnp.where(
            b1,
            jnp.where(b2, 0.0, jnp.where(b3, 1.0, 4.0)),
            jnp.where(b2, jnp.where(b3, 2.0, 3.0), 5.0),
        )
        # f32 id arithmetic exact while 6·nx·ny·nz < 2^24
        elem = ((ix * self.ny + iy) * self.nz + iz) * 6.0 + idx
        elem = jnp.where(inside, elem, jnp.float32(INVALID_F)).astype(
            jnp.int32)
        if self.perm is not None:
            # imported ordering: canonical → actual id, one small gather
            elem = jnp.where(
                elem >= 0, self.perm[jnp.maximum(elem, 0)], elem)
        return elem, inside


INVALID_F = -1.0


def detect_box_kuhn(coords: np.ndarray, tets: np.ndarray
                    ) -> Optional[KuhnLocator3D]:
    """Return a :class:`KuhnLocator3D` iff (coords, tets) IS a structured
    Kuhn box mesh: vertices on a full rectilinear lattice and connectivity
    bit-identical to ``box_tet_mesh``'s for the reconstructed (nx, ny, nz).
    The equality proof makes the analytic locate exact by construction —
    no sampling, no tolerance calibration."""
    coords = np.asarray(coords)
    tets = np.asarray(tets)
    if coords.shape[1] != 3 or tets.shape[1] != 4:
        return None
    xs = np.unique(coords[:, 0])
    ys = np.unique(coords[:, 1])
    zs = np.unique(coords[:, 2])
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    if min(nx, ny, nz) < 1:
        return None
    if coords.shape[0] != (nx + 1) * (ny + 1) * (nz + 1):
        return None
    if tets.shape[0] != 6 * nx * ny * nz or tets.shape[0] >= (1 << 24):
        return None
    # lattice spacing must be uniform per axis (floor division assumes it)
    if not all(np.allclose(np.diff(a), np.diff(a).mean(),
                           rtol=1e-6, atol=1e-12) and np.diff(a).mean() > 0
               for a in (xs, ys, zs)):
        return None
    # vertices must be the row-major lattice and the connectivity must be
    # exactly box_tet_mesh's
    from pumipic_jax.mesh.generate import box_tet_mesh

    h = np.array([xs[-1] - xs[0], ys[-1] - ys[0], zs[-1] - zs[0]])
    h = h / np.array([nx, ny, nz])
    ref_coords, ref_tets = box_tet_mesh(
        nx, ny, nz, xs[-1] - xs[0], ys[-1] - ys[0], zs[-1] - zs[0])
    identity = (
        np.allclose(ref_coords + np.array([xs[0], ys[0], zs[0]]),
                    coords, rtol=1e-6, atol=1e-12)
        # orientation-insensitive: Mesh3D.from_arrays may flip vertex
        # pairs to fix tet orientation; the tet as a POINT SET (what
        # locate assigns) is determined by its vertex set
        and np.array_equal(np.sort(ref_tets, axis=1),
                           np.sort(tets, axis=1))
    )
    if identity:
        return KuhnLocator3D(
            origin=jnp.asarray([xs[0], ys[0], zs[0]], jnp.float32),
            inv_h=jnp.asarray(1.0 / h, jnp.float32),
            nx=nx, ny=ny, nz=nz,
        )
    # imported orderings: permutation-tolerant proof — recover the vertex
    # lattice permutation from snapped coordinates and match every tet to
    # a canonical Kuhn path simplex as a vertex SET (see
    # _detect_annulus_permuted; the 3D analog for gmsh round-trips)
    scale = np.array([xs[0], ys[0], zs[0]])
    ijk = np.round((coords - scale) / h).astype(np.int64)
    if not np.allclose(scale + ijk * h, coords, rtol=1e-6, atol=1e-12):
        return None
    lat = (ijk[:, 0] * (ny + 1) + ijk[:, 1]) * (nz + 1) + ijk[:, 2]
    if (ijk.min() < 0 or (ijk.max(axis=0) != [nx, ny, nz]).any()
            or len(np.unique(lat)) != coords.shape[0]):
        return None
    pv = np.empty(coords.shape[0], np.int64)
    pv[lat] = np.arange(coords.shape[0])
    canon = pv[ref_tets]                      # canonical tets, actual ids
    cs = np.sort(canon, axis=1)
    ts = np.sort(tets, axis=1)
    oc = np.lexsort(cs.T)
    ot = np.lexsort(ts.T)
    if not np.array_equal(cs[oc], ts[ot]):
        return None
    sigma = np.empty(tets.shape[0], np.int64)
    sigma[oc] = ot                            # canonical id -> actual id
    return KuhnLocator3D(
        origin=jnp.asarray([xs[0], ys[0], zs[0]], jnp.float32),
        inv_h=jnp.asarray(1.0 / h, jnp.float32),
        nx=nx, ny=ny, nz=nz,
        perm=jnp.asarray(sigma, LID_DTYPE),
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AnnulusLocator2D:
    """Analytic point location for structured annulus triangle meshes
    (``mesh.generate.annulus_mesh``: n_rings radial bands × n_sectors
    wedges, 2 triangles per quad — the flagship bench's XGC-24k-analog
    layout).

    Exactness geometry: the radial edges lie ON the sector rays θ = kΔθ,
    so the sector index is an exact ``atan2`` floor; within a wedge the
    ring chords are HOMOTHETIC copies of one unit chord (each connects the
    two points at distance R_r along the wedge's rays), hence parallel
    lines at signed distance R_r·cos(Δθ/2) from the center along the wedge
    bisector — so the ring index is an exact floor of the bisector
    PROJECTION r_eff = (x·cosφ + y·sinφ)/cos(Δθ/2), φ = (k+½)Δθ.  Using
    r_eff instead of the radius also makes the inner/outer BOUNDARY test
    chord-exact (the mesh boundary is the inscribed chord polygon, not the
    circle).  The triangle within the quad is one cross-product sign
    against the quad diagonal a→d.  No table, no gather, no walk — one
    fused elementwise pass.  Ties on shared edges fall in the same tolerance
    ambiguity class the walk resolves by relative tolerance.  Built by
    :func:`detect_annulus_structured`, which proves applicability by
    reconstructing the connectivity bit-for-bit (the 2D analog of
    :func:`detect_box_kuhn`; the reference's adjacency search
    pumipic_adjacency.tpp has no structured fast path)."""

    cx: jax.Array                # ()
    cy: jax.Array                # ()
    r_in: jax.Array              # ()
    dr: jax.Array                # () ring thickness
    n_rings: int = _static_field(default=1)
    n_sectors: int = _static_field(default=1)
    # True iff the mesh's class_id was ALSO proven equal to annulus_mesh's
    # per-ring classification (class_id = ring+1): element classification
    # is then analytic in the element id (see class_of) and consumers may
    # replace per-particle class/rotation table gathers with elementwise
    # arithmetic.
    ring_class: bool = _static_field(default=False)
    # angular offset of sector ray 0 (imported structured annuli may be
    # rotated; the canonical generator has theta0 = 0)
    theta0: jax.Array = 0.0
    # canonical→actual element-id permutation for IMPORTED structured
    # annuli whose element/vertex order is shuffled (gmsh round-trips):
    # the analytic locate computes the canonical id, then maps through
    # this (E,) table — one small gather instead of the full walk.  None
    # = identity (the generator's order; pure gather-free locate).
    perm: Optional[jax.Array] = None

    def class_of(self, elem: jax.Array) -> jax.Array:
        """Analytic per-element classification for a proven ``ring_class``
        mesh: class_id(e) = e // (2·n_sectors) + 1 (annulus_mesh layout) —
        pure elementwise, replacing the mesh-table gather at particle
        rate.  Only valid when ``ring_class`` is True (which detection
        grants only for the identity element ordering — with a ``perm``
        the actual id is not analytic in the ring)."""
        assert self.ring_class, "class_of requires a ring_class-proven mesh"
        assert self.perm is None
        return elem // (2 * self.n_sectors) + 1

    def locate(self, pts, eps: float = 1e-6):
        """Points → (elem_ids, inside): analytic containing triangle and an
        in-annulus mask (chord-exact; outside points get elem INVALID)."""
        elem, inside, _, _, _ = self.locate_parts(pts, eps)
        return elem, inside

    def locate_parts(self, pts, eps: float = 1e-6):
        """:meth:`locate` plus the raw (ring, sector, tri) f32 indices the
        element id is assembled from — consumers that route on the
        STRUCTURE (sector bands: parallel/banded_route.py) use these parts
        directly instead of re-deriving them from the id with hazardous
        f32 divisions.  The parts are exact small integers in f32; they
        are clamped in-range even for outside points (gate on ``inside``/
        the INVALID elem id)."""
        if isinstance(pts, tuple):
            px, py = pts
        else:
            px, py = pts[:, 0], pts[:, 1]
        x = px - self.cx
        y = py - self.cy
        two_pi = jnp.float32(2.0 * np.pi)
        dth = two_pi / self.n_sectors
        th = jnp.arctan2(y, x) - self.theta0
        th = jnp.where(th < 0, th + two_pi, th)
        th = jnp.where(th < 0, th + two_pi, th)     # theta0 ∈ (-π, π]
        kf = jnp.clip(jnp.floor(th / dth), 0.0, self.n_sectors - 1.0)
        # wedge-bisector projection: exact ring floor AND chord-exact bounds
        phi = self.theta0 + (kf + 0.5) * dth
        m = jnp.cos(0.5 * dth)
        r_eff = (x * jnp.cos(phi) + y * jnp.sin(phi)) / m
        r_out = self.r_in + self.dr * self.n_rings
        tol = eps * r_out
        inside = (r_eff >= self.r_in - tol) & (r_eff <= r_out + tol)
        rf = jnp.clip(jnp.floor((r_eff - self.r_in) / self.dr),
                      0.0, self.n_rings - 1.0)
        # diagonal test: a = vertex (rf, kf), d = vertex (rf+1, kf+1);
        # cross((d-a), (p-a)) > 0 → tri [a,b,d] (elem +0), < 0 → [a,d,c] (+1)
        ra = self.r_in + rf * self.dr
        rd = ra + self.dr
        tha = self.theta0 + kf * dth
        thd = tha + dth
        ax = ra * jnp.cos(tha)
        ay = ra * jnp.sin(tha)
        ddx = rd * jnp.cos(thd) - ax
        ddy = rd * jnp.sin(thd) - ay
        cross = ddx * (y - ay) - ddy * (x - ax)
        # f32 id arithmetic exact while 2·n_rings·n_sectors < 2^24
        trif = jnp.where(cross >= 0, 0.0, 1.0)
        elem = (rf * self.n_sectors + kf) * 2.0 + trif
        elem = jnp.where(inside, elem, jnp.float32(INVALID_F)).astype(
            jnp.int32)
        if self.perm is not None:
            # imported ordering: canonical → actual id through one small
            # gather (still no walk, no containment pyramid)
            elem = jnp.where(
                elem >= 0, self.perm[jnp.maximum(elem, 0)], elem)
        return elem, inside, rf, kf, trif


def _detect_annulus_permuted(coords, tris, c, rad, n_rings, n_sectors,
                             r_in, r_out, level_tol):
    """Permutation/rotation-tolerant structured-annulus proof: recover the
    (ring × sector) lattice with a global angular offset, the vertex
    permutation, and the element permutation σ (canonical → actual id) by
    EXACT connectivity matching.  Returns (theta0, sigma) or None.

    This widens the detected class from 'bit-identical to the generator'
    to 'any reordering/rotation of a structured annulus' — the orderings
    real mesh IMPORTS have (gmsh round-trips shuffle vertices and
    elements; VERDICT r4 on detection generality)."""
    V = coords.shape[0]
    E = tris.shape[0]
    S, Rg = n_sectors, n_rings
    dth = 2.0 * np.pi / S
    th = np.arctan2(coords[:, 1] - c[1], coords[:, 0] - c[0])
    # ring index per vertex from the radius level
    order = np.argsort(rad)
    lev = np.zeros(V, np.int64)
    lev[order] = np.cumsum(
        np.concatenate([[0], (np.diff(rad[order]) > level_tol)]))
    if lev.max() != Rg:
        return None
    # global angular offset: vertices sit at theta0 + k·dth, so the S-fold
    # phase mean recovers theta0 exactly on an ideal lattice
    z = np.exp(1j * S * th)
    theta0 = np.angle(z.mean()) / S
    kf = np.mod(np.round((th - theta0) / dth).astype(np.int64), S)
    # verify every vertex is ON its lattice site (rotation-tolerant)
    r_lat = r_in + (r_out - r_in) * lev / Rg
    ang = theta0 + kf * dth
    ideal = np.stack([c[0] + r_lat * np.cos(ang),
                      c[1] + r_lat * np.sin(ang)], axis=1)
    if not np.allclose(ideal, coords, rtol=1e-6, atol=2e-6 * r_out):
        return None
    # vertex permutation lattice-site -> vertex id (must be a bijection)
    lat = lev * S + kf
    if len(np.unique(lat)) != V or V != (Rg + 1) * S:
        return None
    pv = np.empty(V, np.int64)
    pv[lat] = np.arange(V)
    # canonical triangles through the vertex permutation
    rr = np.repeat(np.arange(Rg), S)
    kk = np.tile(np.arange(S), Rg)
    a = pv[rr * S + kk]
    b = pv[rr * S + (kk + 1) % S]
    cc = pv[(rr + 1) * S + kk]
    d = pv[(rr + 1) * S + (kk + 1) % S]
    canon = np.empty((E, 3), np.int64)
    canon[0::2] = np.stack([a, b, d], axis=1)
    canon[1::2] = np.stack([a, d, cc], axis=1)
    # exact element matching as vertex SETS (orientation-insensitive)
    cs = np.sort(canon, axis=1)
    ts = np.sort(np.asarray(tris, np.int64), axis=1)
    oc = np.lexsort(cs.T)
    ot = np.lexsort(ts.T)
    if not np.array_equal(cs[oc], ts[ot]):
        return None
    sigma = np.empty(E, np.int64)
    sigma[oc] = ot                       # canonical id -> actual id
    return float(theta0), sigma


def detect_annulus_structured(coords: np.ndarray, tris: np.ndarray,
                              cls: Optional[np.ndarray] = None
                              ) -> Optional[AnnulusLocator2D]:
    """Return an :class:`AnnulusLocator2D` iff (coords, tris) IS a
    structured annulus mesh: vertices on a full (ring × sector) polar
    lattice and connectivity bit-identical to ``annulus_mesh``'s for the
    reconstructed parameters.  The equality proof makes the analytic
    locate exact by construction — no sampling, no calibration.  Shaped
    meshes (``tokamak_mesh``'s stitched flux surfaces, gmsh imports of
    real XGC meshes) fail the proof and keep the general walk.

    When ``cls`` (per-element classification) is also given and equals
    annulus_mesh's per-ring classification, the returned locator is
    additionally ``ring_class``-proven: classification (hence the
    elliptical push's per-element rotation) is analytic in the element id
    (:meth:`AnnulusLocator2D.class_of`)."""
    coords = np.asarray(coords)
    tris = np.asarray(tris)
    if coords.shape[1] != 2 or tris.shape[1] != 3 or coords.shape[0] < 8:
        return None
    c = coords.mean(axis=0)          # exact center by lattice symmetry
    rad = np.hypot(coords[:, 0] - c[0], coords[:, 1] - c[1])
    r_in, r_out = rad.min(), rad.max()
    if r_in <= 0 or r_out <= r_in:
        return None
    # distinct radius levels (tolerant grouping) → n_rings+1 rings of
    # n_sectors vertices each
    order = np.sort(rad)
    gaps = np.diff(order)
    level_tol = max(1e-6 * r_out, 1e-12)
    n_levels = 1 + int((gaps > level_tol).sum())
    if n_levels < 2 or coords.shape[0] % n_levels:
        return None
    n_sectors = coords.shape[0] // n_levels
    n_rings = n_levels - 1
    if n_sectors < 3 or tris.shape[0] != 2 * n_rings * n_sectors:
        return None
    if tris.shape[0] >= (1 << 24):
        return None
    from pumipic_jax.mesh.generate import annulus_mesh

    ref_coords, ref_tris, _ref_cls = annulus_mesh(
        n_rings, n_sectors, r_in, r_out, c[0], c[1])
    # atol covers the f32 round-trip of Mesh2D.from_arrays (~6e-8·r_out),
    # still ~10^4 below any mesh feature (ring spacing ~0.05·r_out)
    identity = (
        ref_coords.shape == coords.shape
        and np.allclose(ref_coords, coords, rtol=1e-6, atol=2e-6 * r_out)
        # orientation-insensitive (from_arrays may flip a vertex pair): the
        # triangle as a POINT SET determines what locate must assign
        and np.array_equal(np.sort(ref_tris, axis=1),
                           np.sort(tris, axis=1))
    )
    if identity:
        ring_class = cls is not None and np.array_equal(
            np.asarray(cls).ravel(), _ref_cls.ravel())
        return AnnulusLocator2D(
            cx=jnp.float32(c[0]), cy=jnp.float32(c[1]),
            r_in=jnp.float32(r_in),
            dr=jnp.float32((r_out - r_in) / n_rings),
            n_rings=n_rings, n_sectors=n_sectors, ring_class=ring_class,
        )
    # imported orderings: permutation/rotation-tolerant proof (locate maps
    # canonical → actual ids through one small gather)
    got = _detect_annulus_permuted(
        coords, tris, c, rad, n_rings, n_sectors, r_in, r_out, level_tol)
    if got is None:
        return None
    theta0, sigma = got
    _check_ids_f32_exact(tris)
    return AnnulusLocator2D(
        cx=jnp.float32(c[0]), cy=jnp.float32(c[1]),
        r_in=jnp.float32(r_in),
        dr=jnp.float32((r_out - r_in) / n_rings),
        n_rings=n_rings, n_sectors=n_sectors, ring_class=False,
        theta0=jnp.float32(theta0),
        perm=jnp.asarray(sigma, LID_DTYPE),
    )


def _host_walk_3d(geom: np.ndarray, e0: np.ndarray, px, py, pz,
                  iters: int = 24) -> np.ndarray:
    """Vectorized host-side 3D BCC walk (build-time only)."""
    e = np.asarray(e0, np.int64).copy()
    done = e < 0

    def bary(g):
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2] * pz + g[:, 3]
        l2 = g[:, 4] * px + g[:, 5] * py + g[:, 6] * pz + g[:, 7]
        l3 = g[:, 8] * px + g[:, 9] * py + g[:, 10] * pz + g[:, 11]
        return l1, l2, l3, 1.0 - l1 - l2 - l3

    for _ in range(iters):
        g = geom[np.maximum(e, 0)]
        l1, l2, l3, w0 = bary(g)
        inside = np.minimum(np.minimum(l1, l2),
                            np.minimum(l3, w0)) >= -1e-6
        done_new = done | inside
        wmin = w0.copy()
        kmin = np.zeros(len(e), np.int64)
        for k, lk in ((1, l1), (2, l2), (3, l3)):
            take = lk < wmin
            wmin = np.where(take, lk, wmin)
            kmin = np.where(take, k, kmin)
        nxt = np.take_along_axis(
            g[:, 12:16], kmin[:, None], axis=1)[:, 0].astype(np.int64)
        e = np.where(done_new, e, nxt)
        done = done_new | (~done_new & (e < 0))
        if done.all():
            break
    g = geom[np.maximum(e, 0)]
    l1, l2, l3, w0 = bary(g)
    ok = (e >= 0) & (np.minimum(np.minimum(l1, l2),
                                np.minimum(l3, w0)) >= -1e-6)
    return np.where(ok, e, -1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandGrid2D:
    """Ragged flux-band locator cells (round 5): cells keyed by
    (flux band, uniform θ-bin) instead of cartesian squares.

    Real XGC meshes (and the shipped tokamak workloads) are stitched flux
    surfaces: elements come band by band with ragged per-band sector counts
    and non-uniform, D-shaped ring radii — they can never pass the
    structured-annulus proof, and cartesian cells straddle the thin curved
    bands (A∪B hit 67-78% at the policy resolution on the 120k workload,
    perf/band_probe.py).  Band-aligned cells have ZERO radial straddle when
    the band assignment is right, and the band is computable by pure fused
    elementwise arithmetic:

    - build time (host, generic — no generator equality): ring polygons are
      derived from the band-ordered classification, each ring's polar
      radius is Fourier-fitted (exact to chord level on star-shaped
      rings), and the Fourier coefficients are smoothed across rings with
      Chebyshev polynomials in the band coordinate (flux surfaces morph
      smoothly) — giving a forward model R(b, θ) with residual gates
      (detection returns None when the mesh isn't band-structured enough);
    - run time: θ-harmonics by recurrence FROM (x/r, y/r) — no
      trig calls — → per-particle Chebyshev coefficients (rank-space
      accumulators) → scalar-poly-seeded safeguarded Newton on
      R(b, θ) = r (Clenshaw value+slope per step) → band; the angular
      bin uses the transcendental-free "diamond angle" τ(x, y) ∈ [0, 4)
      (monotone in θ; piecewise rational); cell = band·T + τ-bin, then
      the standard 14-col calibrated candidate-row peel
      (search_mesh_2d_accel dispatches on the same duck-typed interface
      as LocatorGrid2D).

    The model is evaluated without transcendentals, from (x/r, y/r) with
    τ-binning: particle-rate atan2/cos/sin were the slow path where this
    was first tuned (not yet re-measured on a GPU).  τ-binning costs
    ≤0.3% A∪B hit vs true-θ bins at equal T (perf/band_tau_probe.py) —
    the calibration bins with the same τ, so the non-uniform bin widths
    are absorbed.

    Fit bias near ring boundaries is ABSORBED by the calibration: cells
    are calibrated through the same composite assignment, so systematically
    misassigned slivers simply contribute their true element as a
    candidate.  Misses walk from candidate A exactly like the cartesian
    peel.  The reference has no analog — its search always walks
    (pumipic_adjacency.hpp:1011-1158); this is a redesign for its own
    flagship mesh class."""

    cx: jax.Array                 # () polar center
    cy: jax.Array                 # ()
    # SVD-factored forward model R(b, θ) = Cheb(u)ᵀ (U·V) h(θ): the Miller
    # flux-surface family is strongly low-rank (rank 5 reconstructs the
    # 120k model to 2e-4 of 4e-3 min ring gap), so the harmonic recurrence
    # carries only ``rank`` accumulator arrays instead of P+1 (the dense
    # (P+1, 2J+1) accumulation carries every coefficient per particle)
    coef_u: jax.Array             # (P+1, rank)
    coef_v: jax.Array             # (rank, 2J+1)
    # scalar radial-inverse polynomial u0(r) fitted to the angular-mean
    # profile (host build): a register-resident Horner seed for Newton —
    # SCALAR coefficients cost nothing at particle rate
    inv_coef: jax.Array           # (deg+1,) ascending powers of r
    cell_rows: jax.Array          # (K·T, 14) [A affine 6 | idA | B … | idB]
    cell_elem: jax.Array          # (K·T,) candidate A ids (guess())
    n_bands: int = _static_field(default=1)     # K
    n_theta: int = _static_field(default=1)     # T θ-bins per band
    n_harm: int = _static_field(default=8)      # J
    n_cheb: int = _static_field(default=8)      # P
    rank: int = _static_field(default=5)
    # root refinement: u0 seed + ``newton_iters`` safeguarded Newton steps
    # (each one Clenshaw value+derivative pass) — replaces the 14-pass
    # bisection, whose per-pass q-array reads dominated the ψ cost
    newton_iters: int = _static_field(default=3)
    # duck-typing with LocatorGrid2D for search_mesh_2d_accel's dispatch
    cell_lines: Optional[jax.Array] = None
    cell_rows_b: Optional[jax.Array] = None
    rows_layout: str = _static_field(default="rows")

    def _band_continuous(self, px, py):
        """Continuous band coordinate b*(x, y) plus the diamond angle
        τ ∈ [0, 4); pure fused elementwise arithmetic — NO trig calls
        (see class docstring: transcendentals at particle rate measured
        ~40× the cost of this whole evaluation on-chip)."""
        x = px - self.cx
        y = py - self.cy
        r = jnp.sqrt(x * x + y * y)
        J, P, rk = self.n_harm, self.n_cheb, self.rank
        inv_r = 1.0 / jnp.maximum(r, 1e-30)
        c1 = x * inv_r
        s1 = y * inv_r
        # rank-space projections t_k = Σ_j V[k, j]·h_j(θ): harmonics by
        # recurrence with only ``rank`` live accumulators
        t = [jnp.full(r.shape, self.coef_v[k, 0]) for k in range(rk)]
        cj, sj = c1, s1
        for j in range(J):
            for k in range(rk):
                t[k] = t[k] + self.coef_v[k, 1 + j] * cj
                t[k] = t[k] + self.coef_v[k, 1 + J + j] * sj
            if j + 1 < J:
                cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
        # per-particle Chebyshev coefficients (one fused pass from rank-r)
        q = [sum(self.coef_u[p, k] * t[k] for k in range(rk))
             for p in range(P + 1)]

        def radius_and_slope(u):
            # Clenshaw for value AND du-derivative in one recurrence pair
            bk1 = jnp.zeros_like(u)
            bk2 = jnp.zeros_like(u)
            dk1 = jnp.zeros_like(u)
            dk2 = jnp.zeros_like(u)
            for p in range(P, 0, -1):
                dk1, dk2 = 2.0 * bk1 + 2.0 * u * dk1 - dk2, dk1
                bk1, bk2 = q[p] + 2.0 * u * bk1 - bk2, bk1
            val = q[0] + u * bk1 - bk2
            dv = bk1 + u * dk1 - dk2
            return val, dv

        # seed from the scalar angular-mean inverse, then safeguarded
        # Newton (profiles are monotone in u with slope ~(r_out-r_in)/2,
        # never near zero)
        u = jnp.full(r.shape, self.inv_coef[-1], r.dtype)
        for p in range(self.inv_coef.shape[0] - 2, -1, -1):
            u = u * r + self.inv_coef[p]
        u = jnp.clip(u, -1.05, 1.05)
        for _ in range(self.newton_iters):
            val, dv = radius_and_slope(u)
            u = u - (val - r) / jnp.maximum(dv, 1e-6)
            u = jnp.clip(u, -1.05, 1.05)
        # diamond angle τ ∈ [0, 4): monotone in θ, pure arithmetic
        d = y / jnp.maximum(jnp.abs(x) + jnp.abs(y), 1e-30)
        tau = jnp.where(x >= 0, jnp.where(y >= 0, d, 4.0 + d), 2.0 - d)
        return (u + 1.0) * (0.5 * self.n_bands), tau

    def cell_of(self, pts) -> jax.Array:
        px, py = (pts[0], pts[1]) if isinstance(pts, tuple) else (
            pts[:, 0], pts[:, 1])
        bstar, tau = self._band_continuous(px, py)
        bf = jnp.clip(jnp.floor(bstar), 0.0, self.n_bands - 1.0)
        tf = jnp.clip(jnp.floor(tau * (self.n_theta / 4.0)),
                      0.0, self.n_theta - 1.0)
        # f32 id arithmetic exact while K·T < 2^24
        return (bf * self.n_theta + tf).astype(jnp.int32)

    def guess(self, pts) -> jax.Array:
        return self.cell_elem[self.cell_of(pts)]


def _ring_vertices_from_bands(tris: np.ndarray, cls: np.ndarray,
                              nverts: int) -> Optional[np.ndarray]:
    """Generic ring index per vertex from a band-ordered classification:
    a vertex incident to bands {j, j+1} lies on ring j (rings 0..K);
    single-band vertices are the domain boundary rings.  None if the mesh
    is not a stitched band structure."""
    mn = np.full(nverts, 1 << 30, np.int64)
    mx = np.full(nverts, -1, np.int64)
    for k in range(3):
        np.minimum.at(mn, tris[:, k], cls)
        np.maximum.at(mx, tris[:, k], cls)
    if (mx < 0).any():
        return None                      # isolated vertices
    K = int(cls.max())
    if (mx - mn > 1).any():
        return None                      # vertex spans non-adjacent bands
    solo = mn == mx
    if not np.all((mn[solo] == 1) | (mn[solo] == K)):
        return None                      # interior single-band vertex
    return np.where(mn < mx, mn, np.where(mn == 1, 0, K)).astype(np.int64)


def detect_banded_locator(
    coords: np.ndarray,
    tris: np.ndarray,
    cls: Optional[np.ndarray],
    walk_geom,
    n_theta: Optional[int] = None,
    n_harm: int = 24,
    n_cheb: int = 12,
    samples_per_cell: int = 16,
    seed: int = 1729,
    resid_gate: float = 0.25,
) -> Optional[BandGrid2D]:
    """Build a :class:`BandGrid2D` iff the mesh is a stitched flux-band
    structure: band-ordered classification, star-shaped ring polygons, and
    a forward radius model R(b, θ) whose residual (per-ring Fourier fit +
    cross-ring Chebyshev smoothing) stays under ``resid_gate`` × the
    minimum ring spacing.  Returns None otherwise (callers keep the
    cartesian grid).  All checks are generic mesh-array properties — no
    generator equality (unlike detect_annulus_structured)."""
    coords = np.asarray(coords, np.float64)
    tris = np.asarray(tris, np.int64)
    if cls is None or coords.shape[1] != 2 or tris.shape[1] != 3:
        return None
    cls = np.asarray(cls).ravel()
    if cls.size != tris.shape[0] or not np.issubdtype(cls.dtype,
                                                      np.integer):
        return None
    if cls.min() != 1 or np.any(np.diff(cls) < 0):
        return None                      # not band-ordered
    K = int(cls.max())
    if K < 4:
        return None
    ring = _ring_vertices_from_bands(tris, cls, coords.shape[0])
    if ring is None:
        return None
    geom = np.asarray(walk_geom)
    _check_ids_f32_exact(geom)
    E = tris.shape[0]

    center = coords.mean(axis=0)
    dx = coords[:, 0] - center[0]
    dy = coords[:, 1] - center[1]
    r_v = np.hypot(dx, dy)
    th_v = np.arctan2(dy, dx)
    if r_v.min() <= 1e-12 * r_v.max():
        return None                      # a vertex at the center: not polar

    # clamp model capacity to the data: the sparsest ring must
    # overdetermine its Fourier fit, and the ring count the smoothing
    ring_counts = np.bincount(ring, minlength=K + 1)
    J = max(min(n_harm, (int(ring_counts.min()) - 4) // 2), 4)
    P = min(n_cheb, K - 1)
    if J < 4 or P < 2:
        return None

    def ang_feats(th):
        n = len(th)
        A = np.empty((n, 2 * J + 1))
        A[:, 0] = 1.0
        c1, s1 = np.cos(th), np.sin(th)
        cj, sj = c1.copy(), s1.copy()
        A[:, 1], A[:, 1 + J] = cj, sj
        for j in range(1, J):
            cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
            A[:, 1 + j], A[:, 1 + J + j] = cj, sj
        return A

    # stage 1: per-ring Fourier fits of the ring polygons' polar radius
    C = np.zeros((K + 1, 2 * J + 1))
    for b in range(K + 1):
        sel = ring == b
        nb = int(sel.sum())
        if nb < 2 * J + 4:
            return None                  # too few vertices for the fit
        # star-shapedness: consecutive cross products about the center
        # must have one sign (radius single-valued in θ)
        order = np.argsort(th_v[sel])
        xs = dx[sel][order]
        ys = dy[sel][order]
        crs = xs * np.roll(ys, -1) - ys * np.roll(xs, -1)
        if not (np.all(crs > 0) or np.all(crs < 0)):
            return None
        A = ang_feats(th_v[sel])
        G = A.T @ A
        G[np.diag_indices_from(G)] += 1e-12 * max(np.trace(G), 1.0)
        C[b] = np.linalg.solve(G, A.T @ r_v[sel])

    # stage 2: Chebyshev smoothing across rings
    u = 2.0 * np.arange(K + 1) / K - 1.0
    Tb = np.polynomial.chebyshev.chebvander(u, P)
    G = Tb.T @ Tb
    G[np.diag_indices_from(G)] += 1e-12 * np.trace(G)
    coef = np.linalg.solve(G, Tb.T @ C)              # (P+1, 2J+1)

    th_grid = np.linspace(-np.pi, np.pi, 256, endpoint=False)
    Ag = ang_feats(th_grid)
    prof_full = Tb @ coef @ Ag.T                     # (K+1, 256)
    gaps_full = np.diff(prof_full, axis=0)
    if gaps_full.min() <= 0:
        return None                                  # non-nested fit
    # SVD rank truncation: the runtime harmonic recurrence carries one
    # accumulator array per rank, and the dense (P+1)-accumulator form
    # carries every coefficient per particle — flux-surface families
    # are strongly low-rank, so pick the smallest rank whose profile
    # error is well under the minimum ring gap
    Uc, sv, Vt = np.linalg.svd(coef, full_matrices=False)
    rank = len(sv)
    for rr_ in range(2, len(sv) + 1):
        cr = (Uc[:, :rr_] * sv[:rr_]) @ Vt[:rr_]
        if np.abs(Tb @ cr @ Ag.T - prof_full).max() <= 0.1 * gaps_full.min():
            rank = rr_
            break
    rank = min(rank, 8)
    coef = (Uc[:, :rank] * sv[:rank]) @ Vt[:rank]    # what actually runs

    # residual gate ON THE TRUNCATED MODEL: model radius vs actual vertex
    # radii, relative to the local ring spacing (the quantity band
    # assignment is measured in)
    Rfit = Tb @ coef                                 # (K+1, 2J+1) smoothed
    eval_err = 0.0
    min_gap = np.inf
    prof = Rfit @ Ag.T                               # (K+1, 256)
    gaps = np.diff(prof, axis=0)
    if gaps.min() <= 0:
        return None                                  # non-nested fit
    for b in range(K + 1):
        sel = ring == b
        pred = ang_feats(th_v[sel]) @ (Tb[b] @ coef)
        err = np.abs(pred - r_v[sel])
        # local gap at each vertex's θ
        gi = np.clip(((th_v[sel] + np.pi) / (2 * np.pi) * 256).astype(int),
                     0, 255)
        local_gap = gaps[np.clip(b, 0, K - 1), gi]
        eval_err = max(eval_err, float((err / local_gap).max()))
    if eval_err > resid_gate:
        return None
    min_gap = float(gaps.min())

    if n_theta is None:
        # T sizing: hit-driven resolution (a power of two covering the
        # widest band's triangle count), capped by the rows-table budget
        per_band = np.bincount(cls - 1, minlength=K)
        want = 1 << int(np.ceil(np.log2(max(per_band.max(), 8))))
        cap = max(
            int(BAND_ROWS_BYTES_BUDGET / (14 * 4 * K)) // 256 * 256, 256)
        n_theta = min(want, cap)
    T = int(n_theta)
    if K * T >= _F32_EXACT_ID_LIMIT:
        # BandGrid2D.cell_of computes b*T + t in f32 (exact only below
        # 2^24); the auto-sizing candidates respect this, but an explicit
        # n_theta (cfg.band_theta sweeps) must not silently round cell ids
        raise ValueError(
            f"n_theta={T} gives K*T={K * T} >= 2^24: band cell ids are "
            f"carried in f32 peel columns and would round; use a smaller "
            f"n_theta")

    # scalar Newton seed: invert the ANGULAR-MEAN radial profile with an
    # ascending-power polynomial u0(r) (register-resident on device)
    rmean = prof.mean(axis=1)                        # (K+1,)
    inv_deg = min(10, K - 1)
    inv_coef = np.polynomial.polynomial.polyfit(rmean, u, inv_deg)

    # --- calibration through the composite assignment (host mirror of
    # BandGrid2D.cell_of — same seed + Newton algorithm, float64; f32/f64
    # boundary flips are ~0.5% of cells and cost <0.1% hit,
    # perf/band_f32_diag.py)
    def band_of(pts):
        dxq = pts[:, 0] - center[0]
        dyq = pts[:, 1] - center[1]
        rq = np.hypot(dxq, dyq)
        tq = np.arctan2(dyq, dxq)
        tau = np.where(
            dxq >= 0,
            np.where(dyq >= 0,
                     dyq / np.maximum(np.abs(dxq) + np.abs(dyq), 1e-30),
                     4.0 + dyq / np.maximum(np.abs(dxq) + np.abs(dyq),
                                            1e-30)),
            2.0 - dyq / np.maximum(np.abs(dxq) + np.abs(dyq), 1e-30))
        q = ang_feats(tq) @ coef.T                   # (n, P+1)

        def radius_and_slope(uv):
            bk1 = np.zeros_like(uv)
            bk2 = np.zeros_like(uv)
            dk1 = np.zeros_like(uv)
            dk2 = np.zeros_like(uv)
            for p in range(P, 0, -1):
                dk1, dk2 = 2.0 * bk1 + 2.0 * uv * dk1 - dk2, dk1
                bk1, bk2 = q[:, p] + 2.0 * uv * bk1 - bk2, bk1
            return q[:, 0] + uv * bk1 - bk2, bk1 + uv * dk1 - dk2

        uv = np.full(len(rq), inv_coef[-1])
        for p in range(len(inv_coef) - 2, -1, -1):
            uv = uv * rq + inv_coef[p]
        uv = np.clip(uv, -1.05, 1.05)
        for _ in range(3):
            val, dv = radius_and_slope(uv)
            uv = np.clip(uv - (val - rq) / np.maximum(dv, 1e-6), -1.05, 1.05)
        bst = (uv + 1.0) * (K / 2.0)
        return np.clip(np.floor(bst), 0, K - 1).astype(np.int64), tau

    def cell_of_h(pts):
        b, tau = band_of(pts)
        tb = np.clip((tau / 4.0 * T).astype(np.int64), 0, T - 1)
        return b * T + tb

    n_cells = K * T
    rng = np.random.default_rng(seed)
    cal_per_elem = max(int(samples_per_cell * n_cells / E), 8)
    te = np.repeat(np.arange(E, dtype=np.int64), cal_per_elem)
    w = rng.dirichlet((1.0, 1.0, 1.0), len(te))
    pts = (coords[tris[te]] * w[:, :, None]).sum(axis=1)
    cell = cell_of_h(pts)

    cent = coords[tris].mean(axis=1)
    fb = np.zeros(n_cells, np.int64)
    fb[cell_of_h(cent)] = np.arange(E)
    a, b = _top2_per_cell(cell, te, fb)
    rows = np.concatenate(
        [geom[a][:, 0:6], a[:, None].astype(np.float64),
         geom[b][:, 0:6], b[:, None].astype(np.float64)],
        axis=1).astype(np.float32)

    return BandGrid2D(
        cx=jnp.float32(center[0]), cy=jnp.float32(center[1]),
        coef_u=jnp.asarray(Uc[:, :rank] * sv[:rank], jnp.float32),
        coef_v=jnp.asarray(Vt[:rank], jnp.float32),
        inv_coef=jnp.asarray(inv_coef, jnp.float32),
        cell_rows=jnp.asarray(rows),
        cell_elem=jnp.asarray(a, LID_DTYPE),
        n_bands=K, n_theta=T, n_harm=J, n_cheb=P, rank=rank,
    )


# every attach_* layout stores element ids as f32 columns; ids must stay
# exactly representable (ADVICE r3: np.concatenate promotes then casts, so
# ids >= 2^24 would silently round on the f32 round-trip)
_F32_EXACT_ID_LIMIT = 1 << 24

# byte budget for the BandGrid2D rows table (K·T·14·4 bytes); tuned on an
# earlier accelerator and not re-decided on a GPU (ROADMAP Queue 1, item 3)
BAND_ROWS_BYTES_BUDGET = 10.8e6

# known peel layouts (build_locator_grid validates against this set; an
# unknown string must raise instead of silently falling through to "rows")
_KNOWN_PEELS = ("auto", "rows", "lines", "rows_split", "rows_ab",
                "rows_abc", "ids", "ids4")


def _check_ids_f32_exact(geom: np.ndarray) -> None:
    if geom.shape[0] >= _F32_EXACT_ID_LIMIT:
        raise ValueError(
            f"{geom.shape[0]} elements: element ids stored as f32 cell-row "
            f"columns are only exact below 2^24")


def _topk_per_cell(cell, found, ce, k=2):
    """Top-k elements per cell by sample count (calibrated candidates for
    the peel rows).  Returns k arrays; rank j falls back to rank j-1's
    value where a cell has fewer than j+1 distinct sampled elements."""
    valid = found >= 0
    c_v, e_v = cell[valid], found[valid]
    order = np.lexsort((e_v, c_v))
    c_s, e_s = c_v[order], e_v[order]
    new_run = np.ones(len(c_s), bool)
    new_run[1:] = (c_s[1:] != c_s[:-1]) | (e_s[1:] != e_s[:-1])
    starts = np.nonzero(new_run)[0]
    counts = np.diff(np.append(starts, len(c_s)))
    rc, re = c_s[starts], e_s[starts]
    o2 = np.lexsort((-counts, rc))
    rc2, re2 = rc[o2], re[o2]
    # rank of each (cell, elem) run within its cell (0 = most sampled)
    first = np.ones(len(rc2), bool)
    first[1:] = rc2[1:] != rc2[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(rc2)), 0))
    rank = np.arange(len(rc2)) - run_start
    outs = []
    prev = ce.copy()
    for j in range(k):
        cur = prev.copy()
        sel = rank == j
        cur[rc2[sel]] = re2[sel]
        outs.append(cur)
        prev = cur
    return outs


def _top2_per_cell(cell, found, ce):
    """Shared top-2-by-sample-count reduction (see attach_cell_rows)."""
    a, b = _topk_per_cell(cell, found, ce, 2)
    return a, b


def attach_cell_rows_3d(grid: LocatorGrid3D, walk_geom,
                        samples_per_cell: int = 8,
                        seed: int = 1729,
                        split: bool = False,
                        ab: bool = False,
                        abc: bool = False) -> LocatorGrid3D:
    """3D analog of :func:`attach_cell_rows`: sample-calibrated TWO
    candidate elements per cell, rows [A affine (12) | elemA | B affine
    (12) | elemB] → (n_cells, 26) f32.  ``split=True`` stores the
    candidates as two separate (n_cells, 13) tables instead
    (``cell_rows`` + ``cell_rows_b``) so the peel issues two independent
    half-byte gathers.  ``ab=True`` stores [A affine (12) | elemA |
    elemB] → (n_cells, 14): candidate B is demoted from a peel-provable
    candidate to a walk START HINT — the peel gathers half the bytes and
    A-misses enter the pyramid at B (their first walk iteration is B's
    containment test), trading gather bytes for pyramid tail width.
    ``abc=True`` stores [A affine 12 | elemA | B affine 12 | elemB | elemC]
    → (n_cells, 27): two peel-provable candidates PLUS a third-ranked walk
    start hint for A∪B misses — tets overlap a cell ~6 deep, so the third
    candidate prices one extra column against the 13.7% both-miss tail
    (VERDICT r3: the 2D rows_ab rejection does not price a third candidate
    on a tet-mesh miss base).

    Column-width contract (search_mesh_3d_accel dispatches on it):
    ab=True → 14 cols; split=True → two 13-col tables; abc=True → 27 cols;
    default → 26 cols.
    """
    geom = np.asarray(walk_geom)
    _check_ids_f32_exact(geom)
    ce = np.asarray(grid.cell_elem, dtype=np.int64)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    n_grid = nx * ny * nz
    o = np.asarray(grid.origin, np.float64)
    h = 1.0 / np.asarray(grid.inv_h, np.float64)

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=(n_grid * K, 3))
    # cell id = (ix*ny + iy)*nz + iz
    iz = cell % nz
    iy = (cell // nz) % ny
    ix = cell // (ny * nz)
    px = o[0] + (ix + u[:, 0]) * h[0]
    py = o[1] + (iy + u[:, 1]) * h[1]
    pz = o[2] + (iz + u[:, 2]) * h[2]
    found = _host_walk_3d(geom, ce[cell], px, py, pz)
    if abc:
        a, b, c = _topk_per_cell(cell, found, ce, 3)
        rows = np.concatenate(
            [geom[a][:, 0:12], a[:, None].astype(np.float32),
             geom[b][:, 0:12], b[:, None].astype(np.float32),
             c[:, None].astype(np.float32)],
            axis=1).astype(np.float32)
        return dataclasses.replace(grid, cell_rows=jnp.asarray(rows),
                                   rows_layout="rows_abc")
    a, b = _top2_per_cell(cell, found, ce)
    if ab:
        rows = np.concatenate(
            [geom[a][:, 0:12], a[:, None], b[:, None]],
            axis=1).astype(np.float32)
        return dataclasses.replace(grid, cell_rows=jnp.asarray(rows),
                                   rows_layout="rows_ab")
    if split:
        rows_a = np.concatenate(
            [geom[a][:, 0:12], a[:, None]], axis=1).astype(np.float32)
        rows_b = np.concatenate(
            [geom[b][:, 0:12], b[:, None]], axis=1).astype(np.float32)
        return dataclasses.replace(
            grid, cell_rows=jnp.asarray(rows_a),
            cell_rows_b=jnp.asarray(rows_b), rows_layout="rows_split")
    rows = np.concatenate(
        [geom[a][:, 0:12], a[:, None].astype(np.float32),
         geom[b][:, 0:12], b[:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    return dataclasses.replace(grid, cell_rows=jnp.asarray(rows))


def attach_cell_ids_3d(grid: LocatorGrid3D, walk_geom, k: int = 2,
                       samples_per_cell: int = 8,
                       seed: int = 1729) -> LocatorGrid3D:
    """id-diet peel ("ids"/"ids4"): the cell table stores ONLY the top-k
    calibrated candidate element ids (int32, (n_cells, k)); the peel
    chains a second gather off the small per-element walk_geom table
    ((E, 16) f32 — 1.6 MB at the pps3d scale, far below the gather
    cliff).  This decouples locator RESOLUTION from table BYTES: the
    inline-rows layouts pay 26 f32 cols per cell (81 MB at cpe32 on 24.5k
    tets), so past cpe16 resolution was unaffordable; id cells cost 4k
    bytes each (6.2 MB at cpe32 k=2), and tet guess accuracy keeps
    climbing with resolution (A∪B 88.3% at cpe16 → 92.4% at cpe32,
    perf/slab_probe.py) while both chained gathers stay sub-cliff.  The
    2D big-mesh result went the other way (one mid-size inline-rows
    gather beat chained gathers) because the 2D per-element
    geometry table at 120k elements is 7.8 MB — 3 orders closer to the
    cliff than the pps3d walk_geom."""
    geom = np.asarray(walk_geom)
    ce = np.asarray(grid.cell_elem, dtype=np.int64)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    n_grid = nx * ny * nz
    o = np.asarray(grid.origin, np.float64)
    h = 1.0 / np.asarray(grid.inv_h, np.float64)

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=(n_grid * K, 3))
    iz = cell % nz
    iy = (cell // nz) % ny
    ix = cell // (ny * nz)
    px = o[0] + (ix + u[:, 0]) * h[0]
    py = o[1] + (iy + u[:, 1]) * h[1]
    pz = o[2] + (iz + u[:, 2]) * h[2]
    found = _host_walk_3d(geom, ce[cell], px, py, pz)
    cands = _topk_per_cell(cell, found, ce, k)
    ids = np.stack(cands, axis=1).astype(np.int32)
    return dataclasses.replace(grid, cell_ids=jnp.asarray(ids),
                               rows_layout="ids")


def build_locator_grid_3d(coords: np.ndarray, elem2verts: np.ndarray,
                          cells_per_elem: float = 2.0,
                          walk_geom=None,
                          peel: str = "auto") -> LocatorGrid3D:
    """3D analog of :func:`build_locator_grid` (tet meshes)."""
    if peel not in _KNOWN_PEELS:
        raise ValueError(f"unknown peel {peel!r}; expected one of "
                         f"{_KNOWN_PEELS}")
    coords = np.asarray(coords, np.float64)
    ev = np.asarray(elem2verts, np.int64)
    E = ev.shape[0]
    cent = coords[ev].mean(axis=1)

    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    extent = np.maximum(hi - lo, 1e-30)
    n_cells = max(int(E * cells_per_elem), 64)
    # proportional cell counts per axis
    scale = (n_cells / np.prod(extent)) ** (1.0 / 3.0)
    nx, ny, nz = (max(int(e * scale), 1) for e in extent)
    h = extent / np.array([nx, ny, nz])

    ijk = np.clip(((cent - lo) / h).astype(np.int64),
                  0, np.array([nx - 1, ny - 1, nz - 1]))
    grid = np.full((nx, ny, nz), -1, np.int64)
    grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = np.arange(E)

    while (grid < 0).any():
        empty = grid < 0
        filled_any = False
        for ax in (0, 1, 2):
            for s in (1, -1):
                shifted = np.roll(grid, s, axis=ax)
                idx = [slice(None)] * 3
                idx[ax] = 0 if s == 1 else -1
                shifted[tuple(idx)] = -1
                newfill = empty & (grid < 0) & (shifted >= 0)
                grid = np.where(empty & (grid < 0), shifted, grid)
                filled_any = filled_any or bool(newfill.any())
        if not filled_any:
            raise ValueError("3d locator grid flood fill failed")

    out = LocatorGrid3D(
        origin=jnp.asarray(lo, jnp.float32),
        inv_h=jnp.asarray(1.0 / h, jnp.float32),
        cell_elem=jnp.asarray(grid.reshape(-1), LID_DTYPE),
        nx=nx, ny=ny, nz=nz,
    )
    if walk_geom is not None:
        if peel == "auto":
            rows_bytes = out.cell_elem.shape[0] * 26 * 4
            peel = "lines" if rows_bytes > PEEL_AUTO_LINES_BYTES else "rows"
        if peel == "lines":
            out = attach_cell_lines_3d(out, walk_geom)
        elif peel in ("ids", "ids4"):
            out = attach_cell_ids_3d(out, walk_geom,
                                     k=(4 if peel == "ids4" else 2))
        else:
            out = attach_cell_rows_3d(out, walk_geom,
                                      split=(peel == "rows_split"),
                                      ab=(peel == "rows_ab"),
                                      abc=(peel == "rows_abc"))
    return out


def _host_walk(geom: np.ndarray, e0: np.ndarray, px: np.ndarray,
               py: np.ndarray, iters: int = 24) -> np.ndarray:
    """Vectorized host-side BCC walk (build-time only): locate (px, py)
    starting from e0; -1 where the walk exits the domain / doesn't settle."""
    e = np.asarray(e0, np.int64).copy()
    done = e < 0
    for _ in range(iters):
        g = geom[np.maximum(e, 0)]
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
        l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
        w0 = 1.0 - l1 - l2
        inside = np.minimum(np.minimum(l1, l2), w0) >= -1e-6
        done_new = done | inside
        wmin = np.minimum(w0, l1)
        kmin = np.where(w0 <= l1, 0, 1)
        kmin = np.where(l2 < wmin, 2, kmin)
        nxt = np.take_along_axis(
            g[:, 6:9], kmin[:, None], axis=1)[:, 0].astype(np.int64)
        e = np.where(done_new, e, nxt)
        exited = ~done_new & (e < 0)
        done = done_new | exited
        if done.all():
            break
    g = geom[np.maximum(e, 0)]
    l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
    l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
    w0 = 1.0 - l1 - l2
    ok = (e >= 0) & (np.minimum(np.minimum(l1, l2), w0) >= -1e-6)
    return np.where(ok, e, -1)


def _cell_sample_xy(grid: LocatorGrid2D, cell: np.ndarray,
                    u: np.ndarray, v: np.ndarray):
    """Host-side Cartesian sample points stratified over each grid cell
    (maps through the polar cell geometry when the grid is polar)."""
    ox, oy = np.asarray(grid.origin, np.float64)
    hx = 1.0 / float(np.asarray(grid.inv_h)[0])
    hy = 1.0 / float(np.asarray(grid.inv_h)[1])
    ny = int(np.asarray(grid.ny))
    ax0 = ox + (cell // ny + u) * hx      # cell id = ix*ny + iy
    ax1 = oy + (cell % ny + v) * hy
    if grid.polar:
        c = np.asarray(grid.center, np.float64)
        return c[0] + ax0 * np.cos(ax1), c[1] + ax0 * np.sin(ax1)
    return ax0, ax1


def attach_cell_rows(grid: LocatorGrid2D, walk_geom,
                     samples_per_cell: int = 8,
                     seed: int = 1729,
                     aux: Optional[np.ndarray] = None,
                     split: bool = False,
                     ab: bool = False) -> LocatorGrid2D:
    """Return a copy of ``grid`` whose cells carry TWO candidate walk rows.

    Candidates are calibrated by stratified random samples per cell located
    exactly on the host: A = the element covering the most samples, B = the
    second (B = A when one element covers the whole cell).  A 2-candidate
    peel cuts the guess-miss rate from ~30% to ~5% on the 24k annulus
    (86% of misses are edge-straddling cells whose true element is a single
    dominant second candidate), which
    removes the full-width straggler passes from the walk entirely.

    Column-width contract (search_mesh_2d_accel dispatches on it):
    ab=True → 8 cols; split=True → two (7+aux)-col tables; default →
    14+2·aux cols.
    """
    geom = np.asarray(walk_geom)
    _check_ids_f32_exact(geom)
    ce = np.asarray(grid.cell_elem, dtype=np.int64)
    n_cells = ce.shape[0]
    nx = int(np.asarray(grid.nx))
    ny = int(np.asarray(grid.ny))
    n_grid = nx * ny                      # ce may be padded beyond the grid

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=n_grid * K)
    v = rng.uniform(size=n_grid * K)
    px, py = _cell_sample_xy(grid, cell, u, v)
    found = _host_walk(geom, ce[cell], px, py)
    a, b = _top2_per_cell(cell, found, ce)

    if ab:
        # [A affine 6 | elemA | elemB] (8 cols): B demoted from a
        # peel-provable candidate to a walk start hint — see the 3D
        # variant's docstring (attach_cell_rows_3d(ab=True))
        if aux is not None:
            raise ValueError("aux_capture unsupported with rows_ab")
        rows = np.concatenate(
            [geom[a][:, 0:6], a[:, None], b[:, None]],
            axis=1).astype(np.float32)
        return dataclasses.replace(grid, cell_rows=jnp.asarray(rows),
                                   rows_layout="rows_ab")

    # per-candidate layout: [affine 6 | elem id | aux columns (A)]; aux is
    # an optional (E, A) table captured by the search at walk finish (e.g.
    # the push's per-element rotation) — see search_mesh_2d_accel
    parts_a = [geom[a][:, 0:6], a[:, None].astype(np.float32)]
    parts_b = [geom[b][:, 0:6], b[:, None].astype(np.float32)]
    if aux is not None:
        auxh = np.asarray(aux, np.float32)
        parts_a.append(auxh[a])
        parts_b.append(auxh[b])
    if split:
        return dataclasses.replace(
            grid,
            cell_rows=jnp.asarray(
                np.concatenate(parts_a, axis=1).astype(np.float32)),
            cell_rows_b=jnp.asarray(
                np.concatenate(parts_b, axis=1).astype(np.float32)),
            rows_layout="rows_split",
        )
    rows = np.concatenate(parts_a + parts_b, axis=1).astype(np.float32)
    return dataclasses.replace(grid, cell_rows=jnp.asarray(rows))


def _sep_rows(geom: np.ndarray, a: np.ndarray, b: np.ndarray,
              bary_coeffs, nbr_cols: slice) -> np.ndarray:
    """Shared separating-line/plane row assembly: for each (A, B) candidate
    pair, emit [line coeffs | elemA | elemB] where the line is A's
    barycentric coordinate toward B (EXACT decision on A∪B when B is a
    neighbor of A — the neighbor triangle/tet lies entirely on the
    coordinate's non-positive side).  Non-adjacent or identical pairs get
    the always-A line (coeffs = 0, offset = 1).

    ``bary_coeffs(g)`` returns a list of K+1 coefficient tuples (length
    dim+1 each) for barycentric coordinates k = 0..K of rows ``g``;
    ``nbr_cols`` slices the neighbor ids (col 6+k is the neighbor across
    coordinate k's zero line, pre-permuted by the mesh build).
    """
    ga = geom[a]
    nbrs = ga[:, nbr_cols].astype(np.int64)                # (n, K)
    coeffs = bary_coeffs(ga)                               # list of tuples
    ncoef = len(coeffs[0])
    line = np.zeros((len(a), ncoef), np.float32)
    line[:, -1] = 1.0                                      # always-A default
    for k in range(nbrs.shape[1]):
        hit = nbrs[:, k] == b
        for j in range(ncoef):
            line[hit, j] = coeffs[k][j][hit]
    return np.concatenate(
        [line, a[:, None].astype(np.float32), b[:, None].astype(np.float32)],
        axis=1).astype(np.float32)


def attach_cell_lines(grid: LocatorGrid2D, walk_geom,
                      samples_per_cell: int = 8,
                      seed: int = 1729) -> LocatorGrid2D:
    """Attach slim separating-line rows (see ``LocatorGrid2D.cell_lines``).

    Same sample calibration as :func:`attach_cell_rows`, but the cell
    carries only [gx gy gc | elemA | elemB] (5 f32 columns vs 14): the
    guess-resolution moves from two containment tests in the peel to one
    exact line test, and containment moves to the walk's first pass off the
    small ``walk_geom`` table — byte-driven gather design.
    """
    geom = np.asarray(walk_geom)
    _check_ids_f32_exact(geom)     # elemA/elemB ride f32 line columns
    ce = np.asarray(grid.cell_elem, dtype=np.int64)
    nx = int(np.asarray(grid.nx))
    ny = int(np.asarray(grid.ny))
    n_grid = nx * ny

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=n_grid * K)
    v = rng.uniform(size=n_grid * K)
    px, py = _cell_sample_xy(grid, cell, u, v)
    found = _host_walk(geom, ce[cell], px, py)
    a, b = _top2_per_cell(cell, found, ce)

    def bary_coeffs(g):
        return [
            (-g[:, 0] - g[:, 3], -g[:, 1] - g[:, 4], 1.0 - g[:, 2] - g[:, 5]),
            (g[:, 0], g[:, 1], g[:, 2]),
            (g[:, 3], g[:, 4], g[:, 5]),
        ]

    rows = _sep_rows(geom, a, b, bary_coeffs, slice(6, 9))
    return dataclasses.replace(grid, cell_lines=jnp.asarray(rows))


def attach_cell_lines_3d(grid: LocatorGrid3D, walk_geom,
                         samples_per_cell: int = 8,
                         seed: int = 1729) -> LocatorGrid3D:
    """3D analog of :func:`attach_cell_lines`: slim separating-plane rows
    [gx gy gz gc | elemA | elemB] (6 f32 columns vs 26)."""
    geom = np.asarray(walk_geom)
    _check_ids_f32_exact(geom)     # elemA/elemB ride f32 line columns
    ce = np.asarray(grid.cell_elem, dtype=np.int64)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    n_grid = nx * ny * nz
    o = np.asarray(grid.origin, np.float64)
    h = 1.0 / np.asarray(grid.inv_h, np.float64)

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=(n_grid * K, 3))
    iz = cell % nz
    iy = (cell // nz) % ny
    ix = cell // (ny * nz)
    px = o[0] + (ix + u[:, 0]) * h[0]
    py = o[1] + (iy + u[:, 1]) * h[1]
    pz = o[2] + (iz + u[:, 2]) * h[2]
    found = _host_walk_3d(geom, ce[cell], px, py, pz)
    a, b = _top2_per_cell(cell, found, ce)

    def bary_coeffs(g):
        return [
            (-g[:, 0] - g[:, 4] - g[:, 8],
             -g[:, 1] - g[:, 5] - g[:, 9],
             -g[:, 2] - g[:, 6] - g[:, 10],
             1.0 - g[:, 3] - g[:, 7] - g[:, 11]),
            (g[:, 0], g[:, 1], g[:, 2], g[:, 3]),
            (g[:, 4], g[:, 5], g[:, 6], g[:, 7]),
            (g[:, 8], g[:, 9], g[:, 10], g[:, 11]),
        ]

    rows = _sep_rows(geom, a, b, bary_coeffs, slice(12, 16))
    return dataclasses.replace(grid, cell_lines=jnp.asarray(rows))


# peel="auto" policy: 2-candidate containment rows while their table is at
# or below 32 MB, the slim separating-line peel for larger tables.  The
# 32 MB switch was tuned on an earlier accelerator and has not been
# re-decided on a GPU (ROADMAP Queue 1, item 3).  With
# resolve_locator_policy dropping cpe on big meshes, auto resolves to rows
# everywhere unless a caller forces an oversized cpe.
PEEL_AUTO_LINES_BYTES = 32e6


def build_locator_grid(coords: np.ndarray, elem2verts: np.ndarray,
                       cells_per_elem: float = 16.0,
                       walk_geom=None, aux=None,
                       peel: str = "auto",
                       polar: object = "auto") -> LocatorGrid2D:
    """Host build: bucket element centroids into ~cells_per_elem*E cells and
    flood-fill empty cells from their neighbors.

    ``polar``: True buckets in (radius, angle) about the vertex centroid
    instead of (x, y) — on near-annular meshes (tokamak flux surfaces)
    polar cells follow the element anisotropy, cutting straddle/miss rates
    at the same cell budget.  "auto" turns it on when the mesh has a
    genuine central hole (min vertex radius > 15% of max: an annular
    domain; disks and boxes stay cartesian).  False forces cartesian.
    """
    if peel not in _KNOWN_PEELS:
        raise ValueError(f"unknown peel {peel!r}; expected one of "
                         f"{_KNOWN_PEELS}")
    if peel == "rows_abc":
        raise ValueError("rows_abc is a 3D-only peel (triangle-mesh cells "
                         "rarely overlap 3 elements; use rows)")
    if peel in ("ids", "ids4"):
        raise ValueError("ids/ids4 are 3D-only peels (the id-diet layout "
                         "chains containment off the 3D walk_geom table; "
                         "use rows/rows_ab in 2D)")
    coords = np.asarray(coords, np.float64)
    ev = np.asarray(elem2verts, np.int64)
    E = ev.shape[0]
    cent = coords[ev].mean(axis=1)

    c = coords.mean(axis=0)
    vrad = np.hypot(coords[:, 0] - c[0], coords[:, 1] - c[1])
    if polar == "auto":
        use_polar = bool(vrad.min() > 0.15 * vrad.max())
    elif isinstance(polar, bool):
        use_polar = polar
    else:
        raise ValueError(f"polar must be True/False/'auto', got {polar!r}")

    if use_polar:
        # axis 0 = radius, axis 1 = angle in [0, 2π) (wraps)
        two_pi = 2.0 * np.pi
        r_c = np.hypot(cent[:, 0] - c[0], cent[:, 1] - c[1])
        th_c = np.mod(np.arctan2(cent[:, 1] - c[1], cent[:, 0] - c[0]),
                      two_pi)
        lo = np.array([vrad.min(), 0.0])
        hi = np.array([vrad.max(), two_pi])
        extent = np.maximum(hi - lo, 1e-30)
        # square-ish cells in PHYSICAL units: arc length ≈ r_mean·h_θ
        r_mean = 0.5 * (lo[0] + hi[0])
        aspect = extent[0] / (extent[1] * max(r_mean, 1e-30))
        ax0, ax1 = r_c, th_c
    else:
        lo = coords.min(axis=0)
        hi = coords.max(axis=0)
        extent = np.maximum(hi - lo, 1e-30)
        aspect = extent[0] / extent[1]
        ax0, ax1 = cent[:, 0], cent[:, 1]
    n_cells = max(int(E * cells_per_elem), 16)
    nx = max(int(np.sqrt(n_cells * aspect)), 1)
    ny = max(n_cells // max(nx, 1), 1)
    h = extent / np.array([nx, ny])

    ix = np.clip(((ax0 - lo[0]) / h[0]).astype(np.int64), 0, nx - 1)
    iy = np.clip(((ax1 - lo[1]) / h[1]).astype(np.int64), 0, ny - 1)
    grid = np.full((nx, ny), -1, np.int64)
    grid[ix, iy] = np.arange(E)  # last write wins; any nearby elem is fine

    # flood-fill empties by repeated 4-neighbor dilation (the angle axis of
    # a polar grid is periodic, so its dilation legitimately wraps)
    while (grid < 0).any():
        empty = grid < 0
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = np.roll(grid, (sx, sy), axis=(0, 1))
            # don't wrap around the domain
            if sx == 1:
                shifted[0, :] = -1
            if sx == -1:
                shifted[-1, :] = -1
            if not use_polar:
                if sy == 1:
                    shifted[:, 0] = -1
                if sy == -1:
                    shifted[:, -1] = -1
            grid = np.where(empty & (grid < 0), shifted, grid)
        if (grid < 0).all():
            raise ValueError("locator grid flood fill failed")

    out = LocatorGrid2D(
        origin=jnp.asarray(lo, jnp.float32),
        inv_h=jnp.asarray(1.0 / h, jnp.float32),
        cell_elem=jnp.asarray(grid.reshape(-1), LID_DTYPE),
        nx=jnp.int32(nx),
        ny=jnp.int32(ny),
        center=jnp.asarray(c, jnp.float32) if use_polar else None,
        polar=use_polar,
    )
    if walk_geom is not None:
        if peel == "auto":
            rows_bytes = out.cell_elem.shape[0] * 14 * 4
            # aux channels only exist on the rows layout, so auto resolves
            # to rows whenever an aux table is attached
            peel = ("lines" if rows_bytes > PEEL_AUTO_LINES_BYTES
                    and aux is None else "rows")
        if peel == "lines":
            if aux is not None:
                # the 5-col lines layout has no aux channel; silently
                # attaching the 14+2*aux-col rows table instead would give
                # the caller ~4x the gathered bytes they asked to avoid
                raise ValueError(
                    "peel='lines' cannot carry an aux table (the slim "
                    "separating-line rows have no aux columns); use "
                    "peel='rows' with aux, or drop aux")
            out = attach_cell_lines(out, walk_geom)
        else:
            out = attach_cell_rows(out, walk_geom, aux=aux,
                                   split=(peel == "rows_split"),
                                   ab=(peel == "rows_ab"))
    return out
