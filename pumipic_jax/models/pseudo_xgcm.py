"""pseudoXGCm — 2D gyrokinetic proxy mini-app (the flagship workload).

Reference parity: ``test/pseudoXGCm.cpp`` + ``test/ellipticalPush.hpp`` +
``test/gyroScatter.hpp`` — per step: elliptical push → 2D adjacency search →
migrate/rebuild → forward/backward gyro-ring charge scatter → buffered-copy
field sync; with particle/memory imbalance telemetry.

The whole timestep is ONE jitted function over the particle
structure pytree; mesh and gyro maps are closed-over immutable device arrays.
The reference's element classification drive (particles seeded on model faces
``class_id <= mdlFace``, push speed ∝ 1/class_id) is reproduced on generated
annulus/disk meshes whose class ids are radial bands.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh import generate as gen
from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.ops import push as push_ops
from pumipic_jax.ops import scatter as scatter_ops
from pumipic_jax.ops import search as search_ops
from pumipic_jax.particles import SellCSigma, SCSInput, CSR, DPS, CabM
from pumipic_jax.utils.types import LID_DTYPE

ELEMENT_SEED = 1024 * 1024
PARTICLE_SEED = 512 * 512


@dataclass(frozen=True)
class GyroConfig:
    """setGyroConfig analog (gyroScatter.hpp:6-18)."""

    rmax: float = 0.038
    num_rings: int = 3
    points_per_ring: int = 8
    theta: float = 0.0
    # per-particle gyro radius carried in particle state and bracketed per
    # particle at deposition (the reference's gyroScatter.hpp:185 leaves
    # the radius a 'TODO' uniform placeholder; this completes it).  The
    # radius field is seeded uniform in (0.25, 1)·rmax and rides the state.
    per_particle_radius: bool = False


@dataclass(frozen=True)
class XGCmConfig:
    num_ptcls: int = 100_000
    num_iterations: int = 10
    mdl_face: int = 2            # seed particles where class_id <= mdl_face
    deg_per_push: float = 30.0
    structure: str = "scs"       # scs | csr | cabm | dps
    max_search_iters: int = 128
    # background-grid point-location accelerator (global-mesh modes)
    use_locator: bool = True
    # peel flavor: "auto" picks 2-candidate containment rows whenever the
    # rows table fits under mesh.locator.PEEL_AUTO_LINES_BYTES (at the
    # policy-resolved cpe that is every mesh in the repo) and the slim
    # separating-line peel only for oversized tables; "rows"/"lines" force
    # a variant
    peel: str = "auto"
    # locator grid resolution (cells per element); None = auto — 16 for
    # small meshes, 4 + a wider first pyramid level for big ones
    # (resolve_locator_policy)
    locator_cpe: Optional[float] = None
    # override for the walk's compaction pyramid (None = default; see
    # ops/search.py)
    search_widths: Optional[Tuple[int, ...]] = None
    # capture the push rotation (cosΔ, sinΔ) during the SEARCH instead of
    # gathering it in the push: the per-element rotation rides the peel's
    # cell rows (+4 cols) and the packed rec channel through compaction,
    # killing the push's full-width rot-table gather.  An A/B arm; off by
    # default.
    rot_aux_capture: bool = False
    # structured-annulus analytic locator (mesh.locator.AnnulusLocator2D):
    # "auto" replaces the walk with the exact analytic locate when
    # detect_annulus_structured PROVES the mesh is a structured annulus
    # (connectivity equality — the flagship bench's XGC-24k analog is one;
    # shaped tokamak_mesh / gmsh imports fail the proof and keep the
    # walk); "off" forces the general walk; "force" errors if detection
    # fails.  The 2D analog of PushSearchConfig.kuhn.
    analytic_locate: str = "auto"
    # ragged flux-band locator (mesh.locator.BandGrid2D): "auto" replaces
    # the cartesian locator grid with band-aligned cells whenever
    # detect_banded_locator proves the mesh is a stitched flux-band
    # structure (band-ordered classification + star-shaped rings + a
    # residual-gated smooth radius model) — the mesh class of real XGC
    # workloads, where cartesian cells straddle the thin curved bands
    # (A∪B hit 67-80% vs ~90+% band-aligned on the 120k workload,
    # perf/band_probe.py).  "force" builds the band grid and errors when
    # detection fails; "off" keeps the cartesian cells.  "auto" is reserved
    # for the measured adoption rule (ROADMAP Queue 1, item 3): until that
    # rule exists it behaves exactly as "off".  Only relevant when the walk
    # runs (the exact analytic locator takes precedence when proven).
    band_locator: str = "auto"
    # θ-bins per band for the band locator (None = auto: next power of two
    # covering the widest band's triangle count; the sweep knob for the
    # hit-rate-vs-table-bytes trade — perf/band_probe.py)
    band_theta: Optional[int] = None
    # gather-free rotation: when the analytic locator ALSO proves the
    # mesh's classification is per-ring (ring_class), the push's
    # rotation-table gather collapses to elementwise arithmetic on the
    # element id (push_ops.rot_vals_from_class) — bit-identical values,
    # zero gathers.  Effective only with an active ring_class-proven
    # analytic locator; off = keep the table gather (A/B arm).
    rot_analytic: bool = True
    gyro: GyroConfig = GyroConfig()
    # ellipse geometry (reference reads h,k,d from argv)
    h: float = 0.0
    k: float = 0.0
    d: float = 0.9


def resolve_locator_policy(cfg: XGCmConfig, nelems: int, num_ptcls: int):
    """Resolve (cells_per_elem, peel, search_widths) for a mesh size.

    Auto policy: while the cpe16 2-candidate rows table stays at or below
    32 MB (~36k elements) keep cpe16 + rows; past it, drop to cpe4 — still
    rows — and open the pyramid's first level to N/8 for the higher
    (7.2%) peel-miss tail.  The 32 MB switch and the cpe choices were tuned
    on an earlier accelerator and have not been re-decided on a GPU
    (ROADMAP Queue 1, item 3).
    """
    cpe, peel, widths = cfg.locator_cpe, cfg.peel, cfg.search_widths
    if cpe is None:
        if nelems * 16 * 14 * 4 <= 32e6:
            cpe = 16.0
        else:
            cpe = 4.0
            if widths is None and num_ptcls >= 1 << 16:
                widths = (max(num_ptcls // 8, 2048),
                          max(num_ptcls // 128, 2048), 2048)
    return cpe, peel, widths


def seed_particles_per_element(
    mesh: Mesh2D, cfg: XGCmConfig, rng: np.random.Generator
) -> np.ndarray:
    """setSourceElements analog (pseudoXGCm.cpp:167-222): Gaussian-random
    particle counts on elements classified <= mdl_face, clipped to total."""
    cls = np.asarray(mesh.class_id)
    on = cls <= cfg.mdl_face
    num_marked = int(on.sum())
    if num_marked == 0:
        return np.zeros(mesh.nelems, np.int64)
    nppe = cfg.num_ptcls // num_marked
    ppe = np.zeros(mesh.nelems, np.int64)
    draws = rng.normal(nppe, max(nppe / 4, 1), size=mesh.nelems)
    # Vectorized form of the reference's sequential fill: visit marked
    # elements in order, clip the cumulative total at num_ptcls, and dump any
    # leftover on the last element visited while the budget was open.
    # Bit-identical to the per-element loop it replaces (O(E) numpy instead
    # of O(E) interpreter time — seconds at 120k elements).
    midx = np.nonzero(on)[0]
    c = np.maximum(np.round(draws[midx]).astype(np.int64), 0)
    cum_before = np.cumsum(c) - c
    take = np.clip(cfg.num_ptcls - cum_before, 0, None)
    ppe[midx] = np.minimum(c, take)
    total = int(ppe.sum())
    open_budget = np.nonzero(cum_before < cfg.num_ptcls)[0]
    last = midx[open_budget[-1]] if len(open_budget) else -1
    if total < cfg.num_ptcls and last >= 0:
        ppe[last] += cfg.num_ptcls - total
    return ppe


def uniform_points_in_elements(
    mesh: Mesh2D, ptcl_elems: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """setInitialPtclCoords analog: uniform position inside each particle's
    element via folded barycentric sampling."""
    ev = np.asarray(mesh.elem2verts)[ptcl_elems]
    cz = np.asarray(mesh.coords)
    r1 = rng.uniform(size=len(ptcl_elems))
    r2 = rng.uniform(size=len(ptcl_elems))
    over = r1 + r2 > 1
    r1[over] = 1 - r1[over]
    r2[over] = 1 - r2[over]
    a, b, c = cz[ev[:, 0]], cz[ev[:, 1]], cz[ev[:, 2]]
    return a + r1[:, None] * (b - a) + r2[:, None] * (c - a)


# ---------------------------------------------------------------------------
# gyro-ring mapping build (createGyroRingMappings, gyroScatter.hpp:96-166)
# ---------------------------------------------------------------------------

def build_gyro_mapping(
    mesh: Mesh2D, gyro: GyroConfig, project=None
) -> jax.Array:
    """For every (vertex, ring, point): generate the ring point, project it
    (identity by default, as the reference's TODO), search for its element
    starting from the first element adjacent to the vertex, and record the 3
    vertices of that element (-1 if outside the domain).

    Returns (V * num_rings * points_per_ring * 3,) int32.
    """
    V = mesh.nverts
    R, P = gyro.num_rings, gyro.points_per_ring

    vid = jnp.repeat(jnp.arange(V, dtype=LID_DTYPE), R * P)
    ring = jnp.tile(jnp.repeat(jnp.arange(R), P), V)
    pt = jnp.tile(jnp.arange(P), V * R)

    radius = gyro.rmax * (ring + 1) / R
    deg = gyro.theta + pt / P * 360.0
    rad = jnp.deg2rad(deg)
    base = mesh.coords[vid]
    pts = base + radius[:, None] * jnp.stack([jnp.cos(rad), jnp.sin(rad)], -1)
    if project is not None:
        pts = project(pts)

    # starting element: first element adjacent to the vertex
    start_elem = mesh.vert2elem_vals[mesh.vert2elem_offsets[vid]]

    res = search_ops.search_mesh_2d(
        mesh, base, pts, start_elem, jnp.ones(vid.shape[0], bool), 100
    )
    parent = res.elem_ids
    verts = mesh.elem2verts[jnp.maximum(parent, 0)]          # (M, 3)
    verts = jnp.where((parent >= 0)[:, None], verts, -1)
    return verts.reshape(-1).astype(LID_DTYPE)


def build_gyro_mappings(mesh: Mesh2D, gyro: GyroConfig,
                        project_fwd=None, project_bwd=None):
    """Forward and backward maps.  The reference keeps distinct projection
    slots but both are the identity placeholder (gyroScatter.hpp:96-166
    TODO); when the projections coincide, ONE search builds both maps (the
    second full mesh search was pure waste at setup — seconds on a 120k
    mesh)."""
    fwd = build_gyro_mapping(mesh, gyro, project=project_fwd)
    if project_fwd is project_bwd:
        return fwd, fwd
    return fwd, build_gyro_mapping(mesh, gyro, project=project_bwd)


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

_BUILDERS = {
    "scs": lambda E, elems, fields: SellCSigma(
        E, elems, fields=fields, scs_input=SCSInput(chunk_size=8, sigma=None)
    ),
    "csr": lambda E, elems, fields: CSR(E, elems, fields=fields),
    "cabm": lambda E, elems, fields: CabM(E, elems, fields=fields),
    "dps": lambda E, elems, fields: DPS(E, elems, fields=fields),
}


class PseudoXGCm:
    """Single-device pseudoXGCm driver; the distributed version wraps the
    same step under shard_map (pumipic_jax.parallel)."""

    def __init__(self, mesh: Mesh2D, cfg: XGCmConfig, seed: int = ELEMENT_SEED):
        self.mesh = mesh
        self.cfg = cfg

        rng = np.random.default_rng(seed)
        ppe = seed_particles_per_element(mesh, cfg, rng)
        ptcl_elems = np.repeat(np.arange(mesh.nelems), ppe)
        prng = np.random.default_rng(PARTICLE_SEED)
        pos = uniform_points_in_elements(mesh, ptcl_elems, prng)

        phi, b = push_ops.elliptical_setup(jnp.asarray(pos), cfg.h, cfg.k, cfg.d)
        fields = {
            "x": jnp.asarray(pos, jnp.float32),
            "xtgt": jnp.zeros((len(ptcl_elems), 2), jnp.float32),
            "pid": jnp.arange(len(ptcl_elems), dtype=jnp.int32),
            "b": b.astype(jnp.float32),
            "phi": phi.astype(jnp.float32),
        }
        if cfg.gyro.per_particle_radius:
            rg = np.random.default_rng(PARTICLE_SEED + 1).uniform(
                0.25 * cfg.gyro.rmax, cfg.gyro.rmax, len(ptcl_elems))
            fields["rg"] = jnp.asarray(rg, jnp.float32)
        self.ptcls = _BUILDERS[cfg.structure](mesh.nelems, ptcl_elems, fields)

        self.gyro_fwd, self.gyro_bwd = build_gyro_mappings(mesh, cfg.gyro)
        self.locator = None
        self.analytic = None
        cpe, peel, self._widths = resolve_locator_policy(
            cfg, mesh.nelems, len(ptcl_elems))
        if cfg.analytic_locate in ("auto", "force"):
            from pumipic_jax.mesh.locator import detect_annulus_structured

            self.analytic = detect_annulus_structured(
                np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                cls=np.asarray(mesh.class_id))
            if self.analytic is None and cfg.analytic_locate == "force":
                raise ValueError("analytic_locate='force' but the mesh is "
                                 "not a structured annulus")
        self._banded = (
            push_ops.detect_banded_class(np.asarray(mesh.class_id))
            if cfg.rot_analytic
            and not (self.analytic is not None and self.analytic.ring_class)
            else None)
        if cfg.use_locator and self.analytic is None:
            from pumipic_jax.mesh.locator import (
                build_locator_grid,
                detect_banded_locator,
            )

            if cfg.band_locator not in ("auto", "off", "force"):
                raise ValueError(
                    f"unknown band_locator {cfg.band_locator!r}")
            if cfg.band_locator == "force":
                self.locator = detect_banded_locator(
                    np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                    np.asarray(mesh.class_id), mesh.walk_geom,
                    n_theta=cfg.band_theta)
                if self.locator is None:
                    raise ValueError("band_locator='force' but the mesh is "
                                     "not a stitched flux-band structure")
            if self.locator is None:
                self.locator = build_locator_grid(
                    np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                    walk_geom=mesh.walk_geom, peel=peel,
                    cells_per_elem=cpe,
                )
        self.step_fn = self._make_step()   # unjitted (for compile checks)
        self._step = jax.jit(self.step_fn)

    def _make_step(self):
        mesh = self.mesh
        cfg = self.cfg
        gyro = cfg.gyro

        def step(ptcls):
            elem = ptcls.elem
            active = ptcls.active
            x = ptcls.get("x")
            phi = ptcls.get("phi")
            b = ptcls.get("b")

            # elliptical push (ellipticalPush::push); classification is
            # analytic on a ring_class-proven mesh (no table gather)
            if (self.analytic is not None and self.analytic.ring_class
                    and cfg.rot_analytic):
                cid = self.analytic.class_of(jnp.maximum(elem, 0))
            elif self._banded is not None:
                cid = push_ops.class_from_bands(
                    jnp.maximum(elem, 0), self._banded)
            else:
                cid = mesh.class_id[jnp.maximum(elem, 0)]
            xtgt, phi_new = push_ops.elliptical_push(
                phi, b, cid, cfg.deg_per_push, cfg.h, cfg.k, cfg.d
            )
            xtgt = jnp.where(active[:, None], xtgt, x)
            phi_new = jnp.where(active, phi_new, phi)

            # search (p::search_mesh_2d; grid-accelerated when enabled;
            # analytic on a PROVEN structured annulus — one fused elementwise pass)
            if self.analytic is not None:
                e_an, _ins = self.analytic.locate(
                    (xtgt[:, 0], xtgt[:, 1]))
                res = search_ops.SearchResult(
                    elem_ids=jnp.where(active, e_an, search_ops.INVALID),
                    dest_c=(xtgt[:, 0], xtgt[:, 1]), all_found=jnp.bool_(True),
                    iters=jnp.int32(0),
                )
            elif self.locator is not None:
                res = search_ops.search_mesh_2d_accel(
                    mesh, self.locator, x, xtgt, elem, active,
                    cfg.max_search_iters, widths=self._widths,
                )
            else:
                res = search_ops.search_mesh_2d(
                    mesh, x, xtgt, elem, active, cfg.max_search_iters,
                    widths=self._widths,
                )

            # rebuild/migrate (updatePtclPositions + migrate_lb_ptcls; one
            # device → pure rebuild)
            ptcls2 = ptcls.set("x", res.dest).set("phi", phi_new)
            ptcls2 = ptcls2.rebuild(res.elem_ids)

            # gyro scatter forward/backward + sync (sync is a no-op on one
            # device; the distributed reduce lives in parallel.reduce).
            # The particle-rate ring accumulation is shared; only the
            # mesh-rate mapped scatter differs between the two directions.
            ring_accum = scatter_ops.accumulate_to_rings(
                ptcls2.elem, ptcls2.active, mesh.elem2verts,
                mesh.nverts, gyro.num_rings, gyro.rmax,
                ptcl_radius=(ptcls2.get("rg")
                             if gyro.per_particle_radius else None),
            )
            fwd = scatter_ops.scatter_to_mapped_verts(
                ring_accum, self.gyro_fwd, mesh.nverts, gyro.num_rings,
                gyro.points_per_ring,
            )
            bwd = scatter_ops.scatter_to_mapped_verts(
                ring_accum, self.gyro_bwd, mesh.nverts, gyro.num_rings,
                gyro.points_per_ring,
            )
            return ptcls2, fwd, bwd, res.iters

        return step

    def run(self, num_iterations: Optional[int] = None, verbose: bool = True,
            render_prefix: Optional[str] = None):
        """Step loop with the reference's telemetry: per-step timing
        (RecordTime), particle/memory imbalance (pseudoXGCm.cpp:17-62), and
        optional VTK rendering (render, :64-69)."""
        from pumipic_jax.utils.memory import memory_imbalance
        from pumipic_jax.utils.timing import prebarrier, record_time
        import time

        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        # memory imbalance needs device memory statistics (the CPU
        # backend keeps none)
        track_mem = jax.local_devices()[0].memory_stats() is not None
        fwd = bwd = None
        for i in range(iters):
            # fence first so queued async work is attributed as prebarrier
            # (the reference's pumipic_prebarrier around collectives)
            pre = prebarrier()
            t0 = time.perf_counter()
            self.ptcls, fwd, bwd, walk_iters = self._step(self.ptcls)
            jax.block_until_ready(fwd)
            record_time("xgcm step", time.perf_counter() - t0, prebarrier=pre)
            if verbose:
                from pumipic_jax.utils.plog import print_info

                mem = (" mem_imb %.2f" % memory_imbalance()["imbalance"]
                       if track_mem else "")
                print_info(
                    "iter %d: ptcls %d walk_iters %d fwd_sum %.1f%s",
                    i, self.ptcls.n_ptcls(), int(walk_iters),
                    float(fwd.sum()), mem,
                )
            if render_prefix is not None:
                self.render(f"{render_prefix}_t{i}", fwd, bwd)
        return fwd, bwd

    def render(self, path: str, fwd=None, bwd=None) -> None:
        """VTK dump of the mesh with particle counts and gyro tags."""
        from pumipic_jax.io.vtk import write_vtk

        elem_fields = {
            "class_id": np.asarray(self.mesh.class_id),
            "has_particles": np.asarray(self.ptcls.ppe()),
        }
        vert_fields = {}
        if fwd is not None:
            vert_fields["gyro_fwd"] = np.asarray(fwd)
        if bwd is not None:
            vert_fields["gyro_bwd"] = np.asarray(bwd)
        write_vtk(
            path, np.asarray(self.mesh.coords),
            np.asarray(self.mesh.elem2verts),
            elem_fields=elem_fields, vert_fields=vert_fields,
        )


# ---------------------------------------------------------------------------
# distributed (FULL-buffer particle-DP) variant
# ---------------------------------------------------------------------------

class DpLocate(NamedTuple):
    """The point-location and rotation path :func:`make_dp_setup` takes."""
    analytic: Any                 # AnnulusLocator2D, or None: the walk runs
    use_rot_an: bool              # rotation from the annulus ring class
    banded: Optional[Tuple[int, ...]]   # band starts: rotation by compares
    use_aux: bool                 # rotation captured by the search
    locator: Any                  # LocatorGrid2D / BandGrid2D / None
    cpe: float
    widths: Optional[Tuple[int, ...]]

    def describe(self) -> str:
        """One line naming the resolved path."""
        loc = self.locator
        if self.analytic is not None:
            return "analytic annulus locate (no walk)"
        if loc is None:
            return f"plain walk, widths={self.widths}"
        if hasattr(loc, "n_bands"):
            grid = f"band grid {loc.n_bands}x{loc.n_theta}"
        else:
            peel = "lines" if loc.cell_lines is not None else "rows"
            kind = "polar" if loc.polar else "cartesian"
            grid = (f"{kind} grid {int(loc.nx)}x{int(loc.ny)} "
                    f"(cells/elem {self.cpe:g}), peel {peel}")
        return f"{grid} + walk, widths={self.widths}"


def resolve_dp_locate(mesh: Mesh2D, cfg: XGCmConfig, num_ptcls: int,
                      rot_table=None) -> DpLocate:
    """Detect the mesh's structure and build the locator that
    :func:`make_dp_setup` steps with (``rot_table`` feeds the aux-capture
    arm; computed here when that arm needs it and none is given)."""
    cpe, peel, widths = resolve_locator_policy(cfg, mesh.nelems, num_ptcls)
    analytic = None
    if cfg.analytic_locate in ("auto", "force"):
        from pumipic_jax.mesh.locator import detect_annulus_structured

        analytic = detect_annulus_structured(
            np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
            cls=np.asarray(mesh.class_id))
        if analytic is None and cfg.analytic_locate == "force":
            raise ValueError("analytic_locate='force' but the mesh is not "
                             "a structured annulus")
    elif cfg.analytic_locate != "off":
        raise ValueError(f"unknown analytic_locate "
                         f"{cfg.analytic_locate!r}")
    use_rot_an = bool(analytic is not None and analytic.ring_class
                      and cfg.rot_analytic)
    # band-ordered classification (nondecreasing class_id: every stitched
    # ring/flux-surface mesh incl. the gmsh XGC imports): class ids from
    # fused scalar compares instead of the particle-rate rot-table gather.
    # The annulus ring_class proof (one div) takes precedence when present.
    banded = (push_ops.detect_banded_class(np.asarray(mesh.class_id))
              if cfg.rot_analytic and not use_rot_an else None)
    use_aux = bool(cfg.rot_aux_capture and cfg.use_locator
                   and analytic is None and banded is None)
    locator = None
    if cfg.use_locator and analytic is None:
        from pumipic_jax.mesh.locator import (
            build_locator_grid,
            detect_banded_locator,
        )

        if cfg.band_locator not in ("auto", "off", "force"):
            raise ValueError(f"unknown band_locator {cfg.band_locator!r}")
        if cfg.band_locator == "force" and use_aux:
            raise ValueError(
                "band_locator='force' is incompatible with rot_aux_capture "
                "(the aux rotation channel rides the cartesian peel rows)")
        if cfg.band_locator == "force":
            locator = detect_banded_locator(
                np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                np.asarray(mesh.class_id), mesh.walk_geom,
                n_theta=cfg.band_theta)
            if locator is None:
                raise ValueError("band_locator='force' but the mesh is not "
                                 "a stitched flux-band structure")
        if locator is None:
            if use_aux and rot_table is None:
                rot_table = push_ops.elliptical_rot_table(
                    mesh.class_id, cfg.deg_per_push)
            locator = build_locator_grid(
                np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                walk_geom=mesh.walk_geom, peel=peel,
                cells_per_elem=cpe,
                aux=np.asarray(rot_table) if use_aux else None,
            )
    return DpLocate(analytic, use_rot_an, banded, use_aux, locator, cpe,
                    widths)


def make_dp_setup(mesh: Mesh2D, cfg: XGCmConfig, device_mesh, seed: int = ELEMENT_SEED):
    """Build sharded flat particle state + the SPMD step for Input::FULL mode
    (mesh replicated, particles sharded, fields psummed — the reference's
    full-mesh shortcut at src/pumipic_comm.cpp:233-247).

    State is a dict of flat arrays (DPS layout: parent element per particle)
    because per-shard element sorting buys nothing when deposition is a
    segment_sum.  Returns (state, step) with step jitted over the device mesh.
    """
    from pumipic_jax.parallel import full_mode

    rng = np.random.default_rng(seed)
    ppe = seed_particles_per_element(mesh, cfg, rng)
    ptcl_elems = np.repeat(np.arange(mesh.nelems), ppe)
    prng = np.random.default_rng(PARTICLE_SEED)
    pos = uniform_points_in_elements(mesh, ptcl_elems, prng)
    phi, b = push_ops.elliptical_setup(jnp.asarray(pos), cfg.h, cfg.k, cfg.d)

    # trig-free rotation push state: carry (cos phi, sin phi) instead of phi
    # (the per-step trig collapses to a 2x2 rotation by the element's
    # per-step angle; parity test in test_models.py).  Walk-captured
    # rotation (search aux_capture) is the rot_aux_capture A/B arm.
    rot_table = push_ops.elliptical_rot_table(mesh.class_id, cfg.deg_per_push)
    state = {
        "x0": jnp.asarray(pos[:, 0], jnp.float32),
        "x1": jnp.asarray(pos[:, 1], jnp.float32),
        "cphi": jnp.cos(phi).astype(jnp.float32),
        "sphi": jnp.sin(phi).astype(jnp.float32),
        "b": b.astype(jnp.float32),
        "elem": jnp.asarray(ptcl_elems, LID_DTYPE),
        "active": jnp.ones(len(ptcl_elems), bool),
    }
    gyro_fwd, gyro_bwd = build_gyro_mappings(mesh, cfg.gyro)
    gyro = cfg.gyro
    if gyro.per_particle_radius:
        rg = np.random.default_rng(PARTICLE_SEED + 1).uniform(
            0.25 * gyro.rmax, gyro.rmax, len(ptcl_elems))
        state["rg"] = jnp.asarray(rg, jnp.float32)
    plan = resolve_dp_locate(mesh, cfg, len(ptcl_elems), rot_table)
    analytic, use_rot_an, banded, use_aux, locator, widths = (
        plan.analytic, plan.use_rot_an, plan.banded, plan.use_aux,
        plan.locator, plan.widths)
    if use_aux:
        # per-particle rotation state, refreshed by the search's aux
        # capture (the search already knows each particle's final element)
        elem0 = jnp.asarray(ptcl_elems, LID_DTYPE)
        rt0 = rot_table[jnp.maximum(elem0, 0)]
        state["cd"] = rt0[:, 0]
        state["sd"] = rt0[:, 1]

    def per_device_step(s):
        elem, active = s["elem"], s["active"]
        # flat component state end to end: no (N,2) intermediates
        if use_rot_an:
            # ring_class-proven mesh: rotation analytic in the element id —
            # zero particle-rate gathers in the push
            cd, sd = push_ops.rot_vals_from_class(
                analytic.class_of(jnp.maximum(elem, 0)), cfg.deg_per_push)
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot_vals(
                s["cphi"], s["sphi"], s["b"], cd, sd, cfg.h, cfg.k, cfg.d
            )
        elif banded is not None:
            # band-ordered classification: class ids from fused scalar
            # compares, rotation values elementwise — no table gather
            cd, sd = push_ops.rot_vals_from_class(
                push_ops.class_from_bands(jnp.maximum(elem, 0), banded),
                cfg.deg_per_push)
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot_vals(
                s["cphi"], s["sphi"], s["b"], cd, sd, cfg.h, cfg.k, cfg.d
            )
        elif use_aux:
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot_vals(
                s["cphi"], s["sphi"], s["b"], s["cd"], s["sd"],
                cfg.h, cfg.k, cfg.d
            )
        else:
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot(
                s["cphi"], s["sphi"], s["b"], elem, rot_table,
                cfg.h, cfg.k, cfg.d
            )
        xtgt = (jnp.where(active, tx, s["x0"]), jnp.where(active, ty, s["x1"]))
        orig = (s["x0"], s["x1"])
        if analytic is not None:
            # structured fast path: the whole search is one fused
            # elementwise pass — exact containing triangle of the
            # destination (proof: detect_annulus_structured), INVALID
            # outside the chord-exact annulus boundary (= the walk's
            # boundary-exit removal)
            e_an, _inside = analytic.locate(xtgt)
            res = search_ops.SearchResult(
                elem_ids=jnp.where(active, e_an, search_ops.INVALID),
                dest_c=xtgt, all_found=jnp.bool_(True),
                iters=jnp.int32(0), aux_c=None,
            )
        elif locator is not None:
            res = search_ops.search_mesh_2d_accel(
                mesh, locator, orig, xtgt, elem, active,
                cfg.max_search_iters, widths=widths,
                aux_capture=rot_table if use_aux else None,
            )
        else:
            res = search_ops.search_mesh_2d(
                mesh, orig, xtgt, elem, active, cfg.max_search_iters,
                widths=widths,
            )
        new_active = res.elem_ids >= 0
        new_state = {
            "x0": res.dest_c[0],
            "x1": res.dest_c[1],
            "cphi": jnp.where(active, cphi_new, s["cphi"]),
            "sphi": jnp.where(active, sphi_new, s["sphi"]),
            "b": s["b"],
            "elem": res.elem_ids,
            "active": new_active,
        }
        if use_aux:
            new_state["cd"] = jnp.where(new_active, res.aux_c[0], s["cd"])
            new_state["sd"] = jnp.where(new_active, res.aux_c[1], s["sd"])
        if gyro.per_particle_radius:
            new_state["rg"] = s["rg"]
        ring_accum = scatter_ops.accumulate_to_rings(
            res.elem_ids, new_active, mesh.elem2verts,
            mesh.nverts, gyro.num_rings, gyro.rmax,
            ptcl_radius=s["rg"] if gyro.per_particle_radius else None,
        )
        fwd = scatter_ops.scatter_to_mapped_verts(
            ring_accum, gyro_fwd, mesh.nverts, gyro.num_rings,
            gyro.points_per_ring,
        )
        bwd = scatter_ops.scatter_to_mapped_verts(
            ring_accum, gyro_bwd, mesh.nverts, gyro.num_rings,
            gyro.points_per_ring,
        )
        return new_state, {"fwd": fwd, "bwd": bwd}

    state = full_mode.shard_particles(device_mesh, state)
    # padded slots must be inactive
    step = full_mode.make_dp_step(device_mesh, per_device_step)
    return state, step


# ---------------------------------------------------------------------------
# distributed (BFS-buffered PICparts) variant — the full reference pipeline
# ---------------------------------------------------------------------------

def make_picparts_setup(
    coords: np.ndarray,
    elem2verts: np.ndarray,
    class_id: np.ndarray,
    cfg: XGCmConfig,
    device_mesh,
    inp=None,
    migrate_cap: Optional[int] = None,
    seed: int = ELEMENT_SEED,
    use_lb: bool = False,
    lb_tol: float = 1.05,
    neighbor_migration: bool = True,
    cap_factor: float = 1.5,
    partition: str = "auto",
    banded_route: str = "auto",
):
    """Distributed pseudoXGCm over BFS-buffered PICparts: per step —
    push → local search → safe-zone migration → gyro scatter →
    reduceCommArray(SUM) gyroSync.  This is the complete reference
    pipeline (pseudoXGCm.cpp:504-534) as one SPMD jitted step.

    ``neighbor_migration=True`` (default) runs the Distributor-scoped
    ppermute exchange (payload O(neighbors), SCS_migrate.h:41-62);
    False falls back to the world all_to_all.  Results are bit-identical.

    Returns (picparts, state, step) with state sharded P('ranks').
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pumipic_jax.parallel import balancer as lbm
    from pumipic_jax.parallel import migrate as mig
    from pumipic_jax.parallel import picparts as ppm
    from pumipic_jax.parallel import reduce as red
    from pumipic_jax.parallel.mesh_axis import mesh_axes

    # axis-name tuple of the device mesh: ("ranks",) flat, or
    # ("slice", "ranks") on a multi-slice topology — every collective below
    # takes the tuple (flat-rank semantics), and the world exchanges switch
    # to the DCN-aware two-stage route (mesh_axis.hier_all_to_all)
    AX = mesh_axes(device_mesh)
    hier = len(AX) == 2
    R = int(np.prod([device_mesh.shape[a] for a in device_mesh.axis_names]))
    if inp is None:
        inp = ppm.PicPartsInput()

    # Partition choice (independent of cfg.analytic_locate, so the
    # analytic and walk arms run on IDENTICAL picparts): a detection-proven
    # structured annulus defaults to the sector-band decomposition — it
    # makes every routed quantity banded in the sector index, enabling the
    # gather-free routing below (parallel/banded_route.py) — while shaped
    # meshes keep RCB (the .ptn stand-in, partition_rcb).
    from pumipic_jax.mesh.locator import detect_annulus_structured
    from pumipic_jax.parallel import banded_route as brm

    detected = detect_annulus_structured(coords, elem2verts, cls=class_id)
    if partition == "auto":
        # sector_band_owners assumes the generator's canonical element
        # order; an imported (permutation-proven) annulus keeps RCB
        partition = ("bands" if detected is not None
                     and detected.perm is None else "rcb")
    if partition == "bands":
        if detected is None:
            raise ValueError("partition='bands' needs a detection-proven "
                             "structured annulus")
        owners = brm.sector_band_owners(
            detected.n_rings, detected.n_sectors, R)
    elif partition == "rcb":
        owners = ppm.partition_rcb(coords, elem2verts, R)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    pp = ppm.build_picparts(coords, elem2verts, owners, R, inp, class_id)
    bt = lbm.build_balancer(pp, R) if use_lb else None
    nplan = None
    if neighbor_migration:
        from pumipic_jax.parallel import distributor as dstm

        # DCN-aware round split on a multi-slice mesh: within-slice edges
        # first (ICI rounds), cross-slice edges batched after (DCN rounds)
        slice_of_rank = (np.repeat(
            np.arange(device_mesh.shape[AX[0]]),
            device_mesh.shape[AX[1]]) if hier else None)
        nplan = mig.build_neighbor_plan(dstm.from_picparts(pp),
                                        slice_of_rank=slice_of_rank)

    # --- host-side particle seeding on the GLOBAL mesh, routed to owners
    gmesh = Mesh2D.from_arrays(coords, elem2verts, class_id)
    rng = np.random.default_rng(seed)
    ppe = seed_particles_per_element(gmesh, cfg, rng)
    g_elems = np.repeat(np.arange(gmesh.nelems), ppe)
    pos = uniform_points_in_elements(
        gmesh, g_elems, np.random.default_rng(PARTICLE_SEED)
    )
    phi, b = push_ops.elliptical_setup(jnp.asarray(pos), cfg.h, cfg.k, cfg.d)
    # (cos phi, sin phi) through XLA exactly as make_dp_setup computes them:
    # numpy's f32 cos/sin differ from XLA's in the last bit for about one
    # particle in five, and the two setups must seed identical state
    cphi = np.asarray(jnp.cos(phi))
    sphi = np.asarray(jnp.sin(phi))
    b = np.asarray(b)

    own_of_ptcl = owners[g_elems]
    elem_gid_h = np.asarray(pp.elem_gid)

    # detection-gated GLOBAL analytic locate for the SPMD step: the per-rank
    # wedges can never pass the annulus proof, but the GLOBAL mesh can —
    # locate analytically in global ids and map to rank-local ids through
    # ONE small-table gather (g2l, (E_global,) i32 per rank), replacing the
    # per-rank peel+pyramid walk entirely.  State carries the global elem id
    # (``gelem``) so a ring_class-proven mesh also gets the gather-free
    # rotation.  Shaped meshes fail the proof and keep the walk.
    analytic = None
    if cfg.analytic_locate in ("auto", "force"):
        analytic = detected
        if analytic is None and cfg.analytic_locate == "force":
            raise ValueError("analytic_locate='force' but the mesh is not "
                             "a structured annulus")
    elif cfg.analytic_locate != "off":
        raise ValueError(f"unknown analytic_locate "
                         f"{cfg.analytic_locate!r}")
    use_rot_an = (analytic is not None and analytic.ring_class
                  and cfg.rot_analytic)
    # gather-free routing: when the partition is banded AND every routing
    # quantity verifies against the generic tables, the fused [lid | route]
    # gather collapses to
    # elementwise arithmetic on the locate's (ring, sector, tri) parts
    if banded_route not in ("auto", "off"):
        raise ValueError(f"unknown banded_route {banded_route!r}")
    br = None
    if analytic is not None and banded_route == "auto":
        br = brm.derive_banded_route(pp, owners, analytic, bt, R)
    # Per-rank slot capacity: every particle-rate op in the step runs at
    # CAPACITY width (padded slots ride the gathers/sorts), so headroom is
    # pure per-step cost — the R=1 picparts-vs-dp gap was almost entirely
    # this padding.  Keep cap_factor tight when migration
    # volume is bounded; overflow is counted, never silent.
    n_cap = max(
        int(max((own_of_ptcl == r).sum() for r in range(R)) * cap_factor)
        + 8, 64
    )
    # per-rank rotation tables (local element -> per-step rotation)
    rot_h = np.stack([
        np.asarray(push_ops.elliptical_rot_table(
            pp.mesh.class_id[r], cfg.deg_per_push))
        for r in range(R)
    ]).astype(np.float32)

    state_h = {
        "x0": np.zeros((R, n_cap), np.float32),
        "x1": np.zeros((R, n_cap), np.float32),
        "cphi": np.zeros((R, n_cap), np.float32),
        "sphi": np.zeros((R, n_cap), np.float32),
        "b": np.zeros((R, n_cap), np.float32),
        "pid": np.full((R, n_cap), -1, np.int32),
        "elem": np.full((R, n_cap), -1, np.int32),
        "active": np.zeros((R, n_cap), bool),
    }
    if analytic is not None:
        state_h["gelem"] = np.full((R, n_cap), -1, np.int32)
        g2l_h = np.full((R, gmesh.nelems), -1, np.int32)
    if cfg.gyro.per_particle_radius:
        # same global-seed radius stream as make_dp_setup so the picparts
        # arm deposits identically for identical configs (round-5 review:
        # per_particle_radius was silently ignored here)
        state_h["rg"] = np.zeros((R, n_cap), np.float32)
        rg_all = np.random.default_rng(PARTICLE_SEED + 1).uniform(
            0.25 * cfg.gyro.rmax, cfg.gyro.rmax, cfg.num_ptcls)
    for r in range(R):
        sel = np.nonzero(own_of_ptcl == r)[0]
        n = len(sel)
        g2l = np.full(gmesh.nelems, -1, np.int64)
        valid = elem_gid_h[r] >= 0
        g2l[elem_gid_h[r][valid]] = np.nonzero(valid)[0]
        state_h["x0"][r, :n] = pos[sel, 0]
        state_h["x1"][r, :n] = pos[sel, 1]
        state_h["cphi"][r, :n] = cphi[sel]
        state_h["sphi"][r, :n] = sphi[sel]
        state_h["b"][r, :n] = b[sel]
        state_h["pid"][r, :n] = sel
        state_h["elem"][r, :n] = g2l[g_elems[sel]]
        state_h["active"][r, :n] = True
        if cfg.gyro.per_particle_radius:
            state_h["rg"][r, :n] = rg_all[sel]
        if analytic is not None:
            state_h["gelem"][r, :n] = g_elems[sel]
            g2l_h[r] = g2l.astype(np.int32)

    sharding = NamedSharding(device_mesh, P(AX))
    state = {
        k: jax.device_put(jnp.asarray(v), sharding) for k, v in state_h.items()
    }
    pp = jax.device_put(pp, sharding)

    # --- per-rank gyro maps on the local (padded) meshes
    gyro = cfg.gyro
    gyro_maps = []
    rpp3 = gyro.num_rings * gyro.points_per_ring * 3
    for r in range(R):
        lmesh = jax.tree_util.tree_map(lambda a, _r=r: a[_r], pp.mesh)
        gm = build_gyro_mapping(lmesh, gyro)
        # padded vertices carry no rings
        vmask = jnp.repeat(pp.vert_gid[r] >= 0, rpp3)
        gyro_maps.append(jnp.where(vmask, gm, -1))
    gyro_map = jax.device_put(jnp.stack(gyro_maps), sharding)

    # per-rank locator grids (built from each picpart's VALID entities only;
    # padded coords would pollute the bounds)
    locator = None
    # per-rank policy from the LOCAL (padded) mesh size — spatial
    # decomposition shrinks per-rank tables, so parts usually stay on the
    # small-mesh (cpe16 + rows) side of the policy
    pp_cpe, pp_peel, pp_widths = resolve_locator_policy(
        cfg, pp.mesh.nelems, n_cap)
    if cfg.use_locator and analytic is None:
        from pumipic_jax.mesh.locator import (
            BandGrid2D,
            LocatorGrid2D,
            build_locator_grid,
            detect_banded_locator,
        )

        grids = []
        eg_h = np.asarray(pp.elem_gid)
        vg_h = np.asarray(pp.vert_gid)
        ev_h = np.asarray(pp.mesh.elem2verts)
        cz_h = np.asarray(pp.mesh.coords)
        wg_h = np.asarray(pp.mesh.walk_geom)
        cls_h = np.asarray(pp.mesh.class_id)
        # ragged flux-band cells per rank (band_locator="force") need EVERY
        # rank's local picpart to detect as a stitched band structure with
        # matching shape (in practice R=1, where local == global: the
        # wedge submeshes of a real decomposition have partial rings and
        # fail detection)
        band_grids = None
        if cfg.band_locator not in ("auto", "off", "force"):
            raise ValueError(f"unknown band_locator {cfg.band_locator!r}")
        if cfg.band_locator == "force":
            bgs = []
            for r in range(R):
                valid_e = np.nonzero(eg_h[r] >= 0)[0]
                nv = int((vg_h[r] >= 0).sum())
                bgs.append(detect_banded_locator(
                    cz_h[r][:nv], ev_h[r][valid_e], cls_h[r][valid_e],
                    wg_h[r][valid_e], n_theta=cfg.band_theta))
            if all(b is not None for b in bgs) and len({
                    (b.n_bands, b.n_theta, b.n_harm, b.n_cheb, b.rank)
                    for b in bgs}) == 1:
                band_grids = bgs
            else:
                raise ValueError("band_locator='force' but a picpart is "
                                 "not a stitched flux-band structure")
        if band_grids is not None:
            locator = BandGrid2D(
                cx=jnp.stack([b.cx for b in band_grids]),
                cy=jnp.stack([b.cy for b in band_grids]),
                coef_u=jnp.stack([b.coef_u for b in band_grids]),
                coef_v=jnp.stack([b.coef_v for b in band_grids]),
                inv_coef=jnp.stack([b.inv_coef for b in band_grids]),
                cell_rows=jnp.stack([b.cell_rows for b in band_grids]),
                cell_elem=jnp.stack([b.cell_elem for b in band_grids]),
                n_bands=band_grids[0].n_bands,
                n_theta=band_grids[0].n_theta,
                n_harm=band_grids[0].n_harm,
                n_cheb=band_grids[0].n_cheb,
                rank=band_grids[0].rank,
            )
            locator = jax.device_put(locator, sharding)
    if cfg.use_locator and analytic is None and locator is None:
        grids = []
        for r in range(R):
            valid_e = np.nonzero(eg_h[r] >= 0)[0]
            # local element ids are preserved: build over the valid subset
            # and scatter guesses back through the subset index
            sub_ev = ev_h[r][valid_e]
            # polar=False: a picpart is a wedge of the domain — its θ span
            # is far less than 2π, so polar cells would dilute the budget
            g = build_locator_grid(cz_h[r][: (vg_h[r] >= 0).sum()], sub_ev,
                                   walk_geom=wg_h[r], peel=pp_peel,
                                   cells_per_elem=pp_cpe, polar=False)
            # cell ids are positions within valid_e == local elem ids when
            # valid elements are a prefix (they are: padding is appended)
            grids.append(g)
        kmax = max(int(g.cell_elem.shape[0]) for g in grids)

        def _stack_padded(field):
            vals = [getattr(g, field) for g in grids]
            if vals[0] is None:
                return None
            return jnp.stack([
                jnp.pad(v, ((0, kmax - v.shape[0]),) + ((0, 0),) * (v.ndim - 1))
                for v in vals
            ])

        locator = LocatorGrid2D(
            origin=jnp.stack([g.origin for g in grids]),
            inv_h=jnp.stack([g.inv_h for g in grids]),
            cell_elem=_stack_padded("cell_elem"),
            nx=jnp.stack([g.nx for g in grids]),
            ny=jnp.stack([g.ny for g in grids]),
            cell_rows=_stack_padded("cell_rows"),
            cell_lines=_stack_padded("cell_lines"),
            cell_rows_b=_stack_padded("cell_rows_b"),
        )
        locator = jax.device_put(locator, sharding)

    if migrate_cap is None:
        migrate_cap = max(n_cap // 8, 64)

    from functools import partial as _partial

    rot_tables = jax.device_put(jnp.asarray(rot_h), sharding)

    # packed per-element routing (safe | owner | sbar in ONE f32): the hot
    # step pays a single particle-rate gather where set_unsafe_procs + the
    # LB's sbar lookup + noncore priority cost three (pack_route)
    n_sbars = bt.num_sbars if bt is not None else 0
    assert mig.route_pack_bound_ok(n_sbars, R), (
        f"route pack exceeds f32 exactness: S={n_sbars} R={R}")
    route = jnp.stack([
        mig.pack_route(
            pp.elem_safe[r], pp.elem_owner[r],
            bt.sbar_of_elem[r] if bt is not None else None, R,
        )
        for r in range(R)
    ])
    g2l_tbl = None
    if analytic is not None and br is None:
        # fused [g2l | route] columns: ONE (E_global, 2) i32 row gather per
        # particle replaces the separate g2l and route gathers (a
        # bit-packed 1-col variant was slower where this was first tuned:
        # narrow (N,)-output gathers hit a padded layout).  The production
        # path on band partitions is the gather-FREE banded route above;
        # this 2-col row is the fallback for non-band partitions.  pack_route
        # values are integer-valued < 2^24, exact through the i32
        # round-trip.
        route_h = np.asarray(route).astype(np.int64)      # (R, E_local)
        fused = np.zeros((R, gmesh.nelems, 2), np.int32)
        for r in range(R):
            fused[r, :, 0] = g2l_h[r]
            valid = g2l_h[r] >= 0
            fused[r, valid, 1] = route_h[r][g2l_h[r][valid]]
        g2l_tbl = jax.device_put(jnp.asarray(fused), sharding)
    route = jax.device_put(route, sharding)

    @jax.jit
    @_partial(
        jax.shard_map,
        mesh=device_mesh,
        in_specs=(P(AX), P(AX), P(), P(), P(AX),
                  P(AX), P(AX), P(AX), P(AX)),
        out_specs=(P(AX), P(AX), P()),
        check_vma=False,
    )
    def step(pp_l, gmap_l, bt_r, nplan_r, loc_l, rot_l, route_l, g2l_l, s):
        lpp = ppm.local_view(pp_l)
        lmesh = lpp.mesh
        s = ppm.local_view(s)
        gmap = gmap_l[0]
        lloc = ppm.local_view(loc_l) if loc_l is not None else None
        rot_table = rot_l[0]
        me = jax.lax.axis_index(AX).astype(jnp.int32)

        elem, active = s["elem"], s["active"]
        if use_rot_an:
            # ring_class-proven global mesh: rotation analytic in the
            # CARRIED global element id — no table gather
            cd, sd = push_ops.rot_vals_from_class(
                analytic.class_of(jnp.maximum(s["gelem"], 0)),
                cfg.deg_per_push)
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot_vals(
                s["cphi"], s["sphi"], s["b"], cd, sd, cfg.h, cfg.k, cfg.d
            )
        else:
            # rotation push: gather the local element's (cos, sin) row
            tx, ty, cphi_new, sphi_new = push_ops.elliptical_push_rot(
                s["cphi"], s["sphi"], s["b"], elem, rot_table,
                cfg.h, cfg.k, cfg.d
            )
        xtgt = (jnp.where(active, tx, s["x0"]), jnp.where(active, ty, s["x1"]))
        if analytic is not None:
            # global analytic locate (exact by the detection proof) + ONE
            # (E_global,) g2l gather to rank-local ids — replaces the
            # per-rank peel+pyramid walk.  Destinations outside the domain
            # are boundary exits (INVALID, the walk's removal semantics);
            # in-domain destinations outside this rank's picpart cannot
            # occur within safe-zone semantics (the buffer covers every
            # reachable element before migration) and would deactivate the
            # particle exactly like the walk's buffer-boundary exit.
            e_gl, _ins, rf_p, kf_p, trif_p = analytic.locate_parts(xtgt)
            e_gl = jnp.where(active, e_gl, search_ops.INVALID)
            if br is not None:
                # gather-free banded routing: lid/dest/sbar/noncore are
                # fused elementwise arithmetic on the locate's
                # (ring, sector, tri) parts (derive-time exhaustive
                # verification against the generic tables); the per-rank
                # window/safe scalars are tiny closed-over constants
                lid, dest_b, sbar_b, noncore_b = brm.banded_decode(
                    br, rf_p, kf_p, trif_p, e_gl >= 0, active, me,
                    br.win_a[me], br.win_w[me], br.win_w0[me],
                    br.win_nsa[me], br.safe_a[me], br.safe_len[me])
                route_v = None
            else:
                g_row = g2l_l[0][jnp.maximum(e_gl, 0)]   # (N, 2) [lid|route]
                lid = jnp.where(e_gl >= 0, g_row[:, 0], search_ops.INVALID)
                route_v = g_row[:, 1].astype(jnp.float32)
            gelem_new = jnp.where(lid >= 0, e_gl, search_ops.INVALID)
            res = search_ops.SearchResult(
                elem_ids=lid, dest_c=xtgt, all_found=jnp.bool_(True),
                iters=jnp.int32(0), aux_c=None,
            )
        elif lloc is not None:
            res = search_ops.search_mesh_2d_accel(
                lmesh, lloc, (s["x0"], s["x1"]), xtgt, elem, active,
                cfg.max_search_iters, widths=pp_widths,
            )
        else:
            res = search_ops.search_mesh_2d(
                lmesh, (s["x0"], s["x1"]), xtgt, elem, active,
                cfg.max_search_iters, widths=pp_widths,
            )

        mid = {
            "x0": res.dest_c[0],
            "x1": res.dest_c[1],
            "cphi": jnp.where(active, cphi_new, s["cphi"]),
            "sphi": jnp.where(active, sphi_new, s["sphi"]),
            "b": s["b"],
            "pid": s["pid"],
            "elem": res.elem_ids,
            "active": active & (res.elem_ids >= 0),
        }
        if gyro.per_particle_radius:
            mid["rg"] = s["rg"]
        if analytic is not None:
            mid["gelem"] = gelem_new
        # one-gather routing: dest (setUnsafeProcs semantics), per-particle
        # sbar and noncore priority decoded from the packed f32 table (or
        # from the route column already fused into the analytic g2l
        # gather; or gather-FREE from the banded proofs)
        if analytic is not None and br is not None:
            dest, sbar_p, noncore_p = dest_b, sbar_b, noncore_b
        elif analytic is not None:
            dest, sbar_p, noncore_p = mig.route_decode(
                route_v, mid["active"], me, R)
        else:
            dest, sbar_p, noncore_p = mig.route_particles(
                route_l[0], res.elem_ids, mid["active"], me, R
            )
        if bt_r is not None:
            # migrate_lb_ptcls analog: diffusion plan + particle selection
            dest = lbm.repartition(
                bt_r, bt_r.sbar_of_elem[me], res.elem_ids,
                mid["active"], dest, me, lb_tol,
                sbar_of_ptcl=sbar_p, noncore=noncore_p, axis_name=AX,
            )
        mres = mig.migrate(
            mid, res.elem_ids, dest, lpp.elem_gid,
            lpp.elem_gid_sorted, lpp.elem_gid_perm, me, R, migrate_cap,
            plan=nplan_r, axis_name=AX, hier=hier,
        )
        s2 = mres.state

        # gyroScatter + gyroSync.  The reference scatters fwd AND bwd
        # (gyroScatter.hpp:169-232), but with the identity projection both
        # directions share one map, so the bwd pipeline is value-identical
        # to fwd and XLA CSEs it away — the step returns the shared field
        # once (build_gyro_mappings likewise builds one map for both).
        if gyro.per_particle_radius:
            # bracket each particle's own gyro radius (same path as the
            # dp/single-device arms — this config was silently ignored
            # here before round 5)
            ring_accum = scatter_ops.accumulate_to_rings(
                s2["elem"], s2["active"], lmesh.elem2verts,
                lmesh.nverts, gyro.num_rings, gyro.rmax,
                ptcl_radius=s2["rg"],
            )
            fwd = scatter_ops.scatter_to_mapped_verts(
                ring_accum, gmap, lmesh.nverts, gyro.num_rings,
                gyro.points_per_ring,
            )
        else:
            fwd = scatter_ops.gyro_scatter(
                s2["elem"], s2["active"], lmesh.elem2verts, gmap,
                lmesh.nverts, gyro.num_rings, gyro.points_per_ring,
                gyro.rmax,
            )
        # gyroSync: reduceCommArray(VERT, SUM) over buffered copies
        fwd = red.reduce_comm_array(
            lpp.vert_send_ids, lpp.vert_recv_ids, fwd, red.Op.SUM,
            axis_name=AX, hier=hier,
        )
        nloc = jnp.sum(s2["active"].astype(jnp.int32))
        _, _, imb = lbm.ptcl_imbalance(nloc, axis_name=AX)
        stats = {
            "alive": jax.lax.psum(nloc, AX),
            "sent": jax.lax.psum(mres.num_sent, AX),
            # admission-quota pressure: leavers parked at home because the
            # receiver lacked free slots (lossless migration); sustained
            # nonzero means capacity is too tight (parallel/capacity.py)
            "kept_home": jax.lax.psum(mres.num_kept_home, AX),
            "overflow": jax.lax.pmax(
                mres.overflow.astype(jnp.int32), AX
            ),
            "unresolved": jax.lax.psum(mres.num_recv_unresolved, AX),
            "illegal_dest": jax.lax.psum(mres.num_illegal_dest, AX),
            "imbalance": imb,
            # per-rank telemetry for summarize_across_devices
            # (SummarizeTimeAcrossProcesses analog, ppTiming.cpp:220-338)
            "alive_per_rank": jax.lax.all_gather(nloc, AX),
            "sent_per_rank": jax.lax.all_gather(mres.num_sent, AX),
        }
        return (
            jax.tree_util.tree_map(lambda a: a[None], s2),
            fwd[None],
            stats,
        )

    return pp, state, gyro_map, (
        lambda s: step(pp, gyro_map, bt, nplan, locator, rot_tables, route,
                       g2l_tbl, s)
    )


def shrink_picparts_capacity(state, new_cap: int):
    """Adaptive slot-capacity shrink for the picparts particle state.

    Every particle-rate op in the step runs at CAPACITY width (static
    shapes), so idle headroom is pure per-step cost — the round-3 picparts
    premium was exactly this padding.  This host-side utility compacts each
    rank's live particles to a slot prefix and truncates the state to
    ``new_cap`` slots; the jitted step simply re-traces at the new width.
    Pair with migration telemetry (``alive_per_rank`` + ``sent_per_rank``)
    to pick ``new_cap``, and rely on the lossless admission quotas
    (parallel/migrate.py) as the backstop when a burst exceeds the shrunk
    free space — beyond-quota leavers stay home and retry, never drop.
    The same recompile economics as particle-structure capacity growth.

    Thin alias for :func:`pumipic_jax.parallel.capacity.resize_capacity`
    (which also grows); prefer the telemetry-driven
    :class:`~pumipic_jax.parallel.capacity.CapacityMonitor` in app loops.
    """
    from pumipic_jax.parallel.capacity import resize_capacity

    return resize_capacity(state, new_cap)


def make_default_mesh(nelems_target: int = 25_000) -> Mesh2D:
    """Tokamak-cross-section-like annulus sized to ~nelems_target elements
    (XGC 24k-element mesh analog)."""
    # annulus elems = 2 * n_rings * n_sectors; keep sectors ≈ 4x rings
    n_rings = max(int(np.sqrt(nelems_target / 8)), 2)
    n_sectors = nelems_target // (2 * n_rings)
    coords, tris, cls = gen.annulus_mesh(n_rings, n_sectors, 0.3, 1.0)
    return Mesh2D.from_arrays(coords, tris, cls)
