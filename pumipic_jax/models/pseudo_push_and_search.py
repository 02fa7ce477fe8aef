"""pseudoPushAndSearch — 3D push + search + migrate mini-app.

Reference parity: ``test/pseudoPushAndSearch.cpp`` — particles seeded on a
model face of a tet mesh, pushed a fixed distance along a direction vector
each step (push, :87-118), located with the 3D adjacency search, and
migrated/rebuilt; particles exiting the domain are deleted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh.core import Mesh3D
from pumipic_jax.ops import push as push_ops
from pumipic_jax.ops import search as search_ops
from pumipic_jax.particles import SellCSigma, SCSInput, CSR, DPS, CabM

_BUILDERS = {
    "scs": lambda E, elems, fields: SellCSigma(
        E, elems, fields=fields, scs_input=SCSInput(chunk_size=8, sigma=None)
    ),
    "csr": lambda E, elems, fields: CSR(E, elems, fields=fields),
    "cabm": lambda E, elems, fields: CabM(E, elems, fields=fields),
    "dps": lambda E, elems, fields: DPS(E, elems, fields=fields),
}


@dataclass(frozen=True)
class PushSearchConfig:
    num_ptcls: int = 10_000
    num_iterations: int = 5
    push_dir: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    distance: float = 0.05       # reference: domain height / 20
    structure: str = "scs"
    max_search_iters: int = 100
    use_locator: bool = True
    # wall behavior: "remove" = reference semantics (delete on exit,
    # test/pseudoPushAndSearch.cpp deletes leavers), "reflect" = specular
    # wall, "periodic" = wrap the pushed position back into the domain box
    # BEFORE the search (steady-state benchmark mode: the particle
    # population never drains, and with the grid-accelerated search a wrap
    # is an ordinary one-guess locate, not a cross-domain walk)
    wall: str = "remove"
    # 3D locator policy: tet meshes have a much higher 2-candidate guess-miss
    # rate than triangle meshes (a locator cell overlaps ~6 Kuhn tets), so
    # the resolution and the pyramid widths matter more than in 2D.  None =
    # auto (resolve_locator_policy_3d).
    cells_per_elem: Optional[float] = None
    peel: str = "auto"
    widths: Optional[Tuple[int, ...]] = None
    # "auto" = reshuffle-or-rebuild (SCS_rebuild.h semantics): scs/cabm keep
    # unmoved particles in their slots and only place the movers, falling
    # back to the full sort when counts outgrow the layout.  Structures are
    # then built with ``extra_padding`` per-segment headroom so the
    # reshuffle keeps fitting under steady-state drift.
    rebuild_mode: str = "sort"
    extra_padding: float = 0.15
    # structured-region analytic locator (mesh.locator.KuhnLocator3D):
    # "auto" uses it when detect_box_kuhn PROVES the mesh is a structured
    # Kuhn box (connectivity equality) and the wall mode is convex-exact
    # (periodic/remove — on a convex box the path exits iff the destination
    # is outside); "off" forces the grid-accelerated walk; "force" errors
    # if detection fails.  The walk path stays the general unstructured
    # engine — this is the tet-aligned fast path for structured regions.
    kuhn: str = "auto"


def resolve_locator_policy_3d(cfg: PushSearchConfig, nelems: int,
                              num_ptcls: int):
    """Resolve (cells_per_elem, peel, widths) for a tet mesh.

    The tet 2-candidate guess-miss rate is an order of magnitude above the
    triangle meshes' (37% at cpe2, 19% at cpe8 — a locator cell overlaps
    ~6 Kuhn tets), so the policy
    spends locator memory on resolution and opens the pyramid's first
    level wide enough to absorb the miss tail without extra full-width
    16-col walk passes."""
    cpe, peel, widths = cfg.cells_per_elem, cfg.peel, cfg.widths
    if cpe is None:
        if nelems * 16 * 26 * 4 <= 48e6:
            # the 48 MB table bound and this choice were tuned on an
            # earlier accelerator at 24.5k tets / 10M particles (miss
            # 13.7%) and have not been re-decided on a GPU
            cpe = 16.0
        else:
            # big tet meshes: follow the 2D big-table result (chained
            # sub-cliff lines beat a far-above-cliff rows gather)
            cpe = 4.0
            if peel == "auto":
                peel = "lines"
    if widths is None and num_ptcls >= 1 << 16:
        # first level must absorb the tet miss tail (13.7% at cpe16)
        # without full-width 16-col walk passes
        widths = (max(num_ptcls // 4, 2048),
                  max(num_ptcls // 64, 2048), 2048)
    return cpe, peel, widths


class PseudoPushAndSearch:
    def __init__(self, mesh: Mesh3D, cfg: PushSearchConfig, seed: int = 0):
        self.mesh = mesh
        self.cfg = cfg
        rng = np.random.default_rng(seed)

        # seed particles uniformly over elements, at element centroids with
        # jitter toward a random vertex (uniform-in-tet via folded sampling)
        elems = rng.integers(0, mesh.nelems, size=cfg.num_ptcls)
        ev = np.asarray(mesh.elem2verts)[elems]
        cz = np.asarray(mesh.coords)
        r = rng.dirichlet(np.ones(4), size=cfg.num_ptcls)
        pos = np.einsum("nk,nkd->nd", r, cz[ev])

        d = np.asarray(cfg.push_dir, np.float64)
        d = d / np.linalg.norm(d)
        fields = {
            "x": jnp.asarray(pos, jnp.float32),
            "pid": jnp.arange(cfg.num_ptcls, dtype=jnp.int32),
        }
        self.direction = jnp.asarray(d, jnp.float32)
        sorted_fields = {
            "x": fields["x"][np.argsort(elems, kind="stable")],
            "pid": fields["pid"][np.argsort(elems, kind="stable")],
        }
        if cfg.rebuild_mode == "auto" and cfg.structure in ("scs", "cabm"):
            pad = cfg.extra_padding
            if cfg.structure == "scs":
                self.ptcls = SellCSigma(
                    mesh.nelems, np.sort(elems), fields=sorted_fields,
                    scs_input=SCSInput(chunk_size=8, sigma=None,
                                       extra_padding=pad))
            else:
                self.ptcls = CabM(mesh.nelems, np.sort(elems),
                                  fields=sorted_fields, extra_padding=pad)
        elif cfg.structure in ("csr", "dps"):
            # this app never ADDS particles (rebuild only deactivates
            # leavers), so slot capacity = num_ptcls exactly: every
            # particle-rate op in the step runs at true width instead of
            # the constructor's 1.2x padded default (the same capacity-
            # padding tax as the picparts R=1 finding)
            self.ptcls = _BUILDERS_CAP[cfg.structure](
                mesh.nelems, np.sort(elems), sorted_fields, cfg.num_ptcls)
        else:
            self.ptcls = _BUILDERS[cfg.structure](
                mesh.nelems, np.sort(elems), sorted_fields)
        self._step = self._make_step()

    def _make_step(self):
        mesh, cfg, direction = self.mesh, self.cfg, self.direction
        locator = None
        widths = None
        kuhn = None
        if cfg.kuhn == "force" and cfg.wall not in ("periodic", "remove"):
            # the analytic locate replaces the walk entirely, so it cannot
            # service walls that need the walk's boundary interaction
            # (reflect) — 'force' must error, not silently run the walk
            raise ValueError(
                f"kuhn='force' is incompatible with wall={cfg.wall!r} "
                f"(the analytic locate supports 'periodic'/'remove' only)")
        if cfg.kuhn in ("auto", "force") and cfg.wall in ("periodic",
                                                          "remove"):
            from pumipic_jax.mesh.locator import detect_box_kuhn

            kuhn = detect_box_kuhn(
                np.asarray(mesh.coords), np.asarray(mesh.elem2verts))
            if kuhn is None and cfg.kuhn == "force":
                raise ValueError("kuhn='force' but the mesh is not a "
                                 "structured Kuhn box")
        if cfg.use_locator and kuhn is None:
            from pumipic_jax.mesh.locator import build_locator_grid_3d

            cpe, peel, widths = resolve_locator_policy_3d(
                cfg, mesh.nelems, cfg.num_ptcls)
            locator = build_locator_grid_3d(
                np.asarray(mesh.coords), np.asarray(mesh.elem2verts),
                cells_per_elem=cpe, walk_geom=mesh.walk_geom, peel=peel,
            )
        handler = (search_ops.reflect_on_exit_3d if cfg.wall == "reflect"
                   else search_ops.remove_on_exit)
        coords_h = np.asarray(mesh.coords)
        box_lo = jnp.asarray(coords_h.min(axis=0), jnp.float32)
        box_ext = jnp.asarray(
            coords_h.max(axis=0) - coords_h.min(axis=0), jnp.float32)

        @jax.jit
        def step(ptcls):
            x = ptcls.get("x")
            xtgt = push_ops.straight_line_push(x, direction, cfg.distance)
            if cfg.wall == "periodic":
                # torus topology: wrap before the search; nudge off the
                # exact boundary so the wrapped point is strictly interior
                xtgt = (xtgt - box_lo) % box_ext + box_lo
            if kuhn is not None:
                # structured fast path: the whole search is one fused
                # elementwise pass — analytic containing tet of the
                # destination; on the convex box, destination-outside ⟺
                # the path exits (remove semantics), and periodic wrap
                # keeps every destination inside
                e, _inside = kuhn.locate(
                    (xtgt[:, 0], xtgt[:, 1], xtgt[:, 2]))
                elem_ids = jnp.where(ptcls.active, e, search_ops.INVALID)
                ptcls2 = ptcls.set("x", xtgt).rebuild(
                    elem_ids, mode=cfg.rebuild_mode)
                return ptcls2, jnp.int32(0)
            if locator is not None:
                res = search_ops.search_mesh_3d_accel(
                    mesh, locator, x, xtgt, ptcls.elem, ptcls.active,
                    cfg.max_search_iters, boundary_handler=handler,
                    widths=widths,
                )
            else:
                res = search_ops.search_mesh_3d(
                    mesh, x, xtgt, ptcls.elem, ptcls.active,
                    cfg.max_search_iters, boundary_handler=handler,
                )
            ptcls2 = ptcls.set("x", res.dest).rebuild(
                res.elem_ids, mode=cfg.rebuild_mode)
            return ptcls2, res.iters

        return step

    def run(self, num_iterations: Optional[int] = None, verbose: bool = False):
        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        history = []
        for i in range(iters):
            self.ptcls, walk_iters = self._step(self.ptcls)
            history.append(self.ptcls.n_ptcls())
            if verbose:
                from pumipic_jax.utils.plog import print_info

                print_info("iter %d: ptcls %d walk %d", i, history[-1], int(walk_iters))
            if history[-1] == 0:
                break
        return history


# ---------------------------------------------------------------------------
# distributed (BFS-buffered 3D PICparts) variant — the reference runs this
# app at 2 ranks with migrate_lb_ptcls (test/pseudoPushAndSearch.cpp:204-206,
# 524; registered in test/testing.cmake:98-108)
# ---------------------------------------------------------------------------

def make_picparts_setup_3d(
    coords: np.ndarray,
    tets: np.ndarray,
    cfg: PushSearchConfig,
    device_mesh,
    inp=None,
    migrate_cap: Optional[int] = None,
    seed: int = 0,
    use_lb: bool = True,
    lb_tol: float = 1.05,
    neighbor_migration: bool = True,
):
    """Distributed pseudoPushAndSearch over BFS-buffered 3D PICparts:
    per step — straight-line push → 3D adjacency search from the previous
    element (the reference's walk) → safe-zone migration with optional LB →
    layout rebuild on arrival (``migrate_structure``, so ANY container
    layout rides the collective like the reference's per-structure
    migrate).  Returns ``(pp, ps_stacked, step)``; ``step(ps) -> (ps,
    stats)`` with ps sharded ``P('ranks')``.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pumipic_jax.parallel import balancer as lbm
    from pumipic_jax.parallel import migrate as mig
    from pumipic_jax.parallel import picparts as ppm
    from pumipic_jax.parallel.mesh_axis import mesh_axes

    # axis-name tuple of the device mesh (('ranks',) or
    # ('slice', 'ranks') multi-slice) — flat-rank collective semantics
    AX = mesh_axes(device_mesh)
    hier = len(AX) == 2
    R = int(np.prod([device_mesh.shape[a] for a in device_mesh.axis_names]))
    if inp is None:
        inp = ppm.PicPartsInput()
    owners = ppm.partition_rcb(coords, tets, R)
    pp = ppm.build_picparts(coords, tets, owners, R, inp, mesh_cls=Mesh3D)
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

    # --- global seeding, routed to owning ranks
    gmesh = Mesh3D.from_arrays(coords, tets)
    rng = np.random.default_rng(seed)
    g_elems = rng.integers(0, gmesh.nelems, size=cfg.num_ptcls)
    ev = np.asarray(gmesh.elem2verts)[g_elems]
    cz = np.asarray(gmesh.coords)
    r4 = rng.dirichlet(np.ones(4), size=cfg.num_ptcls)
    pos = np.einsum("nk,nkd->nd", r4, cz[ev])
    own_of_ptcl = owners[g_elems]
    eg_h = np.asarray(pp.elem_gid)
    n_cap = max(
        int(max((own_of_ptcl == r).sum() for r in range(R)) * 2.0) + 16, 64
    )
    E_l = pp.mesh.nelems

    # detection-gated GLOBAL Kuhn analytic locate (the 3D analog of
    # make_picparts_setup's annulus path): per-rank submeshes never pass
    # the box proof, but the GLOBAL mesh can — locate analytically in
    # global tet ids and map to rank-local ids through one (E_global,)
    # g2l gather, replacing the per-rank walk.  Gated on remove-wall
    # semantics (the distributed step has no periodic wrap): on the
    # convex box, destination-outside ⟺ the path exits.
    kuhn = None
    if cfg.kuhn in ("auto", "force") and cfg.wall == "remove":
        from pumipic_jax.mesh.locator import detect_box_kuhn

        kuhn = detect_box_kuhn(coords, tets)
        if kuhn is None and cfg.kuhn == "force":
            raise ValueError("kuhn='force' but the mesh is not a "
                             "structured Kuhn box")
    g2l_h = None
    if kuhn is not None:
        g2l_h = np.full((R, gmesh.nelems), -1, np.int32)

    ps_list = []
    for r in range(R):
        sel = np.nonzero(own_of_ptcl == r)[0]
        g2l = np.full(gmesh.nelems, -1, np.int64)
        valid = eg_h[r] >= 0
        g2l[eg_h[r][valid]] = np.nonzero(valid)[0]
        if g2l_h is not None:
            g2l_h[r] = g2l.astype(np.int32)
        ps_list.append(_BUILDERS[cfg.structure](
            E_l, g2l[g_elems[sel]],
            {
                "x": jnp.asarray(pos[sel], jnp.float32),
                "pid": jnp.asarray(sel, jnp.int32),
            },
        ))
    # equalize capacities so the per-rank pytrees stack
    cap = max(p.capacity for p in ps_list)
    cap = max(cap, n_cap)
    for i, p in enumerate(ps_list):
        if p.capacity != cap:
            h = p.copy_to_host()
            elems = np.where(h["active"], h["elem"], -1)
            ps_list[i] = _BUILDERS_CAP[cfg.structure](
                E_l, elems,
                {"x": jnp.asarray(h["x"]), "pid": jnp.asarray(h["pid"])},
                cap,
            )
    ps_stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ps_list)

    sharding = NamedSharding(device_mesh, P(AX))
    ps_stacked = jax.device_put(ps_stacked, sharding)
    pp = jax.device_put(pp, sharding)
    g2l_tbl = None
    g2l_fused = False
    if g2l_h is not None:
        # fused [g2l | route] columns (the 2D analytic picparts design,
        # make_picparts_setup): ONE (E_global, 2) i32 row gather replaces
        # g2l + set_unsafe_procs + the LB's sbar/owner gathers (the 2-col
        # ROW form, as in the 2D step).
        n_sbars = bt.num_sbars if bt is not None else 0
        assert mig.route_pack_bound_ok(n_sbars, R)
        route_h = np.stack([
            np.asarray(mig.pack_route(
                pp.elem_safe[r], pp.elem_owner[r],
                bt.sbar_of_elem[r] if bt is not None else None, R))
            for r in range(R)
        ]).astype(np.int64)
        g2l_fused = True
        fused = np.zeros((R, gmesh.nelems, 2), np.int32)
        for r in range(R):
            fused[r, :, 0] = g2l_h[r]
            valid = g2l_h[r] >= 0
            fused[r, valid, 1] = route_h[r][g2l_h[r][valid]]
        g2l_tbl = jax.device_put(jnp.asarray(fused), sharding)

    d = np.asarray(cfg.push_dir, np.float64)
    direction = jnp.asarray(d / np.linalg.norm(d), jnp.float32)
    if migrate_cap is None:
        migrate_cap = max(cap // 4, 64)

    from functools import partial as _partial

    @jax.jit
    @_partial(
        jax.shard_map,
        mesh=device_mesh,
        in_specs=(P(AX), P(), P(), P(AX), P(AX)),
        out_specs=(P(AX), P()),
        check_vma=False,
    )
    def step(pp_l, bt_r, nplan_r, g2l_l, ps_s):
        lpp = ppm.local_view(pp_l)
        lmesh = lpp.mesh
        ps = ppm.local_view(ps_s)
        me = jax.lax.axis_index(AX).astype(jnp.int32)

        x = ps.get("x")
        xtgt = push_ops.straight_line_push(x, direction, cfg.distance)
        sbar_p = noncore_p = None
        if kuhn is not None:
            # global analytic locate + ONE fused [lid|route] gather (see
            # setup comment); in-domain destinations outside this rank's
            # picpart cannot occur within safe-zone semantics and
            # deactivate the particle exactly like the walk's
            # buffer-boundary exit
            e_gl, _ins = kuhn.locate(
                (xtgt[:, 0], xtgt[:, 1], xtgt[:, 2]))
            e_gl = jnp.where(ps.active, e_gl, search_ops.INVALID)
            if g2l_fused:
                g_row = g2l_l[0][jnp.maximum(e_gl, 0)]   # (N, 2) [lid|route]
                elem_ids = jnp.where(e_gl >= 0, g_row[:, 0],
                                     search_ops.INVALID)
                route_v = g_row[:, 1].astype(jnp.float32)
            else:
                elem_ids = jnp.where(
                    e_gl >= 0, g2l_l[0][jnp.maximum(e_gl, 0)],
                    search_ops.INVALID)
                route_v = None
            dest_x = xtgt
        else:
            res = search_ops.search_mesh_3d(
                lmesh, x, xtgt, ps.elem, ps.active, cfg.max_search_iters,
            )
            elem_ids = res.elem_ids
            dest_x = res.dest
            route_v = None
        ps1 = ps.set("x", dest_x)
        ok = ps.active & (elem_ids >= 0)
        if route_v is not None:
            dest, sbar_p, noncore_p = mig.route_decode(route_v, ok, me, R)
        else:
            dest = mig.set_unsafe_procs(
                lpp.elem_safe, lpp.elem_owner, elem_ids, ps.active, me
            )
        if bt_r is not None:
            dest = lbm.repartition(
                bt_r, bt_r.sbar_of_elem[me], elem_ids,
                ok, dest, me, lb_tol,
                elem_owner=lpp.elem_owner,
                sbar_of_ptcl=sbar_p, noncore=noncore_p, axis_name=AX,
            )
        ps2, mres = mig.migrate_structure(
            ps1, elem_ids, dest, lpp.elem_gid,
            lpp.elem_gid_sorted, lpp.elem_gid_perm, me, R, migrate_cap,
            plan=nplan_r, axis_name=AX, hier=hier,
        )
        nloc = jnp.sum(ps2.active.astype(jnp.int32))
        _, _, imb = lbm.ptcl_imbalance(nloc, axis_name=AX)
        stats = {
            "alive": jax.lax.psum(nloc, AX),
            "sent": jax.lax.psum(mres.num_sent, AX),
            # quota-parked leavers (lossless migration backpressure signal)
            "kept_home": jax.lax.psum(mres.num_kept_home, AX),
            "overflow": jax.lax.pmax(
                (mres.overflow | ps2.overflowed).astype(jnp.int32), AX
            ),
            "unresolved": jax.lax.psum(mres.num_recv_unresolved, AX),
            "illegal_dest": jax.lax.psum(mres.num_illegal_dest, AX),
            "imbalance": imb,
        }
        return jax.tree_util.tree_map(lambda a: a[None], ps2), stats

    return pp, ps_stacked, (lambda ps: step(pp, bt, nplan, g2l_tbl, ps))


_BUILDERS_CAP = {
    "scs": lambda E, elems, fields, cap: SellCSigma(
        E, elems, fields=fields, capacity=cap,
        scs_input=SCSInput(chunk_size=8, sigma=None)
    ),
    "csr": lambda E, elems, fields, cap: CSR(
        E, elems, fields=fields, capacity=cap),
    "cabm": lambda E, elems, fields, cap: CabM(
        E, elems, fields=fields, capacity=cap),
    "dps": lambda E, elems, fields, cap: DPS(
        E, elems, fields=fields, capacity=cap),
}
