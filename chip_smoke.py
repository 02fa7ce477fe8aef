"""Chip smoke test: the system's entry points on the GPU, checked against
plain float64 references.

  python chip_smoke.py                # one GPU: every single-card phase
  python chip_smoke.py --four-cards   # four GPUs: picparts R=4 against dp

One card runs, in one process:

- ``dp``: the pseudoXGCm step exactly as ``bench.py`` builds it by default
  (the imported 120k gmsh mesh, 10M particles, ``make_dp_setup``).  Prints
  compile time, ``memory_analysis()``, the resolved locator policy,
  ms/step and peak device bytes, then checks the final state against
  ``pumipic_jax.reference``: containment, deaths, literal deposition and
  conservation, plus the step's accelerated walk against the plain walk.
- ``picparts``: ``make_picparts_setup`` at R=1 on the same mesh and count.
- ``pps3d``: ``PseudoPushAndSearch`` at 10M particles with the tet walk.
- ``structures``: construction, churn rebuild and migrate conservation for
  the four particle layouts at 10M, and the histogram past 2^24 keys.

``--four-cards`` runs only picparts R=4 (10M particles per card) and
``make_dp_setup`` over the same cards as its comparison, stepped in turn
and compared particle by particle after every step.

The script exits non-zero, and prints no result line, when JAX finds no
GPU (or too few), when the package cannot be imported, or when any phase
fails.  Its last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MESH_120K = os.path.join(ROOT, "data", "xgc_like_120k.msh.gz")
STEPS = 5
# f32 deposited fields: the mesh-rate scatters are f32 atomics on the GPU,
# so the order of each sum changes from run to run.  Every summand is a
# multiple of 1/points_per_ring, so at these magnitudes the sums are in
# fact exact; the tolerance only allows for reordered rounding.
FIELD_RTOL = 1e-5
# conservation: float64 sum of the f32 field against the exact total
CHARGE_RTOL = 1e-6


class CheckFailed(AssertionError):
    pass


def check(name: str, ok: bool, detail: str = "") -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {name} {detail}".rstrip(), flush=True)
    if not ok:
        raise CheckFailed(f"{name} {detail}")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def xgcm_config(class_id: np.ndarray, num_ptcls: int):
    """The configuration bench.py builds by default."""
    from pumipic_jax.models.pseudo_xgcm import XGCmConfig

    return XGCmConfig(
        num_ptcls=num_ptcls,
        mdl_face=max(int(np.asarray(class_id).max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
    )


def load_mesh(path: str = MESH_120K):
    from pumipic_jax.mesh.gmsh import read_msh

    return read_msh(path)


def _host(x):
    import jax

    return np.asarray(jax.device_get(x))


def describe_memory(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: none"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(ma, k, 'n/a')}"
        for k in keys)


def peak_bytes() -> int:
    import jax

    return max(d.memory_stats()["peak_bytes_in_use"]
               for d in jax.local_devices())


# ---------------------------------------------------------------------------
# checks shared by the 2D phases
# ---------------------------------------------------------------------------

def check_containment(coords, cells, elem, active, pts) -> None:
    from pumipic_jax.reference import (
        CONTAINMENT_ABS_TOL, CONTAINMENT_REL_TOL, containment_margin,
    )

    idx = np.flatnonzero(active)
    margin = containment_margin(coords, cells, elem[idx], pts[idx])
    bad = int((margin < 0).sum())
    check("containment", bad == 0,
          f"({len(idx)} active, {bad} outside by more than tol = "
          f"{CONTAINMENT_REL_TOL:.2e} x |terms| + {CONTAINMENT_ABS_TOL:g}; "
          f"worst margin {margin.min() if len(idx) else 0:.3e})")


def check_deaths(coords, tris, was_active, active, pts) -> None:
    from pumipic_jax.reference import outside_domain

    died = np.flatnonzero(was_active & ~active)
    inside = int((~outside_domain(coords, tris, pts[died])).sum())
    check("deaths left the domain", inside == 0,
          f"({len(died)} died, {inside} of them inside the domain)")


def check_deposition(elem, active, elem2verts, num_verts, gyro, gyro_map,
                     fields, ring_dev=None, elem_counts_dev=None) -> None:
    """Literal float64 deposition against the step's f32 fields."""
    from pumipic_jax.reference import deposited_charge, literal_deposition

    ring, ref = literal_deposition(
        elem, active, elem2verts, num_verts, gyro.num_rings, gyro.rmax,
        gyro_map, gyro.points_per_ring)
    if elem_counts_dev is not None:
        want = np.bincount(elem[active], minlength=len(elem2verts))
        check("per-element counts exact",
              np.array_equal(elem_counts_dev.astype(np.int64), want))
    if ring_dev is not None:
        check("per-(vertex, ring) counts exact",
              np.array_equal(ring_dev.astype(np.int64), ring))
    scale = max(float(np.abs(ref).max()), 1.0)
    alive = int(active.sum())
    nvpe = elem2verts.shape[1]
    rings_per_ptcl = 2 if gyro.num_rings > 1 else 1
    check("ring total = alive x vertices x rings",
          int(ring.sum()) == alive * nvpe * rings_per_ptcl,
          f"({int(ring.sum())} vs {alive * nvpe * rings_per_ptcl})")
    total = deposited_charge(ring, gyro_map, gyro.points_per_ring)
    for name, f in fields.items():
        f = np.asarray(f, np.float64)
        err = float(np.abs(f - ref).max()) / scale
        check(f"{name} = literal deposition", err <= FIELD_RTOL,
              f"(max rel err {err:.2e}, tol {FIELD_RTOL:g})")
        rel = abs(float(f.sum()) - total) / max(total, 1.0)
        check(f"{name} conserves charge", rel <= CHARGE_RTOL,
              f"(sum {float(f.sum()):.6e} vs {total:.6e}, rel {rel:.1e})")


def check_walks_agree(coords, tris, accel_elem, plain_elem, dest) -> None:
    """The accelerated walk must equal the plain walk element for element,
    except where the destination lies on a shared edge (both elements then
    contain it to tolerance)."""
    from pumipic_jax.reference import containment_margin

    diff = np.flatnonzero(accel_elem != plain_elem)
    both = (accel_elem[diff] >= 0) & (plain_elem[diff] >= 0)
    ties = 0
    if both.any():
        d = diff[both]
        ma = containment_margin(coords, tris, accel_elem[d], dest[d])
        mp = containment_margin(coords, tris, plain_elem[d], dest[d])
        ties = int(((ma >= 0) & (mp >= 0)).sum())
    log(f"  walk comparison: {len(diff)} differ, {ties} of them edge ties")
    check("accel walk = plain walk", len(diff) == ties,
          f"({len(diff) - ties} disagree beyond edge ties)")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_dp(mesh_arrays, num_ptcls: int, steps: int = STEPS,
             plain_walk_iters: int = 4096) -> dict:
    import jax

    from pumipic_jax.mesh.core import Mesh2D
    from pumipic_jax.models.pseudo_xgcm import (
        build_gyro_mappings, make_dp_setup, resolve_dp_locate,
    )
    from pumipic_jax.ops import scatter as scatter_ops
    from pumipic_jax.ops import search as search_ops
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    coords, tris, cls = mesh_arrays
    t0 = time.perf_counter()
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    cfg = xgcm_config(cls, num_ptcls)
    state, step = make_dp_setup(mesh, cfg, make_device_mesh(1))
    jax.block_until_ready(state)
    n = int(state["active"].sum())
    log(f"  setup {time.perf_counter() - t0:.1f} s: {mesh.nelems} elements, "
        f"{mesh.nverts} vertices, {n} particles")
    log("  locate: " + resolve_dp_locate(mesh, cfg, n).describe())

    t0 = time.perf_counter()
    compiled = step.lower(state).compile()
    compile_s = time.perf_counter() - t0
    log(f"  compile {compile_s:.1f} s")
    log("  " + describe_memory(compiled))

    ev = np.asarray(mesh.elem2verts)
    cz = np.asarray(mesh.coords, np.float64)
    s0 = {k: _host(v) for k, v in state.items()}
    state, f = compiled(state)
    jax.block_until_ready(state)
    s1 = {k: _host(v) for k, v in state.items()}

    # step 0: the step's accelerated walk against a plain walk over the
    # same segments
    dest1 = np.stack([s1["x0"], s1["x1"]], axis=1)
    plain = jax.jit(lambda o0, o1, d0, d1, e, a: search_ops.search_mesh_2d(
        mesh, (o0, o1), (d0, d1), e, a, plain_walk_iters).elem_ids)(
        s0["x0"], s0["x1"], s1["x0"], s1["x1"], s0["elem"], s0["active"])
    check_walks_agree(cz, ev, s1["elem"], _host(plain), dest1)

    t0 = time.perf_counter()
    for _ in range(steps):
        state, f = compiled(state)
    jax.block_until_ready((state, f))
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = peak_bytes()
    log(f"  {ms:.3f} ms/step over {steps} steps, peak_bytes_in_use {peak}")

    s = {k: _host(v) for k, v in state.items()}
    elem, active = s["elem"], s["active"].astype(bool)
    pts = np.stack([s["x0"], s["x1"]], axis=1)
    check_containment(cz, ev, elem, active, pts)
    check_deaths(cz, ev, s0["active"].astype(bool), active, pts)
    gyro_fwd, gyro_bwd = build_gyro_mappings(mesh, cfg.gyro)
    ring_dev = _host(jax.jit(lambda e, a: scatter_ops.accumulate_to_rings(
        e, a, mesh.elem2verts, mesh.nverts, cfg.gyro.num_rings,
        cfg.gyro.rmax))(state["elem"], state["active"]))
    counts_dev = _host(jax.jit(lambda e, a: scatter_ops.particles_per_element(
        e, a, mesh.nelems))(state["elem"], state["active"]))
    check_deposition(elem, active, ev, mesh.nverts, cfg.gyro,
                     _host(gyro_fwd), {"fwd": _host(f["fwd"])},
                     ring_dev=ring_dev, elem_counts_dev=counts_dev)
    check_deposition(elem, active, ev, mesh.nverts, cfg.gyro,
                     _host(gyro_bwd), {"bwd": _host(f["bwd"])})
    return {"ms_per_step": ms, "peak_bytes": peak, "compile_s": compile_s,
            "alive": int(active.sum())}


def _picparts_local(pp, r):
    """Rank r's local (coords, elem2verts, nverts) with padding removed."""
    nv = int((np.asarray(pp.vert_gid[r]) >= 0).sum())
    ne = int((np.asarray(pp.elem_gid[r]) >= 0).sum())
    cz = np.asarray(pp.mesh.coords[r], np.float64)[:nv]
    ev = np.asarray(pp.mesh.elem2verts[r])[:ne]
    return cz, ev, nv


def run_picparts(mesh_arrays, cfg, device_mesh, steps: int, **kw):
    """Build and step picparts; returns (pp, state, gyro_map, fwd, totals)."""
    import jax

    from pumipic_jax.models.pseudo_xgcm import make_picparts_setup

    coords, tris, cls = mesh_arrays
    t0 = time.perf_counter()
    pp, state, gyro_map, pstep = make_picparts_setup(
        coords, tris, cls, cfg, device_mesh, use_lb=True, **kw)
    jax.block_until_ready(state)
    log(f"  setup {time.perf_counter() - t0:.1f} s, "
        f"{state['active'].shape[1]} slots per rank")
    t0 = time.perf_counter()
    state, fwd, stats = pstep(state)
    jax.block_until_ready(fwd)
    log(f"  first step (compile) {time.perf_counter() - t0:.1f} s")
    totals = {k: int(_host(stats[k])) for k in
              ("overflow", "unresolved", "illegal_dest", "sent")}
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, fwd, stats = pstep(state)
        for k in ("unresolved", "illegal_dest", "sent"):
            totals[k] += int(_host(stats[k]))
        totals["overflow"] = max(totals["overflow"],
                                 int(_host(stats["overflow"])))
    jax.block_until_ready(fwd)
    if steps > 1:
        log(f"  {(time.perf_counter() - t0) / (steps - 1) * 1e3:.3f} "
            f"ms/step (with host reads of the stats)")
    totals["alive"] = int(_host(stats["alive"]))
    log(f"  stats over {steps} steps: {totals}")
    for k in ("overflow", "unresolved", "illegal_dest"):
        check(f"picparts {k} = 0", totals[k] == 0, f"({totals[k]})")
    return pp, state, _host(gyro_map), _host(fwd), totals


def phase_picparts_r1(mesh_arrays, num_ptcls: int, steps: int = STEPS):
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    cfg = xgcm_config(mesh_arrays[2], num_ptcls)
    pp, state, gmap, fwd, totals = run_picparts(
        mesh_arrays, cfg, make_device_mesh(1), steps, cap_factor=1.05)
    cz, ev, nv = _picparts_local(pp, 0)
    elem = _host(state["elem"])[0]
    active = _host(state["active"])[0].astype(bool)
    pts = np.stack([_host(state["x0"])[0], _host(state["x1"])[0]], axis=1)
    check_containment(cz, ev, elem, active, pts)
    check("alive count = active slots", totals["alive"] == int(active.sum()))
    V = pp.mesh.coords.shape[1]
    gmap_r = gmap[0].reshape(V, -1)[:nv].reshape(-1)
    check_deposition(elem, active, ev, nv, cfg.gyro, gmap_r,
                     {"fwd": fwd[0][:nv]})
    return totals


def phase_pps3d(num_ptcls: int, n_side: int = 16, steps: int = STEPS):
    import jax

    from pumipic_jax.mesh.core import Mesh3D
    from pumipic_jax.mesh.generate import box_tet_mesh
    from pumipic_jax.models.pseudo_push_and_search import (
        PseudoPushAndSearch, PushSearchConfig,
    )
    from pumipic_jax.reference import containment_margin

    coords, tets = box_tet_mesh(n_side, n_side, n_side)
    mesh = Mesh3D.from_arrays(coords, tets)
    cfg = PushSearchConfig(num_ptcls=num_ptcls, structure="dps",
                           wall="periodic", distance=0.05,
                           max_search_iters=64, rebuild_mode="sort",
                           kuhn="off")
    app = PseudoPushAndSearch(mesh, cfg)
    ptcls = app.ptcls
    t0 = time.perf_counter()
    ptcls, iters = app._step(ptcls)
    jax.block_until_ready(ptcls)
    log(f"  {mesh.nelems} tets; first step (compile) "
        f"{time.perf_counter() - t0:.1f} s, walk iters {int(iters)}")
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        ptcls, iters = app._step(ptcls)
    jax.block_until_ready(ptcls)
    if steps > 1:
        log(f"  {(time.perf_counter() - t0) / (steps - 1) * 1e3:.3f} "
            f"ms/step, walk iters {int(iters)}")
    active = _host(ptcls.active).astype(bool)
    check("periodic wall keeps every particle",
          int(active.sum()) == num_ptcls, f"({int(active.sum())})")
    check("walk within its iteration limit",
          int(iters) < cfg.max_search_iters, f"({int(iters)})")
    idx = np.flatnonzero(active)
    margin = containment_margin(
        np.asarray(mesh.coords, np.float64), np.asarray(mesh.elem2verts),
        _host(ptcls.elem)[idx], _host(ptcls.get("x"))[idx])
    check("tet containment", int((margin < 0).sum()) == 0,
          f"(worst margin {margin.min():.3e})")


def phase_structures(num_ptcls: int, num_elems: int = 1000,
                     hist_rows: int = 12_000_000):
    """Construction, churn rebuild and migrate conservation for all four
    layouts at size, the in-place reshuffle and its fallback, and the
    histogram past 2^24 keys."""
    import jax
    import jax.numpy as jnp

    from pumipic_jax.ops.scatter import count_per_key
    from pumipic_jax.particles import (
        CSR, DPS, CabM, SCSInput, SellCSigma, distribute,
    )

    NE, NP = num_elems, num_ptcls
    _, elems = distribute.distribute_particles(NE, NP, "uniform", seed=11)
    spec = {"pos": ((3,), jnp.float32), "pid": ((), jnp.int32)}
    builders = {
        "scs": lambda: SellCSigma(NE, elems, field_spec=spec,
                                  scs_input=SCSInput(chunk_size=32)),
        "csr": lambda: CSR(NE, elems, field_spec=spec),
        "cabm": lambda: CabM(NE, elems, field_spec=spec),
        "dps": lambda: DPS(NE, elems, field_spec=spec),
    }

    def with_pids(ps):
        pid = jnp.arange(ps.capacity, dtype=jnp.int32)
        ps = dataclasses.replace(ps, fields={**ps.fields, "pid": pid})
        act = _host(ps.active).astype(bool)
        return ps, act, int(_host(pid)[act].astype(np.int64).sum())

    def conserved(ps, n, pid_sum, what):
        act = _host(ps.active).astype(bool)
        pid = _host(ps.fields["pid"])
        check(f"{what} conserves actives", int(act.sum()) == n,
              f"({int(act.sum())}/{n})")
        check(f"{what} conserves pid multiset",
              int(pid[act].astype(np.int64).sum()) == pid_sum)
        return act, pid

    @jax.jit
    def two_churns(p):
        p = p.rebuild(jnp.where(p.active, (p.elem + 1) % NE, -1))
        return p.rebuild(jnp.where(p.active, (p.elem + 7) % NE, -1))

    for name, build in builders.items():
        log(f"  {name}:")
        ps = build()
        act = _host(ps.active)
        check("construction places all", int(act.sum()) == NP,
              f"({int(act.sum())}/{NP})")
        ps, act, pid_sum = with_pids(ps)
        conserved(two_churns(ps), NP, pid_sum, "rebuild")
        leave = (jnp.arange(ps.capacity) % 8) == 3
        ps3 = ps.migrate(ps.elem, jnp.where(leave, 1, 0), my_rank=0)
        keep = int((act & ~_host(leave)).sum())
        n3 = int(_host(ps3.active).sum())
        check("migrate removes exactly the leavers", n3 == keep,
              f"({n3}/{keep})")

    # in-place reshuffle at size: a count-preserving swap churn (always
    # fits), then a global shift (never fits: falls back to the sort path)
    for name in ("scs", "cabm"):
        log(f"  {name} reshuffle:")
        ps = (SellCSigma(NE, elems, field_spec=spec,
                         scs_input=SCSInput(chunk_size=32,
                                            extra_padding=0.15))
              if name == "scs" else CabM(NE, elems, field_spec=spec))
        ps, act, pid_sum = with_pids(ps)
        cur = np.where(act, _host(ps.elem), -1)
        new_elem = cur.copy()
        rng = np.random.default_rng(5)
        live = np.flatnonzero(cur >= 0)
        k = (len(live) // 10) // 2 * 2
        sel = rng.choice(live, size=k, replace=False)
        a, b = sel[: k // 2], sel[k // 2:]
        new_elem[a], new_elem[b] = cur[b], cur[a]
        pid0 = _host(ps.fields["pid"])
        ps1 = jax.jit(lambda p, ne: p.rebuild(ne, mode="auto"))(
            ps, jnp.asarray(new_elem))
        act1, pid1 = conserved(ps1, NP, pid_sum, "reshuffle")
        stay = act & (new_elem == cur) & (new_elem >= 0)
        check("reshuffle branch ran (stayers kept slots)",
              bool(np.array_equal(pid1[stay], pid0[stay]))
              and bool(act1[stay].all()))
        ps2 = jax.jit(lambda p: p.rebuild(
            jnp.where(p.active, (p.elem + 7) % NE, -1), mode="auto"))(ps1)
        conserved(ps2, NP, pid_sum, "fallback")
        check("no overflow", not bool(_host(ps2.overflowed)))

    key = np.concatenate([np.full(hist_rows, NE, np.int64), elems])
    got = _host(jax.jit(lambda k: count_per_key(k, NE))(
        jnp.asarray(key, jnp.int32)))
    want = np.bincount(key, minlength=NE + 1)[:NE]
    check("histogram exact past 2^24 keys",
          np.array_equal(got.astype(np.int64), want),
          f"(keys={len(key)})")


PUSH_STATE = ("x0", "x1", "cphi", "sphi")


def picparts_by_pid(pp, pstate, n: int):
    """picparts state gathered from every card into the global seed order
    (its ``pid``): global element id (-1 where inactive) and push state.
    Also returns how many active slots there were."""
    eg = np.asarray(pp.elem_gid)
    h = {k: _host(pstate[k]) for k in ("active", "pid", "elem") + PUSH_STATE}
    out = {"elem": np.full(n, -1, np.int64)}
    out.update({k: np.zeros(n, np.float32) for k in PUSH_STATE})
    slots = 0
    for r in range(eg.shape[0]):
        a = h["active"][r].astype(bool)
        pid = h["pid"][r][a]
        slots += len(pid)
        out["elem"][pid] = eg[r][h["elem"][r][a]]
        for k in PUSH_STATE:
            out[k][pid] = h[k][r][a]
    return out, slots


def dp_by_pid(dstate, n: int):
    """dp state (already in the global seed order) without its padding."""
    a = _host(dstate["active"])[:n].astype(bool)
    out = {"elem": np.where(a, _host(dstate["elem"])[:n], -1).astype(np.int64)}
    out.update({k: _host(dstate[k])[:n] for k in PUSH_STATE})
    return out


def compare_particles(p, d, coords, cells, cls, class_tied) -> dict:
    """One step of picparts against dp, particle by particle.

    Both setups seed identical state and push with identical arithmetic,
    so a particle's push state can differ between them only after it sat
    on an edge between two elements of different classes: the two
    locators may resolve such an edge tie to either element, and the next
    push then rotates by the other class's angle.  ``class_tied`` marks
    the particles that sat on such a tie at an earlier step; it is updated
    in place."""
    from pumipic_jax.reference import containment_margin

    pa, da = p["elem"] >= 0, d["elem"] >= 0
    check("no particle alive in one path only", bool((pa == da).all()),
          f"({int((pa != da).sum())})")
    same = np.ones(len(pa), bool)
    for k in PUSH_STATE:
        same &= p[k] == d[k]
    tie = pa & same & (p["elem"] != d["elem"])
    div = pa & ~same
    for name, m in (("edge-tie", tie), ("diverged", div)):
        i = np.flatnonzero(m)
        for path in (p, d):
            pts = np.stack([path["x0"][i], path["x1"][i]], axis=1)
            bad = int((containment_margin(coords, cells, path["elem"][i],
                                          pts) < 0).sum())
            check(f"each {name} particle lies in its own element", bad == 0,
                  f"({bad} of {len(i)})")
    unexplained = int((div & ~class_tied).sum())
    check("push state differs only after a tie between classes",
          unexplained == 0, f"({int(div.sum())} differ, {unexplained} "
          f"without an earlier tie between classes)")
    ctie = tie & (cls[np.maximum(p["elem"], 0)]
                  != cls[np.maximum(d["elem"], 0)])
    class_tied |= ctie
    return {"ties": int(tie.sum()), "class_ties": int(ctie.sum()),
            "diverged": int(div.sum())}


def phase_four_cards(mesh_arrays, ptcls_per_card: int, steps: int = STEPS,
                     cards: int = 4) -> dict:
    """picparts at R=cards against dp over the same cards and seeds,
    compared particle by particle after every step."""
    import jax

    from pumipic_jax.mesh.core import Mesh2D
    from pumipic_jax.models.pseudo_xgcm import (
        build_gyro_mappings, make_dp_setup, make_picparts_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh
    from pumipic_jax.parallel.picparts import BufferMethod, PicPartsInput
    from pumipic_jax.reference import literal_deposition

    R = cards
    dm = make_device_mesh(R)
    coords, tris, cls = mesh_arrays
    cfg = xgcm_config(cls, ptcls_per_card * R)
    gyro = cfg.gyro

    # Full buffers: at 15 degrees per push a particle crosses more elements
    # in one step than the default 3 BFS layers hold, so under BFS buffers
    # a particle near a part boundary leaves its picpart and is removed by
    # safe-zone semantics, which dp has no counterpart for.  With the whole
    # mesh in every picpart the two paths must agree particle for
    # particle, and migration still moves every particle that leaves its
    # owner's safe zone.
    t0 = time.perf_counter()
    pp, pstate, gmap, pstep = make_picparts_setup(
        coords, tris, cls, cfg, dm, use_lb=True,
        inp=PicPartsInput(buffer_method=BufferMethod.FULL))
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    dstate, dstep = make_dp_setup(mesh, cfg, dm)
    jax.block_until_ready((pstate, dstate))
    n = int(_host(pstate["active"]).sum())
    log(f"  setup of both paths {time.perf_counter() - t0:.1f} s: "
        f"{n} particles, {pstate['active'].shape[1]} picparts slots per "
        f"card")
    cz = np.asarray(mesh.coords, np.float64)
    ev = np.asarray(mesh.elem2verts)
    cls_h = np.asarray(mesh.class_id)

    p, slots = picparts_by_pid(pp, pstate, n)
    d = dp_by_pid(dstate, n)
    check("both setups seed identical state",
          all(np.array_equal(p[k], d[k]) for k in ("elem",) + PUSH_STATE))

    class_tied = np.zeros(n, bool)
    totals = {"overflow": 0, "unresolved": 0, "illegal_dest": 0, "sent": 0}
    times = {"picparts": [], "dp": []}
    for i in range(steps):
        t0 = time.perf_counter()
        pstate, pfwd, stats = pstep(pstate)
        jax.block_until_ready(pfwd)
        times["picparts"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dstate, dfields = dstep(dstate)
        jax.block_until_ready(dfields)
        times["dp"].append(time.perf_counter() - t0)
        for k in ("unresolved", "illegal_dest", "sent"):
            totals[k] += int(_host(stats[k]))
        totals["overflow"] = max(totals["overflow"],
                                 int(_host(stats["overflow"])))
        p, slots = picparts_by_pid(pp, pstate, n)
        d = dp_by_pid(dstate, n)
        c = compare_particles(p, d, cz, ev, cls_h, class_tied)
        log(f"  step {i}: sent {int(_host(stats['sent']))}, alive "
            f"{int(_host(stats['alive']))}; {c}")
    for k, ts in times.items():
        log(f"  {k}: first step (compile) {ts[0]:.1f} s, then "
            f"{np.mean(ts[1:]) * 1e3 if len(ts) > 1 else float('nan'):.3f} "
            f"ms/step")
    log(f"  stats over {steps} steps: {totals}")
    for k in ("overflow", "unresolved", "illegal_dest"):
        check(f"picparts {k} = 0", totals[k] == 0, f"({totals[k]})")
    check("migration crossed cards", R == 1 or totals["sent"] > 0,
          f"(sent {totals['sent']})")
    p_alive = int(_host(stats["alive"]))
    d_alive = int((d["elem"] >= 0).sum())
    check("each particle on one card", slots == p_alive
          and int((p["elem"] >= 0).sum()) == p_alive)
    check(f"alive equal: picparts R={R} vs dp", p_alive == d_alive,
          f"({p_alive} vs {d_alive})")
    check("particles on paths that differ <= ties between classes",
          c["diverged"] <= int(class_tied.sum()),
          f"({c['diverged']} vs {int(class_tied.sum())})")

    # fields: every copy of a global vertex holds the synced value, each
    # path's field is the literal deposition of its own particles, so the
    # difference between the paths is what their differing particles (and
    # ring maps) deposit
    pf = _host(pfwd)
    vg = np.asarray(pp.vert_gid)
    V = mesh.nverts
    lo = np.full(V, np.inf)
    hi = np.full(V, -np.inf)
    for r in range(R):
        ok = vg[r] >= 0
        np.minimum.at(lo, vg[r][ok], pf[r][ok])
        np.maximum.at(hi, vg[r][ok], pf[r][ok])
    scale = max(float(np.abs(hi).max()), 1.0)
    spread = float((hi - lo).max()) / scale
    check("every copy of a vertex holds the synced value",
          spread <= FIELD_RTOL, f"(max rel spread {spread:.2e})")

    gmap_g = _host(build_gyro_mappings(mesh, gyro)[0])
    _, lit_d = literal_deposition(
        d["elem"], d["elem"] >= 0, ev, V, gyro.num_rings, gyro.rmax,
        gmap_g, gyro.points_per_ring)
    gm = _host(gmap)
    elem_h, act_h = _host(pstate["elem"]), _host(pstate["active"])
    Vp = pp.mesh.coords.shape[1]
    rpp = gyro.num_rings * gyro.points_per_ring
    glob_rows = np.sort(gmap_g.reshape(V, rpp, 3), axis=2)
    lit_p = np.zeros(V)
    map_rows_differ = 0
    for r in range(R):
        _, ev_r, nv = _picparts_local(pp, r)
        gm_r = gm[r].reshape(Vp, rpp, 3)[:nv]
        _, f = literal_deposition(
            elem_h[r], act_h[r].astype(bool), ev_r, nv, gyro.num_rings,
            gyro.rmax, gm_r.reshape(-1), gyro.points_per_ring)
        np.add.at(lit_p, vg[r][:nv], f)
        in_glob = np.sort(np.where(gm_r >= 0, vg[r][np.maximum(gm_r, 0)],
                                   -1), axis=2)
        map_rows_differ += int((in_glob != glob_rows[vg[r][:nv]])
                               .any(axis=2).sum())
    dfwd = _host(dfields["fwd"]).astype(np.float64)[:V]
    err_d = float(np.abs(dfwd - lit_d).max()) / scale
    err_p = float(np.abs(hi - lit_p).max()) / scale
    check("dp fwd = literal deposition of its particles",
          err_d <= FIELD_RTOL, f"(max rel err {err_d:.2e}, tol {FIELD_RTOL:g})")
    check("picparts fwd = literal deposition of its particles "
          "through each card's ring map", err_p <= FIELD_RTOL,
          f"(max rel err {err_p:.2e}, tol {FIELD_RTOL:g})")
    raw = np.abs(hi - dfwd)
    unexplained = float(np.abs((hi - dfwd) - (lit_p - lit_d)).max()) / scale
    check(f"per-vertex fwd: picparts R={R} - dp = the deposition of their "
          f"differences", unexplained <= 2 * FIELD_RTOL,
          f"(max rel {unexplained:.2e}, tol {2 * FIELD_RTOL:g}; raw max abs "
          f"diff {float(raw.max()):.3g} on {int((raw > FIELD_RTOL * scale).sum())}"
          f" vertices; {map_rows_differ} ring-map rows differ from the "
          f"global map)")
    return {"alive": d_alive, "sent": totals["sent"],
            "raw_fwd_max_abs": float(raw.max()),
            "map_rows_differ": map_rows_differ,
            "class_tied": int(class_tied.sum()), **c}


# ---------------------------------------------------------------------------

def run(phases) -> bool:
    """Run (name, fn) phases in order; every phase runs, failures count."""
    failed = []
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
        log(f"== {name}: {'FAILED' if name in failed else 'ok'} "
            f"({time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"failed phases: {', '.join(failed)}")
    return not failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only picparts R=4 against dp on four GPUs")
    ap.add_argument("--particles", type=int, default=10_000_000,
                    help="particles (per card with --four-cards)")
    args = ap.parse_args(argv)

    import jax

    need = 4 if args.four_cards else 1
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2

    from pumipic_jax.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache(ROOT)}")
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
    log(gpu_name_and_power())

    mesh_arrays = load_mesh()
    n = args.particles
    if args.four_cards:
        phases = [("four cards: picparts R=4 vs dp",
                   lambda: phase_four_cards(mesh_arrays, n))]
    else:
        phases = [
            ("dp 120k", lambda: phase_dp(mesh_arrays, n)),
            ("picparts R=1 120k", lambda: phase_picparts_r1(mesh_arrays, n)),
            ("pps3d walk", lambda: phase_pps3d(n)),
            ("structures", lambda: phase_structures(n)),
        ]
    if not run(phases):
        return 1
    log(gpu_name_and_power())           # name, power limit: one line per card
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
