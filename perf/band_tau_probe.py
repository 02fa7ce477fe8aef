"""Hit-rate check for the transcendental-free band cell design (round 5):
theta-bin replaced by the diamond-angle tau-bin (pure arithmetic), at T in
{1024, 1536, 2048}.  Bench-like
test distribution (class <= mdl_face), production-density calibration.

  JAX_PLATFORMS=cpu python perf/band_tau_probe.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from pumipic_jax.mesh.gmsh import read_msh
from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.mesh.locator import detect_banded_locator

MESH = os.environ.get("BP_MESH", "data/xgc_like_120k.msh.gz")
N_TEST = 200_000

coords, tris, cls = read_msh(MESH)
mesh = Mesh2D.from_arrays(coords, tris, cls)
coords = np.asarray(coords, np.float64)
tris = np.asarray(tris, np.int64)
cls = np.asarray(cls)
E = len(tris)
bg = detect_banded_locator(coords, tris, cls, mesh.walk_geom)
K = bg.n_bands
coef_u = np.asarray(bg.coef_u, np.float64)
coef_v = np.asarray(bg.coef_v, np.float64)
inv_coef = np.asarray(bg.inv_coef, np.float64)
cx, cy = float(bg.cx), float(bg.cy)
J, P, rk = bg.n_harm, bg.n_cheb, bg.rank


def band_of(px, py):
    x = px - cx
    y = py - cy
    r = np.hypot(x, y)
    inv_r = 1.0 / np.maximum(r, 1e-30)
    c1 = x * inv_r
    s1 = y * inv_r
    t = [np.full(r.shape, coef_v[k, 0]) for k in range(rk)]
    cj, sj = c1.copy(), s1.copy()
    for j in range(J):
        for k in range(rk):
            t[k] = t[k] + coef_v[k, 1 + j] * cj
            t[k] = t[k] + coef_v[k, 1 + J + j] * sj
        if j + 1 < J:
            cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
    q = [sum(coef_u[p, k] * t[k] for k in range(rk)) for p in range(P + 1)]
    u = np.full(r.shape, inv_coef[-1])
    for p in range(len(inv_coef) - 2, -1, -1):
        u = u * r + inv_coef[p]
    u = np.clip(u, -1.05, 1.05)
    for _ in range(3):
        bk1 = np.zeros_like(u)
        bk2 = np.zeros_like(u)
        dk1 = np.zeros_like(u)
        dk2 = np.zeros_like(u)
        for p in range(P, 0, -1):
            dk1, dk2 = 2.0 * bk1 + 2.0 * u * dk1 - dk2, dk1
            bk1, bk2 = q[p] + 2.0 * u * bk1 - bk2, bk1
        val = q[0] + u * bk1 - bk2
        dv = bk1 + u * dk1 - dk2
        u = np.clip(u - (val - r) / np.maximum(dv, 1e-6), -1.05, 1.05)
    return np.clip(np.floor((u + 1.0) * (0.5 * K)), 0, K - 1).astype(np.int64)


def tau_of(px, py):
    x = px - cx
    y = py - cy
    d = y / np.maximum(np.abs(x) + np.abs(y), 1e-30)
    return np.where(x >= 0, np.where(y >= 0, d, 4.0 + d), 2.0 - d)


def theta_of(px, py):
    return np.mod(np.arctan2(py - cy, px - cx), 2 * np.pi)


def topk(cell, elem, n_cells, fb, kk):
    order = np.lexsort((elem, cell))
    cs, es = cell[order], elem[order]
    new = np.ones(len(cs), bool)
    new[1:] = (cs[1:] != cs[:-1]) | (es[1:] != es[:-1])
    starts = np.nonzero(new)[0]
    counts = np.diff(np.append(starts, len(cs)))
    o2 = np.lexsort((-counts, cs[starts]))
    uc, ue = cs[starts][o2], es[starts][o2]
    first = np.ones(len(uc), bool)
    first[1:] = uc[1:] != uc[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(uc)), 0))
    rank = np.arange(len(uc)) - run_start
    outs, prev = [], fb.copy()
    for j in range(kk):
        cur = prev.copy()
        sel = rank == j
        cur[uc[sel]] = ue[sel]
        outs.append(cur)
        prev = cur
    return outs


rng = np.random.default_rng(7)
mdl = max(K // 2, 2)
marked = np.nonzero(cls <= mdl)[0]
te_b = marked[rng.integers(0, len(marked), N_TEST)]
w = rng.dirichlet((1.0, 1.0, 1.0), N_TEST)
pts_b = (coords[tris[te_b]] * w[:, :, None]).sum(1)
cent = coords[tris].mean(axis=1)

band_b = band_of(pts_b[:, 0], pts_b[:, 1])
band_cent = band_of(cent[:, 0], cent[:, 1])

for ang_name, ang in (("tau", tau_of), ("theta", theta_of)):
    span = 4.0 if ang_name == "tau" else 2 * np.pi
    a_b = ang(pts_b[:, 0], pts_b[:, 1])
    a_cent = ang(cent[:, 0], cent[:, 1])
    for T in (1024, 1536, 2048):
        n_cells = K * T
        cal_per_elem = max(int(16 * n_cells / E), 8)
        te_cal = np.repeat(np.arange(E), cal_per_elem)
        w_c = np.random.default_rng(13).dirichlet((1.0, 1.0, 1.0),
                                                  len(te_cal))
        pts_cal = (coords[tris[te_cal]] * w_c[:, :, None]).sum(1)
        band_cal = band_of(pts_cal[:, 0], pts_cal[:, 1])
        a_cal = ang(pts_cal[:, 0], pts_cal[:, 1])

        def cell(band, a):
            tb = np.clip((a / span * T).astype(np.int64), 0, T - 1)
            return band * T + tb

        fb = np.zeros(n_cells, np.int64)
        fb[cell(band_cent, a_cent)] = np.arange(E)
        ks = topk(cell(band_cal, a_cal), te_cal, n_cells, fb, 4)
        ct = cell(band_b, a_b)
        cum = np.zeros(N_TEST, bool)
        msg = []
        for j, kj in enumerate(ks):
            cum |= te_b == kj[ct]
            msg.append(f"{'ABCD'[j]}:{cum.mean() * 100:6.2f}%")
        mb = n_cells * 14 * 4 / 1e6
        print(f"{ang_name:5s} T={T:5d} cells={n_cells:7d} "
              f"({mb:5.1f} MB @14col)  " + " ".join(msg), flush=True)
