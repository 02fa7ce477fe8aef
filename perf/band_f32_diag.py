"""Host diagnosis of the round-5 band-locator device hit-rate collapse
(81.3% device A|B vs 94.3% host mirror):

Hypothesis: the rows are calibrated with the f64 host mirror while the
device assigns cells in f32 — systematic f32 drift (ill-conditioned
raw-power Horner seed, f32 harmonic accumulation) moves particles across
cell boundaries relative to calibration.  If calibrating WITH the same
f32 arithmetic recovers the hit rate, the fix is device-consistent
calibration, not more precision.

  JAX_PLATFORMS=cpu python perf/band_f32_diag.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.mesh.gmsh import read_msh
from pumipic_jax.mesh.locator import detect_banded_locator, _top2_per_cell

MESH = os.environ.get("BD_MESH", "data/xgc_like_120k.msh.gz")

coords, tris, cls = read_msh(MESH)
mesh = Mesh2D.from_arrays(coords, tris, cls)
bg = detect_banded_locator(np.asarray(coords), np.asarray(tris),
                           np.asarray(cls), mesh.walk_geom)
K, T, J, P, rk = bg.n_bands, bg.n_theta, bg.n_harm, bg.n_cheb, bg.rank
print(f"K={K} T={T} J={J} P={P} rank={rk}")

coef_u = np.asarray(bg.coef_u)          # f32 (P+1, rank)
coef_v = np.asarray(bg.coef_v)          # f32 (rank, 2J+1)
inv_coef = np.asarray(bg.inv_coef)      # f32
cx, cy = float(bg.cx), float(bg.cy)


def cell_of_np(px, py, dtype):
    """numpy mirror of BandGrid2D.cell_of at the given dtype."""
    x = (px - dtype(cx)).astype(dtype)
    y = (py - dtype(cy)).astype(dtype)
    r = np.sqrt(x * x + y * y)
    th = np.arctan2(y, x).astype(dtype)
    c1, s1 = np.cos(th).astype(dtype), np.sin(th).astype(dtype)
    cu = coef_u.astype(dtype)
    cv = coef_v.astype(dtype)
    ic = inv_coef.astype(dtype)
    t = [np.full(r.shape, cv[k, 0], dtype) for k in range(rk)]
    cj, sj = c1.copy(), s1.copy()
    for j in range(J):
        for k in range(rk):
            t[k] = t[k] + cv[k, 1 + j] * cj
            t[k] = t[k] + cv[k, 1 + J + j] * sj
        if j + 1 < J:
            cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
    q = [sum(cu[p, k] * t[k] for k in range(rk)) for p in range(P + 1)]

    def radius_and_slope(u):
        bk1 = np.zeros_like(u)
        bk2 = np.zeros_like(u)
        dk1 = np.zeros_like(u)
        dk2 = np.zeros_like(u)
        for p in range(P, 0, -1):
            dk1, dk2 = 2.0 * bk1 + 2.0 * u * dk1 - dk2, dk1
            bk1, bk2 = q[p] + 2.0 * u * bk1 - bk2, bk1
        return q[0] + u * bk1 - bk2, bk1 + u * dk1 - dk2

    u = np.full(r.shape, ic[-1], dtype)
    for p in range(len(ic) - 2, -1, -1):
        u = u * r + ic[p]
    u = np.clip(u, dtype(-1.05), dtype(1.05))
    for _ in range(3):
        val, dv = radius_and_slope(u)
        u = u - (val - r) / np.maximum(dv, dtype(1e-6))
        u = np.clip(u, dtype(-1.05), dtype(1.05))
    bstar = (u + dtype(1.0)) * dtype(0.5 * K)
    bf = np.clip(np.floor(bstar), 0, K - 1)
    thn = np.where(th < 0, th + dtype(2 * np.pi), th)
    tf = np.clip(np.floor(thn * dtype(T / (2 * np.pi))), 0, T - 1)
    return (bf * T + tf).astype(np.int64), u


coords64 = np.asarray(coords, np.float64)
tris64 = np.asarray(tris, np.int64)
E = len(tris64)
rng = np.random.default_rng(7)
M = 2_000_000
te = rng.integers(0, E, M)
w = rng.dirichlet((1.0, 1.0, 1.0), M)
pts = (coords64[tris64[te]] * w[:, :, None]).sum(1)
px32 = pts[:, 0].astype(np.float32)
py32 = pts[:, 1].astype(np.float32)

c64, u64 = cell_of_np(pts[:, 0], pts[:, 1], np.float64)
c32, u32 = cell_of_np(px32, py32, np.float32)
agree = (c64 == c32).mean()
du = np.abs(u64 - u32.astype(np.float64))
print(f"cell agreement f64 vs f32: {agree:.4f}")
print(f"|u64-u32|: mean {du.mean():.3e} p99 {np.quantile(du, 0.99):.3e} "
      f"max {du.max():.3e}  (band width in u = {2.0 / K:.3e})")

# hit rates against the SHIPPED rows (f64-calibrated)
rows = np.asarray(bg.cell_rows)
for name, c in (("f64-cal rows, f64 assign", c64),
                ("f64-cal rows, f32 assign", c32)):
    a = rows[c, 6].astype(np.int64)
    b = rows[c, 13].astype(np.int64)
    print(f"{name}: A {np.mean(a == te):.4f}  "
          f"A|B {np.mean((a == te) | (b == te)):.4f}")

# recalibrate rows WITH f32 assignment (device-consistent) and remeasure
geom = np.asarray(mesh.walk_geom)
n_cells = K * T
cal_per_elem = max(int(16 * n_cells / E), 8)
te_c = np.repeat(np.arange(E, dtype=np.int64), cal_per_elem)
w_c = np.random.default_rng(1729).dirichlet((1.0, 1.0, 1.0), len(te_c))
pts_c = (coords64[tris64[te_c]] * w_c[:, :, None]).sum(1)
cell_c, _ = cell_of_np(pts_c[:, 0].astype(np.float32),
                       pts_c[:, 1].astype(np.float32), np.float32)
cent = coords64[tris64].mean(axis=1)
fb = np.zeros(n_cells, np.int64)
cc, _ = cell_of_np(cent[:, 0].astype(np.float32),
                   cent[:, 1].astype(np.float32), np.float32)
fb[cc] = np.arange(E)
a2, b2 = _top2_per_cell(cell_c, te_c, fb)
a = a2[c32]
b = b2[c32]
print(f"f32-cal rows, f32 assign: A {np.mean(a == te):.4f}  "
      f"A|B {np.mean((a == te) | (b == te)):.4f}")
