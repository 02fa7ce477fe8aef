"""Host-side probe for the round-5 ragged flux-band locator (VERDICT r4 #1).

Questions answered on the 120k tokamak workload (all on the host CPU):

1. How exactly can a fused-VPU-evaluable band coordinate psi(x, y) classify
   points into flux bands?  psi is fitted as a radial-polynomial x Fourier
   tensor model on the mesh's RING VERTICES (ring index j is an exact
   integer target at every vertex; rings are derived generically from the
   band-ordered classification).  Reports band-accuracy vs model capacity
   (DK radial degree, JF Fourier order) and vs flop cost per particle.

2. What do band-aligned locator cells buy?  Cells keyed by
   (band, uniform theta-bin) with sample-calibrated candidates, versus the
   production cartesian grid — candidate-rank coverage (A / A+B / +C / +D)
   at matched table bytes, for BOTH an oracle band assignment (upper
   bound) and the fitted-psi assignment (realizable).

3. Does simply widening the cartesian cells to 3-4 candidates close the
   gap without any band machinery? (the orthogonal fallback lever)

Run:
  JAX_PLATFORMS=cpu python perf/band_probe.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from pumipic_jax.mesh.gmsh import read_msh

MESH = os.environ.get("BP_MESH", "data/xgc_like_120k.msh.gz")
N_TEST = int(os.environ.get("BP_N", 200_000))
CAL_PER_ELEM = int(os.environ.get("BP_CAL", 8))
MDL_FACE_FRAC = 0.5     # bench: mdl_face = max_class // 2


def vertex_rings(coords, tris, cls):
    """Generic ring index per vertex from a band-ordered classification:
    a vertex incident to bands {j, j+1} lies on ring j (rings 0..K);
    single-band vertices are the domain boundaries (ring 0 for band 1,
    ring K for band K).  Returns (ring, K) or raises if not banded."""
    V = coords.shape[0]
    mn = np.full(V, 1 << 30, np.int64)
    mx = np.full(V, -1, np.int64)
    for k in range(3):
        np.minimum.at(mn, tris[:, k], cls)
        np.maximum.at(mx, tris[:, k], cls)
    K = int(cls.max())
    ring = np.where(mn < mx, mn, np.where(mn == 1, 0, K))
    two_band = mx - mn
    if (two_band > 1).any():
        raise ValueError("vertex incident to non-adjacent bands")
    solo = mn == mx
    if not np.all((mn[solo] == 1) | (mn[solo] == K)):
        raise ValueError("interior single-band vertex: not a stitched mesh")
    return ring.astype(np.int64), K


def _features(rn, th, DK, JF):
    """(n, (DK+1)(2JF+1)) tensor features rn^d x {1, cos jθ, sin jθ} —
    harmonics by recurrence, powers by cumulative product (the naive
    per-(d,j) trig loop is minutes of single-core time at 1M points)."""
    n = len(rn)
    ang = np.empty((n, 2 * JF + 1))
    ang[:, 0] = 1.0
    c1, s1 = np.cos(th), np.sin(th)
    cj, sj = c1.copy(), s1.copy()
    ang[:, 1], ang[:, 1 + JF] = cj, sj
    for j in range(1, JF):
        cn = cj * c1 - sj * s1
        sn = sj * c1 + cj * s1
        cj, sj = cn, sn
        ang[:, 1 + j], ang[:, 1 + JF + j] = cj, sj
    R = np.empty((n, DK + 1))
    R[:, 0] = 1.0
    for d in range(1, DK + 1):
        R[:, d] = R[:, d - 1] * rn
    return (R[:, :, None] * ang[:, None, :]).reshape(n, -1)


def fit_inverse(coords, ring, K, DK, JF, center):
    """Fit psi(rn, th) = sum_{d<=DK, |j|<=JF} c_{dj} rn^d {cos,sin}(j th)
    to psi(vertex) = ring index.  Returns (predict fn, train residual).
    Normal equations with a tiny ridge — the probe wants speed on one
    core, not SVD-grade conditioning."""
    dx = coords[:, 0] - center[0]
    dy = coords[:, 1] - center[1]
    r = np.hypot(dx, dy)
    th = np.arctan2(dy, dx)
    rs = r.max()

    A = _features(r / rs, th, DK, JF)
    y = ring.astype(np.float64)
    G = A.T @ A
    G[np.diag_indices_from(G)] += 1e-9 * np.trace(G) / G.shape[0]
    coef = np.linalg.solve(G, A.T @ y)
    resid = A @ coef - y

    def predict(pts):
        dx = pts[:, 0] - center[0]
        dy = pts[:, 1] - center[1]
        rq = np.hypot(dx, dy)
        tq = np.arctan2(dy, dx)
        out = np.empty(len(rq))
        for s in range(0, len(rq), 262144):           # bound the temp
            e = min(s + 262144, len(rq))
            out[s:e] = _features(rq[s:e] / rs, tq[s:e], DK, JF) @ coef
        return out

    return predict, resid


def topk_per_cell(cell, elem, n_cells, fallback, kk=4):
    """k most-frequent elements per cell (by calibration sample count)."""
    order = np.lexsort((elem, cell))
    cs, es = cell[order], elem[order]
    new = np.ones(len(cs), bool)
    new[1:] = (cs[1:] != cs[:-1]) | (es[1:] != es[:-1])
    starts = np.nonzero(new)[0]
    counts = np.diff(np.append(starts, len(cs)))
    ucell, uelem = cs[starts], es[starts]
    o2 = np.lexsort((-counts, ucell))
    uc, ue = ucell[o2], uelem[o2]
    first = np.ones(len(uc), bool)
    first[1:] = uc[1:] != uc[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(uc)), 0))
    rank = np.arange(len(uc)) - run_start
    outs = []
    prev = fallback.copy()
    for j in range(kk):
        cur = prev.copy()
        sel = rank == j
        cur[uc[sel]] = ue[sel]
        outs.append(cur)
        prev = cur
    return outs


def report(name, cands, cell_cal, cell_test, te_cal, te_test, n_cells,
           fallback, table_cols=None):
    ks = topk_per_cell(cell_cal, te_cal, n_cells, fallback, kk=cands)
    cum = np.zeros(len(te_test), bool)
    msg = []
    for j, kj in enumerate(ks):
        cum |= te_test == kj[cell_test]
        msg.append(f"{'ABCD'[j]}:{cum.mean() * 100:6.2f}%")
    cols = table_cols if table_cols is not None else 7 * cands
    mb = n_cells * cols * 4 / 1e6
    print(f"  {name:34s} cells={n_cells:8d} ({mb:6.1f} MB @{cols}col)  "
          + " ".join(msg), flush=True)
    return cum.mean()


def main():
    coords, tris, cls = read_msh(MESH)
    E = len(tris)
    ring, K = vertex_rings(coords, tris, cls)
    print(f"mesh: {E} elems, {K} bands, {len(coords)} verts ({MESH})",
          flush=True)
    center = coords.mean(axis=0)

    rng = np.random.default_rng(42)

    def sample_in(te):
        w = rng.dirichlet((1.0, 1.0, 1.0), len(te))
        return (coords[tris[te]] * w[:, :, None]).sum(axis=1)

    # calibration: element-stratified (covers every cell)
    te_cal = np.repeat(np.arange(E), CAL_PER_ELEM)
    pts_cal = sample_in(te_cal)
    # test set A: element-uniform over the whole domain
    te_dom = rng.integers(0, E, N_TEST)
    pts_dom = sample_in(te_dom)
    # test set B: bench-like (elements with class <= mdl_face, the seeding
    # distribution pseudoXGCm drives)
    mdl = max(K // 2, 2)
    marked = np.nonzero(cls <= mdl)[0]
    te_b = marked[rng.integers(0, len(marked), N_TEST)]
    pts_b = sample_in(te_b)

    # ---- 1. fitted band coordinate accuracy -----------------------------
    band_dom = cls[te_dom] - 1            # 0-based band of each test point
    band_b = cls[te_b] - 1
    band_cal = cls[te_cal] - 1
    fits = {}
    best_key = None
    for DK, JF in ((4, 4), (8, 16), (12, 24), (16, 32), (24, 48)):
        predict, resid = fit_inverse(coords, ring, K, DK, JF, center)
        psi_dom = predict(pts_dom)
        bd = np.clip(np.floor(psi_dom), 0, K - 1).astype(np.int64)
        acc_dom = (bd == band_dom).mean()
        off1 = (np.abs(bd - band_dom) <= 1).mean()
        psi_b = predict(pts_b)
        bb = np.clip(np.floor(psi_b), 0, K - 1).astype(np.int64)
        acc_b = (bb == band_b).mean()
        ncoef = (DK + 1) * (2 * JF + 1)
        print(f"fit DK={DK:2d} JF={JF:2d} ({ncoef:5d} coef): train-resid "
              f"max={np.abs(resid).max():.3f} rms={np.sqrt((resid**2).mean()):.4f} "
              f"| band acc dom={acc_dom * 100:6.2f}% (±1: {off1 * 100:6.2f}%) "
              f"bench={acc_b * 100:6.2f}%", flush=True)
        fits[(DK, JF)] = predict
        best_key = (DK, JF)

    # cached fitted-band assignments for the cell designs (one predict per
    # point set, not one per T)
    predict = fits[best_key]
    psi_cal_b = np.clip(np.floor(predict(pts_cal)), 0, K - 1).astype(np.int64)
    psi_dom_b = np.clip(np.floor(predict(pts_dom)), 0, K - 1).astype(np.int64)
    psi_bb_b = np.clip(np.floor(predict(pts_b)), 0, K - 1).astype(np.int64)

    # ---- 2/3. cell designs ----------------------------------------------
    dx = coords[:, 0] - center[0]
    dy = coords[:, 1] - center[1]
    cent = coords[tris].mean(axis=1)

    def theta(pts):
        return np.mod(np.arctan2(pts[:, 1] - center[1],
                                 pts[:, 0] - center[0]), 2 * np.pi)

    th_cal, th_dom, th_b = theta(pts_cal), theta(pts_dom), theta(pts_b)
    th_cent = theta(cent)

    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)

    def cart_cells(pts, nx, ny, h):
        i = np.clip(((pts[:, 0] - lo[0]) / h[0]).astype(np.int64), 0, nx - 1)
        j = np.clip(((pts[:, 1] - lo[1]) / h[1]).astype(np.int64), 0, ny - 1)
        return i * ny + j

    print("\n-- domain-uniform test points --", flush=True)
    for label, te_test, pts_test, th_test in (
            ("dom", te_dom, pts_dom, th_dom), ("bench", te_b, pts_b, th_b)):
        if label == "bench":
            print("\n-- bench-like test points (class <= mdl_face) --",
                  flush=True)
        for cpe in (2.0, 4.0, 8.0):
            n_cells = max(int(E * cpe), 16)
            aspect = ext[0] / ext[1]
            nx = max(int(np.sqrt(n_cells * aspect)), 1)
            ny = max(n_cells // nx, 1)
            h = ext / np.array([nx, ny])
            fb = np.zeros(nx * ny, np.int64)
            fb[cart_cells(cent, nx, ny, h)] = np.arange(E)
            report(f"cart cpe={cpe:g}", 4,
                   cart_cells(pts_cal, nx, ny, h),
                   cart_cells(pts_test, nx, ny, h),
                   te_cal, te_test, nx * ny, fb)

        for T in (1024, 2048, 3072):
            n_cells = K * T

            def band_cell(band, th):
                tb = np.clip((th / (2 * np.pi) * T).astype(np.int64),
                             0, T - 1)
                return band * T + tb

            fb = np.zeros(n_cells, np.int64)
            fb[band_cell(cls - 1, th_cent)] = np.arange(E)
            # oracle band assignment (upper bound for any band locator)
            report(f"band-oracle T={T}", 4,
                   band_cell(band_cal, th_cal),
                   band_cell(cls[te_test] - 1, th_test),
                   te_cal, te_test, n_cells, fb)
            # fitted band assignment (the realizable design): calibration
            # AND test both routed through the same fitted psi, so
            # systematic fit errors are absorbed into the candidates
            psi_test = psi_dom_b if label == "dom" else psi_bb_b
            report(f"band-fit{best_key} T={T}", 4,
                   band_cell(psi_cal_b, th_cal),
                   band_cell(psi_test, th_test),
                   te_cal, te_test, n_cells, fb)


if __name__ == "__main__" and not os.environ.get("BP_V2"):
    main()


# ---------------------------------------------------------------------------
# v2: FORWARD per-ring Fourier model + smooth-in-ring coefficients +
# bisection inversion (the realizable analytic band coordinate), with
# production-density calibration (the v1 element-stratified 8/elem samples
# under-calibrate high-cell-count designs; attach_cell_rows uses 8 per CELL)
# ---------------------------------------------------------------------------

def fit_forward(coords, ring, K, J, P, center):
    """R(b, th) = sum_m P_m(b) {cos,sin}(m th): per-ring Fourier fits of the
    ring polygons' polar radius (exact to chord level), then each Fourier
    coefficient smoothed across rings with a degree-P Chebyshev polynomial
    in b.  Returns (coef (P+1, 2J+1) in Chebyshev-b x Fourier-th basis,
    per-ring fit resid, smoothing resid, predict_band fn)."""
    dx = coords[:, 0] - center[0]
    dy = coords[:, 1] - center[1]
    r = np.hypot(dx, dy)
    th = np.arctan2(dy, dx)

    def ang_feats(th):
        n = len(th)
        A = np.empty((n, 2 * J + 1))
        A[:, 0] = 1.0
        c1, s1 = np.cos(th), np.sin(th)
        cj, sj = c1.copy(), s1.copy()
        A[:, 1], A[:, 1 + J] = cj, sj
        for j in range(1, J):
            cn = cj * c1 - sj * s1
            sn = sj * c1 + cj * s1
            cj, sj = cn, sn
            A[:, 1 + j], A[:, 1 + J + j] = cj, sj
        return A

    # stage 1: independent per-ring Fourier fits
    C = np.zeros((K + 1, 2 * J + 1))
    ring_resid = np.zeros(K + 1)
    for b in range(K + 1):
        sel = ring == b
        A = ang_feats(th[sel])
        G = A.T @ A
        G[np.diag_indices_from(G)] += 1e-12 * max(np.trace(G), 1.0)
        cb = np.linalg.solve(G, A.T @ r[sel])
        C[b] = cb
        ring_resid[b] = np.abs(A @ cb - r[sel]).max()

    # stage 2: smooth each coefficient across rings (Chebyshev in
    # u = 2b/K - 1)
    u = 2.0 * np.arange(K + 1) / K - 1.0
    Tb = np.polynomial.chebyshev.chebvander(u, P)        # (K+1, P+1)
    G = Tb.T @ Tb
    G[np.diag_indices_from(G)] += 1e-12 * np.trace(G)
    coef = np.linalg.solve(G, Tb.T @ C)                  # (P+1, 2J+1)
    smooth_resid = np.abs(Tb @ coef - C).max()

    def predict_band(pts, iters=20):
        dx = pts[:, 0] - center[0]
        dy = pts[:, 1] - center[1]
        rq = np.hypot(dx, dy)
        tq = np.arctan2(dy, dx)
        H = ang_feats(tq)                                # (n, 2J+1)
        # per-point Chebyshev coefficients of R(.) in u: q = H @ coef.T
        q = H @ coef.T                                   # (n, P+1)

        def R(u_val):
            # Clenshaw per point (vector u)
            bk1 = np.zeros_like(u_val)
            bk2 = np.zeros_like(u_val)
            for p in range(P, 0, -1):
                bk1, bk2 = q[:, p] + 2.0 * u_val * bk1 - bk2, bk1
            return q[:, 0] + u_val * bk1 - bk2

        lo = np.full_like(rq, -1.05)
        hi = np.full_like(rq, 1.05)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            below = R(mid) < rq
            lo = np.where(below, mid, lo)
            hi = np.where(below, hi, mid)
        bstar = (0.5 * (lo + hi) + 1.0) * K / 2.0        # continuous band
        return bstar

    return coef, ring_resid, smooth_resid, predict_band


def main_v2():
    coords, tris, cls = read_msh(MESH)
    E = len(tris)
    ring, K = vertex_rings(coords, tris, cls)
    center = coords.mean(axis=0)
    print(f"[v2] mesh: {E} elems, {K} bands", flush=True)

    for J, P in ((8, 8), (16, 8), (16, 12), (24, 12), (32, 16)):
        coef, rr, sr, predict_band = fit_forward(coords, ring, K, J, P,
                                                 center)
        print(f"[v2] fwd J={J:2d} P={P:2d}: per-ring resid max="
              f"{rr.max():.2e}  smooth resid max={sr:.2e}", flush=True)

    J, P = 24, 12
    coef, rr, sr, predict_band = fit_forward(coords, ring, K, J, P, center)

    rng = np.random.default_rng(7)

    def sample_in(te, seed):
        w = np.random.default_rng(seed).dirichlet((1.0, 1.0, 1.0), len(te))
        return (coords[tris[te]] * w[:, :, None]).sum(axis=1)

    mdl = max(K // 2, 2)
    marked = np.nonzero(cls <= mdl)[0]
    te_b = marked[rng.integers(0, len(marked), N_TEST)]
    pts_b = sample_in(te_b, 11)
    te_dom = rng.integers(0, E, N_TEST)
    pts_dom = sample_in(te_dom, 12)

    for label, te_t, pts_t in (("dom", te_dom, pts_dom),
                               ("bench", te_b, pts_b)):
        bstar = predict_band(pts_t)
        bhat = np.clip(np.floor(bstar), 0, K - 1).astype(np.int64)
        btrue = cls[te_t] - 1
        acc = (bhat == btrue).mean()
        off1 = (np.abs(bhat - btrue) <= 1).mean()
        print(f"[v2] band acc ({label}): exact={acc * 100:6.2f}%  "
              f"±1={off1 * 100:6.2f}%", flush=True)

    # dense calibration: ~16 expected samples per cell for every design
    def theta(pts):
        return np.mod(np.arctan2(pts[:, 1] - center[1],
                                 pts[:, 0] - center[0]), 2 * np.pi)

    cent = coords[tris].mean(axis=1)
    th_cent = theta(cent)

    for T in (768, 1024, 1536, 2048):
        n_cells = K * T
        cal_per_elem = max(int(16 * n_cells / E), 8)
        te_cal = np.repeat(np.arange(E), cal_per_elem)
        pts_cal = sample_in(te_cal, 13)
        th_cal = theta(pts_cal)

        def band_cell(band, th):
            tb = np.clip((th / (2 * np.pi) * T).astype(np.int64), 0, T - 1)
            return band * T + tb

        fb = np.zeros(n_cells, np.int64)
        fb[band_cell(cls - 1, th_cent)] = np.arange(E)
        report(f"[v2] band-oracle T={T} cal{cal_per_elem}", 4,
               band_cell(cls[te_cal] - 1, th_cal),
               band_cell(cls[te_b] - 1, theta(pts_b)),
               te_cal, te_b, n_cells, fb)
        bc_cal = np.clip(np.floor(predict_band(pts_cal)), 0, K - 1
                         ).astype(np.int64)
        bc_t = np.clip(np.floor(predict_band(pts_b)), 0, K - 1
                       ).astype(np.int64)
        report(f"[v2] band-fwdfit T={T} cal{cal_per_elem}", 4,
               band_cell(bc_cal, th_cal),
               band_cell(bc_t, theta(pts_b)),
               te_cal, te_b, n_cells, fb)

    # bytes-matched cartesian reference at production calibration density
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)
    for cpe in (2.0, 4.0):
        n_cells = max(int(E * cpe), 16)
        aspect = ext[0] / ext[1]
        nx = max(int(np.sqrt(n_cells * aspect)), 1)
        ny = max(n_cells // nx, 1)
        h = ext / np.array([nx, ny])
        cal_per_elem = max(int(16 * nx * ny / E), 8)
        te_cal = np.repeat(np.arange(E), cal_per_elem)
        pts_cal = sample_in(te_cal, 13)

        def cart_cells(pts):
            i = np.clip(((pts[:, 0] - lo[0]) / h[0]).astype(np.int64),
                        0, nx - 1)
            j = np.clip(((pts[:, 1] - lo[1]) / h[1]).astype(np.int64),
                        0, ny - 1)
            return i * ny + j

        fb = np.zeros(nx * ny, np.int64)
        fb[cart_cells(cent)] = np.arange(E)
        report(f"[v2] cart cpe={cpe:g} cal{cal_per_elem}", 4,
               cart_cells(pts_cal), cart_cells(pts_b),
               te_cal, te_b, nx * ny, fb)


if __name__ == "__main__" and os.environ.get("BP_V2"):
    main_v2()
