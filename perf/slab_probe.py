"""Host probe for the pps3d walk-arm locator (VERDICT r4 #6): do z-slab-
aligned locator cells beat the cartesian 3D grid on layered tet meshes?

The pps3d workload mesh (box_tet_mesh) is z-layered: every tet's z-extent
spans exactly one slab of a global z-lattice — detectable from mesh arrays.
A slab-aligned cell (analytic z-slab index × xy-grid) has ZERO z-straddle;
the question is the A/B(CD) candidate coverage at matched table bytes vs
the production cartesian cpe16 grid (13.6% A∪B miss, 40.5 MB @26col).

  JAX_PLATFORMS=cpu python perf/slab_probe.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from pumipic_jax.mesh.generate import box_tet_mesh
from band_probe import topk_per_cell, report

N_SIDE = int(os.environ.get("SP_NSIDE", 16))
N_TEST = int(os.environ.get("SP_N", 200_000))


def main():
    coords, tets = box_tet_mesh(N_SIDE, N_SIDE, N_SIDE)
    E = len(tets)
    print(f"mesh: {E} tets ({N_SIDE}^3 hexes)", flush=True)
    rng = np.random.default_rng(3)

    def sample_in(te, seed):
        w = np.random.default_rng(seed).dirichlet((1.0,) * 4, len(te))
        return np.einsum("nk,nkd->nd", w, coords[tets[te]])

    te_t = rng.integers(0, E, N_TEST)
    pts_t = sample_in(te_t, 21)
    cent = coords[tets].mean(axis=1)

    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)

    # production-style cartesian 3D grid at cpe
    for cpe in (8.0, 16.0, 32.0):
        n_cells = int(E * cpe)
        s = (n_cells / np.prod(ext)) ** (1 / 3)
        nx, ny, nz = (max(int(e * s), 1) for e in ext)
        h = ext / np.array([nx, ny, nz])
        cal_per_elem = max(int(16 * nx * ny * nz / E), 8)
        te_c = np.repeat(np.arange(E), cal_per_elem)
        pts_c = sample_in(te_c, 23)

        def cell(pts):
            i = np.clip(((pts[:, 0] - lo[0]) / h[0]).astype(np.int64),
                        0, nx - 1)
            j = np.clip(((pts[:, 1] - lo[1]) / h[1]).astype(np.int64),
                        0, ny - 1)
            k = np.clip(((pts[:, 2] - lo[2]) / h[2]).astype(np.int64),
                        0, nz - 1)
            return (i * ny + j) * nz + k

        fb = np.zeros(nx * ny * nz, np.int64)
        fb[cell(cent)] = np.arange(E)
        report(f"cart3d cpe={cpe:g} cal{cal_per_elem}", 4,
               cell(pts_c), cell(pts_t), te_c, te_t, nx * ny * nz, fb,
               table_cols=26)

    # slab-aligned: analytic z-slab (lattice) x xy grid at gx cells/hex-side
    nzs = N_SIDE                       # slabs = z lattice cells
    hz = ext[2] / nzs
    for gx in (2, 3, 4, 6):
        nx = ny = N_SIDE * gx
        h = ext[:2] / np.array([nx, ny])
        n_cells = nx * ny * nzs
        cal_per_elem = max(int(16 * n_cells / E), 8)
        te_c = np.repeat(np.arange(E), cal_per_elem)
        pts_c = sample_in(te_c, 23)

        def cell(pts):
            i = np.clip(((pts[:, 0] - lo[0]) / h[0]).astype(np.int64),
                        0, nx - 1)
            j = np.clip(((pts[:, 1] - lo[1]) / h[1]).astype(np.int64),
                        0, ny - 1)
            k = np.clip(((pts[:, 2] - lo[2]) / hz).astype(np.int64),
                        0, nzs - 1)
            return (i * ny + j) * nzs + k

        fb = np.zeros(n_cells, np.int64)
        fb[cell(cent)] = np.arange(E)
        report(f"slab gx={gx} ({gx * gx}c/hex) cal{cal_per_elem}", 4,
               cell(pts_c), cell(pts_t), te_c, te_t, n_cells, fb,
               table_cols=26)


if __name__ == "__main__":
    main()
