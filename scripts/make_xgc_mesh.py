"""Generate the XGC-like tokamak cross-section meshes shipped in data/.

The reference's integration workloads run on 24k- and 120k-element XGC
tokamak meshes from the (unvendored) pumipic-data repo
(test/testing.cmake:114-130).  These generated equivalents reproduce their
character — D-shaped Miller flux surfaces, ragged per-surface point counts,
sliver elements, edge-graded resolution, flux-band classification — and are
written as gzip'd Gmsh files so the FILE INGESTION path (not an in-memory
generator) feeds tests and benchmarks.

Usage:  python scripts/make_xgc_mesh.py [out_dir]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pumipic_jax.mesh.generate import tokamak_mesh  # noqa: E402
from pumipic_jax.mesh.gmsh import write_msh2  # noqa: E402


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "data"
    )
    os.makedirs(out_dir, exist_ok=True)
    for name, ns, bp in (("xgc_like_24k", 52, 290), ("xgc_like_120k", 120, 620)):
        coords, tris, cls = tokamak_mesh(ns, bp)
        path = os.path.join(out_dir, f"{name}.msh.gz")
        write_msh2(path, coords, tris, cls)
        print(f"{path}: {tris.shape[0]} elems, {coords.shape[0]} verts, "
              f"{os.path.getsize(path) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
