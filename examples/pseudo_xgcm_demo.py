"""pseudoXGCm demo: single device, with VTK output.

Run:  python examples/pseudo_xgcm_demo.py [num_ptcls] [iters]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from pumipic_jax.library import Library
from pumipic_jax.mesh import annulus_mesh
from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.models.pseudo_xgcm import PseudoXGCm, XGCmConfig


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    lib = Library()
    coords, tris, cls = annulus_mesh(24, 200, 0.3, 1.0)
    mesh = Mesh2D.from_arrays(coords, tris, cls)
    cfg = XGCmConfig(
        num_ptcls=n, num_iterations=iters,
        mdl_face=int(np.asarray(mesh.class_id).max()) // 2,
        deg_per_push=15.0,
    )
    app = PseudoXGCm(mesh, cfg)
    fwd, bwd = app.run(render_prefix=None)
    app.render("pseudo_xgcm_final", fwd, bwd)
    app.ptcls.print_metrics()
    lib.finalize()
    print("wrote pseudo_xgcm_final.vtk")


if __name__ == "__main__":
    main()
