"""search2d — 2D search correctness driver (``test/search2d.cpp`` analog).

Seeds points at element centroids, pushes them toward random destinations in
the mesh, runs the 2D walk, and verifies containment with barycentric checks.
Returns the failure count like the reference's ``main``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh.core import Mesh2D
from pumipic_jax.ops import geometry as geo
from pumipic_jax.ops import search as search_ops


def run(mesh: Mesh2D, num_ptcls: int = 1000, seed: int = 0,
        max_iters: int = 200) -> int:
    rng = np.random.default_rng(seed)
    elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    orig = np.asarray(mesh.elem_centroids)[elems]

    # random destinations = centroids of other random elements
    dst_elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    dest = np.asarray(mesh.elem_centroids)[dst_elems]

    res = search_ops.search_mesh_2d(
        mesh,
        jnp.asarray(orig),
        jnp.asarray(dest),
        jnp.asarray(elems, jnp.int32),
        jnp.ones(num_ptcls, bool),
        max_iters,
    )
    got = res.elem_ids
    e_safe = jnp.maximum(got, 0)
    w = geo.bcc_2d(
        mesh.elem_inv_basis[e_safe], mesh.elem_v0[e_safe], jnp.asarray(dest)
    )
    contained = geo.all_positive(w, tol=1e-5) & (got >= 0)
    failures = int(jnp.sum(~contained))
    return failures
