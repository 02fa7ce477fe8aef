"""Device-resident unstructured simplex meshes.

Replaces the subset of Omega_h consumed by pumi-pic (SURVEY.md §2 item 8):
coords, element↔vertex/edge/face adjacencies, dual graph, exposed sides,
element measures, classification and named tags.  The reference queries these
through Omega_h at runtime (``mesh.ask_down/ask_up``, ``mark_exposed_sides``);
here they are derived once on host (:mod:`pumipic_jax.mesh.adjacency`) and
frozen into immutable jnp arrays that live in HBM for the whole run.

Design notes:

- **Barycentric via precomputed inverse affine maps.**  Instead of the
  reference's area/volume formulas per walk step
  (``src/pumipic_adjacency.hpp:75-133``), we precompute for every element the
  inverse of its edge-basis matrix.  A barycentric evaluation is then one
  gather + a (dim×dim)·(dim) matvec — FMA-bound, no divides in the hot loop.
- **Orientation-normalized connectivity** so sign conventions are uniform and
  branch-free: bcc weight of vertex ``k`` is positive iff the point is on the
  interior side of the side opposite ``k``; the exit side for a walk is simply
  ``argmin`` of the weights.
- **Fixed shapes**: every adjacency is a rectangular array; boundary duals are
  padded with -1 (tested, not branched on).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.mesh import adjacency as adj
from pumipic_jax.utils.types import LID_DTYPE, REAL_DTYPE


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Mesh2D:
    """Immutable 2D triangle mesh (device arrays).

    Vertex convention: edge ``i`` of a triangle connects local verts
    ``(i, (i+1)%3)`` and is opposite local vert ``(i+2)%3``; triangles are CCW.
    """

    coords: jax.Array          # (V, 2) real
    elem2verts: jax.Array      # (E, 3) lid
    elem2edges: jax.Array      # (E, 3) lid
    edge2verts: jax.Array      # (Ned, 2) lid
    edge2elems: jax.Array      # (Ned, 2) lid, -1 where boundary
    side_is_exposed: jax.Array  # (Ned,) bool
    elem_area: jax.Array       # (E,) real
    elem_v0: jax.Array         # (E, 2) coords of local vertex 0
    elem_inv_basis: jax.Array  # (E, 2, 2) inverse of [v1-v0, v2-v0] columns
    vert2elem_offsets: jax.Array  # (V+1,) lid CSR
    vert2elem_vals: jax.Array     # (sum deg,) lid
    class_id: jax.Array        # (E,) lid geometric-model classification
    # packed walk table: ONE row gather per search step.  All-float row —
    # barycentric weights as affine forms l_k(x) = A_k·x + c_k, and
    # neighbor/edge ids stored as f32 (exact for ids < 2^24; an all-float
    # row fuses into one gather, where int32-bitcast columns forced XLA to
    # split the gather per consumer where this was first tuned).
    # cols: [a11 a12 c1, a21 a22 c2, xnbr0..2 (f32), xedge0..2 (f32)]
    # where xnbr[k]/xedge[k] are the neighbor/edge across the EXIT side for
    # most-negative-weight vertex k (i.e. pre-permuted by (k+1)%3, so the
    # walk step selects directly by kmin — no int mod/mul in the hot loop)
    walk_geom: jax.Array       # (E, 12) f32
    elem_tags: Dict[str, jax.Array]
    vert_tags: Dict[str, jax.Array]
    nelems: int = _static_field(default=0)
    nverts: int = _static_field(default=0)
    nedges: int = _static_field(default=0)

    dim = 2

    # -- Omega_h-style accessors -------------------------------------------
    def ask_elem_verts(self) -> jax.Array:
        return self.elem2verts

    def get_tag(self, dim: int, name: str) -> jax.Array:
        return self.elem_tags[name] if dim == self.dim else self.vert_tags[name]

    def set_tag(self, dim: int, name: str, arr: jax.Array) -> "Mesh2D":
        if dim == self.dim:
            tags = dict(self.elem_tags)
            tags[name] = arr
            return dataclasses.replace(self, elem_tags=tags)
        tags = dict(self.vert_tags)
        tags[name] = arr
        return dataclasses.replace(self, vert_tags=tags)

    @property
    def elem_centroids(self) -> jax.Array:
        return jnp.mean(self.coords[self.elem2verts], axis=1)

    @staticmethod
    def from_arrays(
        coords: np.ndarray,
        elem2verts: np.ndarray,
        class_id: Optional[np.ndarray] = None,
        real_dtype=REAL_DTYPE,
    ) -> "Mesh2D":
        a = adj.build_tri_adjacency(coords, elem2verts)
        ev = a["elem2verts"]
        E = ev.shape[0]
        p = a["coords"][ev]  # (E, 3, 2) float64
        basis = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=-1)  # cols
        inv_basis = np.linalg.inv(basis)
        if class_id is None:
            class_id = np.ones(ev.shape[0], dtype=np.int64)

        # packed per-element walk table (hot-loop fusion: 1 gather/step);
        # l_k(x) = A_k·x + c_k with c = -inv_basis @ v0; ids as f32
        if E >= (1 << 24) or a["edge2verts"].shape[0] >= (1 << 24):
            raise ValueError("mesh too large for f32-packed walk ids (2^24)")
        geom = np.zeros((E, 12), np.float32)
        c_aff = -np.einsum("eij,ej->ei", inv_basis, p[:, 0])   # (E, 2)
        geom[:, 0:2] = inv_basis[:, 0, :].astype(np.float32)
        geom[:, 2] = c_aff[:, 0].astype(np.float32)
        geom[:, 3:5] = inv_basis[:, 1, :].astype(np.float32)
        geom[:, 5] = c_aff[:, 1].astype(np.float32)
        e2e = a["edge2elems"][a["elem2edges"]]            # (E, 3, 2)
        self_ids = np.arange(E)[:, None]
        nbrs = np.where(e2e[:, :, 0] == self_ids, e2e[:, :, 1], e2e[:, :, 0])
        # pre-permute: exit side for most-negative vertex k is edge (k+1)%3
        perm = [1, 2, 0]
        geom[:, 6:9] = nbrs[:, perm].astype(np.float32)
        geom[:, 9:12] = a["elem2edges"][:, perm].astype(np.float32)
        return Mesh2D(
            coords=jnp.asarray(a["coords"], real_dtype),
            elem2verts=jnp.asarray(ev, LID_DTYPE),
            elem2edges=jnp.asarray(a["elem2edges"], LID_DTYPE),
            edge2verts=jnp.asarray(a["edge2verts"], LID_DTYPE),
            edge2elems=jnp.asarray(a["edge2elems"], LID_DTYPE),
            side_is_exposed=jnp.asarray(a["side_is_exposed"]),
            elem_area=jnp.asarray(a["elem_area"], real_dtype),
            elem_v0=jnp.asarray(p[:, 0], real_dtype),
            elem_inv_basis=jnp.asarray(inv_basis, real_dtype),
            vert2elem_offsets=jnp.asarray(a["vert2elem_offsets"], LID_DTYPE),
            vert2elem_vals=jnp.asarray(a["vert2elem_vals"], LID_DTYPE),
            class_id=jnp.asarray(class_id, LID_DTYPE),
            walk_geom=jnp.asarray(geom),
            elem_tags={},
            vert_tags={},
            nelems=int(ev.shape[0]),
            nverts=int(a["coords"].shape[0]),
            nedges=int(a["edge2verts"].shape[0]),
        )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Mesh3D:
    """Immutable 3D tetrahedral mesh (device arrays).

    Face convention: face ``i`` is opposite local vertex ``i`` with outward
    orientation; tets are positively oriented.
    """

    coords: jax.Array           # (V, 3)
    elem2verts: jax.Array       # (E, 4)
    elem2faces: jax.Array       # (E, 4)
    face2verts: jax.Array       # (Nf, 3)
    face2elems: jax.Array       # (Nf, 2), -1 where boundary
    side_is_exposed: jax.Array  # (Nf,)
    elem_volume: jax.Array      # (E,)
    elem_v0: jax.Array          # (E, 3)
    elem_inv_basis: jax.Array   # (E, 3, 3)
    vert2elem_offsets: jax.Array
    vert2elem_vals: jax.Array
    class_id: jax.Array
    # packed walk table (all-float; see Mesh2D.walk_geom):
    # cols [A1 c1, A2 c2, A3 c3, nbr0..3 (f32)]
    walk_geom: jax.Array   # (E, 16) f32
    # packed face-plane table for the intersection (trace-through) walk:
    # per face i: [nx, ny, nz, d] outward unit normal, then nbr0..3 (f32)
    walk_planes: jax.Array  # (E, 20) f32
    elem_tags: Dict[str, jax.Array]
    vert_tags: Dict[str, jax.Array]
    nelems: int = _static_field(default=0)
    nverts: int = _static_field(default=0)
    nfaces: int = _static_field(default=0)

    dim = 3

    def ask_elem_verts(self) -> jax.Array:
        return self.elem2verts

    def get_tag(self, dim: int, name: str) -> jax.Array:
        return self.elem_tags[name] if dim == self.dim else self.vert_tags[name]

    def set_tag(self, dim: int, name: str, arr: jax.Array) -> "Mesh3D":
        if dim == self.dim:
            tags = dict(self.elem_tags)
            tags[name] = arr
            return dataclasses.replace(self, elem_tags=tags)
        tags = dict(self.vert_tags)
        tags[name] = arr
        return dataclasses.replace(self, vert_tags=tags)

    @property
    def elem_centroids(self) -> jax.Array:
        return jnp.mean(self.coords[self.elem2verts], axis=1)

    @staticmethod
    def from_arrays(
        coords: np.ndarray,
        elem2verts: np.ndarray,
        class_id: Optional[np.ndarray] = None,
        real_dtype=REAL_DTYPE,
    ) -> "Mesh3D":
        a = adj.build_tet_adjacency(coords, elem2verts)
        ev = a["elem2verts"]
        E = ev.shape[0]
        p = a["coords"][ev]  # (E, 4, 3)
        basis = np.stack(
            [p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1
        )
        inv_basis = np.linalg.inv(basis)
        if class_id is None:
            class_id = np.ones(ev.shape[0], dtype=np.int64)

        if E >= (1 << 24) or a["face2verts"].shape[0] >= (1 << 24):
            raise ValueError("mesh too large for f32-packed walk ids (2^24)")
        geom = np.zeros((E, 16), np.float32)
        c_aff = -np.einsum("eij,ej->ei", inv_basis, p[:, 0])   # (E, 3)
        for k in range(3):
            geom[:, 4 * k:4 * k + 3] = inv_basis[:, k, :].astype(np.float32)
            geom[:, 4 * k + 3] = c_aff[:, k].astype(np.float32)
        f2e = a["face2elems"][a["elem2faces"]]            # (E, 4, 2)
        self_ids = np.arange(E)[:, None]
        nbrs = np.where(f2e[:, :, 0] == self_ids, f2e[:, :, 1], f2e[:, :, 0])
        geom[:, 12:16] = nbrs.astype(np.float32)

        # outward unit face planes per element (face i opposite vertex i)
        planes = np.zeros((E, 20), np.float32)
        for i, fv in enumerate(adj.TET_FACE_VERTS):
            fa, fb, fc = p[:, fv[0]], p[:, fv[1]], p[:, fv[2]]
            nrm = np.cross(fb - fa, fc - fa)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
            planes[:, 4 * i:4 * i + 3] = nrm.astype(np.float32)
            planes[:, 4 * i + 3] = np.einsum("ei,ei->e", nrm, fa).astype(np.float32)
        planes[:, 16:20] = nbrs.astype(np.float32)
        return Mesh3D(
            coords=jnp.asarray(a["coords"], real_dtype),
            elem2verts=jnp.asarray(ev, LID_DTYPE),
            elem2faces=jnp.asarray(a["elem2faces"], LID_DTYPE),
            face2verts=jnp.asarray(a["face2verts"], LID_DTYPE),
            face2elems=jnp.asarray(a["face2elems"], LID_DTYPE),
            side_is_exposed=jnp.asarray(a["side_is_exposed"]),
            elem_volume=jnp.asarray(a["elem_volume"], real_dtype),
            elem_v0=jnp.asarray(p[:, 0], real_dtype),
            elem_inv_basis=jnp.asarray(inv_basis, real_dtype),
            vert2elem_offsets=jnp.asarray(a["vert2elem_offsets"], LID_DTYPE),
            vert2elem_vals=jnp.asarray(a["vert2elem_vals"], LID_DTYPE),
            class_id=jnp.asarray(class_id, LID_DTYPE),
            walk_geom=jnp.asarray(geom),
            walk_planes=jnp.asarray(planes),
            elem_tags={},
            vert_tags={},
            nelems=int(ev.shape[0]),
            nverts=int(a["coords"].shape[0]),
            nfaces=int(a["face2verts"].shape[0]),
        )
