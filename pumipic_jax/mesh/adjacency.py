"""Host-side (numpy) derivation of simplex-mesh adjacencies.

Replaces the subset of Omega_h that pumi-pic consumes on device
(SURVEY.md §2 item 8): given (coords, elem2verts) this derives

- 2D tri meshes: elem→edge, edge→verts, edge→elems (dual), exposed sides,
  vert→elems (CSR), signed element areas;
- 3D tet meshes: elem→face, face→verts, face→elems (dual), exposed sides,
  vert→elems (CSR), element volumes.

Everything is computed once on host with vectorized numpy and frozen into
immutable device arrays by :mod:`pumipic_jax.mesh.core`.  The reference pulls
these from Omega_h (``mesh.ask_down/ask_up``, ``mark_exposed_sides``,
``measure_elements_real``) at runtime; here they are preprocessing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Local ordering of the 3 edges of a triangle in terms of its vertices,
# matching the simplex_down_template convention used by the barycentric
# edge-opposite-vertex association: edge i connects verts (i, (i+1)%3) and is
# *opposite* vertex (i+2)%3.
TRI_EDGE_VERTS = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64)

# The 4 faces of a tet: face i is opposite vertex i; vertex triples oriented
# so the face normal points outward for a positively-oriented tet (verts
# ordered with positive volume  det[v1-v0, v2-v0, v3-v0] > 0).
TET_FACE_VERTS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int64
)


def _unique_sides(side_verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate per-element side vertex tuples.

    side_verts: (E*S, k) vertex ids of every element-side occurrence.
    Returns (unique_sides (Ns, k) keeping the first occurrence's orientation,
    inverse (E*S,) mapping occurrence -> unique side id).
    """
    key = np.sort(side_verts, axis=1)

    from pumipic_jax import native

    res = native.unique_sides(key)
    if res is not None:
        inv, first_occ = res
        return side_verts[first_occ], inv

    _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return side_verts[idx], inv


def build_tri_adjacency(coords: np.ndarray, elem2verts: np.ndarray) -> Dict[str, np.ndarray]:
    """Adjacency bundle for a 2D triangle mesh.

    coords: (V, 2) float; elem2verts: (E, 3) int with CCW orientation
    (areas are made positive by flipping if needed).
    """
    coords = np.asarray(coords, dtype=np.float64)
    ev = np.asarray(elem2verts, dtype=np.int64).copy()
    E = ev.shape[0]

    def cross2(u, v):  # z-component of 2D cross product (signed 2*area)
        return u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]

    # Enforce CCW orientation so barycentric signs are consistent.
    p = coords[ev]  # (E, 3, 2)
    area2 = cross2(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    flip = area2 < 0
    ev[flip] = ev[flip][:, [0, 2, 1]]
    p = coords[ev]
    area2 = cross2(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    if np.any(area2 <= 0):
        raise ValueError("degenerate (zero-area) triangle in mesh")

    # Edge occurrences: (E, 3, 2) -> (3E, 2)
    occ = ev[:, TRI_EDGE_VERTS]  # (E, 3, 2)
    occ_flat = occ.reshape(-1, 2)
    edge2verts, inv = _unique_sides(occ_flat)
    n_edges = edge2verts.shape[0]
    elem2edges = inv.reshape(E, 3)

    # Dual: each edge borders 1 (boundary) or 2 elements.
    edge2elems = np.full((n_edges, 2), -1, dtype=np.int64)
    occ_elem = np.repeat(np.arange(E, dtype=np.int64), 3)
    counts = np.zeros(n_edges, dtype=np.int64)
    # First occurrence per edge
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_elem = occ_elem[order]
    start = np.searchsorted(sorted_inv, np.arange(n_edges))
    end = np.searchsorted(sorted_inv, np.arange(n_edges), side="right")
    counts = end - start
    if np.any(counts > 2):
        raise ValueError("non-manifold edge (more than 2 adjacent triangles)")
    edge2elems[:, 0] = sorted_elem[start]
    has2 = counts == 2
    edge2elems[has2, 1] = sorted_elem[np.minimum(start + 1, len(sorted_elem) - 1)][has2]

    side_is_exposed = counts == 1

    # vert -> elems CSR
    vert_ids = ev.reshape(-1)
    elem_ids = np.repeat(np.arange(E, dtype=np.int64), 3)
    vorder = np.argsort(vert_ids, kind="stable")
    v2e_vals = elem_ids[vorder]
    V = coords.shape[0]
    v2e_offsets = np.zeros(V + 1, dtype=np.int64)
    np.add.at(v2e_offsets, vert_ids + 1, 1)
    v2e_offsets = np.cumsum(v2e_offsets)

    return {
        "coords": coords,
        "elem2verts": ev,
        "elem2edges": elem2edges,
        "edge2verts": edge2verts,
        "edge2elems": edge2elems,
        "side_is_exposed": side_is_exposed,
        "elem_area": area2 / 2.0,
        "vert2elem_offsets": v2e_offsets,
        "vert2elem_vals": v2e_vals,
    }


def build_tet_adjacency(coords: np.ndarray, elem2verts: np.ndarray) -> Dict[str, np.ndarray]:
    """Adjacency bundle for a 3D tetrahedral mesh.

    coords: (V, 3); elem2verts: (E, 4), reordered to positive volume.
    """
    coords = np.asarray(coords, dtype=np.float64)
    ev = np.asarray(elem2verts, dtype=np.int64).copy()
    E = ev.shape[0]

    p = coords[ev]  # (E, 4, 3)
    vol6 = np.einsum(
        "ei,ei->e",
        p[:, 3] - p[:, 0],
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
    )
    flip = vol6 < 0
    ev[flip] = ev[flip][:, [0, 1, 3, 2]]
    p = coords[ev]
    vol6 = np.einsum(
        "ei,ei->e",
        p[:, 3] - p[:, 0],
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
    )
    if np.any(vol6 <= 0):
        raise ValueError("degenerate (zero-volume) tet in mesh")

    occ = ev[:, TET_FACE_VERTS]  # (E, 4, 3)
    occ_flat = occ.reshape(-1, 3)
    face2verts, inv = _unique_sides(occ_flat)
    n_faces = face2verts.shape[0]
    elem2faces = inv.reshape(E, 4)

    face2elems = np.full((n_faces, 2), -1, dtype=np.int64)
    occ_elem = np.repeat(np.arange(E, dtype=np.int64), 4)
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_elem = occ_elem[order]
    start = np.searchsorted(sorted_inv, np.arange(n_faces))
    end = np.searchsorted(sorted_inv, np.arange(n_faces), side="right")
    counts = end - start
    if np.any(counts > 2):
        raise ValueError("non-manifold face (more than 2 adjacent tets)")
    face2elems[:, 0] = sorted_elem[start]
    has2 = counts == 2
    face2elems[has2, 1] = sorted_elem[np.minimum(start + 1, len(sorted_elem) - 1)][has2]

    side_is_exposed = counts == 1

    vert_ids = ev.reshape(-1)
    elem_ids = np.repeat(np.arange(E, dtype=np.int64), 4)
    vorder = np.argsort(vert_ids, kind="stable")
    v2e_vals = elem_ids[vorder]
    V = coords.shape[0]
    v2e_offsets = np.zeros(V + 1, dtype=np.int64)
    np.add.at(v2e_offsets, vert_ids + 1, 1)
    v2e_offsets = np.cumsum(v2e_offsets)

    return {
        "coords": coords,
        "elem2verts": ev,
        "elem2faces": elem2faces,
        "face2verts": face2verts,
        "face2elems": face2elems,
        "side_is_exposed": side_is_exposed,
        "elem_volume": vol6 / 6.0,
        "vert2elem_offsets": v2e_offsets,
        "vert2elem_vals": v2e_vals,
    }
