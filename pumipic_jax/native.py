"""Native meshcore loader (ctypes).

``csrc/meshcore.cpp`` implements the preprocessing hot loops (BFS layers,
sbar set hashing, exchange-list builds, side dedup) with a C ABI — the role
the reference's C++ plays in mesh distribution, here confined to offline
preprocessing since all per-step work lives on the device.  The library is
built on first use with g++; every caller has a numpy fallback, so the
native path is an accelerator, not a requirement.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "meshcore.cpp"
# C-ABI shared object loaded with ctypes (NOT a Python extension
# module; the "lib" prefix keeps pkgutil/importlib from trying)
_SO = Path(__file__).resolve().parent / "libmeshcore.so"

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 str(_SRC), "-o", str(_SO)],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(str(_SO))
    except Exception:
        return None

    lib.pp_bfs_layers.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _u8p, ctypes.c_int64, _i64p,
    ]
    lib.pp_bfs_layers.restype = None
    lib.pp_sbar_map.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _u8p, _i64p, _i64p, _i64p,
        ctypes.c_int64,
    ]
    lib.pp_sbar_map.restype = ctypes.c_int64
    lib.pp_exchange_lists.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, _i64p, ctypes.c_int64,
    ]
    lib.pp_exchange_lists.restype = ctypes.c_int64
    lib.pp_unique_sides.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
    ]
    lib.pp_unique_sides.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            if os.environ.get("PUMIPIC_NO_NATIVE") != "1":
                _lib = _build()
            _tried = True
    return _lib


# -------------------------------------------------------------- wrappers

def bfs_layers(elem2verts: np.ndarray, nverts: int, seed_mask: np.ndarray,
               max_layers: int) -> Optional[np.ndarray]:
    """Native BFS distances; None -> caller uses the numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    E, k = elem2verts.shape
    dist = np.empty(E, np.int64)
    lib.pp_bfs_layers(
        E, nverts, k, np.ascontiguousarray(elem2verts, np.int64),
        np.ascontiguousarray(seed_mask, np.uint8), max_layers, dist,
    )
    return dist


def sbar_map(safe_by_rank: np.ndarray):
    """safe_by_rank: (R, Eg) uint8 -> (sbar_of_elem (Eg,), members list of
    arrays) or None for fallback."""
    lib = get_lib()
    R, Eg = safe_by_rank.shape
    if lib is None or R > 64:
        return None
    sbar_of = np.empty(Eg, np.int64)
    cap = R * Eg + 1
    members = np.empty(cap, np.int64)
    off = np.empty(Eg + 2, np.int64)
    S = lib.pp_sbar_map(
        R, Eg, np.ascontiguousarray(safe_by_rank, np.uint8),
        sbar_of, members, off, cap,
    )
    if S < 0:
        return None
    mem_lists = [members[off[s]:off[s + 1]].copy() for s in range(S)]
    return sbar_of, mem_lists


def exchange_lists(vert_gid: np.ndarray, vert_owner: np.ndarray,
                   num_global_verts: int):
    """(R, Vmax) arrays -> (n, 4) [src, owner, src_lid, owner_lid] or None."""
    lib = get_lib()
    if lib is None:
        return None
    R, Vmax = vert_gid.shape
    cap = int((vert_gid >= 0).sum()) + 1
    out = np.empty((cap, 4), np.int64)
    n = lib.pp_exchange_lists(
        R, Vmax, num_global_verts,
        np.ascontiguousarray(vert_gid, np.int64),
        np.ascontiguousarray(vert_owner, np.int64),
        out.reshape(-1), cap,
    )
    if n < 0:
        return None
    return out[:n]


def unique_sides(side_verts_sorted: np.ndarray):
    """(n_occ, k) pre-sorted rows -> (inv (n_occ,), first_occ (n_unique,))
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_occ, k = side_verts_sorted.shape
    inv = np.empty(n_occ, np.int64)
    first = np.empty(n_occ, np.int64)
    n_unique = lib.pp_unique_sides(
        n_occ, k, np.ascontiguousarray(side_verts_sorted, np.int64),
        inv, first,
    )
    return inv, first[:n_unique]
