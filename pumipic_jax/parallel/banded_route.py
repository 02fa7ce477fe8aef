"""Gather-free particle routing for sector-band picparts on proven annuli.

The analytic SPMD picparts step (models/pseudo_xgcm.py) replaced the
per-rank peel+pyramid walk with a global analytic locate, leaving ONE
particle-rate memory access: the fused [lid | route] gather (local element
id + packed safe/owner/sbar), the largest term of the picparts-vs-dp
premium where this was first tuned.  This module deletes it: when the partition is a SECTOR BAND
decomposition of a detection-proven structured annulus, every routed
quantity is a banded function of the (ring, sector, tri) indices the
analytic locator already computes, so lid/dest/sbar/noncore collapse to
fused elementwise arithmetic — the same "turn the lookup into arithmetic"
move as the banded gather-free rotation (ops/push.py detect_banded_class).

Verified-by-construction, never assumed: :func:`derive_banded_route`
EXHAUSTIVELY checks every formula against the generically-built picparts
tables (owner per sector, per-rank rectangular windows, the local-id
formula against ``elem_gid``, per-rank safe intervals against
``elem_safe``, global sector-constant sbars against the balancer tables) —
any mismatch returns None and callers keep the fused gather.  This mirrors
the reference's routing semantics exactly (set_unsafe_procs,
src/pumipic_ptcl_ops.hpp:32-52, and the balancer's sbar map,
src/pumipic_lb.cpp:93-110) with the lookups replaced by proofs.

Why the local-id formula holds: build_picparts numbers each rank's local
elements by ascending global id (``np.nonzero(sel)[0]``), and a sector
band's BFS buffer on a structured annulus is a full rectangle (all rings ×
a circular sector interval) — so the local id of global element
(ring, sec, tri) is ring·2W + gidx(sec)·2 + tri, where gidx is the
sector's position in the window's GLOBAL-id order (wrapped sectors sort
first).  All arithmetic is exact-int-in-f32 (ids < 2^24, asserted).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.utils.types import LID_DTYPE

INVALID = np.int32(-1)


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandedRoute2D:
    """Per-rank window/safe scalars (stacked (R,) f32, sharded P('ranks'))
    plus static global structure.  All values are exact small integers
    carried in f32 (the step's id arithmetic dtype)."""

    win_a: jax.Array       # (R,) window start sector
    win_w: jax.Array       # (R,) window width (sectors)
    win_w0: jax.Array      # (R,) wrapped-sector count  max(a+W-Ns, 0)
    win_nsa: jax.Array     # (R,) Ns - a (gidx branch threshold)
    safe_a: jax.Array      # (R,) safe interval start sector
    safe_len: jax.Array    # (R,) safe interval length
    n_sectors: int = _static_field(default=1)
    n_rings: int = _static_field(default=1)
    num_ranks: int = _static_field(default=1)
    # static ((lo, hi, val), ...) non-wrapping sector runs of the GLOBAL
    # sbar map (empty when no balancer)
    sbar_runs: tuple = _static_field(default=())


def banded_decode(
    br: BandedRoute2D,
    ring_f: jax.Array,     # (N,) f32 exact ring index (locate_parts)
    sec_f: jax.Array,      # (N,) f32 exact sector index
    tri_f: jax.Array,      # (N,) f32 exact triangle-in-quad (0/1)
    valid: jax.Array,      # (N,) located in-domain (elem id >= 0)
    active: jax.Array,     # (N,) particle live
    me: jax.Array,         # () rank
    a: jax.Array, w: jax.Array, w0: jax.Array, nsa: jax.Array,
    sa: jax.Array, sl: jax.Array,   # this rank's scalars (pre-sliced)
):
    """(lid, dest, sbar, noncore) — pure fused elementwise arithmetic;
    value-identical to [g2l | route] gather + route_decode by the
    derive-time exhaustive verification."""
    Ns = jnp.float32(br.n_sectors)
    R = br.num_ranks

    # window position and global-order index (wrapped sectors sort first)
    pos = sec_f - a
    pos = jnp.where(pos < 0, pos + Ns, pos)
    in_win = pos < w
    gidx = jnp.where(pos >= nsa, pos + a - Ns, pos + w0)
    lid_f = ring_f * (2.0 * w) + gidx * 2.0 + tri_f
    ok = active & valid & in_win
    lid = jnp.where(ok, lid_f, jnp.float32(INVALID)).astype(LID_DTYPE)

    # owner: sector band formula (exhaustively verified over all sectors)
    owner_f = jnp.floor(sec_f * jnp.float32(R) / Ns)

    # safe: circular interval membership for THIS rank
    d = sec_f - sa
    d = jnp.where(d < 0, d + Ns, d)
    safe = d < sl

    me_f = me.astype(jnp.float32)
    dest = jnp.where(ok & ~safe, owner_f, me_f).astype(jnp.int32)
    noncore = ok & (owner_f != me_f)

    sbar = jnp.full(sec_f.shape, -1, LID_DTYPE)
    for lo, hi, val in br.sbar_runs:
        sbar = jnp.where(
            (sec_f >= jnp.float32(lo)) & (sec_f < jnp.float32(hi)),
            jnp.asarray(val, LID_DTYPE), sbar)
    sbar = jnp.where(ok, sbar, -1)
    return lid, dest, sbar, noncore


def sector_band_owners(n_rings: int, n_sectors: int, num_ranks: int
                       ) -> np.ndarray:
    """Sector-band partition of a structured annulus: owner(e) =
    floor(sector·R / Ns).  The partition for proven structured
    meshes — it makes every routing quantity banded in the sector index
    (stand-in for the reference's .ptn vectors, like partition_rcb)."""
    E = 2 * n_rings * n_sectors
    gid = np.arange(E)
    sec = (gid // 2) % n_sectors
    return (sec * num_ranks) // n_sectors


def _circular_interval(present: np.ndarray) -> Optional[Tuple[int, int]]:
    """(start, length) of the single circular True-interval, or None."""
    Ns = present.shape[0]
    if present.all():
        return 0, Ns
    if not present.any():
        return None
    starts = np.nonzero(present & ~np.roll(present, 1))[0]
    if len(starts) != 1:
        return None
    a = int(starts[0])
    length = int(present.sum())
    idx = (a + np.arange(length)) % Ns
    if not present[idx].all():
        return None
    return a, length


def derive_banded_route(pp, owners: np.ndarray, analytic, bt,
                        num_ranks: int) -> Optional[BandedRoute2D]:
    """Extract + EXHAUSTIVELY verify the banded routing structure from the
    generically-built picparts/balancer tables.  Returns None whenever any
    quantity is not banded (non-band partitions, ragged BFS windows,
    sector-varying safe zones or sbars) — callers then keep the fused
    [lid | route] gather, which is always correct."""
    R = num_ranks
    Ns, Nr = analytic.n_sectors, analytic.n_rings
    E_g = 2 * Nr * Ns
    if E_g >= (1 << 24) or owners.shape[0] != E_g:
        return None
    gid = np.arange(E_g)
    ring = gid // (2 * Ns)
    sec = (gid // 2) % Ns
    tri = gid & 1

    # owner: sector-constant AND equal to the f32 band formula (device
    # semantics replicated with float32 host arithmetic)
    own_sec = np.full(Ns, -1, np.int64)
    own_sec[sec] = owners
    if not np.array_equal(own_sec[sec], owners):
        return None
    owner_formula = np.floor(
        sec.astype(np.float32) * np.float32(R) / np.float32(Ns))
    if not np.array_equal(owner_formula.astype(np.int64), owners):
        return None

    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    win_a = np.zeros(R, np.float32)
    win_w = np.zeros(R, np.float32)
    win_w0 = np.zeros(R, np.float32)
    win_nsa = np.zeros(R, np.float32)
    safe_a = np.zeros(R, np.float32)
    safe_len = np.zeros(R, np.float32)
    for r in range(R):
        valid = eg[r] >= 0
        g = eg[r][valid]
        lids = np.nonzero(valid)[0]
        present = np.zeros(Ns, bool)
        present[sec[g]] = True
        iv = _circular_interval(present)
        if iv is None:
            return None
        a, W = iv
        # full rectangle: every (ring, window-sector, tri) present exactly
        if len(g) != Nr * W * 2:
            return None
        w0 = max(a + W - Ns, 0)
        # local-id formula against the actual numbering (f32 products are
        # exact: lid < 2^24 by the E_g bound above)
        if Nr * 2 * W >= (1 << 24):
            return None
        pos = (sec[g] - a) % Ns
        gidx = np.where(pos >= Ns - a, pos + a - Ns, pos + w0)
        lid_formula = ring[g] * (2 * W) + gidx * 2 + tri[g]
        if not np.array_equal(lid_formula, lids):
            return None
        # safe: sector-constant on the window, single circular interval
        # (vectorized — the zip loop here was O(E) interpreter time per
        # rank at setup, seconds on 120k-element meshes; round-5 review)
        fl = es[r][valid].astype(bool)
        seen_safe = np.zeros(Ns, bool)
        seen_unsafe = np.zeros(Ns, bool)
        seen_safe[sec[g][fl]] = True
        seen_unsafe[sec[g][~fl]] = True
        if (seen_safe & seen_unsafe).any():   # mixed sector
            return None
        iv_s = _circular_interval(seen_safe)
        if iv_s is None:
            # no safe elements at all is representable (len 0)
            if seen_safe.any():
                return None
            sa_r, sl_r = 0, 0
        else:
            sa_r, sl_r = iv_s
        win_a[r], win_w[r], win_w0[r] = a, W, w0
        win_nsa[r] = Ns - a
        safe_a[r], safe_len[r] = sa_r, sl_r

    # sbar: globally sector-constant; non-wrapping value runs
    sbar_runs: tuple = ()
    if bt is not None:
        sb = np.asarray(bt.sbar_of_elem)
        # globally sector-constant check via per-sector min/max scatter
        # (vectorized; was an O(R*E) interpreter loop — round-5 review)
        mn = np.full(Ns, np.iinfo(np.int64).max)
        mx = np.full(Ns, np.iinfo(np.int64).min)
        for r in range(R):
            valid = eg[r] >= 0
            ss = sec[eg[r][valid]]
            vv = sb[r][valid].astype(np.int64)
            np.minimum.at(mn, ss, vv)
            np.maximum.at(mx, ss, vv)
        seen = mx >= mn
        if (seen & (mn != mx)).any():
            return None
        sb_sec = np.where(seen, mn, -1)
        runs = []
        s = 0
        while s < Ns:
            v = sb_sec[s]
            e = s
            while e < Ns and sb_sec[e] == v:
                e += 1
            if v >= 0:
                runs.append((int(s), int(e), int(v)))
            s = e
        if len(runs) > 4 * R + 4:
            return None  # too many fused selects to be worth it
        sbar_runs = tuple(runs)

    return BandedRoute2D(
        win_a=jnp.asarray(win_a), win_w=jnp.asarray(win_w),
        win_w0=jnp.asarray(win_w0), win_nsa=jnp.asarray(win_nsa),
        safe_a=jnp.asarray(safe_a), safe_len=jnp.asarray(safe_len),
        n_sectors=Ns, n_rings=Nr, num_ranks=R, sbar_runs=sbar_runs,
    )
