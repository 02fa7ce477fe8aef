"""Mesh-aware particle containers ("particle structures").

Reference parity (``particle_structs/src/``, SURVEY.md §2 L1): the abstract
``ParticleStructure<DataTypes>`` (particle_structure.hpp:18-144) and its four
concrete layouts —

- **SellCSigma** (scs/SellCSigma.h): Sell-C-σ — elements sorted by particle
  count within σ windows, grouped into chunks of C rows, each chunk padded to
  its longest row, particles stored transposed within a chunk.
- **CSR** (csr/CSR.hpp): dense element-sorted layout with per-element offsets.
- **CabM** (cabm/cabm.hpp): Cabana AoSoA — element-sorted with each element's
  segment padded to the SoA vector width.
- **DPS** (dps/dps.hpp): unsorted; parent element stored per particle.

Redesign: all four are the SAME pytree — a fixed-capacity
structure-of-arrays with an ``active`` mask, a per-slot parent element, and a
layout policy that decides *which slot* each particle occupies at rebuild.
This is exactly what SCS already is minus pointers (SURVEY.md §7); here the
layout is pure data (slot indices), never a shape, so ``rebuild`` is one
jitted sort + scatter with zero recompilation, and ``parallel_for`` becomes
ordinary masked vectorized ops over the flat slot axis.

Capacity management: construction sizes capacity = max(num_ptcls × padding,
minimum) (the reference's extra-padding inputs); a rebuild whose survivors
exceed capacity sets ``overflowed`` — STICKY: once any rebuild has dropped
particles the flag stays set through later (fitting) rebuilds, so a jit
loop cannot mask a mid-loop loss.  Use :func:`rebuild_checked` where
data loss is unacceptable (it retries from the pre-rebuild state on a
grown structure); :func:`grow_if_overflowed` only adds headroom for future
rebuilds (host path, rare, mirrors the reference re-allocating its views).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.utils.types import LID_DTYPE, round_up


def _static_field(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


def create_member_fields(capacity: int, spec: Dict[str, Tuple[tuple, object]]):
    """``createMemberViews`` analog (MemberTypeLibraries.h:33-41): allocate a
    zeroed field dict from {name: (inner_shape, dtype)}."""
    return {
        name: jnp.zeros((capacity,) + tuple(shape), dtype)
        for name, (shape, dtype) in spec.items()
    }


@dataclass(frozen=True)
class SCSInput:
    """Sell-C-σ tuning (scs/scs_input.hpp:15-64).

    ``chunk_size`` C: rows per chunk (team height in the reference; here it
    sets the transposed-block stride). ``sigma``: sorting-window width in
    elements (None/huge → full sort). ``vertical_slice`` V is kept for API
    parity; it tuned CUDA team shapes and has no meaning here.
    """

    chunk_size: int = 8
    sigma: Optional[int] = None
    vertical_slice: int = 64
    # Extra per-element slot padding (scs_input.hpp:4-11 padding strategies
    # PAD_EVENLY / PAD_PROPORTIONALLY / PAD_INVERSELY): the layout reserves
    # ~extra_padding×N additional slots distributed per element so the
    # in-place reshuffle path (rebuild(mode="auto")) has holes to place
    # movers into.  0.0 = exact layout (reshuffle then rarely fits, exactly
    # like the reference without padding).
    extra_padding: float = 0.0
    pad_strategy: str = "proportionally"   # evenly | proportionally | inversely
    # Capacity floor as a multiple of the particle count.  The constructor
    # sizes capacity from the σ-sorted chunk-padded LAYOUT (×1.1 headroom),
    # exactly like the reference (``constructOffsets`` sets capacity_);
    # σ-sorting keeps that layout near N even for skewed distributions, and
    # every slot-rate rebuild op scales with capacity — the old 1.8 default
    # ran the 10M rebuild at 18M slot width for no benefit.  Overflow is counted and :func:`rebuild_checked`
    # re-materializes, mirroring the reference's reallocation.
    padding_factor: float = 1.2


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ParticleStructure:
    """Fixed-capacity SoA particle container (all layouts).

    Slots ``[0, capacity)``; ``active[s]`` marks live particles;
    ``elem[s]`` is the parent element (undefined where inactive).
    ``elem_offsets``/``slot_of_rank`` exist for element-sorted layouts.
    """

    fields: Dict[str, jax.Array]
    elem: jax.Array            # (C,) int32
    active: jax.Array          # (C,) bool
    num_ptcls: jax.Array       # () int32 — traced so rebuilds never recompile
    # layout-dependent: CSR/CabM hold the (E+1,) slot offsets per element;
    # SCS holds the (E,) slot of each element's rank-0 particle (its slots
    # are chunk-strided, not contiguous); DPS: None
    elem_offsets: Optional[jax.Array]
    row_to_elem: Optional[jax.Array]    # (R,) SCS row order (others: None)
    elem_to_row: Optional[jax.Array]    # (E,)
    overflowed: jax.Array      # () bool — a rebuild has EVER dropped
    #   particles (sticky across rebuilds: a later fitting rebuild cannot
    #   resurrect them, so it must not clear the flag)
    # per-element slot capacity of the CURRENT layout (scs: chunk width of
    # the element's chunk; cabm: SoA-padded segment width) — the reshuffle
    # path's fits check (SCS_rebuild.h:3-120 decides reshuffle-vs-rebuild
    # from exactly this).  None for dps/csr and before the first rebuild.
    seg_cap: Optional[jax.Array] = None
    num_elems: int = _static_field(default=0)
    capacity: int = _static_field(default=0)
    layout: str = _static_field(default="dps")   # dps | csr | cabm | scs
    soa_width: int = _static_field(default=8)    # CabM SoA width
    chunk_size: int = _static_field(default=8)   # SCS C
    sigma: int = _static_field(default=2**30)    # SCS σ
    scs_extra_padding: float = _static_field(default=0.0)
    scs_pad_strategy: str = _static_field(default="proportionally")
    # CabM analog: per-segment headroom beyond the SoA rounding (the SoA
    # width alone leaves <soa_width spare slots per segment — far too few
    # for the reshuffle path at realistic per-element counts)
    cabm_extra_padding: float = _static_field(default=0.0)
    name: str = _static_field(default="ptcls")

    # ---------------------------------------------------------------- API
    def get(self, key) -> jax.Array:
        """``ps->get<N>()`` analog; accepts field name or index."""
        if isinstance(key, int):
            return self.fields[list(self.fields.keys())[key]]
        return self.fields[key]

    def set(self, key, value) -> "ParticleStructure":
        name = list(self.fields.keys())[key] if isinstance(key, int) else key
        f = dict(self.fields)
        f[name] = value
        return dataclasses.replace(self, fields=f)

    def n_ptcls(self) -> int:
        return int(self.num_ptcls)

    @property
    def n_elems(self) -> int:
        return self.num_elems

    def num_rows(self) -> int:
        """numRows: padded row count (SCS pads to chunk multiple)."""
        if self.layout == "scs":
            return round_up(self.num_elems, self.chunk_size)
        return self.num_elems

    def map(self, fn: Callable, *extra) -> "ParticleStructure":
        """``ps::parallel_for`` analog: ``fn(elem, active, fields, *extra)``
        returns a dict of updated field arrays (missing keys unchanged)."""
        updates = fn(self.elem, self.active, self.fields, *extra)
        f = dict(self.fields)
        f.update(updates)
        return dataclasses.replace(self, fields=f)

    def ppe(self) -> jax.Array:
        """Particles per element (E,) — the shared integer histogram
        (ops/scatter.particles_per_element)."""
        from pumipic_jax.ops.scatter import particles_per_element

        return particles_per_element(
            self.elem, self.active, self.num_elems
        ).astype(LID_DTYPE)

    def get_pids(self) -> Tuple[jax.Array, jax.Array]:
        """getPIDs analog (ps_for.hpp:63-85): element-sorted slot ids +
        per-element offsets (inactive slots sorted to the tail)."""
        key = jnp.where(self.active, self.elem, self.num_elems)
        order = jnp.argsort(key, stable=True).astype(LID_DTYPE)
        counts = self.ppe()
        offsets = jnp.concatenate(
            [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)]
        )
        return order, offsets

    def copy_to_host(self) -> Dict[str, np.ndarray]:
        """``copy<HostSpace>()`` analog: materialize to numpy."""
        out = {k: np.asarray(v) for k, v in self.fields.items()}
        out["elem"] = np.asarray(self.elem)
        out["active"] = np.asarray(self.active)
        return out

    # ------------------------------------------------------------- rebuild
    def rebuild(
        self,
        new_elem: jax.Array,
        new_ptcl_elems: Optional[jax.Array] = None,
        new_ptcl_fields: Optional[Dict[str, jax.Array]] = None,
        mode: str = "sort",
    ) -> "ParticleStructure":
        """Reassign particles to elements; negative ``new_elem`` removes.

        Optionally appends a fixed-size batch of new particles (active where
        ``new_ptcl_elems >= 0``).  Mirrors ``SellCSigma::rebuild`` /
        ``CSR::rebuild`` semantics: ``mode="sort"`` is the full
        re-construction (one fused sort + packed gather,
        csr/CSR_rebuild.hpp count→scan→scatter); ``mode="auto"`` first
        tries the reference's in-place **reshuffle** (SCS_rebuild.h:3-120:
        keep every unmoved particle in its slot and place only the movers
        into holes) and falls back to the sort inside one ``lax.cond``
        when the new per-element counts do not fit the current layout.
        Reshuffle applies to scs/cabm without particle additions; dps is
        already in-place and csr is dense (no holes), exactly like the
        reference where only the masked layouts reshuffle.
        """
        return _rebuild(self, new_elem, new_ptcl_elems, new_ptcl_fields,
                        mode=mode)

    def migrate(
        self,
        new_elem: jax.Array,
        new_process: jax.Array,
        my_rank: int = 0,
    ) -> "ParticleStructure":
        """Single-process semantics of ``ps->migrate``: particles assigned to
        another process are removed; the rest rebuild.  The distributed path
        is :func:`pumipic_jax.parallel.migrate.migrate_structure` — every
        layout rides the bucketed collective and rebuilds on arrival
        (the reference's per-structure ``*_migrate`` quartet)."""
        keep = new_process == my_rank
        return self.rebuild(jnp.where(keep, new_elem, -1))

    # ------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, jax.Array]:
        """printMetrics analog (SellCSigma.h:465-524): padded-slot fraction
        and empty rows; layout-specific occupancy."""
        counts = self.ppe()
        n = self.num_ptcls
        cap = jnp.int32(self.capacity)
        return {
            "num_ptcls": n,
            "capacity": cap,
            "padded_fraction": 1.0 - n / jnp.maximum(cap, 1),
            "empty_rows": jnp.sum(counts == 0),
        }

    def print_format(self, max_elems: int = 32) -> str:
        """printFormat analog (SellCSigma.h:403-463): ASCII dump of the slot
        layout — per element, the slots its particles occupy."""
        h = self.copy_to_host()
        lines = [f"{self.name} ({self.layout}) capacity={self.capacity} "
                 f"nPtcls={int(h['active'].sum())}"]
        # vectorized grouping (a per-slot Python loop is minutes at 10M+)
        live = np.flatnonzero(h["active"])
        live_elem = h["elem"][live]
        shown = min(self.num_elems, max_elems)
        sel = live_elem < shown
        order = np.argsort(live_elem[sel], kind="stable")
        sl, se = live[sel][order], live_elem[sel][order]
        starts = np.searchsorted(se, np.arange(shown + 1))
        for e in range(shown):
            slots = sl[starts[e]:starts[e + 1]]
            lines.append(
                f"  elem {e:>6d}: {len(slots):>4d} ptcls @ {slots[:16].tolist()}")
        out = "\n".join(lines)
        from pumipic_jax.utils.plog import print_info

        print_info("%s", out)
        return out

    def print_metrics(self) -> None:
        m = {k: (float(v) if "fraction" in k else int(v)) for k, v in self.metrics().items()}
        from pumipic_jax.utils.plog import print_info

        print_info(
            "%s (%s): nPtcls %d capacity %d padded %.1f%% emptyRows %d",
            self.name, self.layout, m["num_ptcls"], m["capacity"],
            100 * m["padded_fraction"], m["empty_rows"],
        )


# ---------------------------------------------------------------------------
# layout machinery
# ---------------------------------------------------------------------------

def _scs_pad_counts(counts, extra_padding: float, strategy: str, np_mod=jnp):
    """Per-element extra padding (scs_input.hpp:4-11, SCS_buildFns.h:18-100
    padding strategies): reserve ~extra_padding×N additional slots so holes
    exist for the reshuffle path.  Works for jnp (in-jit) and numpy (host
    capacity sizing) alike."""
    if extra_padding <= 0.0:
        return counts
    total = np_mod.sum(counts)
    if strategy == "evenly":
        E = max(counts.shape[0], 1)
        pad_val = np_mod.ceil(
            total.astype(np_mod.float32) * extra_padding / E
        ).astype(counts.dtype)
        pad = np_mod.zeros_like(counts) + pad_val
    elif strategy == "inversely":
        w = 1.0 / (counts.astype(np_mod.float32) + 1.0)
        pad = np_mod.ceil(
            extra_padding * total.astype(np_mod.float32) * w / np_mod.sum(w)
        ).astype(counts.dtype)
    else:  # proportionally
        pad = np_mod.ceil(counts * (extra_padding * 1.0)).astype(counts.dtype)
    return counts + pad


def _scs_row_order(counts: jax.Array, sigma: int, chunk: int, num_elems: int,
                   extra_padding: float = 0.0,
                   pad_strategy: str = "proportionally"):
    """Sigma-sort elements by descending count within windows of σ, pad rows
    to a chunk multiple.  Returns (row_to_elem (R,), elem_to_row (E,),
    chunk_width (R/chunk,)) — all data, no shapes (SCS_sort.h:3-49,
    SCS_buildFns.h:18-100)."""
    counts = _scs_pad_counts(counts, extra_padding, pad_strategy)
    E = num_elems
    R = round_up(max(E, 1), chunk)
    sigma = min(sigma, R)
    # pad counts to R with -1 so padding rows sort last inside each window
    cpad = jnp.full((R,), -1, counts.dtype).at[:E].set(counts)
    nwin = R // sigma if R % sigma == 0 else R // sigma + 1
    Rw = nwin * sigma
    cpad2 = jnp.full((Rw,), -1, counts.dtype).at[:R].set(cpad)
    win = cpad2.reshape(nwin, sigma)
    # stable descending sort per window
    order = jnp.argsort(-win, axis=1, stable=True)
    base = (jnp.arange(nwin, dtype=order.dtype) * sigma)[:, None]
    row_to_elem = (order + base).reshape(-1)[:R].astype(LID_DTYPE)
    # inverse permutation over the padded range
    elem_to_row = (
        jnp.zeros((R,), LID_DTYPE).at[row_to_elem].set(
            jnp.arange(R, dtype=LID_DTYPE)
        )
    )[:E] if E > 0 else jnp.zeros((0,), LID_DTYPE)
    row_counts = jnp.where(cpad[row_to_elem] > 0, cpad[row_to_elem], 0)
    chunk_width = jnp.max(row_counts.reshape(R // chunk, chunk), axis=1)
    return row_to_elem, elem_to_row, chunk_width


# Rebuild moves every field through ONE packed wide-row gather instead of
# one full-width gather per field: 4-byte fields are bitcast to f32 lanes,
# concatenated to an (M, W) matrix, gathered once, and split back (the
# round-2 gather cost model: per-full-width-gather fixed cost dominates —
# MINIMIZE THE NUMBER of gathers, then bytes; the concat is a fused
# bandwidth-bound copy).  Falls back to per-field gathers when any field
# is not 4-byte-wide.  Flag exists for A/B harnesses.
PACKED_REBUILD_GATHER = True
# The pack holds (M, W) + its gathered rows live at once (~2x the field
# bytes as transient device memory); past this limit fall back to per-field gathers,
# which XLA frees between fields — keeps the 55M-particle DPS construction
# (121M-row concat path) inside device memory.
PACKED_REBUILD_BYTES_LIMIT = 1.5e9
# SCS/CabM slot validity from the gathered key lane instead of the
# counts[elem_c] small-table gather (see the keylane comment in _rebuild).
# Flag for A/B harnesses.
SCS_VALID_FROM_KEYLANE = True


def _gather_fields(fields, take, extra=()):
    """out[j] = in[take[j]] for every field, plus ``extra`` (M,) 4-byte
    columns riding the same rows.  Returns (out_fields, out_extra)."""
    width = sum(
        int(np.prod(v.shape[1:], dtype=np.int64)) for v in fields.values()
    ) + len(extra)
    nrows = next(iter(fields.values())).shape[0] if fields else (
        extra[0].shape[0] if extra else 0)
    packable = PACKED_REBUILD_GATHER and (fields or extra) and all(
        v.dtype.itemsize == 4 for v in fields.values()
    ) and all(
        e.dtype.itemsize == 4 for e in extra
    ) and nrows * width * 4 <= PACKED_REBUILD_BYTES_LIMIT
    if not packable:
        return (
            {k: v[take] for k, v in fields.items()},
            tuple(e[take] for e in extra),
        )
    # The pack carrier is s32, NOT f32: int32 values below 2^23 bitcast to
    # f32 are DENORMALS, which a backend may flush to zero somewhere in the
    # copy/fusion pipeline; the s32 carrier is bit-exact for both int and
    # f32 payloads.  Same rule as the walk-state pack in ops/search.py.
    cols = []
    layout = []  # (name, inner_shape, dtype, ncols)
    for k, v in fields.items():
        flat = v.reshape(v.shape[0], -1)
        cols.append(flat if flat.dtype == jnp.int32
                    else jax.lax.bitcast_convert_type(flat, jnp.int32))
        layout.append((k, v.shape[1:], v.dtype, flat.shape[1]))
    for e in extra:
        ec = e[:, None]
        cols.append(ec if ec.dtype == jnp.int32
                    else jax.lax.bitcast_convert_type(ec, jnp.int32))
    packed = jnp.concatenate(cols, axis=1)
    rows = packed[take]
    out_fields = {}
    c = 0
    for k, inner, dt, w in layout:
        blk = rows[:, c:c + w]
        if dt != jnp.int32:
            blk = jax.lax.bitcast_convert_type(blk, dt)
        out_fields[k] = blk.reshape((rows.shape[0],) + inner)
        c += w
    out_extra = []
    for e in extra:
        blk = rows[:, c:c + 1]
        if e.dtype != jnp.int32:
            blk = jax.lax.bitcast_convert_type(blk, e.dtype)
        out_extra.append(blk[:, 0])
        c += 1
    return out_fields, tuple(out_extra)


@functools.partial(jax.jit, static_argnames=("mode",))
def _rebuild(
    ps: ParticleStructure,
    new_elem: jax.Array,
    new_ptcl_elems: Optional[jax.Array],
    new_ptcl_fields: Optional[Dict[str, jax.Array]],
    mode: str = "sort",
) -> ParticleStructure:
    C = ps.capacity
    # out-of-range destinations (>= num_elems) are removals, exactly like
    # negatives, in EVERY layout — without the upper-bound clamp the sorted
    # layouts silently dropped such particles from slots while the DPS
    # in-place path kept them (code-review round-3c)
    ne = new_elem.astype(LID_DTYPE)
    elem = jnp.where(ps.active & (ne >= 0) & (ne < ps.num_elems), ne, -1)
    active = elem >= 0
    fields = ps.fields

    if ps.layout == "dps" and new_ptcl_elems is None:
        # Reference DPS rebuild semantics (dps_rebuild.hpp): rewrite parent
        # element + activity IN PLACE — no sorting, no field movement; holes
        # from removed particles simply stay inactive.  This makes the
        # per-step rebuild of the mini-app loops O(N) elementwise (the
        # actives-first compaction below costs a particle-rate stable
        # argsort + one gather per field — only the particle-ADD path
        # needs it, to pack arrivals into holes).
        return dataclasses.replace(
            ps,
            elem=elem,
            active=active,
            num_ptcls=jnp.sum(active.astype(jnp.int32)),
            overflowed=ps.overflowed,
        )

    if new_ptcl_elems is not None:
        ape = new_ptcl_elems.astype(LID_DTYPE)
        ape = jnp.where(ape < ps.num_elems, ape, -1)
        add_active = ape >= 0
        elem = jnp.concatenate([elem, ape])
        active = jnp.concatenate([active, add_active])
        fields = {
            k: jnp.concatenate([v, new_ptcl_fields[k]]) for k, v in fields.items()
        }

    if ps.layout in ("csr", "dps"):
        # GATHER formulation: for CSR (dense element-sorted, no padding
        # gaps) and DPS (actives-first compaction) the stable sorted order
        # IS the slot order, so rebuild needs no slot array and no
        # scatters at all — out[j] = in[order[j]] per field.  Scatter-free
        # rebuild is ~2x cheaper at 10M (ps_combo).
        from pumipic_jax.ops.scatter import count_per_key

        E, M = ps.num_elems, elem.shape[0]
        if ps.layout == "csr":
            key = jnp.where(active, elem, E)
            order = jnp.argsort(key, stable=True)
            # offsets from the integer histogram (mesh-rate cumsum) instead of
            # searchsorted over key[order] — removes a full-width gather
            counts = count_per_key(key, E).astype(LID_DTYPE)
            start = jnp.concatenate(
                [jnp.zeros(1, LID_DTYPE), jnp.cumsum(counts).astype(LID_DTYPE)])
            elem_offsets = start                    # (E+1,) dense CSR
            needed = start[E]
        else:
            key = elem
            order = jnp.argsort(jnp.where(active, 0, 1), stable=True)
            elem_offsets = None
            needed = jnp.sum(active.astype(LID_DTYPE))
        take = order[:C]
        j = jnp.arange(C, dtype=LID_DTYPE)
        out_active = j < needed
        # the slot's element rides the packed field gather as an extra lane
        # (key[take] == sorted_key[:C])
        out_fields, (sk,) = _gather_fields(fields, take, extra=(key,))
        out_elem = jnp.where(out_active, sk.astype(LID_DTYPE), -1)
        # count the OUTPUT mask: under overflow the input count exceeds the
        # placed survivors, and num_ptcls must report what the structure
        # actually holds
        n = jnp.sum(out_active.astype(jnp.int32))
        return dataclasses.replace(
            ps,
            fields=out_fields,
            elem=out_elem,
            active=out_active,
            num_ptcls=n,
            elem_offsets=elem_offsets,
            row_to_elem=None,
            elem_to_row=None,
            overflowed=ps.overflowed | (needed > C),
        )

    # SCS / CabM.  mode="auto": try the reference's in-place reshuffle
    # first (SCS_rebuild.h decides reshuffle-vs-rebuild from whether the new
    # counts fit the existing layout); additions always take the sort path,
    # and a structure that has never been laid out (seg_cap None) cannot
    # reshuffle.
    if (
        mode == "auto"
        and new_ptcl_elems is None
        and ps.seg_cap is not None
        and ps.num_elems > 0
    ):
        return _rebuild_auto(ps, elem, active)
    return _rebuild_sorted(ps, elem, active, fields)


def _rebuild_sorted(
    ps: ParticleStructure,
    elem: jax.Array,
    active: jax.Array,
    fields: Dict[str, jax.Array],
) -> ParticleStructure:
    """Full re-construction for SCS/CabM: GATHER formulation.  The layout's
    slot map is invertible
    at slot rate — for each slot j find its (element, within-element rank)
    analytically, then out[j] = in[order[start[elem_j] + rank_j]] — so
    rebuild is one stable sort + ONE gather per field, like CSR/DPS,
    instead of per-field scatters (VERDICT r2 weak #4; matches the
    gather-free reshuffle economics of SCS_rebuild.h:3-120)."""
    C = ps.capacity
    #
    # Formulation:
    # - per-element counts come from the integer histogram + a
    #   mesh-rate cumsum instead of gathering the sorted keys back
    #   (``key[order]``) and binary-searching them — one slot-rate gather
    #   gone;
    # - the within-segment offset ``o`` comes from scattering each
    #   segment-start's JUMP (previous segment length) and cumsumming —
    #   replaces the slot-rate ``offsets[segment]`` gather;
    # - element/row metadata stays in SEPARATE 1-D gathers: packing them
    #   into an s32 (R,3) table made XLA copy the gathered columns through
    #   a padded narrow layout that ran out of memory at 18M slots where
    #   this was first tuned (not re-checked on a GPU).
    from pumipic_jax.ops.scatter import count_per_key

    E, M = ps.num_elems, elem.shape[0]
    key = jnp.where(active, elem, E)
    order = jnp.argsort(key, stable=True)
    counts = count_per_key(key, E).astype(LID_DTYPE)
    start = jnp.concatenate(
        [jnp.zeros(1, LID_DTYPE), jnp.cumsum(counts).astype(LID_DTYPE)])
    j = jnp.arange(C, dtype=LID_DTYPE)

    def segment_offsets_of_slot(offsets):
        # slot -> (segment index, segment start) via MESH-rate scatters +
        # slot-rate cumsums: where the segment id increments (at
        # offsets[c]), the segment start jumps by the previous segment's
        # length.  Repeated offsets (empty segments) accumulate at the same
        # slot, so the cumsums skip them correctly.  A slot-rate
        # searchsorted costs log(S) gather rounds and regressed at 24M
        # (perf/sweep round-3); cumsums are bandwidth-bound.
        pos = offsets[1:-1]
        jump = jnp.diff(offsets)[:-1]
        ind = jnp.zeros((C,), LID_DTYPE).at[pos].add(1, mode="drop")
        gj = jnp.zeros((C,), LID_DTYPE).at[pos].add(jump, mode="drop")
        return jnp.cumsum(ind), jnp.cumsum(gj)

    if ps.layout == "cabm":
        counts_eff = _scs_pad_counts(
            counts, ps.cabm_extra_padding, "proportionally")
        seg = ((counts_eff + ps.soa_width - 1) // ps.soa_width) * ps.soa_width
        offsets = jnp.concatenate(
            [jnp.zeros(1, seg.dtype), jnp.cumsum(seg)]).astype(LID_DTYPE)
        elem_j, seg_start = segment_offsets_of_slot(offsets)
        elem_c = jnp.clip(elem_j, 0, E - 1)
        rank_j = j - seg_start
        # src_pos without ANY slot-rate table gather: slots of segment e
        # map to sorted positions shifted by the cumulative padding
        # D[e] = seg_start[e] - start[e]; D jumps by pad[e-1] at each
        # segment start, so one more mesh-rate scatter + slot-rate cumsum
        # yields D per slot (the same trick as segment_offsets_of_slot;
        # SCS cannot use it — its chunk-transposed slot order is not
        # offset-by-a-segment-constant).
        pad = (seg - counts).astype(LID_DTYPE)
        pj = jnp.zeros((C,), LID_DTYPE).at[offsets[1:-1]].add(
            pad[:-1], mode="drop")
        cabm_src_pos0 = j - jnp.cumsum(pj)
        elem_offsets = offsets
        row_to_elem = elem_to_row = None
        seg_cap = seg.astype(LID_DTYPE)
        needed = offsets[E]
    else:  # scs
        chunk = ps.chunk_size
        row_to_elem, elem_to_row, chunk_width = _scs_row_order(
            counts, ps.sigma, chunk, E,
            ps.scs_extra_padding, ps.scs_pad_strategy,
        )
        nchunks = chunk_width.shape[0]
        chunk_slots = chunk * chunk_width
        chunk_off = jnp.concatenate(
            [jnp.zeros(1, chunk_slots.dtype), jnp.cumsum(chunk_slots)]
        ).astype(LID_DTYPE)
        ch, chunk_start = segment_offsets_of_slot(chunk_off)
        o = j - chunk_start
        if chunk & (chunk - 1) == 0:
            # power-of-two chunk: exact int shifts at any o (the previous
            # f32 division was exact only for o < 2^24 — a >2M-particle
            # chunk would silently corrupt the map; code-review round-3c)
            sh = chunk.bit_length() - 1
            rank_j = (o >> sh).astype(LID_DTYPE)
            local_row = (o & (chunk - 1)).astype(LID_DTYPE)
        else:
            # int division by a trace-time constant strength-reduces; exact
            rank_j = (o // chunk).astype(LID_DTYPE)
            local_row = (o - rank_j * chunk).astype(LID_DTYPE)
        row = jnp.clip(ch, 0, nchunks - 1) * chunk + local_row
        elem_j = row_to_elem[jnp.minimum(row, row_to_elem.shape[0] - 1)]
        elem_c = jnp.clip(elem_j, 0, E - 1)
        elem_offsets = (
            chunk_off[elem_to_row // chunk] + (elem_to_row % chunk)
            if E > 0 else jnp.zeros((0,), LID_DTYPE)
        ).astype(LID_DTYPE)
        seg_cap = (
            chunk_width[elem_to_row // chunk]
            if E > 0 else jnp.zeros((0,), LID_DTYPE)
        ).astype(LID_DTYPE)
        needed = chunk_off[nchunks]

    # counts/start stay SEPARATE 1-D gathers: fusing them into a 2-lane
    # (C,2) row gather gave the output a padded narrow layout that ran out
    # of memory at 16.6M slots where this was first tuned (the same trap as
    # the s32 (R,3) table above).  Only WIDE f32 packs (the field gather
    # below) get an efficient layout.
    guard = (elem_j >= 0) & (elem_j < E) & (rank_j >= 0) & (j < needed)
    if ps.layout == "cabm" and SCS_VALID_FROM_KEYLANE:
        # gather-free src (see the cumulative-padding cumsum above); only
        # sound with keylane validity — the counts[elem_c] path needs the
        # same gather anyway, so the flag gates both.
        src_pos0 = cabm_src_pos0
    else:
        src_pos0 = start[elem_c] + rank_j
    src_pos = jnp.minimum(src_pos0, M - 1)
    src = order[src_pos]
    if SCS_VALID_FROM_KEYLANE:
        # Padding-slot validity from the gathered particle's OWN key riding
        # the field pack as one extra lane: segments are key-sorted, so a
        # rank overshoot past counts[elem_c] lands on a slot whose key is
        # strictly greater (or the E sentinel) — key==elem_c exactly iff
        # rank_j < counts[elem_c].  Saves the slot-rate counts[elem_c]
        # small-table gather (the 2-lane (counts,start) fusion that saved
        # both gathers ran out of memory, per the note above).
        out_fields, (key_src,) = _gather_fields(fields, src, extra=(key,))
        valid = guard & (src_pos0 <= M - 1) & (key_src == elem_c)
    else:
        valid = guard & (rank_j < counts[elem_c])
        take = jnp.where(valid, src, 0)
        out_fields, _ = _gather_fields(fields, take)
    out_elem = jnp.where(valid, elem_c, -1).astype(LID_DTYPE)
    out_active = valid
    # OUTPUT-mask count (see the CSR path note): what the layout holds, not
    # what was asked for
    n = jnp.sum(out_active.astype(jnp.int32))
    overflow = ps.overflowed | (needed > C)

    return dataclasses.replace(
        ps,
        fields=out_fields,
        elem=out_elem,
        active=out_active,
        num_ptcls=n,
        elem_offsets=elem_offsets,
        row_to_elem=row_to_elem,
        elem_to_row=elem_to_row,
        seg_cap=seg_cap,
        overflowed=overflow,
    )


# Static mover budget of the reshuffle path, as a fraction of capacity: all
# mover-rate work runs at this fixed width (XLA shapes are static), so it
# bounds the reshuffle's cost at low churn; a step that moves more than this
# many particles falls back to the full sort rebuild via the fits check.
RESHUFFLE_MOVER_FRACTION = 0.125


def _reshuffle_mover_budget(capacity: int) -> int:
    return min(capacity, round_up(
        max(1024, int(capacity * RESHUFFLE_MOVER_FRACTION)), 8))


def _rebuild_auto(
    ps: ParticleStructure, elem: jax.Array, active: jax.Array
) -> ParticleStructure:
    """Reshuffle-or-rebuild (SCS_rebuild.h:3-120): keep every unmoved
    particle in its slot and place only the movers into free slots of their
    destination segments; fall back to the full sort re-construction when
    the new counts don't fit the current layout.  One ``lax.cond`` — the
    guard costs one integer histogram (stay+mover counts in a single
    2E-key scatter-add)."""
    from pumipic_jax.ops.scatter import count_per_key

    E = ps.num_elems
    MB = _reshuffle_mover_budget(ps.capacity)
    stay = (elem >= 0) & (elem == ps.elem)
    mover = (elem >= 0) & ~stay
    # one histogram for both counts: stay keys in [0,E), mover keys in
    # [E,2E), everything else at the 2E sentinel
    key2 = jnp.where(stay, elem, jnp.where(mover, elem + E, 2 * E))
    cnt2 = count_per_key(key2, 2 * E).astype(LID_DTYPE)
    stay_cnt, mov_cnt = cnt2[:E], cnt2[E:]
    n_mov = jnp.sum(mover.astype(jnp.int32))
    fits = jnp.all(mov_cnt <= ps.seg_cap - stay_cnt) & (n_mov <= MB)

    return jax.lax.cond(
        fits,
        lambda: _reshuffle(ps, elem, stay, mover, stay_cnt, mov_cnt,
                           n_mov, MB),
        lambda: _rebuild_sorted(ps, elem, active, ps.fields),
    )


def _reshuffle(
    ps: ParticleStructure,
    elem: jax.Array,
    stay: jax.Array,
    mover: jax.Array,
    stay_cnt: jax.Array,
    mov_cnt: jax.Array,
    n_mov: jax.Array,
    MB: int,
) -> ParticleStructure:
    """In-place reshuffle (fits already verified by the caller).

    Formulation — slot-rate work is ONE stable argsort (group movers by
    destination; stability keeps slot order within a destination), at most
    one 1-lane gather, and a few cumsums; everything else runs at the
    static mover budget ``MB`` or at mesh rate:

    - movers grouped by destination: ``order = argsort(dest)``;
    - holes enumerated segment-major WITHOUT a sort: for CabM segments are
      contiguous in slot order (identity); for SCS an analytic permutation
      ``perm`` (rows in chunk order, ranks within a row) is built from
      mesh-rate scatters + slot-rate cumsums — padding rows ride along as
      fake always-hole segments that no mover targets, so no realness
      gather is needed;
    - the r-th mover to segment e matches the r-th hole of e: target
      cumulative-hole count = hole_start[e] + r + 1, found by a mover-rate
      ``searchsorted`` over the inclusive hole cumsum;
    - fields move with one mover-rate gather + scatter per field.
    """
    C, E = ps.capacity, ps.num_elems
    LID = LID_DTYPE
    dest = jnp.where(mover, elem, E).astype(LID)
    order = jnp.argsort(dest, stable=True).astype(LID)   # the one big sort
    msrc = order[:MB]                                     # mover slots
    m = jnp.arange(MB, dtype=LID)
    mvalid = m < n_mov
    e_m = jnp.minimum(dest[msrc], E - 1)                  # clamped for pads
    mov_start = jnp.concatenate(
        [jnp.zeros(1, LID), jnp.cumsum(mov_cnt).astype(LID)])
    r_m = m - mov_start[e_m]

    if ps.layout == "cabm":
        offsets = ps.elem_offsets                         # (E+1,)
        needed = offsets[E]
        hole = (jnp.arange(C, dtype=LID) < needed) & ~stay
        cum = jnp.cumsum(hole.astype(LID))
        hole_off = jnp.concatenate(
            [jnp.zeros(1, LID),
             jnp.cumsum(ps.seg_cap - stay_cnt).astype(LID)])
        tgt = hole_off[e_m] + r_m + 1
        qpos = jnp.searchsorted(cum, tgt, side="left").astype(LID)
        dst = jnp.minimum(qpos, C - 1)
    else:  # scs
        chunk = ps.chunk_size
        e2r = ps.elem_to_row                              # (E,)
        R = ps.row_to_elem.shape[0]
        nch = R // chunk
        # chunk widths recovered from the persisted per-element caps
        cw = jnp.zeros((nch,), LID).at[e2r // chunk].max(
            ps.seg_cap, mode="drop")
        ch_off = jnp.concatenate(
            [jnp.zeros(1, LID), jnp.cumsum(chunk * cw).astype(LID)])
        needed = ch_off[nch]
        row_cap = jnp.repeat(cw, chunk, total_repeat_length=R)
        row_off = jnp.concatenate(
            [jnp.zeros(1, LID), jnp.cumsum(row_cap).astype(LID)])
        row_slot0 = (
            ch_off[jnp.arange(R, dtype=LID) // chunk]
            + (jnp.arange(R, dtype=LID) % chunk)
        )
        # perm position p -> slot: rows in row order, q ranks per row;
        # mesh-rate scatters + slot-rate cumsums (empty rows accumulate at
        # the same position, exactly like segment_offsets_of_slot)
        p = jnp.arange(C, dtype=LID)
        pos = row_off[1:-1]
        rstart = jnp.cumsum(
            jnp.zeros((C,), LID).at[pos].add(jnp.diff(row_off)[:-1],
                                             mode="drop"))
        base = jnp.cumsum(
            jnp.zeros((C,), LID).at[pos].add(jnp.diff(row_slot0),
                                             mode="drop"))
        in_layout = p < needed
        q = p - rstart
        perm = jnp.where(in_layout, base + q * chunk, p)
        # holes in perm order: ONE slot-rate 1-lane gather; padding rows
        # (row_to_elem >= E) count as holes of segments no mover targets —
        # they shift the cumsum consistently and are never matched
        hole = in_layout & ~stay[perm]
        cum = jnp.cumsum(hole.astype(LID))
        # holes per ROW = row_cap - stayers-in-row (mesh-rate scatter)
        stay_row = jnp.zeros((R,), LID).at[e2r].add(stay_cnt, mode="drop")
        row_hole_off = jnp.concatenate(
            [jnp.zeros(1, LID), jnp.cumsum(row_cap - stay_row).astype(LID)])
        tgt = row_hole_off[e2r[e_m]] + r_m + 1
        qpos = jnp.searchsorted(cum, tgt, side="left").astype(LID)
        dst = perm[jnp.minimum(qpos, C - 1)]

    dstc = jnp.where(mvalid, dst, C)                      # drop invalid
    src = jnp.where(mvalid, msrc, 0)
    new_fields = {
        k: v.at[dstc].set(v[src], mode="drop") for k, v in ps.fields.items()
    }
    new_elem = jnp.where(stay, elem, -1).astype(LID).at[dstc].set(
        e_m, mode="drop")
    new_active = stay.at[dstc].set(mvalid, mode="drop")
    n = jnp.sum(stay.astype(jnp.int32)) + n_mov
    return dataclasses.replace(
        ps,
        fields=new_fields,
        elem=new_elem,
        active=new_active,
        num_ptcls=n,
        overflowed=ps.overflowed,
    )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _build(
    layout: str,
    num_elems: int,
    ptcl_elems: np.ndarray,
    fields: Dict[str, jax.Array] | None,
    field_spec: Dict[str, Tuple[tuple, object]] | None,
    capacity: Optional[int],
    padding_factor: float,
    name: str,
    **layout_kw,
) -> ParticleStructure:
    """Common constructor: place ``len(ptcl_elems)`` particles (elem ids may
    be -1 for none) into a fresh structure."""
    ptcl_elems = jnp.asarray(ptcl_elems, LID_DTYPE)
    n = ptcl_elems.shape[0]
    for reserved in ("elem", "active"):
        if (fields is not None and reserved in fields) or (
            field_spec is not None and reserved in field_spec
        ):
            # copy_to_host would clobber the member with structure metadata
            # and rebuild_checked/_grow would silently drop it
            raise ValueError(
                f"{name}: member field name {reserved!r} is reserved")
    if capacity is None:
        capacity = max(int(n * padding_factor), n + 8, 64)
    capacity = round_up(capacity, 8)

    if fields is None:
        fields = create_member_fields(n, field_spec or {})
    empty = ParticleStructure(
        fields={k: jnp.zeros((capacity,) + v.shape[1:], v.dtype) for k, v in fields.items()},
        elem=jnp.full((capacity,), -1, LID_DTYPE),
        active=jnp.zeros((capacity,), bool),
        num_ptcls=jnp.int32(0),
        elem_offsets=None,
        row_to_elem=None,
        elem_to_row=None,
        overflowed=jnp.asarray(False),
        num_elems=num_elems,
        capacity=capacity,
        layout=layout,
        name=name,
        **layout_kw,
    )
    if n == 0:
        return empty
    ps = empty.rebuild(
        jnp.full((capacity,), -1, LID_DTYPE),
        new_ptcl_elems=ptcl_elems,
        new_ptcl_fields=fields,
    )
    if bool(ps.overflowed):
        raise ValueError(
            f"{name}: initial particles need more than capacity {capacity}"
        )
    return ps


def DPS(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
        padding_factor=1.2, name="ptcls"):
    """Unsorted flat container (dps/dps.hpp:15-418)."""
    return _build("dps", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name)


def CSR(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
        padding_factor=1.2, name="ptcls"):
    """Element-sorted CSR container (csr/CSR.hpp:16-113)."""
    return _build("csr", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name)


def CabM(num_elems, ptcl_elems, fields=None, field_spec=None, capacity=None,
         padding_factor=1.2, soa_width=8, extra_padding=0.0, name="ptcls"):
    """AoSoA-flavored container: element segments padded to the SoA width
    (cabm/cabm.hpp:15-186).

    Capacity sizes from the SoA-padded layout (×1.1) with a
    ``padding_factor``×N floor — layout-exact like the reference, with
    :func:`rebuild_checked` covering growth (round-3b).  ``extra_padding``
    reserves per-segment headroom beyond the SoA rounding so the
    reshuffle path (rebuild mode="auto") has holes to fill."""
    if capacity is None:
        pe = np.asarray(ptcl_elems)
        ppe = np.bincount(pe[pe >= 0], minlength=num_elems)
        ppe = _scs_pad_counts(ppe.astype(np.int64), extra_padding,
                              "proportionally", np_mod=np)
        needed = int((((ppe + soa_width - 1) // soa_width) * soa_width).sum())
        n = int((pe >= 0).sum())
        capacity = max(int(needed * 1.1) + 8, int(n * padding_factor), 64)
    return _build("cabm", num_elems, ptcl_elems, fields, field_spec, capacity,
                  padding_factor, name, soa_width=soa_width,
                  cabm_extra_padding=extra_padding)


def scs_layout_size(ppe: np.ndarray, chunk: int, sigma: int,
                    extra_padding: float = 0.0,
                    pad_strategy: str = "proportionally") -> int:
    """Host-side padded slot count of the Sell-C-σ layout for given
    particles-per-element (the reference sizes capacity from
    ``constructOffsets``'s final entry)."""
    E = len(ppe)
    ppe = _scs_pad_counts(
        np.asarray(ppe, np.int64), extra_padding, pad_strategy, np_mod=np)
    R = round_up(max(E, 1), chunk)
    sigma = min(sigma, R)
    cpad = np.full(R, -1, np.int64)
    cpad[:E] = ppe
    nwin = -(-R // sigma)
    cpad2 = np.full(nwin * sigma, -1, np.int64)
    cpad2[:R] = cpad
    win = np.sort(cpad2.reshape(nwin, sigma), axis=1)[:, ::-1]
    counts = np.maximum(win.reshape(-1)[:R], 0)
    chunk_width = counts.reshape(R // chunk, chunk).max(axis=1)
    return int((chunk * chunk_width).sum())


def SellCSigma(num_elems, ptcl_elems, fields=None, field_spec=None,
               capacity=None, scs_input: SCSInput = SCSInput(), name="ptcls"):
    """Sell-C-σ container (scs/SellCSigma.h:25-227)."""
    sigma = scs_input.sigma if scs_input.sigma is not None else 2**30
    if capacity is None:
        pe = np.asarray(ptcl_elems)
        ppe = np.bincount(pe[pe >= 0], minlength=num_elems)
        needed = scs_layout_size(ppe, scs_input.chunk_size, sigma,
                                 scs_input.extra_padding,
                                 scs_input.pad_strategy)
        n = int((pe >= 0).sum())
        capacity = max(
            int(needed * 1.1) + 8, int(n * scs_input.padding_factor), 64
        )
    return _build(
        "scs", num_elems, ptcl_elems, fields, field_spec, capacity,
        scs_input.padding_factor, name,
        chunk_size=scs_input.chunk_size, sigma=sigma,
        scs_extra_padding=scs_input.extra_padding,
        scs_pad_strategy=scs_input.pad_strategy,
    )


def rebuild_checked(
    ps: ParticleStructure,
    new_elem: jax.Array,
    new_ptcl_elems: Optional[jax.Array] = None,
    new_ptcl_fields: Optional[Dict[str, jax.Array]] = None,
    growth: float = 1.5,
) -> ParticleStructure:
    """Host-side rebuild that recovers from overflow WITHOUT data loss.

    An overflowed ``rebuild`` drops out-of-capacity particles, so the result
    is unusable; this re-issues the rebuild on a larger structure built from
    the *pre-rebuild* state (the reference reallocates its views the same
    way), whose constructor sizes capacity from the survivors + additions —
    a single retry cannot overflow again.  Costs a recompile when it fires —
    size capacity to make it rare.  This is the data-safe escape hatch;
    :func:`grow_if_overflowed` only adds headroom for FUTURE rebuilds and
    cannot resurrect what an overflowed rebuild already dropped.
    """
    out = ps.rebuild(new_elem, new_ptcl_elems, new_ptcl_fields)
    if not bool(out.overflowed):
        return out
    # ``overflowed`` is sticky (history of earlier drops), so decide the
    # retry on THIS call's arithmetic: did every expected survivor land?
    ne = new_elem.astype(LID_DTYPE)
    expected = int(jnp.sum(
        (ps.active & (ne >= 0) & (ne < ps.num_elems)).astype(jnp.int32)))
    if new_ptcl_elems is not None:
        ape = new_ptcl_elems.astype(LID_DTYPE)
        expected += int(jnp.sum(
            ((ape >= 0) & (ape < ps.num_elems)).astype(jnp.int32)))
    if int(out.num_ptcls) == expected:
        return out

    # Overflow: redo the rebuild on host in particle (not slot) terms and
    # materialize a fresh structure whose constructor sizes capacity from the
    # survivors + additions, with growth headroom.
    h = ps.copy_to_host()
    ne = np.asarray(new_elem)
    keep = h["active"] & (ne >= 0)
    elems = ne[keep]
    fields = {
        k: np.asarray(v)[keep]
        for k, v in h.items()
        if k not in ("elem", "active")
    }
    if new_ptcl_elems is not None:
        ane = np.asarray(new_ptcl_elems)
        akeep = ane >= 0
        elems = np.concatenate([elems, ane[akeep]])
        fields = {
            k: np.concatenate([v, np.asarray(new_ptcl_fields[k])[akeep]])
            for k, v in fields.items()
        }
    fields = {k: jnp.asarray(v) for k, v in fields.items()}
    n = len(elems)
    cap_hint = max(int(ps.capacity * growth), int(n * growth)) + 64
    if ps.layout == "scs":
        # let the constructor size from the padded layout, with headroom
        out = SellCSigma(
            ps.num_elems, elems, fields=fields, capacity=None,
            scs_input=SCSInput(
                chunk_size=ps.chunk_size, sigma=ps.sigma,
                padding_factor=growth,
                extra_padding=ps.scs_extra_padding,
                pad_strategy=ps.scs_pad_strategy,
            ),
            name=ps.name,
        )
    elif ps.layout == "cabm":
        out = CabM(ps.num_elems, elems, fields=fields, capacity=None,
                   padding_factor=growth, soa_width=ps.soa_width,
                   extra_padding=ps.cabm_extra_padding, name=ps.name)
    else:
        builder = {"dps": DPS, "csr": CSR}[ps.layout]
        out = builder(ps.num_elems, elems, fields=fields, capacity=cap_hint,
                      name=ps.name)
    # the retry is lossless from the PRE-rebuild state, but earlier sticky
    # history (particles already dropped before this call) must survive it
    return dataclasses.replace(
        out, overflowed=out.overflowed | ps.overflowed)


def _grow(ps: ParticleStructure, growth: float) -> ParticleStructure:
    host = ps.copy_to_host()
    live = host["active"]
    elems = np.where(live, host["elem"], -1)
    fields = {k: jnp.asarray(v) for k, v in host.items() if k not in ("elem", "active")}
    new_cap = int(ps.capacity * growth) + 64
    if ps.layout == "scs":
        try:
            return SellCSigma(
                ps.num_elems, elems, fields=fields, capacity=new_cap,
                scs_input=SCSInput(chunk_size=ps.chunk_size, sigma=ps.sigma,
                                   extra_padding=ps.scs_extra_padding,
                                   pad_strategy=ps.scs_pad_strategy),
                name=ps.name,
            )
        except ValueError:
            # skewed layouts can pad past new_cap; let the constructor size
            # capacity from the padded layout with growth headroom instead
            return SellCSigma(
                ps.num_elems, elems, fields=fields, capacity=None,
                scs_input=SCSInput(chunk_size=ps.chunk_size, sigma=ps.sigma,
                                   padding_factor=growth,
                                   extra_padding=ps.scs_extra_padding,
                                   pad_strategy=ps.scs_pad_strategy),
                name=ps.name,
            )
    if ps.layout == "cabm":
        try:
            return CabM(ps.num_elems, elems, fields=fields,
                        capacity=new_cap, soa_width=ps.soa_width,
                        extra_padding=ps.cabm_extra_padding, name=ps.name)
        except ValueError:
            # spread populations SoA-pad past new_cap (ceil(ppe/soa_width)
            # per element); size capacity from the padded layout instead —
            # the same fallback the SCS branch takes for skewed layouts
            return CabM(ps.num_elems, elems, fields=fields, capacity=None,
                        padding_factor=growth, soa_width=ps.soa_width,
                        extra_padding=ps.cabm_extra_padding, name=ps.name)
    builder = {"dps": DPS, "csr": CSR}[ps.layout]
    return builder(ps.num_elems, elems, fields=fields, capacity=new_cap,
                   name=ps.name)


def grow_if_overflowed(ps: ParticleStructure, growth: float = 1.5) -> ParticleStructure:
    """Host-side capacity headroom: if the last rebuild overflowed,
    re-materialize the SURVIVING particles into a larger structure so
    future rebuilds have room (new compile, rare).

    This cannot recover the particles the overflowed rebuild already
    dropped — when losing them is not acceptable, call
    :func:`rebuild_checked` instead of ``rebuild`` so the retry runs from
    the pre-rebuild state.

    Growing ACKNOWLEDGES the recorded loss: the sticky ``overflowed`` flag
    is cleared on the grown structure (it must be, or a grow-each-step loop
    would re-fire forever), so capture the flag first if you audit it."""
    if not bool(ps.overflowed):
        return ps
    return _grow(ps, growth)
