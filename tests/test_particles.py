"""Particle-structure matrix tests.

Mirrors the reference's exhaustive ``test_structure.cpp:73-100`` suite:
every concrete layout (SCS two configs, CSR, CabM, DPS) is driven through
construction / counts / setValues / pseudo-push / PIDs / metrics / rebuild
variants / single-rank migration / copy-to-host / empty-and-refill, from the
same deterministic fixtures.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pumipic_jax.particles import (
    CSR,
    DPS,
    CabM,
    SellCSigma,
    SCSInput,
    distribute,
)
from pumipic_jax.particles.structure import grow_if_overflowed, rebuild_checked

E = 25
N = 200

BUILDERS = {
    "scs_c4": lambda elems, fields, **kw: SellCSigma(
        E, elems, fields=fields, scs_input=SCSInput(chunk_size=4, sigma=None), **kw
    ),
    "scs_c8_s8": lambda elems, fields, **kw: SellCSigma(
        E, elems, fields=fields, scs_input=SCSInput(chunk_size=8, sigma=8), **kw
    ),
    "csr": lambda elems, fields, **kw: CSR(E, elems, fields=fields, **kw),
    "cabm": lambda elems, fields, **kw: CabM(E, elems, fields=fields, **kw),
    "dps": lambda elems, fields, **kw: DPS(E, elems, fields=fields, **kw),
}


def _fixture(strategy="gaussian", seed=3):
    ppe, elems = distribute.distribute_particles(E, N, strategy, seed=seed)
    fields = {
        "pos": jnp.asarray(np.random.default_rng(1).normal(size=(N, 3)), jnp.float32),
        "val": jnp.zeros((N, 3), jnp.float32),
        "pid": jnp.arange(N, dtype=jnp.int32),
    }
    return ppe, elems, fields


def _host_state(ps):
    """pid -> (elem, pos) for every active slot."""
    h = ps.copy_to_host()
    out = {}
    for s in range(ps.capacity):
        if h["active"][s]:
            out[int(h["pid"][s])] = (int(h["elem"][s]), tuple(h["pos"][s]))
    return out


@pytest.mark.parametrize("name", BUILDERS)
def test_build_counts_and_identity(name):
    ppe, elems, fields = _fixture()
    ps = BUILDERS[name](elems, fields)
    assert ps.n_ptcls() == N
    assert ps.num_elems == E
    np.testing.assert_array_equal(np.asarray(ps.ppe()), ppe)
    # every particle is present exactly once with its data intact
    state = _host_state(ps)
    assert len(state) == N
    for pid, (e, pos) in state.items():
        assert e == elems[pid]
        np.testing.assert_allclose(pos, np.asarray(fields["pos"][pid]), rtol=1e-6)


@pytest.mark.parametrize("name", BUILDERS)
def test_layout_invariants(name):
    ppe, elems, fields = _fixture("exponential")
    ps = BUILDERS[name](elems, fields)
    h = ps.copy_to_host()
    if ps.layout == "csr":
        off = np.asarray(ps.elem_offsets)
        assert off[-1] == N
        for e in range(E):
            seg = h["elem"][off[e]:off[e + 1]]
            assert np.all(seg == e)
            assert np.all(h["active"][off[e]:off[e + 1]])
    if ps.layout == "cabm":
        off = np.asarray(ps.elem_offsets)
        assert np.all(off % ps.soa_width == 0)
        for e in range(E):
            seg_active = h["active"][off[e]:off[e + 1]]
            assert seg_active.sum() == ppe[e]
            assert np.all(h["elem"][off[e]:off[e + 1]][seg_active] == e)
    if ps.layout == "scs":
        # sigma-sorted row order: within each sigma window, counts descend
        r2e = np.asarray(ps.row_to_elem)
        counts = np.zeros(len(r2e), np.int64)
        valid = r2e < E
        counts[valid] = ppe[r2e[valid]]
        sig = min(ps.sigma, len(r2e))
        for w0 in range(0, len(r2e), sig):
            wc = counts[w0:w0 + sig]
            assert np.all(np.diff(wc) <= 0), (w0, wc)


@pytest.mark.parametrize("name", BUILDERS)
def test_set_values_and_pseudo_push(name):
    ppe, elems, fields = _fixture()
    ps = BUILDERS[name](elems, fields)

    def push(elem, active, f):
        new_val = jnp.where(
            active[:, None], f["pos"] * 2.0 + 1.0, f["val"]
        )
        return {"val": new_val}

    ps2 = ps.map(push)
    h = ps2.copy_to_host()
    act = h["active"]
    np.testing.assert_allclose(h["val"][act], h["pos"][act] * 2 + 1, rtol=1e-6)


@pytest.mark.parametrize("name", BUILDERS)
def test_get_pids(name):
    ppe, elems, fields = _fixture()
    ps = BUILDERS[name](elems, fields)
    order, offsets = ps.get_pids()
    order = np.asarray(order)
    offsets = np.asarray(offsets)
    h = ps.copy_to_host()
    assert offsets[-1] == N
    for e in range(E):
        slots = order[offsets[e]:offsets[e + 1]]
        assert np.all(h["elem"][slots] == e)
        assert np.all(h["active"][slots])


@pytest.mark.parametrize("name", BUILDERS)
@pytest.mark.parametrize(
    "variant", ["same", "shift", "remove_half", "add", "empty_refill"]
)
def test_rebuild_variants(name, variant):
    ppe, elems, fields = _fixture()
    # csr/dps capacity is a free choice; cabm/scs must size from their padded
    # layout, so let the constructor compute it
    kw = {"capacity": 2 * N} if name in ("csr", "dps") else {}
    ps = BUILDERS[name](elems, fields, **kw)
    h = ps.copy_to_host()
    cur_elem = jnp.asarray(h["elem"])
    pid = h["pid"]

    if variant == "same":
        ps2 = ps.rebuild(cur_elem)
        assert ps2.n_ptcls() == N
        assert _host_state(ps2) == _host_state(ps)
    elif variant == "shift":
        ps2 = ps.rebuild(jnp.where(ps.active, (cur_elem + 1) % E, -1))
        assert ps2.n_ptcls() == N
        state = _host_state(ps2)
        old = _host_state(ps)
        for p, (e, pos) in state.items():
            assert e == (old[p][0] + 1) % E
            assert pos == old[p][1]
    elif variant == "remove_half":
        new_elem = jnp.where(jnp.asarray(pid) % 2 == 0, cur_elem, -1)
        ps2 = ps.rebuild(new_elem)
        assert ps2.n_ptcls() == N // 2
        state = _host_state(ps2)
        assert set(state) == {p for p in range(N) if p % 2 == 0}
    elif variant == "add":
        add_n = 16
        add_elems = jnp.asarray(np.arange(add_n) % E, jnp.int32)
        add_fields = {
            "pos": jnp.full((add_n, 3), 7.0, jnp.float32),
            "val": jnp.zeros((add_n, 3), jnp.float32),
            "pid": jnp.arange(N, N + add_n, dtype=jnp.int32),
        }
        ps2 = ps.rebuild(cur_elem, add_elems, add_fields)
        assert ps2.n_ptcls() == N + add_n
        state = _host_state(ps2)
        assert len(state) == N + add_n
        for p in range(N, N + add_n):
            assert state[p][0] == (p - N) % E
            assert state[p][1] == (7.0, 7.0, 7.0)
    elif variant == "empty_refill":
        ps2 = ps.rebuild(jnp.full_like(cur_elem, -1))
        assert ps2.n_ptcls() == 0
        assert not bool(ps2.active.any())
        # refill from empty (migrate-to-empty-and-refill analog)
        add_elems = jnp.asarray(elems[:50], jnp.int32)
        add_fields = {
            "pos": fields["pos"][:50],
            "val": fields["val"][:50],
            "pid": fields["pid"][:50],
        }
        ps3 = ps2.rebuild(jnp.full_like(cur_elem, -1), add_elems, add_fields)
        assert ps3.n_ptcls() == 50
        np.testing.assert_array_equal(
            np.asarray(ps3.ppe()), np.bincount(elems[:50], minlength=E)
        )


@pytest.mark.parametrize("name", BUILDERS)
def test_migrate_single_rank(name):
    ppe, elems, fields = _fixture()
    ps = BUILDERS[name](elems, fields)
    h = ps.copy_to_host()
    cur_elem = jnp.asarray(h["elem"])
    # send odd pids to "rank 1" -> they are removed locally
    procs = jnp.where(jnp.asarray(h["pid"]) % 2 == 1, 1, 0)
    ps2 = ps.migrate(cur_elem, procs, my_rank=0)
    assert ps2.n_ptcls() == N // 2
    assert all(p % 2 == 0 for p in _host_state(ps2))


@pytest.mark.parametrize("name", BUILDERS)
def test_empty_structure(name):
    ps = BUILDERS[name](np.zeros(0, np.int64), {
        "pos": jnp.zeros((0, 3), jnp.float32),
        "val": jnp.zeros((0, 3), jnp.float32),
        "pid": jnp.zeros((0,), jnp.int32),
    })
    assert ps.n_ptcls() == 0
    m = ps.metrics()
    assert int(m["num_ptcls"]) == 0


@pytest.mark.parametrize("name", ["csr", "dps", "cabm", "scs_c4"])
def test_overflow_and_grow(name):
    ppe, elems, fields = _fixture()
    kw = {"capacity": max(N + 8, 208)} if name in ("csr", "dps") else {}
    ps = BUILDERS[name](elems, fields, **kw)
    h = ps.copy_to_host()
    cur_elem = jnp.asarray(h["elem"])
    add_n = 64
    add_fields = {
        "pos": jnp.zeros((add_n, 3), jnp.float32),
        "val": jnp.zeros((add_n, 3), jnp.float32),
        "pid": jnp.arange(N, N + add_n, dtype=jnp.int32),
    }
    ps2 = ps.rebuild(cur_elem, jnp.zeros(add_n, jnp.int32), add_fields)
    assert bool(ps2.overflowed)
    # checked rebuild grows the pre-overflow structure and retries
    ps3 = rebuild_checked(ps, cur_elem, jnp.zeros(add_n, jnp.int32), add_fields)
    assert not bool(ps3.overflowed)
    assert ps3.n_ptcls() == N + add_n
    assert ps3.capacity > ps.capacity


@pytest.mark.parametrize("name", ["csr", "dps", "cabm", "scs_c4"])
def test_overflow_flag_is_sticky(name):
    """A mid-loop overflow must stay visible: the flag records "a rebuild
    has EVER dropped particles", so a later rebuild that fits cannot clear
    it (a jit loop's last iteration would otherwise mask the loss — seen
    live in the sigma sweep: 1.7M particles gone, overflow=False)."""
    ppe, elems, fields = _fixture()
    kw = {"capacity": max(N + 8, 208)} if name in ("csr", "dps") else {}
    ps = BUILDERS[name](elems, fields, **kw)
    cur_elem = jnp.asarray(ps.copy_to_host()["elem"])
    add_n = 64
    add_fields = {
        "pos": jnp.zeros((add_n, 3), jnp.float32),
        "val": jnp.zeros((add_n, 3), jnp.float32),
        "pid": jnp.arange(N, N + add_n, dtype=jnp.int32),
    }
    ps2 = ps.rebuild(cur_elem, jnp.zeros(add_n, jnp.int32), add_fields)
    assert bool(ps2.overflowed)
    # a fitting follow-up rebuild (pure survivors, no adds) keeps the flag
    ps3 = ps2.rebuild(ps2.elem)
    assert bool(ps3.overflowed)
    assert ps3.n_ptcls() <= ps3.capacity
    # rebuild_checked on the flagged structure: THIS call is lossless, so
    # no retry fires and the history is preserved on the result
    ps4 = rebuild_checked(ps3, ps3.elem)
    assert bool(ps4.overflowed)
    assert int(ps4.n_ptcls()) == int(ps3.n_ptcls())
    # grow_if_overflowed acknowledges the recorded loss and clears
    ps5 = grow_if_overflowed(ps3)
    assert not bool(ps5.overflowed)
    assert ps5.capacity > ps3.capacity


def test_metrics_padding():
    ppe, elems, fields = _fixture("gitrm")
    ps = SellCSigma(E, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, sigma=None))
    m = ps.metrics()
    assert 0.0 <= float(m["padded_fraction"]) < 1.0
    ps.print_metrics()


@pytest.mark.parametrize("num_keys,n,lo,masked", [
    (129, 50_000, 0, False),             # key space below 2^16
    (70_000, 200_000, 0, False),         # key space above 2^16
    ((1 << 24) + 64, 4096, 1 << 24, False),   # key values at/above 2^24
    (300, 10_000, 0, False),             # heavy overflow bucket (== nk)
    (5000, 50_000, 0, True),             # inactive keys masked out
])
def test_count_per_key_matches_bincount(num_keys, n, lo, masked):
    """The int32 scatter-add histogram agrees exactly with np.bincount:
    keys equal to num_keys (the overflow bucket) and masked inactive keys
    are not counted."""
    import numpy as np
    import jax.numpy as jnp
    from pumipic_jax.ops import scatter

    rng = np.random.default_rng(num_keys)
    key = rng.integers(lo, num_keys + 1, n)          # num_keys == overflow
    if num_keys == 300:
        key[: n // 2] = num_keys
    active = rng.random(n) < 0.7 if masked else np.ones(n, bool)
    dev_key = jnp.where(jnp.asarray(active), jnp.asarray(key, jnp.int32),
                        num_keys)
    got = np.asarray(scatter.count_per_key(dev_key, num_keys))
    want = np.bincount(key[active], minlength=num_keys + 1)[:num_keys]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_gather_fields_s32_carrier_contract():
    """The packed rebuild gather must carry s32 lanes: int32 bitcast into
    f32 lanes produces denormals that an accelerator backend may flush to
    zero — a 10M construction once silently lost 99.9% of its particles
    while CPU tests stayed green.  Locks the carrier dtype and the exact
    round-trip of every payload class, including the bit patterns that
    are denormal when misread as f32."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pumipic_jax.particles import structure as S

    n = 64
    fields = {
        "pos": jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3) * 0.5,
        "pid": jnp.arange(n, dtype=jnp.int32),          # denormal-as-f32
        "big": jnp.full((n,), (1 << 28) + 5, jnp.int32),
    }
    key = jnp.arange(n, dtype=jnp.int32) % 7
    take = jnp.flip(jnp.arange(n, dtype=jnp.int32))

    # the pack path must be active for this spec and produce s32 lanes
    assert S.PACKED_REBUILD_GATHER
    out, (k2,) = S._gather_fields(fields, take, extra=(key,))
    for name, v in fields.items():
        np.testing.assert_array_equal(
            np.asarray(out[name]), np.asarray(v)[np.asarray(take)])
    np.testing.assert_array_equal(
        np.asarray(k2), np.asarray(key)[np.asarray(take)])

    # carrier contract: the concatenated pack inside is s32, never f32
    jaxpr = jax.make_jaxpr(
        lambda f, t, e: S._gather_fields(f, t, extra=(e,)))(fields, take, key)
    concats = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "concatenate"]
    assert concats, "pack path not taken"
    assert all(e.outvars[0].aval.dtype == jnp.int32 for e in concats), (
        "pack carrier must be s32 (f32 lanes can flush denormal int bits)")


def test_out_of_range_new_elem_removes_in_every_layout():
    """A destination >= num_elems is a removal, identically in all four
    layouts (the sorted layouts used to drop such particles from slots
    while DPS kept them live, with num_ptcls disagreeing with the active
    mask)."""
    import numpy as np
    import jax.numpy as jnp
    from pumipic_jax.particles import CSR, DPS, CabM, SellCSigma

    ne, n = 7, 40
    elems = np.arange(n) % ne
    spec = {"pid": ((), jnp.int32)}
    for build in (SellCSigma, CSR, CabM, DPS):
        ps = build(ne, elems, field_spec=spec)
        new = jnp.where(jnp.arange(ps.capacity) % 5 == 0,
                        jnp.int32(ne + 3), ps.elem)   # every 5th: bogus dest
        out = ps.rebuild(jnp.where(ps.active, new, -1))
        act = np.asarray(out.active)
        n_expected = int(np.asarray(
            ps.active & (new >= 0) & (new < ne)).sum())
        assert int(act.sum()) == n_expected, build
        assert int(out.num_ptcls) == n_expected, build
        assert np.asarray(out.elem)[act].max() < ne


def test_reserved_field_names_rejected():
    import pytest
    import numpy as np
    import jax.numpy as jnp
    from pumipic_jax.particles import CSR

    with pytest.raises(ValueError, match="reserved"):
        CSR(4, np.zeros(8, np.int64), field_spec={"elem": ((), jnp.int32)})
    with pytest.raises(ValueError, match="reserved"):
        CSR(4, np.zeros(8, np.int64),
            fields={"active": jnp.zeros((8,), jnp.float32)})


# ---------------------------------------------------------------------------
# reshuffle (rebuild mode="auto") — SCS_rebuild.h:3-120 reshuffle-vs-rebuild
# ---------------------------------------------------------------------------

def _churn(ps, move_frac, seed=11, remove_frac=0.0, concentrate=None):
    """A new_elem vector moving ``move_frac`` of live particles."""
    r = np.random.default_rng(seed)
    cur = np.where(np.asarray(ps.active), np.asarray(ps.elem), -1)
    new_elem = cur.copy()
    mv = (r.random(ps.capacity) < move_frac) & (cur >= 0)
    if concentrate is not None:
        new_elem[mv] = concentrate
    else:
        new_elem[mv] = r.integers(0, ps.num_elems, mv.sum())
    if remove_frac:
        rm = (r.random(ps.capacity) < remove_frac) & (cur >= 0)
        new_elem[rm] = -1
    return jnp.asarray(new_elem)


def _swap_churn(ps, frac, seed=11):
    """Count-preserving churn: swap elements between random pairs of live
    particles.  Per-element counts are unchanged, so the reshuffle fits in
    ANY layout (movers into e never exceed leavers from e) — exercises the
    reshuffle branch even with extra_padding=0."""
    r = np.random.default_rng(seed)
    cur = np.where(np.asarray(ps.active), np.asarray(ps.elem), -1)
    new_elem = cur.copy()
    live = np.flatnonzero(cur >= 0)
    k = max(2, int(len(live) * frac)) // 2 * 2
    sel = r.choice(live, size=k, replace=False)
    a, b = sel[: k // 2], sel[k // 2:]
    new_elem[a], new_elem[b] = cur[b], cur[a]
    return jnp.asarray(new_elem)


def _np_fits(ps, new_elem):
    """Host-side mirror of the reshuffle fits check."""
    ne = np.asarray(new_elem)
    stay = (np.asarray(ps.elem) == ne) & (ne >= 0)
    mover = (ne >= 0) & ~stay
    sc = np.bincount(ne[stay], minlength=ps.num_elems)
    mc = np.bincount(ne[mover], minlength=ps.num_elems)
    return bool(np.all(mc <= np.asarray(ps.seg_cap) - sc))


@pytest.mark.parametrize("strategy", ["evenly", "proportionally", "inversely"])
def test_scs_reshuffle_matches_sort(strategy):
    ppe, elems, fields = _fixture()
    ps = SellCSigma(
        E, elems, fields=fields,
        scs_input=SCSInput(chunk_size=8, sigma=8, extra_padding=0.4,
                           pad_strategy=strategy),
    )
    ne = _swap_churn(ps, 0.12)
    assert _np_fits(ps, ne), "fixture should exercise the reshuffle branch"
    a, b = ps.rebuild(ne, mode="sort"), ps.rebuild(ne, mode="auto")
    assert _host_state(a) == _host_state(b)
    assert int(b.num_ptcls) == int(a.num_ptcls)
    # stayers keep their slots (the whole point of the reshuffle)
    hb, h0 = b.copy_to_host(), ps.copy_to_host()
    keep = np.asarray(ps.active) & (np.asarray(ne) == np.asarray(ps.elem))
    assert np.all(hb["active"][keep])
    assert np.array_equal(hb["pid"][keep], h0["pid"][keep])
    # movers landed in slots of their destination segment: every active
    # slot's elem is consistent with get_pids grouping
    order, offs = b.get_pids()
    order, offs = np.asarray(order), np.asarray(offs)
    for e in range(E):
        assert np.all(hb["elem"][order[offs[e]:offs[e + 1]]] == e)


def test_cabm_reshuffle_matches_sort():
    ppe, elems, fields = _fixture()
    ps = CabM(E, elems, fields=fields, soa_width=16)  # wide SoA => holes
    ne = _swap_churn(ps, 0.10, seed=5)
    assert _np_fits(ps, ne)
    a, b = ps.rebuild(ne, mode="sort"), ps.rebuild(ne, mode="auto")
    assert _host_state(a) == _host_state(b)
    hb, h0 = b.copy_to_host(), ps.copy_to_host()
    keep = np.asarray(ps.active) & (np.asarray(ne) == np.asarray(ps.elem))
    assert np.all(hb["active"][keep])
    # CabM layout: actives of segment e sit inside [offsets[e], offsets[e+1])
    off = np.asarray(b.elem_offsets)
    for e in range(E):
        seg_act = hb["active"][off[e]:off[e + 1]]
        assert np.all(hb["elem"][off[e]:off[e + 1]][seg_act] == e)


def test_reshuffle_misfit_falls_back_to_sort():
    ppe, elems, fields = _fixture()
    ps = SellCSigma(E, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, extra_padding=0.2))
    ne = _churn(ps, 0.8, concentrate=3)   # all movers into one element
    assert not _np_fits(ps, ne)
    a, b = ps.rebuild(ne, mode="sort"), ps.rebuild(ne, mode="auto")
    assert _host_state(a) == _host_state(b)
    # the fallback re-laid-out: element 3's capacity now covers its count
    assert int(np.asarray(b.seg_cap)[3]) >= int(np.asarray(b.ppe())[3])


def test_reshuffle_mover_budget_falls_back(monkeypatch):
    from pumipic_jax.particles import structure as S

    ppe, elems, fields = _fixture()
    ps = SellCSigma(E, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, extra_padding=0.5))
    monkeypatch.setattr(S, "RESHUFFLE_MOVER_FRACTION", 1e-9)
    ne = _churn(ps, 0.3)
    a, b = ps.rebuild(ne, mode="sort"), ps.rebuild(ne, mode="auto")
    assert _host_state(a) == _host_state(b)


def test_reshuffle_multi_step_with_interleaved_fallback():
    ppe, elems, fields = _fixture()
    ps = SellCSigma(E, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, sigma=8,
                                       extra_padding=0.3))
    ref = {int(p) for p in np.asarray(ps.get("pid"))[np.asarray(ps.active)]}
    r = np.random.default_rng(23)
    took_reshuffle = took_sort = 0
    for step in range(8):
        ne = _churn(ps, 0.15, seed=int(r.integers(1 << 30)))
        if _np_fits(ps, ne):
            took_reshuffle += 1
        else:
            took_sort += 1
        ps = ps.rebuild(ne, mode="auto")
        live = {int(p) for p in
                np.asarray(ps.get("pid"))[np.asarray(ps.active)]}
        assert live == ref, step            # conservation every step
        assert not bool(ps.overflowed)
    assert took_reshuffle >= 1              # the path actually exercised


def test_scs_extra_padding_checkpoint_roundtrip(tmp_path):
    from pumipic_jax.io.checkpoint import (
        read_particle_structure,
        write_particle_structure,
    )

    ppe, elems, fields = _fixture()
    ps = SellCSigma(E, elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, extra_padding=0.25,
                                       pad_strategy="evenly"))
    p = write_particle_structure(str(tmp_path / "ps"), ps)
    ps2, _ = read_particle_structure(p)
    assert ps2.scs_extra_padding == 0.25
    assert ps2.scs_pad_strategy == "evenly"
    assert _host_state(ps) == _host_state(ps2)


def test_cabm_grow_spread_population():
    """REGRESSION (round-5 review): grow_if_overflowed's CabM branch passed
    a fixed capacity to the constructor, but a SPREAD population (few
    particles in each of many elements) SoA-pads past any ~1.5x capacity
    (ceil(ppe/soa_width) slots per element) — the recovery path raised
    ValueError instead of growing.  It must fall back to layout-sized
    capacity like the SCS branch does."""
    from pumipic_jax.particles.structure import CabM

    E_many = 300
    n = 200
    elems = np.zeros(n, np.int64)          # dense: all in element 0
    fields = {"pid": jnp.arange(n, dtype=jnp.int32)}
    ps = CabM(E_many, elems, fields=fields, soa_width=8)
    # spread survivors one per element -> SoA padding needs E_many*8 slots,
    # far beyond capacity*1.5 (new_elem is capacity-wide, like rebuild takes)
    h = ps.copy_to_host()
    new_elem = np.where(h["active"],
                        np.arange(len(h["elem"]), dtype=np.int64) % E_many,
                        -1)
    ps2 = ps.rebuild(jnp.asarray(new_elem))
    assert bool(ps2.overflowed) or ps2.capacity >= n  # layout-dependent
    forced = dataclasses.replace(ps2, overflowed=jnp.bool_(True))
    grown = grow_if_overflowed(forced)     # must not raise
    assert grown.capacity >= grown.n_ptcls()
    assert not bool(grown.overflowed)
