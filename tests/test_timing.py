"""Timing registry tests — ppTiming parity (support/ppTiming.cpp:67-338):
RecordTime accumulation with prebarrier attribution, SummarizeTime tables,
and the cross-device summary that replaces SummarizeTimeAcrossProcesses."""
import jax
import jax.numpy as jnp
import numpy as np

from pumipic_jax.utils import timing as tm


def test_record_and_summarize_with_prebarrier():
    reg = tm.TimingRegistry()
    reg.record("opA", 0.5, prebarrier=0.1)
    reg.record("opA", 1.5, prebarrier=0.3)
    reg.record("opB", 2.0)
    out = reg.summarize(print_fn=None)
    assert "opA" in out and "opB" in out
    assert "pre=0.4" in out.replace("pre=0.400000", "pre=0.4")
    s = reg.ops["opA"]
    assert s.count == 2 and abs(s.total - 2.0) < 1e-9
    assert abs(s.prebarrier - 0.4) < 1e-9


def test_prebarrier_fence_measures_queue_drain():
    """The fence returns a nonnegative wall time and actually waits for
    in-flight device work (the MPI_Barrier role, prebarrier.cpp:1-21)."""
    dt_idle = tm.prebarrier()
    assert dt_idle >= 0.0

    # enqueue real work, then fence: the fence must take at least as long
    # as draining it (asserted loosely — just that it doesn't throw and the
    # subsequent value is ready)
    x = jnp.ones((2000, 2000), jnp.float32)
    y = jax.jit(lambda a: a @ a)(x)
    dt_busy = tm.prebarrier()
    assert dt_busy >= 0.0
    assert bool(jnp.isfinite(y[0, 0]))


def test_timed_context_records_prebarrier():
    reg = tm.get_registry()
    reg.reset()
    with tm.timed("fenced op", with_prebarrier=True):
        jnp.zeros((8,)).sum()
    s = reg.ops["fenced op"]
    assert s.count == 1
    assert s.prebarrier >= 0.0
    reg.reset()


def test_summarize_across_devices():
    per_dev = {
        "step time": np.asarray([1.0, 2.0, 1.0, 4.0]),
        "alive": np.asarray([100, 100, 100, 100]),
    }
    out = tm.summarize_across_devices(per_dev, print_fn=None)
    assert "step time" in out
    assert "imb=2.000" in out      # 4.0 / 2.0
    assert "imb=1.000" in out


def test_picparts_stats_expose_per_rank_telemetry():
    from pumipic_jax.mesh import generate as gen
    from pumipic_jax.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup,
    )
    from pumipic_jax.parallel.mesh_axis import make_device_mesh

    R = 4
    coords, tris, cls = gen.annulus_mesh(6, 32, 0.3, 1.0)
    mesh = make_device_mesh(R)
    cfg = XGCmConfig(
        num_ptcls=400, mdl_face=4, deg_per_push=5.0,
        gyro=GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4),
        max_search_iters=64,
    )
    pp, state, gyro_map, step = make_picparts_setup(
        coords, tris, cls, cfg, mesh
    )
    state, fwd, stats = step(state)
    alive_pr = np.asarray(stats["alive_per_rank"])
    assert alive_pr.shape == (R,)
    assert alive_pr.sum() == int(stats["alive"])
    out = tm.summarize_across_devices(
        {"alive": alive_pr, "migrated": np.asarray(stats["sent_per_rank"])},
        print_fn=None,
    )
    assert "alive" in out and "migrated" in out


def test_memaudit_leak_check_detects_growth_and_flat_loops():
    """Live-buffer audit (the memcheck/destroy_test analog): a state-evolving
    jitted loop must leave the buffer census flat; deliberately retained
    buffers must be reported."""
    import jax
    import jax.numpy as jnp

    from pumipic_jax.utils import memaudit

    @jax.jit
    def step(s):
        return {"x": s["x"] * 1.01 + 1.0, "y": s["y"] - 0.5}

    state = {"x": jnp.zeros(1024), "y": jnp.ones(1024)}
    for _ in range(3):
        state = step(state)          # warm caches before the baseline
    jax.block_until_ready(state)

    lc = memaudit.LeakCheck()
    for _ in range(10):
        state = step(state)          # old buffers die as references drop
    jax.block_until_ready(state)
    d = lc.assert_flat(tol_buffers=2)
    assert abs(d.count) <= 2

    # a genuine leak (host list pinning device buffers) is caught
    lc.reset()
    pinned = []
    for _ in range(8):
        state = step(state)
        pinned.append(state["x"])
    jax.block_until_ready(state)
    try:
        lc.assert_flat(tol_buffers=2)
    except AssertionError as e:
        assert "live-buffer delta" in str(e)
    else:
        raise AssertionError("leak not detected")
    del pinned
