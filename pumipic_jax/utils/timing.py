"""Named-operation timing registry.

Reference parity: ``support/ppTiming.hpp/.cpp`` — ``RecordTime`` accumulates
per-op total/min/max/sum-of-squares/count (plus optional prebarrier time that
attributes load imbalance ahead of collectives); ``SummarizeTime`` prints a
per-process table and ``SummarizeTimeAcrossProcesses`` a cross-rank reduced
table (ppTiming.cpp:67-338).

One Python process drives all devices, so "across processes"
becomes "across devices" and is only meaningful for per-device telemetry the
caller gathers itself; the registry is host-side and wraps *jitted* steps, so
callers must ``block_until_ready`` (use :func:`timed` which does it for you).
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import jax


@dataclass
class _OpStats:
    count: int = 0
    total: float = 0.0
    tmin: float = math.inf
    tmax: float = 0.0
    sq_total: float = 0.0  # sum of squares, for RMS like reference "sq-avg"
    prebarrier: float = 0.0


@dataclass
class TimingRegistry:
    enabled: bool = True
    verbosity: int = 0
    ops: Dict[str, _OpStats] = field(default_factory=dict)
    _extra_info: list = field(default_factory=list)

    def record(self, name: str, seconds: float, prebarrier: float = 0.0) -> None:
        """RecordTime analog (ppTiming.cpp:67-100)."""
        if not self.enabled:
            return
        s = self.ops.setdefault(name, _OpStats())
        s.count += 1
        s.total += seconds
        s.tmin = min(s.tmin, seconds)
        s.tmax = max(s.tmax, seconds)
        s.sq_total += seconds * seconds
        s.prebarrier += prebarrier
        if self.verbosity >= 1:
            jax.debug.print  # noop touch; keep host-side
            print(f"[timing] {name}: {seconds:.6f}s (pre-barrier {prebarrier:.6f}s)")

    def print_additional_time_info(self, msg: str, level: int = 1) -> None:
        if self.enabled and self.verbosity >= level - 1:
            self._extra_info.append(msg)

    def summarize(self, print_fn: Callable[[str], None] = print) -> str:
        """SummarizeTime analog: per-op table (ppTiming.cpp:168-213)."""
        lines = ["Timing summary (op, count, total, avg, min, max, rms, prebarrier):"]
        for name in sorted(self.ops):
            s = self.ops[name]
            avg = s.total / s.count if s.count else 0.0
            rms = math.sqrt(s.sq_total / s.count) if s.count else 0.0
            lines.append(
                f"  {name:<40s} n={s.count:<6d} tot={s.total:.6f} avg={avg:.6f} "
                f"min={s.tmin if s.count else 0.0:.6f} max={s.tmax:.6f} "
                f"rms={rms:.6f} pre={s.prebarrier:.6f}"
            )
        for msg in self._extra_info:
            lines.append(f"  info: {msg}")
        out = "\n".join(lines)
        if print_fn is not None:
            print_fn(out)
        return out

    def reset(self) -> None:
        self.ops.clear()
        self._extra_info.clear()


# Global registry, mirroring the reference's file-static accumulator.
_REGISTRY = TimingRegistry()


def get_registry() -> TimingRegistry:
    return _REGISTRY


def enable_timing() -> None:
    _REGISTRY.enabled = True


def disable_timing() -> None:
    _REGISTRY.enabled = False


def set_timing_verbosity(v: int) -> None:
    _REGISTRY.verbosity = v


def record_time(name: str, seconds: float, prebarrier: float = 0.0) -> None:
    _REGISTRY.record(name, seconds, prebarrier)


def summarize_time(print_fn: Callable[[str], None] = print) -> str:
    return _REGISTRY.summarize(print_fn)


def print_additional_time_info(msg: str, level: int = 1) -> None:
    _REGISTRY.print_additional_time_info(msg, level)


# ---------------------------------------------------------------------------
# prebarrier fence + cross-device summary
# ---------------------------------------------------------------------------

class DeviceFence:
    """The reference's ``prebarrier`` (prebarrier.cpp:1-21, an MPI_Barrier
    timed before collectives to separate load imbalance from comm time).

    JAX analog: enqueue a trivial elementwise op on EVERY device and block
    until all are ready — the wait time is exactly how long the busiest
    device's queue still had to drain (the async-dispatch skew the MPI
    barrier would have absorbed)."""

    def __init__(self, devices=None):
        self.devices = list(devices or jax.devices())
        self._bufs = [
            jax.device_put(jax.numpy.zeros((), jax.numpy.float32), d)
            for d in self.devices
        ]
        self._fn = jax.jit(lambda x: x + 1.0)

    def __call__(self) -> float:
        t0 = time.perf_counter()
        jax.block_until_ready([self._fn(b) for b in self._bufs])
        return time.perf_counter() - t0


_FENCE: Optional[DeviceFence] = None


def prebarrier() -> float:
    """Time a fence across all devices; returns seconds waited."""
    global _FENCE
    if _FENCE is None:
        _FENCE = DeviceFence()
    return _FENCE()


@contextmanager
def timed(name: str, block_on=None, with_prebarrier: bool = False):
    """Context manager that records wall time for ``name``.

    ``block_on``: optional array/pytree whose readiness gates the stop stamp
    (callers pass the output of a jitted op so async dispatch is accounted).
    ``with_prebarrier``: fence all devices first and record the wait as the
    op's prebarrier time (ppTiming's RecordTime prebarrier argument).
    """
    pre = prebarrier() if with_prebarrier else 0.0
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        target = holder.get("block_on", block_on)
        if target is not None:
            jax.block_until_ready(target)
        _REGISTRY.record(name, time.perf_counter() - t0, prebarrier=pre)


def summarize_across_devices(
    per_device: Dict[str, "object"],
    print_fn: Callable[[str], None] = print,
) -> str:
    """``SummarizeTimeAcrossProcesses`` analog (ppTiming.cpp:220-338): one
    controller drives all chips, so the cross-rank MPI reduction becomes a
    table over per-device values the caller gathered (step times, particle
    counts, migration counts...).  Prints min/avg/max and imbalance per op
    so load imbalance is visible at a glance."""
    import numpy as np

    lines = ["Cross-device summary (op, min, avg, max, imb):"]
    for name in sorted(per_device):
        v = np.asarray(jax.device_get(per_device[name]), dtype=np.float64)
        avg = float(v.mean()) if v.size else 0.0
        imb = float(v.max() / avg) if avg > 0 else 1.0
        lines.append(
            f"  {name:<40s} min={v.min():.6g} avg={avg:.6g} "
            f"max={v.max():.6g} imb={imb:.3f}"
        )
    out = "\n".join(lines)
    if print_fn is not None:
        print_fn(out)
    return out


@contextmanager
def profiling_region(name: str):
    """Kokkos::Profiling::pushRegion analog → jax named scope + trace annotation."""
    with jax.profiler.TraceAnnotation(name):
        with jax.named_scope(name):
            yield
