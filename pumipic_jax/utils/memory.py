"""Device memory telemetry.

Reference parity: ``support/ppMemUsage.hpp:25-34`` (``getMemUsage`` via
cudaMemGetInfo) and the per-step memory-imbalance telemetry in
``test/pseudoXGCm.cpp:17-39``, read from ``device.memory_stats()``.  A device
that keeps no memory statistics (the CPU backend) is an error, never a
zero reading.
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax


def get_mem_usage(device=None) -> Tuple[int, int]:
    """Return (free_bytes, total_bytes) for one device.

    Raises ``RuntimeError`` when the device reports no memory statistics."""
    dev = device or jax.devices()[0]
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {dev} ({dev.platform}) reports no memory statistics")
    total = stats["bytes_limit"]
    used = stats["bytes_in_use"]
    return (max(total - used, 0), total)


def memory_imbalance() -> Dict[str, float]:
    """Max/avg used-bytes imbalance across local devices (pseudoXGCm.cpp:17-39)."""
    used = []
    for d in jax.local_devices():
        free, total = get_mem_usage(d)
        used.append(total - free)
    if not used or sum(used) == 0:
        return {"max": 0, "avg": 0.0, "imbalance": 1.0}
    avg = sum(used) / len(used)
    return {"max": max(used), "avg": avg, "imbalance": max(used) / avg if avg else 1.0}
