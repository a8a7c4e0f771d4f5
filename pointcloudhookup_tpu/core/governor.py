"""Resource governor: RAM/HBM-aware auto-sizing of chunk capacities.

The reference sizes work to the machine instead of OOMing on big tiles:
chunk_size picked from available RAM (500k/1M/2M points for 4/8/16 GB,
/root/reference/ui/Sampling.py:88-89) and processing capped to a
max-memory percentage with a hard point ceiling
(/root/reference/test/008.py:109,231-243).

The equivalents sized here:

  host  — the streaming staging cost per point (f64 decode copy + f32
          padded upload buffer + mask, ~44 B live per point per
          prefetch slot, x prefetch depth);
  device— the extract step's peak device footprint per input point,
          against the device's memory limit minus a safety fraction.
          On the CPU platform the "device" is host memory.

Capacities snap DOWN onto a power-of-two ladder so repeated runs reuse
jit caches instead of recompiling per file size.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

# bytes per point (see module docstring).  DEVICE_BYTES_PER_POINT:
# peak_bytes_in_use per input point after extract, run-all and
# stream-extract [--fast] at the 4M-point corridor tile was 82 B on an
# NVIDIA H100 80GB HBM3 at a 400 W power limit (chip_smoke.py, phase
# lines), rounded up.
HOST_BYTES_PER_POINT = 44
DEVICE_BYTES_PER_POINT = 96

_LADDER = [1 << s for s in range(14, 27)]  # 16k .. 64M points


@dataclasses.dataclass
class ResourceBudget:
    host_available: int  # bytes
    device_budget: int  # bytes (device memory limit; host memory on CPU)
    capacity: int  # points per device chunk
    chunk_size: int  # points per host processing chunk
    reason: str


def host_available_bytes() -> int:
    """MemAvailable from /proc/meminfo (psutil fallback)."""
    try:
        with open("/proc/meminfo") as f:
            m = re.search(r"MemAvailable:\s+(\d+) kB", f.read())
        if m:
            return int(m.group(1)) * 1024
    except OSError:
        pass
    try:
        import psutil

        return int(psutil.virtual_memory().available)
    except Exception:
        return 4 << 30  # the reference's smallest RAM class


def device_memory_bytes(device=None) -> int:
    """Memory the extract step may use on `device` (default: the first
    JAX device): the runtime's `bytes_limit` on an accelerator, the
    host's available memory on the CPU platform.  A device that is not
    the CPU and reports no limit is an error."""
    if device is None:
        import jax

        device = jax.devices()[0]
    if getattr(device, "platform", None) == "cpu":
        return host_available_bytes()
    stats = None
    try:
        stats = device.memory_stats()
    except Exception:
        pass
    lim = (stats or {}).get("bytes_limit")
    if not lim:
        raise ValueError(
            f"device {getattr(device, 'device_kind', device)!r} reports no "
            "memory limit; pass an explicit capacity"
        )
    return int(lim)


def _snap_down(n: int) -> int:
    best = _LADDER[0]
    for v in _LADDER:
        if v <= n:
            best = v
    return best


def auto_capacity(
    *,
    device=None,
    max_memory_percent: float = 30.0,
    device_memory_fraction: float = 0.6,
    prefetch: int = 1,
    hard_cap: Optional[int] = None,
    n_points: Optional[int] = None,
) -> int:
    """Points per device chunk sized to BOTH host staging RAM and HBM.

    max_memory_percent mirrors test/008.py:109 (default 30% of available
    host RAM may hold staging buffers); device_memory_fraction leaves
    headroom for XLA temporaries beyond the measured per-point envelope.
    hard_cap is the explicit override (the reference's ≤2M cap analogue);
    n_points, when known, avoids over-allocating for small inputs.
    """
    host_budget = int(host_available_bytes() * max_memory_percent / 100.0)
    host_cap = host_budget // (HOST_BYTES_PER_POINT * max(prefetch + 1, 2))
    dev_budget = int(device_memory_bytes(device) * device_memory_fraction)
    dev_cap = dev_budget // DEVICE_BYTES_PER_POINT
    cap = min(host_cap, dev_cap)
    if hard_cap is not None:
        cap = min(cap, hard_cap)
    cap = max(cap, _LADDER[0])
    cap = _snap_down(cap)
    if n_points is not None and n_points > 0:
        # smallest ladder rung that holds the whole input in one chunk,
        # but never beyond the memory-derived cap
        for v in _LADDER:
            if v >= n_points:
                return min(v, cap)
    return cap


def auto_chunk_size(*, max_memory_percent: float = 30.0) -> int:
    """Host-side processing chunk following the reference's RAM ladder
    (ui/Sampling.py:88-89: 500k/1M/2M points for 4/8/16 GB), scaled by
    the same available-memory budget as auto_capacity."""
    avail_gb = host_available_bytes() / (1 << 30)
    if avail_gb >= 16:
        base = 2_000_000
    elif avail_gb >= 8:
        base = 1_000_000
    else:
        base = 500_000
    # very large hosts scale past the reference's table linearly, capped
    # at 16M points per chunk to bound single-chunk latency
    if avail_gb > 32:
        base = min(int(base * avail_gb / 16.0), 16_000_000)
    return int(base * min(max_memory_percent, 100.0) / 30.0)


def budget(
    *,
    device=None,
    max_memory_percent: float = 30.0,
    prefetch: int = 1,
    hard_cap: Optional[int] = None,
    n_points: Optional[int] = None,
) -> ResourceBudget:
    host = host_available_bytes()
    dev = device_memory_bytes(device)
    cap = auto_capacity(
        device=device,
        max_memory_percent=max_memory_percent,
        prefetch=prefetch,
        hard_cap=hard_cap,
        n_points=n_points,
    )
    chunk = auto_chunk_size(max_memory_percent=max_memory_percent)
    return ResourceBudget(
        host_available=host,
        device_budget=dev,
        capacity=cap,
        chunk_size=chunk,
        reason=(
            f"host {host / (1 << 30):.1f} GiB avail @ {max_memory_percent:.0f}%"
            f", device {dev / (1 << 30):.1f} GiB -> capacity {cap:,}"
            f", chunk {chunk:,}"
        ),
    )


def estimate_points(las_path: str) -> Optional[int]:
    """Cheap point-count probe from the LAS header (no full decode)."""
    try:
        from pointcloudhookup_tpu.io.las import peek_point_count

        return peek_point_count(las_path)
    except Exception:
        try:
            return max(os.path.getsize(las_path) // 28, 1)
        except OSError:
            return None
