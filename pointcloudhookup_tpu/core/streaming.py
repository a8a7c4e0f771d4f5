"""Double-buffered host -> device tile streaming.

BASELINE config 5 is a multi-tile 50M+ point corridor run; the host must
decode the next LAS tile while the device processes the current one.
The reference's analogue is sequential chunk loops with disk barriers
(/root/reference/ui/import_PC.py:45-58); here a background thread
prefetches (decode + pad + jax.device_put) one tile ahead, so device
compute and host I/O overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _dequantize_u16(q, scale, shift, n):
    """Device-side u16 lattice -> centered f32 coords + validity mask.
    q: u16[capacity,3]; scale/shift: f32[3]; n: valid row count."""
    xyz = q.astype(jnp.float32) * scale[None, :] + shift[None, :]
    mask = jnp.arange(q.shape[0], dtype=jnp.int32) < n
    return jnp.where(mask[:, None], xyz, 0.0), mask


class TileStreamer:
    """Iterates (xyz f32[capacity,3] device, mask bool[capacity] device,
    meta dict) over a sequence of tile sources with one-tile prefetch.

    `sources` yields either file paths (decoded with io.las.read_las) or
    numpy f64[N,3] arrays.  Tiles larger than capacity are split.

    wire="f32" ships padded f32[capacity,3] + bool[capacity] (13 B/pt,
    exact).  wire="u16" quantizes each chunk to tile-local u16 lattice
    coordinates on the host and dequantizes + masks ON DEVICE (6 B/pt —
    2.2x fewer bytes over transfer-limited links; lattice pitch =
    chunk extent / 65535, ~3 cm on a 2 km tile, far inside the 0.1 m
    voxel the extraction pipeline quantizes to anyway).
    """

    def __init__(
        self,
        sources: Iterable,
        capacity: Optional[int] = None,
        origin: Optional[np.ndarray] = None,
        device=None,
        decode: Optional[Callable] = None,
        prefetch: int = 1,
        max_memory_percent: float = 30.0,
        wire: str = "f32",
        max_pitch: Optional[float] = 0.05,
    ):
        if wire not in ("f32", "u16"):
            raise ValueError(f"wire must be 'f32' or 'u16', got {wire!r}")
        self.wire = wire
        # u16 lattice pitch guard: a sparse/long chunk (e.g. a corridor
        # spanning >~6.5 km per 65535 steps at 0.1 m voxels) would get a
        # quantization step coarser than the voxel grid and silently
        # shift voxel assignments.  Chunks whose pitch (extent/65535 on
        # the widest axis) exceeds max_pitch fall back to exact f32
        # transport; None disables the guard.  0.05 m = half the 0.1 m
        # extraction voxel (quantization noise stays sub-voxel; the
        # 2 km-tile operating point at ~3 cm pitch keeps the u16 wire).
        self.max_pitch = max_pitch
        self.sources = list(sources)
        self.origin = None if origin is None else np.asarray(origin, np.float64)
        self.device = device
        self.decode = decode
        self.prefetch = max(1, prefetch)
        if capacity is None:
            # RAM/HBM-governed auto-sizing (reference analogue:
            # ui/Sampling.py:88-89, test/008.py:109,231-243)
            from pointcloudhookup_tpu.core.governor import auto_capacity, estimate_points

            biggest = 0
            for s in self.sources:
                if isinstance(s, np.ndarray):
                    biggest = max(biggest, len(s))
                else:
                    n = estimate_points(str(s))
                    biggest = max(biggest, n or 0)
            capacity = auto_capacity(
                device=self.device,
                prefetch=self.prefetch,
                max_memory_percent=max_memory_percent,
                n_points=biggest or None,
            )
        self.capacity = capacity

    def _load(self, source) -> np.ndarray:
        if self.decode is not None:
            return np.asarray(self.decode(source), np.float64)
        if isinstance(source, np.ndarray):
            return np.asarray(source, np.float64)
        # native C++ decode when available (no Python object overhead on
        # the streaming critical path), else the pure-Python reader
        from pointcloudhookup_tpu.native import las_read_xyz

        xyz = las_read_xyz(str(source))
        if xyz is not None:
            return xyz
        from pointcloudhookup_tpu.io.las import read_las

        return read_las(source).xyz()

    def _chunks(self) -> Iterator[tuple[np.ndarray, dict]]:
        for i, src in enumerate(self.sources):
            pts = self._load(src).reshape(-1, 3)
            for start in range(0, max(len(pts), 1), self.capacity):
                chunk = pts[start : start + self.capacity]
                yield chunk, dict(tile=i, offset=start, source=src, n=len(chunk))

    def _prepare(self, chunk: np.ndarray, meta: dict):
        origin = self.origin if self.origin is not None else (
            chunk.mean(axis=0) if len(chunk) else np.zeros(3)
        )
        n = len(chunk)
        wire = self.wire
        lo = chunk.min(axis=0) if n else np.zeros(3)
        hi = chunk.max(axis=0) if n else np.zeros(3)
        if wire == "u16":
            scale = np.maximum((hi - lo) / 65535.0, 1e-9)
            if self.max_pitch is not None and float(scale.max()) > self.max_pitch:
                wire = "f32"  # lattice too coarse for this chunk: go exact
        if wire == "u16":
            q = np.zeros((self.capacity, 3), np.uint16)
            if n:
                q[:n] = np.clip(np.rint((chunk - lo) / scale), 0, 65535)
            qa = jnp.asarray(q)
            if self.device is not None:
                qa = jax.device_put(qa, self.device)
            xa, ma = _dequantize_u16(
                qa,
                jnp.asarray(scale.astype(np.float32)),
                jnp.asarray((lo - origin).astype(np.float32)),
                jnp.int32(n),
            )
        else:
            xyz = np.zeros((self.capacity, 3), np.float32)
            xyz[:n] = (chunk - origin).astype(np.float32)
            mask = np.zeros(self.capacity, bool)
            mask[:n] = True
            xa = jnp.asarray(xyz)
            ma = jnp.asarray(mask)
            if self.device is not None:
                xa = jax.device_put(xa, self.device)
                ma = jax.device_put(ma, self.device)
        meta = dict(meta, origin=origin, wire=wire, span=hi - lo)
        return xa, ma, meta

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        errors: list[BaseException] = []

        def producer():
            try:
                for chunk, meta in self._chunks():
                    q.put(self._prepare(chunk, meta))
            except BaseException as e:  # surfaced on the consumer side
                errors.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if errors:
            raise errors[0]


def stream_extract(
    sources,
    capacity: Optional[int] = None,
    params=None,
    origin: Optional[np.ndarray] = None,
    fetch_labels: bool = False,
    wire: str = "u16",
    fast: bool = False,
    prefetch: int = 1,
    timings: bool = False,
    precut_div: int = 4,
):
    """Run the extraction step over streamed tiles; returns a list of
    per-tile (stats dict numpy, meta).  One-tile prefetch keeps the
    device busy while the host decodes.

    Only the [K]-sized tower summaries are pulled to host by default;
    the per-point label/mask arrays (capacity-sized) stay on device
    unless fetch_labels=True — hauling them back dominates wall time on
    transfer-limited links.  The wire format defaults to the u16
    lattice (6 B/pt, ~cm pitch: invisible next to the 0.1 m extraction
    voxel); pass wire="f32" for exact coordinates.  fast=True runs the
    fused geometric front-end + sort-free OBB per tile (the bench fast
    mode: positions quantize to voxel centers, bounded by
    tests/test_fast_vs_parity.py) instead of the modular parity step.
    A tile whose cell table spills re-runs at a higher cell-density
    floor, as pipeline.extract_from_points does."""
    from pointcloudhookup_tpu.config import ExtractParams
    from pointcloudhookup_tpu.models.towers import extract_step

    params = params or ExtractParams()
    if fast:
        from pointcloudhookup_tpu.ops.frontend_fused import (
            fused_extract_step,
        )

        def step(xyz, mask, floor):
            # full sort + ground pre-cut: the pre-cut shrinks the sorted
            # row count itself (auto-disabled on small tiles; capacity
            # overflow rides stats["cells_overflow"]).  precut_div=0
            # reverts to the full-row fast path: the pre-cut base comes
            # from a RAW strided z sample, which skews vs the voxel-dedup
            # base by up to (density skew x terrain relief) on
            # uneven-density tiles (docs/PARITY.md).
            return fused_extract_step(
                xyz, mask, params, geometric_voxels=True,
                min_cell_points=floor, sort_mode="full",
                precut_div=precut_div,
            )
    else:
        import dataclasses

        def step(xyz, mask, floor):
            p = dataclasses.replace(
                params,
                cluster=dataclasses.replace(
                    params.cluster, min_cell_points=floor
                ),
            )
            return extract_step(xyz, mask, p)

    point_sized = ("labels", "ground_keep", "ds_xyz")
    results = []
    import time as _time

    for xyz, mask, meta in TileStreamer(
        sources, capacity, origin=origin, wire=wire, prefetch=prefetch
    ):
        t0 = _time.perf_counter() if timings else 0.0
        # a spilled cell table drops dense cells (and with them whole
        # towers): re-run the tile at a higher cell-density floor, the
        # retry contract of pipeline.extract_from_points
        floor = max(params.cluster.min_cell_points, 1)
        stats = step(xyz, mask, floor)
        while float(np.asarray(stats["cells_overflow"])) > 0.0 and floor < 16:
            floor = min(floor * 2 if floor > 1 else 2, 16)
            stats = step(xyz, mask, floor)
        out = {}
        for k, v in stats.items():
            if k in point_sized and not fetch_labels:
                out[k] = v  # leave on device
            else:
                out[k] = np.asarray(v)
        if timings:
            # wall time of dispatch + the host-blocking [K] fetches —
            # the consumer-side budget a prefetch depth must cover for
            # the producer to stay ahead (on-PCIe tuning hook)
            meta = dict(meta, step_seconds=_time.perf_counter() - t0)
        results.append((out, meta))
    return results
