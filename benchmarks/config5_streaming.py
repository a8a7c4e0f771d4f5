"""BASELINE config 5: multi-tile corridor streaming — host LAS decode
overlapped with device extraction via TileStreamer.

The tiles are REAL LAS FILES on disk (BASELINE's "multi-tile LAS
(50M+ pts)": 50 x 1M-point tiles written once and cached under
PCH_TILES_DIR, by default pch_bench_tiles in the temp directory), so
the streamed pipeline exercises the full ingest path: native C++ LAS
decode -> u16 wire quantization -> device dequantize ->
extraction, with the producer thread decoding tile k+1 while the
device runs tile k.

Prints one JSON line that SEPARATES the pipeline's four rates so the
artifact is self-proving on any link:

  * value / end_to_end_mpts: wall-clock Mpts/s over all tiles (the
    number a user sees),
  * decode: host-side LAS-file -> f64 array rate (native codec),
  * transport: measured host->device bytes/s + the wire bytes/point,
  * device_step: compute-only ms/tile for the per-tile extraction graph
    (resident input, fenced batch of dispatches) and the derived
    compute-only Mpts/s — the rate the same pipeline sustains once the
    host->device link is not the bottleneck,
  * prefetch sweep: end-to-end at depths 1/2/4 (overlap tuning).

PCH_N_TILES / PCH_TILE_N override the 50 x 1M default;
PCH_IN_MEMORY=1 reverts to the old in-memory-array tiles (no decode).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# the temp directory follows TMPDIR, so two checkouts run with their own
# TMPDIR never share tiles
TILES_DIR = os.environ.get(
    "PCH_TILES_DIR", os.path.join(tempfile.gettempdir(), "pch_bench_tiles")
)


def _tile_path(t: int, tile_n: int) -> str:
    return os.path.join(TILES_DIR, f"tile_{tile_n}_{t:03d}.las")


def build_tile_files(n_tiles: int, tile_n: int, log=print) -> list:
    """Write (once, cached) n_tiles synthetic-corridor LAS tiles."""
    from bench import build_workload
    from pointcloudhookup_tpu.io.las import make_las, write_las

    os.makedirs(TILES_DIR, exist_ok=True)
    paths = []
    for t in range(n_tiles):
        path = _tile_path(t, tile_n)
        if not os.path.exists(path):
            xyz, mask, _ = build_workload(tile_n, seed=t)
            pts = np.asarray(xyz[mask], np.float64)
            pts += np.array([t * 4500.0, 0.0, 0.0])
            write_las(make_las(pts, scales=[0.001, 0.001, 0.001]), path)
            log(f"  wrote {path} ({len(pts)} pts)")
        paths.append(path)
    return paths


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()

    from bench import build_workload
    from pointcloudhookup_tpu.config import ExtractParams, ClusterParams
    from pointcloudhookup_tpu.core.streaming import TileStreamer, stream_extract

    in_memory = os.environ.get("PCH_IN_MEMORY", "0") == "1"
    n_tiles = int(os.environ.get("PCH_N_TILES", "8" if in_memory else "50"))
    tile_n = int(os.environ.get("PCH_TILE_N", str(1 << 20)))
    decode = None
    if in_memory:
        tiles = []
        for t in range(n_tiles):
            xyz, mask, _ = build_workload(tile_n)
            tiles.append(
                np.asarray(xyz[mask], np.float64)
                + np.array([t * 4500.0, 0, 0])
            )
        total = sum(len(t) for t in tiles)
    else:
        print(f"building {n_tiles} x {tile_n} LAS tiles (cached) ...",
              file=sys.stderr)
        tiles = build_tile_files(
            n_tiles, tile_n, log=lambda s: print(s, file=sys.stderr)
        )
        # ---- decode rate: native C++ LAS codec, one full tile
        from pointcloudhookup_tpu.native import las_read_xyz

        pts0 = las_read_xyz(tiles[0])
        native = pts0 is not None
        if not native:
            from pointcloudhookup_tpu.io.las import read_las

            pts0 = read_las(tiles[0]).xyz()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            if native:
                pts0 = las_read_xyz(tiles[0])
            else:
                pts0 = read_las(tiles[0]).xyz()
        dt_d = (time.perf_counter() - t0) / reps
        decode = dict(
            codec="native_cpp" if native else "python",
            seconds_per_tile=round(dt_d, 4),
            mpts_per_second=round(len(pts0) / dt_d / 1e6, 2),
        )
        from pointcloudhookup_tpu.native import las_probe

        if native:
            total = sum(las_probe(p)[0] for p in tiles)
        else:
            total = n_tiles * len(pts0)

    fast = os.environ.get("PCH_FAST", "0") == "1"
    params = ExtractParams(
        cluster=ClusterParams(method="grid", max_cells=8192, min_cell_points=3)
    )

    # ---- warm (compile) on one tile
    stream_extract(tiles[:1], capacity=tile_n, params=params, fast=fast)

    # ---- transport-only: ship one prepared tile repeatedly, fence per
    # batch (the wire is the u16 lattice, 6 B/pt + mask-free)
    streamer = TileStreamer(tiles[:1], capacity=tile_n, wire="u16")
    chunk, meta0 = next(streamer._chunks())
    reps = 8
    t0 = time.perf_counter()
    for _ in range(reps):
        xa, ma, _ = streamer._prepare(chunk, meta0)
    _ = np.asarray(xa[0:1, 0])  # fence
    dt_t = (time.perf_counter() - t0) / reps
    wire_bytes = tile_n * 6  # u16[capacity,3]
    transport = dict(
        wire="u16",
        bytes_per_point=6,
        seconds_per_tile=round(dt_t, 4),
        bytes_per_second=round(wire_bytes / dt_t),
        mpts_per_second=round(tile_n / dt_t / 1e6, 2),
    )

    # ---- compute-only: resident tile, queued dispatches, one fence
    from pointcloudhookup_tpu.models.towers import extract_step
    from pointcloudhookup_tpu.ops.frontend_fused import fused_extract_step

    def step(x, m):
        if fast:
            return fused_extract_step(
                x, m, params, geometric_voxels=True,
                min_cell_points=max(params.cluster.min_cell_points, 1),
                sort_mode="full", precut_div=4,
            )
        return extract_step(x, m, params)

    def fence(s):
        return np.asarray(s["accepted"][0:1])

    fence(step(xa, ma))
    iters = 32
    dt_c = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            s = step(xa, ma)
        fence(s)
        dt_c = min(dt_c, (time.perf_counter() - t0) / iters)
    device_step = dict(
        ms_per_tile=round(dt_c * 1e3, 2),
        mpts_per_second=round(tile_n / dt_c / 1e6, 2),
        mode="fast" if fast else "modular",
    )

    # ---- end-to-end at several prefetch depths
    sweep = {}
    best = (None, 0.0)
    for depth in (1, 2, 4):
        t0 = time.perf_counter()
        results = stream_extract(
            tiles, capacity=tile_n, params=params, fast=fast, prefetch=depth
        )
        dt = time.perf_counter() - t0
        mpts = total / dt / 1e6
        sweep[f"prefetch_{depth}"] = round(mpts, 2)
        if mpts > best[1]:
            best = (results, mpts, dt, depth)
    results, mpts, dt, depth = best
    towers = sum(int(s["accepted"].sum()) for s, _ in results)

    rates = dict(
        transport=transport["mpts_per_second"],
        compute=device_step["mpts_per_second"],
    )
    if decode is not None:
        rates["decode"] = decode["mpts_per_second"]
    out = dict(
        metric="streaming_extract", value=round(mpts, 2), unit="Mpts/s",
        tiles=n_tiles, total_points=total, towers_found=towers,
        wall_s=round(dt, 2), best_prefetch=depth,
        prefetch_sweep=sweep,
        transport=transport,
        device_step=device_step,
        bound_by=min(rates, key=rates.get),
    )
    if decode is not None:
        out["decode"] = decode
    print(json.dumps(out))


if __name__ == "__main__":
    main()
