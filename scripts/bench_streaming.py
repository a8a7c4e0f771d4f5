"""Config-5 benchmark: multi-tile streamed extraction throughput.

8 x 1M-point synthetic tiles stream host->device (double-buffered) into
the extraction step; reports end-to-end input Mpts/s for both wire
formats (the u16 wire ships 2.2x fewer bytes than f32).

Usage: python scripts/bench_streaming.py [n_tiles] [tile_mpts]
"""

import sys
import time

import numpy as np


def main():
    import jax

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.core.streaming import stream_extract
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

    n_tiles = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    tile_n = int(float(sys.argv[2]) * 1024 * 1024) if len(sys.argv) > 2 else 1 << 20

    rng = np.random.default_rng(3)
    tiles = []
    for i in range(n_tiles):
        pts, _ = synthetic_corridor(
            rng,
            n_ground=int(tile_n * 0.8),
            n_veg=int(tile_n * 0.12),
            pts_per_tower=(tile_n - int(tile_n * 0.92)) // 3,
            extent=1000.0,
            origin=(i * 2000.0, 0.0, 50.0),
            n_line=0,
        )
        tiles.append(pts[:tile_n])
    total = sum(len(t) for t in tiles)
    params = ExtractParams(cluster=ClusterParams())
    origin = np.array([0.0, 0.0, 50.0])

    for wire, fast in (("u16", True), ("u16", False), ("f32", False)):
        # warm the jit caches on tile 0
        stream_extract(
            tiles[:1], capacity=tile_n, params=params, origin=origin,
            wire=wire, fast=fast,
        )
        t0 = time.perf_counter()
        results = stream_extract(
            tiles, capacity=tile_n, params=params, origin=origin,
            wire=wire, fast=fast,
        )
        dt = time.perf_counter() - t0
        towers = sum(int(s["accepted"].sum()) for s, _ in results)
        print(
            f"wire={wire} fast={fast}: {total/1e6:.0f} Mpts in {dt:.1f} s -> "
            f"{total/dt/1e6:.2f} Mpts/s ({towers} towers)",
            flush=True,
        )


if __name__ == "__main__":
    main()
