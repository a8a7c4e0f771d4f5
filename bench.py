"""Extraction front-end throughput on one GPU.

Times the fused front-end (voxel downsample -> global height-percentile
ground filter -> cell-graph clustering -> sort-free OBB stats + filters)
as one jitted program over the benchmark corridor tile
(io/synthetic.py::corridor_tile: 4M points, 24 towers), and prints one
JSON line with input Mpts/s (median of ITERS timed steps, each ended by
block_until_ready) and the device it ran on.  Refuses to run without a
GPU: a CPU number is not a device number.

PCH_BENCH_MPTS (tile size in Mi points), PCH_BENCH_CELLS (dense-cell
table) and PCH_BENCH_PRECUT (ground pre-cut divisor) override the
defaults.
"""

import functools
import json
import os
import subprocess
import time

import numpy as np

N_POINTS = int(float(os.environ.get("PCH_BENCH_MPTS", "4")) * 1024 * 1024)
WARMUP = 2
ITERS = 20


def build_workload(n, seed=7):
    from pointcloudhookup_tpu.io.synthetic import corridor_tile

    pts, centers = corridor_tile(n, seed=seed)
    origin = pts.mean(axis=0)
    xyz = np.zeros((n, 3), np.float32)
    xyz[: len(pts)] = (pts - origin).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[: len(pts)] = True
    return xyz, mask, centers


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    setup_compilation_cache()

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.models.towers import filter_and_dedup
    from pointcloudhookup_tpu.ops.frontend_fused import (
        fused_downsample_ground_cluster,
    )
    from pointcloudhookup_tpu.ops.obb import cluster_obb_stats_accum

    params = ExtractParams(cluster=ClusterParams())
    max_cells = int(os.environ.get("PCH_BENCH_CELLS", "4096"))
    # ground pre-cut: rows above a sampled ground cut go into an
    # N/precut_div buffer.  4 is the survivor capacity the product's exact
    # path starts at (models/pipeline.py); a tighter divisor can spill,
    # which cells_overflow in the result line reports.
    precut_div =int(os.environ.get("PCH_BENCH_PRECUT", "4"))

    @functools.partial(jax.jit)
    def frontend(xyz, mask):
        hi, lo, keep, labels, base, mn, cells_over, _ = (
            fused_downsample_ground_cluster(
                xyz, mask, params, max_cells=max_cells, min_cell_points=3,
                geometric_voxels=True, emit="codes", precut_div=precut_div,
                return_cells_overflow=True,
            )
        )
        stats = cluster_obb_stats_accum(
            hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        accepted = filter_and_dedup(stats, params.filters)
        return accepted, cells_over

    xyz_np, mask_np, centers = build_workload(N_POINTS)
    xyz = jnp.asarray(xyz_np)
    mask = jnp.asarray(mask_np)
    for _ in range(WARMUP):
        out = jax.block_until_ready(frontend(xyz, mask))
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(frontend(xyz, mask))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    result = {
        "metric": "extract_frontend_throughput",
        "value": N_POINTS / dt / 1e6,
        "unit": "Mpts/s",
        "detail": {
            "n_points": N_POINTS,
            "step_s_median": dt,
            "step_s_min": float(np.min(times)),
            "step_s_max": float(np.max(times)),
            "towers_found": int(np.asarray(out[0]).sum()),
            "towers_expected": len(centers),
            "cells_overflow": float(out[1]),
            "max_cells": max_cells,
            "precut_div": precut_div,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card[0] if card else "not measured",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
