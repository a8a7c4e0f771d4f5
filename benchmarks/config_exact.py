"""Exact-semantics extraction throughput.

Measures the exact fast front-end (ops/frontend_exact.py) that backs
extract_from_points on eligible tiles: identical ground cut / cluster
partition / per-cluster counts to the modular extract_step
(tests/test_exact_frontend.py), no fast-path approximations.

Prints one JSON line with the settled-graph throughput at the bench
workload (4M corridor, 24 towers) plus the routing result.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()

    import bench
    from pointcloudhookup_tpu.config import ExtractParams
    from pointcloudhookup_tpu.models.pipeline import (
        _exact_fast_plan,
        _extract_stats_exact_fast,
    )
    from pointcloudhookup_tpu.ops.frontend_exact import exact_extract_graph

    n = 4 * 1024 * 1024
    xyz, mask, centers = bench.build_workload(n)
    params = ExtractParams()
    pts64 = xyz[mask].astype(np.float64)
    plan = _exact_fast_plan(pts64, params, n)

    # correctness through the product routing (includes retries)
    stats = _extract_stats_exact_fast(xyz, mask, params, plan)
    towers_found = int(stats["accepted"].sum())

    # settled-graph throughput (floor from the routing's retry outcome).
    # The survivor-compaction capacity is settled from the MEASURED
    # survivor count (compact_count is the true pre-truncation count, so
    # sizing to it is exact); the product routing keeps the static N/4
    # so one compiled graph serves every tile, but a fixed-tile
    # benchmark can right-size.
    ccap = n // 4
    xyz_j = jnp.asarray(xyz)
    mask_j = jnp.asarray(mask)
    floor = params.cluster.min_cell_points
    core_cap = 2048  # the routing's starting flood-table capacity
    sized_ccap = False
    while True:
        out = exact_extract_graph(
            xyz_j, mask_j, params, cell_bits=plan, compact_cap=ccap,
            max_cells=params.cluster.max_cells, min_cell_points=floor,
            core_cap=core_cap,
        )
        if float(np.asarray(out["core_overflow"])) > 0.0 and core_cap < 32768:
            need = core_cap + int(np.asarray(out["core_overflow"]))
            core_cap = min(32768, 1 << (need - 1).bit_length())
            continue
        if float(np.asarray(out["cells_overflow"])) > 0.0 and floor < 16:
            floor = min(floor * 2 if floor > 1 else 2, 16)
            continue
        if not sized_ccap:
            sized_ccap = True
            count = int(np.asarray(out["compact_count"]))
            tight = max(-(-count // 1024) * 1024, 1024)
            if tight < ccap:
                ccap = tight
                continue
        # the settled graph must report a clean cut at the tight cap
        assert int(np.asarray(out["compact_count"])) <= ccap
        break

    def run():
        return exact_extract_graph(
            xyz_j, mask_j, params, cell_bits=plan, compact_cap=ccap,
            max_cells=params.cluster.max_cells, min_cell_points=floor,
            core_cap=core_cap,
        )

    for _ in range(2):
        jax.block_until_ready(run())
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    mpts = n / dt / 1e6
    print(json.dumps(dict(
        metric="exact_extract_throughput", value=mpts,
        unit="Mpts/s", n_points=n, towers_found=towers_found,
        towers_expected=len(centers),
        ms_per_iter=dt * 1e3, density_floor=floor,
        core_cap=core_cap, compact_cap=ccap,
        device=str(jax.devices()[0].device_kind),
        semantics="exact (parity with modular extract_step: "
                  "tests/test_exact_frontend.py)",
    )))


if __name__ == "__main__":
    main()
