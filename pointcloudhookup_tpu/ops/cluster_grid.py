"""Grid-accelerated Euclidean clustering (the fast path).

`ops.cluster.dbscan` is exact but O(N^2) in the filtered point count; at
corridor scale the way out is to quantize space into cells of eps/2 and
cluster the CELL graph:

  * all points in one cell are mutually within eps (cell diagonal
    (eps/2)*sqrt(3) < eps), so per-point neighborhoods are approximated
    by summing the populations of cells whose centers lie within eps;
  * cells are built with one device sort + segment reductions (no hash
    maps), giving a packed cell table of M << N entries;
  * core/connectivity/label propagation then run on the M-cell graph —
    O(M^2) tiled passes (ops/neighbor.py) instead of O(N^2) — and point
    labels are a single gather from cell labels.

Semantics are cell-quantized DBSCAN: identical partitions whenever
cluster separations are larger than ~2 cells (towers are hundreds of
meters apart vs eps = 8 m), which is the regime the reference's own
approximations live in (per-chunk DBSCAN, /root/reference/utils/
tower_extraction.py:104-116, splits clusters far more aggressively).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from pointcloudhookup_tpu.ops.cluster import compact_labels
from pointcloudhookup_tpu.ops.neighbor import cluster_cells

_SENTINEL = jnp.int32(2**30)


@functools.partial(
    jax.jit,
    static_argnames=(
        "min_points", "max_cells", "tile", "max_iters", "min_cell_points",
        "return_overflow",
    ),
)
def grid_dbscan(
    xyz,
    mask,
    eps,
    min_points: int,
    *,
    max_cells: int = 65536,
    tile: int = 1024,
    max_iters: int = 64,
    min_cell_points: int = 1,
    return_overflow: bool = False,
):
    """Cell-graph DBSCAN.

    xyz: f32[N,3], mask: bool[N].  Returns (labels i32[N] compact ids /
    -1 noise, core bool[N]) — plus, with return_overflow=True, the
    number of DENSE cells that did not fit the table (f32 scalar).

    max_cells bounds the packed cell table used for the O(M^2) graph
    passes.  min_cell_points drops cells with fewer points BEFORE
    packing: at corridor scale, sparse vegetation occupies hundreds of
    thousands of 1-2 point cells that can never contribute to a
    min_points=80 cluster but would overflow the table; dense structures
    (towers, buildings) survive.  Points in dropped cells become noise.
    Cells beyond max_cells are dropped the same way — callers should
    check the overflow count (pipeline.extract retries with a higher
    cell-density floor) because dropped DENSE cells can lose structures.
    """
    n = xyz.shape[0]
    m = max_cells
    eps = jnp.float32(eps)
    cell = eps / 2.0
    big = jnp.float32(3.0e38)

    from pointcloudhookup_tpu.ops.segments import (
        boundary_flags,
        segmented_scan,
    )

    # ---- assign cell keys and sort points by cell
    mn = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    ijk = jnp.floor((xyz - mn) / cell).astype(jnp.int32)
    ijk = jnp.where(mask[:, None], ijk, _SENTINEL)
    idx = jnp.arange(n, dtype=jnp.int32)
    kx, ky, kz, order = lax.sort((ijk[:, 0], ijk[:, 1], ijk[:, 2], idx), num_keys=3)
    is_start = boundary_flags(kx, ky, kz)
    valid_sorted = kx != _SENTINEL
    w = valid_sorted.astype(jnp.float32)

    # ---- per-row segment population: reverse segmented scan puts the
    # total at the start row; a forward max-scan broadcasts it across the
    # segment (scan+scan instead of scan+gather)
    totals = segmented_scan(jnp.add, w, is_start, reverse=True)
    count_row = segmented_scan(
        jnp.maximum, jnp.where(is_start, totals, 0.0), is_start
    )
    dense_row = valid_sorted & (count_row >= jnp.float32(min_cell_points))

    # packed cell index per sorted row: advances at dense segment starts
    pidx_row = jnp.cumsum((is_start & dense_row).astype(jnp.int32)) - 1
    cell_sorted = jnp.where(dense_row & (pidx_row < m), pidx_row, m)

    # ---- pack the dense-cell table: one 2-operand sort finds the start
    # rows in packed order, then 4 m-sized gathers copy the payloads
    # (much lighter than sorting 5 full payload columns)
    pack_key = jnp.where(is_start & (cell_sorted < m), cell_sorted, m)
    row_iota = jnp.arange(n, dtype=jnp.int32)
    _, packed_rows = lax.sort((pack_key, row_iota), num_keys=1)
    rows_m = jnp.clip(packed_rows[:m], 0, n - 1) if m <= n else jnp.clip(
        jnp.concatenate([packed_rows, jnp.zeros(m - n, jnp.int32)]), 0, n - 1
    )
    counts = count_row[rows_m]
    ckx = kx[rows_m]
    cky = ky[rows_m]
    ckz = kz[rows_m]
    table_rank = jnp.arange(m, dtype=jnp.int32)
    n_dense = jnp.sum((is_start & (cell_sorted < m)).astype(jnp.int32))
    cell_alive = table_rank < n_dense
    counts = jnp.where(cell_alive, counts, 0.0)
    centers = (jnp.stack([ckx, cky, ckz], axis=1).astype(jnp.float32) + 0.5) * cell
    centers = jnp.where(cell_alive[:, None], centers, big)

    # point -> packed cell map back in original order (unsort via sort)
    _, cell_of_point = lax.sort((order, cell_sorted), num_keys=1)

    # ---- cell-graph DBSCAN over the packed table (tiled pairwise
    # passes, min-label flood with pointer jumping)
    cell_labels, pop = cluster_cells(
        centers, counts, cell_alive, eps * eps, min_points,
        max_iter=max_iters, tile=tile,
    )
    core_cell = cell_alive & (pop >= jnp.float32(min_points))
    cell_labels = compact_labels(cell_labels, jnp.int32(m))

    # ---- back to points
    cp = jnp.clip(cell_of_point, 0, m - 1)
    labels = jnp.where(mask & (cell_of_point < m), cell_labels[cp], -1)
    core = mask & (cell_of_point < m) & core_cell[cp]
    if return_overflow:
        n_true_dense = jnp.sum((is_start & dense_row).astype(jnp.int32))
        overflow = jnp.maximum(n_true_dense - jnp.int32(m), 0).astype(
            jnp.float32
        )
        return labels, core, overflow
    return labels, core
