"""Exact-semantics extraction front-end at fast-path speed.

`pipeline.extract` is the reference-semantics product surface
(extract_towers, /root/reference/utils/tower_extraction.py:20-240); its
modular device program (ground_filter -> grid_dbscan -> cluster_obb_stats)
pays a 3-key sort, a pack sort, an unsort and a full-N label sort — the
bench fast path is ~20x quicker but buys that with two documented
approximations (strided percentile sample, geometric voxel centers).
This module back-ports the fast path's *semantics-preserving* wins into
an exact program:

  * the global P25 ground base is computed EXACTLY by radix bisection on
    the order-preserving u32 view of z (33 masked [N] count passes,
    bit-identical to masked_percentile) — no [N] sort, and unlike the
    fast path's pre-sort sample there is no sample-vs-final threshold
    discrepancy to provision for: the cut below uses the exact base;
  * above-ground survivors (raw f32 coordinates + original row index)
    are stream-compacted to a fixed N/compact_div capacity
    (ops/compact.py), so the sort and every downstream pass run at the
    survivor count (~15-25% of a corridor tile);
  * ONE single-u32-key sort (tight-interleaved eps/2 cell key, raw
    coordinates riding as payloads) replaces grid_dbscan's 3-key sort +
    pack sort + unsort;
  * the cell-graph clustering runs a pairwise population pass over the
    dense-cell table and the min-label flood on its compacted core
    cells only (ops/neighbor.py) -- identical partition semantics to
    ops/cluster_grid.py::grid_dbscan: same eps/2 cells anchored at the
    same f32 min corner, same center-distance connectivity, same
    pop >= min_points core rule, same border adoption (the min-label
    fixpoint is seed-order independent);
  * per-cluster OBB statistics accumulate sort-free over the raw
    coordinates (ops/obb_accum.py::obb_accumulate_xyz) -- exact
    member sets, exact centroids/extremes, no per-cluster cap.

Per-point labels come back in cell-sorted order together with each
row's ORIGINAL index; the host scatters them back in numpy (a device
unsort would cost a second full sort).  Semantics match extract_step
with cluster method="grid": same ground keep set, same cluster
partition, same per-cluster point counts; cluster ids and f32 summation
order may differ (centroids to f32 tolerance), and the min-area angle
grid is the accumulation kernel's flat pi/2/A scan instead of the sort
path's coarse+refine search (same resolution).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from pointcloudhookup_tpu.config import ExtractParams
from pointcloudhookup_tpu.ops.cluster import compact_labels
from pointcloudhookup_tpu.ops.compact import compact_indices, compact_rows_multi
from pointcloudhookup_tpu.ops.morton import interleave_tight
from pointcloudhookup_tpu.ops.neighbor import cluster_cells, neighbor_reduce
from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate_xyz
from pointcloudhookup_tpu.ops.percentile import masked_percentile_bisect
from pointcloudhookup_tpu.ops.segments import segmented_scan

_KEY_SENTINEL = jnp.uint32(0xFFFFFFFF)

def _core_flood_cluster(
    centers, ccount, cell_alive, eps2, min_points,
    core_cap: int = 16384,
):
    """grid_dbscan's cell-graph fixpoint, restructured so the REPEATED
    passes run on the small core subgraph instead of the full table:

      1. ONE tiled pairwise pass (ops/neighbor.py) computes every dense
         cell's eps-ball population -> core mask.  Sparse vegetation
         dominates a corridor's dense-cell table but almost none of it
         is core: paying O(pairs) once is unavoidable (every cell's
         count feeds its neighbours' pops), paying it per label walk is
         not.
      2. Core cells compact into a [core_cap] table; the min-label
         flood (cluster_cells, min_points=0 so every row floods) runs
         there at core-count cost.  The compaction is order-preserving,
         so the flood's min-index representative maps back to the min
         PACKED index: identical labels to grid_dbscan's full-table
         flood.
      3. Border adoption is ONE more pass in "lmin" mode with
         allowed=core.

    Returns (labels i32[M] -- representative packed index, M = noise --
    and core_overflow f32: core cells beyond core_cap, which makes the
    flood incomplete; callers must treat the result as invalid and fall
    back)."""
    m = centers.shape[0]
    sent = jnp.int32(m)
    iota_m = jnp.arange(m, dtype=jnp.int32)

    # -- 1. pop over the full dense table (one pairwise pass)
    pop, _ = neighbor_reduce(
        centers, jnp.zeros(m, jnp.int32), ccount, cell_alive, eps2,
        sentinel=m, mode="pop",
    )
    core = cell_alive & (pop >= jnp.float32(min_points))

    # -- 2. compact core cells; flood on the small table
    cap = min(core_cap, m)
    (core_rows,), n_core = compact_rows_multi(core, (iota_m,), cap)
    core_overflow = jnp.maximum(n_core - cap, 0).astype(jnp.float32)
    slot_ok = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(
        n_core, jnp.int32(cap)
    )
    big = jnp.float32(3.0e38)
    core_centers = jnp.where(
        slot_ok[:, None], centers[jnp.clip(core_rows, 0, m - 1)], big
    )
    tab_labels, _ = cluster_cells(
        core_centers, jnp.ones(cap, jnp.float32), slot_ok, eps2, 0.0,
    )
    # core-table index -> original packed index (order-preserving)
    rep = jnp.where(
        slot_ok & (tab_labels < cap),
        core_rows[jnp.clip(tab_labels, 0, cap - 1)],
        sent,
    )

    # -- 3. labels back on the full table + border adoption
    lab_core = jnp.full(m, sent).at[
        jnp.where(slot_ok, core_rows, sent)
    ].set(jnp.where(slot_ok, rep, sent), mode="drop")
    _, border = neighbor_reduce(
        centers, lab_core, jnp.zeros(m, jnp.float32), core, eps2,
        sentinel=m, mode="lmin",
    )
    labels = jnp.where(core, lab_core, jnp.where(cell_alive, border, sent))
    return labels, core_overflow


def exact_cell_plan(span_xyz, eps: float):
    """Host-side plan: per-axis cell-key bit widths for a tile.

    span_xyz: per-axis extent in meters (max - min, host floats).
    Returns a static (bx, by, bz) with sum <= 31 (the all-ones key is
    reserved as the invalid-row sentinel), or None when the tile's cell
    grid cannot be packed into a single u32 key (caller falls back to
    the modular path).  +2 index margin absorbs f32 floor() slack
    against the f64 host span.
    """
    cell = float(eps) / 2.0
    bits = []
    for s in span_xyz:
        max_idx = int(math.floor(max(float(s), 0.0) / cell)) + 2
        bits.append(max(max_idx.bit_length(), 1))
    if sum(bits) > 31:
        return None
    return tuple(bits)


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "cell_bits", "compact_cap", "max_cells",
        "min_cell_points", "core_cap", "_cut", "axis_name",
        "local_rows", "return_acc",
    ),
)
def exact_extract_graph(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    cell_bits: tuple,
    compact_cap: int,
    max_cells: int = 65536,
    min_cell_points: int = 1,
    core_cap: int = 16384,
    _cut: int = 0,
    axis_name: str | None = None,
    local_rows: int | None = None,
    return_acc: bool = False,
):
    """Exact extraction forward step (see module docstring).

    xyz f32[N,3] centered coords, mask bool[N];
    compact_cap: survivor capacity (<= N);
    cell_bits: static per-axis key widths from exact_cell_plan();
    core_cap: core-cell flood-table capacity — corridor tiles have ~1k
      core cells in a ~40k dense table, so a small table floods much
      faster; a core_overflow > 0 result is INVALID and callers escalate
      (see _extract_stats_exact_fast's x4 retry ladder).

    Returns a dict:
      per-cluster stats [K] (count, alive, centroid, center, extent,
      angle, north_angle, aabb_min, aabb_max, overflow) + accepted[K];
      labels_sorted i32[C] (cluster id / -1) and rows_sorted i32[C]
      (original row index; only rows < compact_count are meaningful);
      scalars: base_height, used_retry (bool), compact_count (i32, TRUE
      survivor count — > compact_cap means the tail was dropped),
      cells_overflow (f32: dense cells beyond max_cells + 1.0 if the
      compaction capacity overflowed).

    Multi-device (inside shard_map; parallel/sharded.py mode='exact'):
      axis_name: psums the ground-percentile bisection (EXACT global
        np.percentile over the union of shards) and pmins the cell-grid
        anchor, so every shard cuts and quantizes identically;
      local_rows: rows >= local_rows are halo ghosts — they participate
        in clustering (full eps-neighborhood at tile boundaries) but are
        excluded from the ground percentile and the OBB accumulators
        (their home shard counts them), making the gathered merge exact;
      return_acc: also return the raw accumulators under 'acc' for the
        cross-shard exact merge.
    """
    from pointcloudhookup_tpu.models.towers import filter_and_dedup

    n = xyz.shape[0]
    m = max_cells
    c = compact_cap
    gp = params.ground
    cp = params.cluster
    if sum(cell_bits) > 31:
        raise ValueError(f"cell_bits {cell_bits} exceed 31 bits")
    big = jnp.float32(3.0e38)
    eps = jnp.float32(cp.eps)
    cell = eps / 2.0

    # ---- exact ground base + cut (reference semantics:
    # /root/reference/utils/tower_extraction.py:83-89); with axis_name
    # the base and the retry decision are global and replicated
    z = xyz[:, 2]
    # halo ghosts are counted by their home shard: the percentile and
    # the retry count see local rows only
    local = mask
    if local_rows is not None:
        local = mask & (jnp.arange(n, dtype=jnp.int32) < jnp.int32(local_rows))
    base = masked_percentile_bisect(z, local, gp.percentile, axis_name)
    keep0 = mask & (z > base + jnp.float32(gp.offset))
    n0 = jnp.sum((keep0 & local).astype(jnp.int32))
    if axis_name is not None:
        n0 = lax.psum(n0, axis_name)
    used_retry = n0 < gp.min_points_after
    keep = jnp.where(
        used_retry, mask & (z > base + jnp.float32(gp.retry_offset)), keep0
    )

    # ---- compact survivors (raw coords + original row index)
    idx = jnp.arange(n, dtype=jnp.int32)
    (xs0, ys0, zs0, rows_c), cnt = compact_rows_multi(
        keep, (xyz[:, 0], xyz[:, 1], z, idx), c
    )
    compact_over = (cnt > jnp.int32(c)).astype(jnp.float32)
    valid0 = jnp.arange(c, dtype=jnp.int32) < jnp.minimum(cnt, jnp.int32(c))

    # ---- cell keys: identical assignment arithmetic to grid_dbscan
    # (floor((p - mn) / (eps/2)) against the kept-set f32 min corner;
    # pmin'd across shards so every shard's grid shares one anchor)
    mn = jnp.stack(
        [
            jnp.min(jnp.where(valid0, v, big))
            for v in (xs0, ys0, zs0)
        ]
    )
    if axis_name is not None:
        mn = lax.pmin(mn, axis_name)
    i0 = jnp.floor((xs0 - mn[0]) / cell).astype(jnp.int32)
    i1 = jnp.floor((ys0 - mn[1]) / cell).astype(jnp.int32)
    i2 = jnp.floor((zs0 - mn[2]) / cell).astype(jnp.int32)
    ck = interleave_tight(i0, i1, i2, cell_bits)
    ck = jnp.where(valid0, ck, _KEY_SENTINEL)

    # ---- ONE single-key sort; coordinates + original rows as payloads
    ck_s, xs, ys, zs, rows_s = lax.sort(
        (ck, xs0, ys0, zs0, rows_c), num_keys=1
    )
    valid_s = ck_s != _KEY_SENTINEL
    c_start = (ck_s != jnp.roll(ck_s, 1)).at[0].set(True)

    # ---- per-cell population -> dense-cell start flags
    ctot = segmented_scan(
        jnp.add, valid_s.astype(jnp.int32), c_start, reverse=True
    )
    dense_start = c_start & valid_s & (ctot >= jnp.int32(min_cell_points))

    # ---- pack the dense-cell table: start row of every dense cell
    n_dense = jnp.sum(dense_start.astype(jnp.int32))
    cell_alive = jnp.arange(m, dtype=jnp.int32) < n_dense
    rows_m = jnp.minimum(compact_indices(dense_start, m), jnp.int32(c - 1))
    ccount = jnp.where(cell_alive, ctot[rows_m].astype(jnp.float32), 0.0)
    px, py, pz = xs[rows_m], ys[rows_m], zs[rows_m]
    # cell centers relative to mn, recomputed from a member coordinate
    # with the SAME f32 arithmetic as the key assignment above (the
    # start row's point is in the cell by definition; identical values
    # to grid_dbscan's (k + 0.5) * cell)
    cij = jnp.stack(
        [
            jnp.floor((px - mn[0]) / cell),
            jnp.floor((py - mn[1]) / cell),
            jnp.floor((pz - mn[2]) / cell),
        ],
        axis=1,
    )
    centers = jnp.where(cell_alive[:, None], (cij + 0.5) * cell, big)

    # _cut: early exits that return a stage's intermediates (chip_smoke.py
    # checks the dense-cell table at 4 and the labelled rows at 6)
    if _cut == 4:
        return dict(centers=centers, ccount=ccount, cell_alive=cell_alive)

    # ---- cell-graph clustering: one pairwise pop pass, then the
    # min-label flood on the compacted CORE subgraph (see
    # _core_flood_cluster: almost every dense cell of a corridor tile is
    # sparse vegetation, so flooding the full table would repeat its
    # pairwise pass on every label walk)
    eps2 = eps * eps
    cell_labels, core_overflow = _core_flood_cluster(
        centers, ccount, cell_alive, eps2, cp.min_points, core_cap=core_cap,
    )
    cell_labels = compact_labels(cell_labels, jnp.int32(m))

    # ---- per-row labels: deliver each packed cell's label to its start
    # row (m-sized scatter, dead slots dropped) and forward-fill across
    # the cell run
    lab_at_start = jnp.full(c, -1, jnp.int32).at[
        jnp.where(cell_alive, rows_m, jnp.int32(c))
    ].set(jnp.where(cell_alive, cell_labels, -1), mode="drop")
    lab_row = segmented_scan(jnp.maximum, lab_at_start, c_start)
    labels_s = jnp.where(valid_s & (lab_row >= 0), lab_row, -1)

    if _cut == 6:
        return dict(labels_s=labels_s, xs=xs, ys=ys, zs=zs)

    # ---- sort-free OBB over the raw coordinates + acceptance filters.
    # Halo ghost rows (original index >= local_rows) informed the
    # density/connectivity decisions above but are accumulated by their
    # home shard only — label them out here.
    labels_acc = labels_s
    if local_rows is not None:
        labels_acc = jnp.where(rows_s < jnp.int32(local_rows), labels_s, -1)
    acc = obb_accumulate_xyz(
        xs, ys, zs, labels_acc, max_clusters=params.max_clusters,
        num_angles=params.obb_angles,
    )
    from pointcloudhookup_tpu.ops.obb import _obb_from_accum

    stats = _obb_from_accum(acc, params.max_clusters, params.obb_angles)
    accepted = filter_and_dedup(stats, params.filters)

    cells_overflow = (
        jnp.maximum(n_dense - jnp.int32(m), 0).astype(jnp.float32)
        + compact_over
    )
    out = dict(
        accepted=accepted,
        labels_sorted=labels_s,
        rows_sorted=rows_s,
        base_height=base,
        used_retry=used_retry,
        compact_count=cnt,
        cells_overflow=cells_overflow,
        core_overflow=core_overflow,
        **stats,
    )
    if return_acc:
        out["acc"] = acc
    return out
