"""Fused extraction front-end: ONE Morton sort for downsample + cluster.

The modular pipeline sorts the cloud twice (voxel keys, then cell keys)
and unsorts once.  Because a cell of size voxel*2^k shares the Morton
PREFIX of its voxels, a single Morton sort makes both voxel runs and
cell runs contiguous:

  raw points --Morton sort--> voxel runs --reverse segscan--> voxel
  centroids at run starts --global z percentile--> ground keep -->
  cell runs (prefix boundaries) --reverse segscan--> dense-cell table
  --tiled pairwise passes--> cell labels --> per-voxel labels -->
  cluster_obb_stats (which label-sorts internally) --> towers

With voxel = 0.1 m and cell_shift = 5, cells are 3.2 m: the same-cell
diagonal (5.5 m) stays below the reference eps = 8 m, so the cell-graph
clustering semantics match ops/cluster_grid.py.

Everything is one device program except the OBB/filters (reused ops):
one Morton sort, a strided-sample percentile, one m-table gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from pointcloudhookup_tpu.config import ExtractParams
from pointcloudhookup_tpu.ops.cluster import compact_labels
from pointcloudhookup_tpu.ops.compact import compact_indices, compact_rows
from pointcloudhookup_tpu.ops.morton import SENTINEL_HI, morton_encode
from pointcloudhookup_tpu.ops.neighbor import cluster_cells
from pointcloudhookup_tpu.ops.percentile import masked_percentile
from pointcloudhookup_tpu.ops.segments import segmented_scan


def hier_sort_eligible(span_xyz, voxel_size: float = 0.1,
                       cell_shift: int = 5) -> bool:
    """True when a tile's Morton codes fit the single-u32 cell key that
    sort_mode='hier' needs (max code >> 3*cell_shift < 2**32 - 1).

    span_xyz: per-axis extent in meters (max - min), host values.
    Monotonicity of the Morton spread means the max-corner code bounds
    every point's code, so a host-side corner check suffices.
    """
    import numpy as _np

    idx = _np.floor(
        _np.asarray(span_xyz, _np.float64) / float(voxel_size)
    ).astype(_np.int64)
    if (idx >= (1 << 20)).any() or (idx < 0).any():
        return False

    def _spread(v):
        v = int(v)
        out = 0
        for b in range(20):
            out |= ((v >> b) & 1) << (3 * b)
        return out

    code = _spread(idx[0]) | (_spread(idx[1]) << 1) | (_spread(idx[2]) << 2)
    return (code >> (3 * cell_shift)) < 0xFFFFFFFF


def cell_sort_plan(span_xyz, eps: float = 8.0, voxel_size: float = 0.1,
                   cell_shift: int = 5):
    """Host-side plan for sort_mode='cell' with a TIGHT packed key.

    Standard Morton reserves 20 bit positions per axis, so a corridor
    tile's cell-level code barely fits u32 even though the z span only
    needs ~11 bits.  Packing the cell key with interleave_tight frees
    the dead positions; the reclaimed g bits carry the TOP g bits of
    the within-cell code, which shrinks equal-key runs by ~2^g and with
    them the dupwin depth the dedup pass needs (64 -> 16 at g >= 2).

    Returns (bx, by, bz, g, depth) — static per tile-shape class — or
    None when the tile cannot use the packed key (fall back to
    'hier'/'full').  Mirrors the in-jit cell_shift adjustment so the
    plan and the trace agree on the cell size.
    """
    import math

    import numpy as _np

    idx = _np.floor(
        _np.asarray(span_xyz, _np.float64) / float(voxel_size)
    ).astype(_np.int64)
    if (idx >= (1 << 20)).any() or (idx < 0).any():
        return None
    safe_shift = int(math.floor(math.log2(
        max(eps / (math.sqrt(3.0) * voxel_size), 1e-6))))
    cs = max(2, min(cell_shift, safe_shift))
    bits = [max(int(v).bit_length(), 1) for v in idx]
    cell_bits = sum(max(b - cs, 0) for b in bits)
    if cell_bits > 30:
        return None
    g = min(32 - cell_bits, 3 * cs)
    if g < 2:
        return None
    depth = 0 if g == 3 * cs else 16
    return (bits[0], bits[1], bits[2], g, depth)


def _dup_window_flags(key, w, depth: int, n: int):
    """bool[N] first-occurrence flags: row i is first iff no j in
    [i-depth, i) has equal (key, w) -- a rolled compare chain."""
    w32 = w.astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    dup = jnp.zeros(n, bool)
    for d in range(1, depth + 1):
        dup = dup | (
            (jnp.roll(key, d) == key)
            & (jnp.roll(w32, d) == w32)
            & (pos >= d)
        )
    return jnp.logical_not(dup)


def window_sort(k1, w, window: int = 256):
    """Restore (k1, w) order within `window`-row windows at offsets 0
    and window/2 of a k1-sorted array (batched lax.sort).  Every k1-run
    of length <= window/2 + 1 lies wholly inside a window of one of the
    two passes, and a later pass never un-sorts a run an earlier one
    ordered, so such runs end exactly (k1, w)-sorted.  Returns (k1, w)."""
    n = k1.shape[0]
    pad = (-n) % window
    if pad:
        k1 = jnp.concatenate([k1, jnp.full(pad, 0xFFFFFFFF, k1.dtype)])
        w = jnp.concatenate([w, jnp.full(pad, 0x7FFF, w.dtype)])

    def _winsort(a, b):
        a2, b2 = lax.sort(
            (a.reshape(-1, window), b.reshape(-1, window)),
            dimension=1,
            num_keys=2,
        )
        return a2.reshape(-1), b2.reshape(-1)

    k1, w = _winsort(k1, w)
    half = window // 2
    if k1.shape[0] > window:
        mid_k, mid_w = _winsort(k1[half:-half], w[half:-half])
        k1 = lax.dynamic_update_slice(k1, mid_k, (half,))
        w = lax.dynamic_update_slice(w, mid_w, (half,))
    return k1[:n], w[:n]


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_cells", "min_cell_points", "cell_shift",
        "geometric_voxels", "emit", "return_cells_overflow",
        "sort_mode", "hier_window", "cell_plan", "precut_div",
        "precut_margin", "core_flood_cells", "core_cap", "axis_name",
    ),
)
def fused_downsample_ground_cluster(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    max_cells: int = 8192,
    min_cell_points: int = 2,
    cell_shift: int = 5,
    voxel_size: float = 0.1,
    geometric_voxels: bool = False,
    emit: str = "xyz",
    ground_override=None,
    return_cells_overflow: bool = False,
    sort_mode: str = "full",
    hier_window: int = 256,
    cell_plan=None,
    precut_div: int = 0,
    precut_margin: float = 0.25,
    core_flood_cells: int = 16384,
    core_cap: int = 16384,
    axis_name: str | None = None,
):
    """One-pass voxel downsample + global ground filter + cell-graph
    clustering.

    Returns (ds_xyz f32[N,3] voxel centroids at run-start rows,
    ds_mask bool[N] kept-above-ground voxels, labels i32[N] compact
    cluster ids at those rows / -1, base_height scalar).

    geometric_voxels=True replaces per-voxel centroids with geometric
    voxel centers (Morton-decoded, pure elementwise): downstream
    positions quantize to voxel_size/2 but the expensive [N,4]
    segmented centroid scan reduces to a 1-column occupancy scan.

    emit="codes" (geometric mode only) skips the [N,3] voxel-center
    materialization — only the z channel is decoded for the ground
    filter — and returns (hi, lo, keep, labels, base, mn) so the OBB
    stage can sort Morton codes (one payload fewer) and decode on its
    dense [K, P] member tensor instead (cluster_obb_stats_codes).

    core_cap: core-cell flood-table capacity for the core-flood branch
    (m >= core_flood_cells); on overflow the incomplete flood is
    reported through cells_overflow and callers escalate or fall back.

    axis_name (inside shard_map): pmin the grid anchor across shards.
    """
    if emit not in ("xyz", "codes"):
        raise ValueError(f"emit must be 'xyz' or 'codes', got {emit!r}")
    if emit == "codes" and not geometric_voxels:
        raise ValueError("emit='codes' requires geometric_voxels=True")
    if sort_mode not in ("full", "hier", "cell"):
        raise ValueError(
            f"sort_mode must be 'full', 'hier' or 'cell', got {sort_mode!r}"
        )
    if sort_mode in ("hier", "cell") and not geometric_voxels:
        raise ValueError(f"sort_mode={sort_mode!r} requires geometric_voxels=True")
    n = xyz.shape[0]
    m = max_cells
    gp = params.ground
    cp = params.cluster
    # cell-graph soundness: two points in 3D-diagonal-adjacent cells can
    # be arbitrarily close, so the cell DIAGONAL must stay under eps or
    # a cluster can split on a cell-phase accident (center-distance
    # connectivity misses the sqrt(3)*cell 3D diagonal).  cell_shift is
    # therefore a CAP; the effective shift shrinks with eps.  At the
    # reference eps = 8 m the default 3.2 m cells are unchanged.
    import math

    safe_shift = int(math.floor(math.log2(
        max(cp.eps / (math.sqrt(3.0) * voxel_size), 1e-6))))
    cell_shift = max(2, min(cell_shift, safe_shift))
    eps = jnp.float32(cp.eps)
    big = jnp.float32(3.0e38)
    shift3k = 3 * cell_shift

    # ---- Morton keys + ONE sort.  Coordinates ride as payloads only
    # when true centroids are needed; geometric mode sorts 3 operands.
    mn = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    if axis_name is not None:
        # one anchor for every shard (the global min corner, as a
        # single-device run over the union computes it): voxel AND cell
        # lattices then agree bit for bit across shards, so a
        # boundary-split tower clusters and boxes exactly as it would on
        # one device
        mn = lax.pmin(mn, axis_name)
    # snap the grid origin to the voxel lattice (multiples of voxel_size
    # in the tile frame), so tilings of one corridor share voxel
    # boundaries
    mn = jnp.floor(mn / voxel_size) * voxel_size
    v = jnp.floor((xyz - mn) / voxel_size).astype(jnp.int32)
    hi, lo = morton_encode(v[:, 0], v[:, 1], v[:, 2])
    hi = jnp.where(mask, hi, SENTINEL_HI)

    # ---- ground pre-cut + stream compaction (fast mode): ~75-80% of a
    # corridor tile is below the ground cut and only ever feeds the
    # percentile.  Estimate the base from a strided RAW-z sample BEFORE
    # the sort (the post-sort fast path samples voxel rows instead -- the
    # delta is bounded by voxel-occupancy skew and vanishes at <~1
    # pt/voxel after 0.1 m voxelization), drop everything below base +
    # offset - margin, and compact the survivors (ops/compact.py) so the
    # sort and every downstream [N] pass run at N/precut_div.  The final
    # keep test below re-tests voxel-center z against the SAME base, so
    # the margin only needs to cover the raw-z vs voxel-center-z
    # discrepancy (voxel/2).
    # Cutting at the RETRY offset instead would be exact under retry
    # too, but ground undulation between the two cuts can blow the
    # capacity (45% vs 15% of the bench tile): the retry branch only
    # fires on near-empty tiles (< min_points_after voxels), so it is
    # flagged for a resolver re-run rather than provisioned for.
    # Dropped-tail overflow (kept > capacity) folds into cells_overflow
    # so models/overflow.py re-runs the tile split in four.
    precut_dropped = None
    precut_base = None
    if precut_div and sort_mode == "full" and geometric_voxels \
            and emit == "codes" and xyz.shape[0] >= 131072:
        # capacity rounds UP to 1024 rows: more slack never changes
        # results (extra rows are sentinel-padded)
        cap = -(-(xyz.shape[0] // precut_div) // 1024) * 1024
        if ground_override is not None:
            # multi-shard callers already hold the GLOBAL psum'd base
            # AND the retry decision, so the pre-cut threshold is exact
            # (no offset-vs-retry ambiguity to provision for)
            base_o, use_retry_o = ground_override
            pre_thresh = (
                base_o
                + jnp.where(use_retry_o, gp.retry_offset, gp.offset)
                - jnp.float32(precut_margin)
            )
        else:
            stride = max(n >> 14, 16)
            zs = xyz[::stride, 2]
            ms = mask[::stride]
            pre_base = masked_percentile(
                jnp.where(ms, zs, jnp.inf), ms, gp.percentile
            )
            pre_thresh = (
                pre_base + jnp.float32(gp.offset) - jnp.float32(precut_margin)
            )
            precut_base = pre_base  # retry logic still applies below
        keep_pre = mask & (xyz[:, 2] > pre_thresh)
        hi, lo, pre_count = compact_rows(keep_pre, hi, lo, cap)
        precut_dropped = jnp.maximum(
            pre_count - jnp.int32(cap), 0
        ).astype(jnp.float32)
        n = cap
        mask = None  # consumed: sentinel keys now carry validity
    if geometric_voxels:
        # keys only: masked-out rows carry the sentinel key, and every
        # non-sentinel row has weight 1, so the per-voxel point count is
        # never needed — voxel validity is just `hi != SENTINEL` at run
        # starts.  Saves one sort payload AND the [N] count scan.
        v_first = None
        if sort_mode == "cell":
            # ONE single-key sort and NO order restoration — the only
            # thing within-cell ORDER ever fed in geometric/emit-codes
            # mode is the adjacent-row voxel dedup test, and dedup FLAGS
            # don't need order: a windowed duplicate-suppression pass
            # (_dup_window_flags) yields exact first-occurrence flags
            # for every equal-key run
            # <= depth+1.  Longer runs may count a duplicate voxel
            # twice (reported via hier_runs_over); cell grouping stays
            # exact, and per-cluster min/max/count stats are multiset-
            # invariant, so accepted towers match 'full' under the
            # guarantee (centroids to f32 summation order).
            #
            # With a cell_plan (cell_sort_plan()), the key is a TIGHT
            # interleave of the cell coordinates (per-axis bit widths
            # from the tile span — a flat corridor wastes ~9 z bit
            # positions in the standard Morton layout) plus the top g
            # within-cell bits: equal-key runs shrink ~2^g, so the
            # dedup window depth drops 64 -> 16, and at
            # g == 3*cell_shift the key IS the full voxel
            # key and dedup is an exact adjacent compare.  hi/lo ride
            # as near-free payloads, so every downstream stage sees
            # standard codes and nothing else changes.
            if cell_plan is not None:
                bxp, byp, bzp, gbits, depth = cell_plan
                cs = cell_shift
                cbits = (max(bxp - cs, 0), max(byp - cs, 0), max(bzp - cs, 0))
                from pointcloudhookup_tpu.ops.morton import interleave_tight

                ck = interleave_tight(
                    v[:, 0] >> cs, v[:, 1] >> cs, v[:, 2] >> cs, cbits
                )
                w15 = (lo & ((1 << shift3k) - 1)).astype(jnp.uint32)
                ksort = (ck << gbits) | (w15 >> (shift3k - gbits))
                ksort = jnp.where(mask, ksort, jnp.uint32(0xFFFFFFFF))
                ksort, hi, lo = lax.sort((ksort, hi, lo), num_keys=1)
                # masked rows carry garbage lo; -1 can never equal a
                # real row's non-negative low bits, so a masked row can
                # never mark a real voxel as duplicate
                w_low = jnp.where(
                    hi == SENTINEL_HI,
                    jnp.int32(-1),
                    lo & ((1 << (shift3k - gbits)) - 1),
                )
                if depth == 0:
                    pos0 = jnp.arange(n, dtype=jnp.int32)
                    v_first = (
                        (ksort != jnp.roll(ksort, 1)) | (pos0 == 0)
                    )
                else:
                    v_first = _dup_window_flags(ksort, w_low, depth, n)
                run_key = ksort
            else:
                # untight fallback: u32 cell code key (code >> 3k must
                # fit u32 — hier_sort_eligible), full within-cell code
                # as payload, depth-64 window
                depth = 64
                k1 = (hi.astype(jnp.uint32) << (30 - shift3k)) | (
                    lo.astype(jnp.uint32) >> shift3k
                )
                k1 = jnp.where(mask, k1, jnp.uint32(0xFFFFFFFF))
                w16 = (lo & ((1 << shift3k) - 1)).astype(jnp.uint16)
                k1, w16 = lax.sort((k1, w16), num_keys=1)
                v_first = _dup_window_flags(k1, w16, depth, n)
                lo = (
                    ((k1 & ((1 << (30 - shift3k)) - 1)) << shift3k)
                    | w16.astype(jnp.uint32)
                ).astype(jnp.int32)
                hi = jnp.where(
                    k1 == jnp.uint32(0xFFFFFFFF),
                    SENTINEL_HI,
                    (k1 >> (30 - shift3k)).astype(jnp.int32),
                )
                run_key = k1
        elif sort_mode == "hier":
            # Hierarchical sort: ONE single-key sort by the u32 CELL
            # code k1 = C >> 3k groups cells exactly, with the 3k
            # within-cell bits riding as a u16 payload; then two offset
            # window sorts of length hier_window restore full (k1, w)
            # order wherever a cell's run length <= hier_window/2 + 1
            # (window_sort).  Cells denser than that keep exact cell
            # grouping but may count a duplicate voxel twice —
            # thresholds are unaffected (such cells are far above
            # min_cell_points/min_points) and box centers/extents are
            # duplicate-insensitive; callers check eligibility with
            # hier_sort_eligible() (codes must fit the u32 cell key).
            k1 = (hi.astype(jnp.uint32) << (30 - shift3k)) | (
                lo.astype(jnp.uint32) >> shift3k
            )
            k1 = jnp.where(mask, k1, jnp.uint32(0xFFFFFFFF))
            w16 = (lo & ((1 << shift3k) - 1)).astype(jnp.uint16)
            k1, w16 = lax.sort((k1, w16), num_keys=1)
            k1, w16 = window_sort(k1, w16, hier_window)
            lo = (
                ((k1 & ((1 << (30 - shift3k)) - 1)) << shift3k)
                | w16.astype(jnp.uint32)
            ).astype(jnp.int32)
            hi = jnp.where(
                k1 == jnp.uint32(0xFFFFFFFF),
                SENTINEL_HI,
                (k1 >> (30 - shift3k)).astype(jnp.int32),
            )
        else:
            hi, lo = lax.sort((hi, lo), num_keys=2)
        sx = sy = sz = None
    else:
        v_first = None
        w_in = mask.astype(jnp.float32)
        hi, lo, sx, sy, sz, w = lax.sort(
            (hi, lo, xyz[:, 0], xyz[:, 1], xyz[:, 2], w_in), num_keys=2
        )

    # ---- voxel runs -> centroids/counts at run-start rows.  In cell
    # mode the windowed dedup pass already produced first-occurrence
    # flags (within-cell rows are unordered, so adjacent-row comparison
    # would miss non-adjacent duplicates).
    if v_first is not None:
        v_start = v_first
    else:
        v_start = ((hi != jnp.roll(hi, 1)) | (lo != jnp.roll(lo, 1))).at[0].set(True)
    if geometric_voxels and emit == "codes":
        from pointcloudhookup_tpu.ops.morton import _compact10

        # only the z channel feeds the ground filter; x/y are never
        # materialized (the OBB decodes them on its [K,P] member tensor)
        viz = _compact10(lo >> 2) | (_compact10(hi >> 2) << 10)
        vz_col = (viz.astype(jnp.float32) + 0.5) * voxel_size + mn[2]
        vcent = None
        voxel_valid = v_start & (hi != SENTINEL_HI)
    elif geometric_voxels:
        from pointcloudhookup_tpu.ops.morton import morton_decode

        vix, viy, viz = morton_decode(hi, lo)
        vcent = (
            jnp.stack([vix, viy, viz], axis=1).astype(jnp.float32) + 0.5
        ) * voxel_size + mn[None, :]
        vz_col = None
        voxel_valid = v_start & (hi != SENTINEL_HI)
    else:
        vals = jnp.stack([sx * w, sy * w, sz * w, w], axis=1)
        vtot = segmented_scan(jnp.add, vals, v_start, reverse=True)
        vcount = vtot[:, 3]
        vcent = vtot[:, :3] / jnp.maximum(vcount, 1.0)[:, None]
        vz_col = None
        voxel_valid = v_start & (vcount > 0.0) & (hi != SENTINEL_HI)

    # ---- global ground percentile over voxel centroids.  In geometric
    # (fast) mode, a strided sample suffices: rows are Morton-sorted, so
    # every 16th row is a spatially stratified sample (~cm quantile
    # error at corridor scale) and the percentile sort shrinks 16x.
    zcol = vz_col if vcent is None else vcent[:, 2]
    if ground_override is not None:
        # multi-shard callers supply a GLOBAL (psum'd) base + retry
        # decision so every shard applies the identical ground cut
        base, use_retry = ground_override
        off = jnp.where(use_retry, gp.retry_offset, gp.offset)
        keep = voxel_valid & (zcol > base + off)
    elif precut_base is not None:
        # pre-cut mode computed the base from the pre-sort raw-z sample;
        # reuse it so the pre-cut threshold and the final keep test are
        # consistent (a voxel whose center passes below can never have
        # been pre-dropped: margin > voxel/2)
        base = precut_base
    elif geometric_voxels:
        # strided sample: Morton-sorted rows make this a spatially
        # stratified ~16k sample at any n; quantile error stays ~cm
        # against the 3 m ground offset.  The stride scales
        # with the row count so small tiles keep a dense sample
        # (>=n/16 rows) instead of a fixed /256 decimation.
        stride = max(n >> 14, 16)
        vz_s = jnp.where(voxel_valid, zcol, jnp.inf)[::stride]
        base = masked_percentile(vz_s, voxel_valid[::stride], gp.percentile)
    else:
        vz = jnp.where(voxel_valid, zcol, jnp.inf)
        base = masked_percentile(vz, voxel_valid, gp.percentile)
    if ground_override is None:
        keep = voxel_valid & (zcol > base + gp.offset)
        n_keep = jnp.sum(keep.astype(jnp.int32))
        keep = lax.cond(
            n_keep < gp.min_points_after,
            lambda: voxel_valid & (zcol > base + gp.retry_offset),
            lambda: keep,
        )
        if precut_base is not None:
            # retry fired on a pre-cut tile: points in (base+retry,
            # base+offset-margin) were pre-dropped, so the retry set is
            # incomplete — flag it so the caller re-runs without precut
            precut_dropped = precut_dropped + jnp.where(
                n_keep < gp.min_points_after, jnp.float32(1.0), 0.0
            )

    # ---- cell runs (Morton prefix boundaries), stats over KEPT voxels
    if shift3k >= 30:
        c_hi = hi >> (shift3k - 30)
        c_lo = jnp.zeros_like(lo)
    else:
        c_hi = hi
        c_lo = (lo >> shift3k) | ((hi & ((1 << shift3k) - 1)) << (30 - shift3k))
    c_start = ((c_hi != jnp.roll(c_hi, 1)) | (c_lo != jnp.roll(c_lo, 1))).at[0].set(True)
    # cell population: 1-column reverse segmented scan (totals land at
    # start rows; exact in i32).  Cell CENTERS need no scans at all:
    # they decode geometrically from the Morton prefix at pack time
    # (m rows).
    ctot = segmented_scan(jnp.add, keep.astype(jnp.int32), c_start, reverse=True)
    # density only needs deciding at START rows — the label forward-fill
    # below never leaks labels into undense cells, so no per-row
    # broadcast scan is required
    dense_start = c_start & (ctot >= jnp.int32(min_cell_points))

    # ---- pack the dense-cell table: rows_m[j] = row of the j-th dense
    # start
    rows_m = compact_indices(dense_start, m)
    ccount = ctot[rows_m].astype(jnp.float32)
    from pointcloudhookup_tpu.ops.morton import morton_decode, shift_code

    # (c_hi, c_lo) above keep hi UNSHIFTED (equality-only trick); decode
    # needs the true shifted code — computed on the m packed rows only
    d_hi, d_lo = shift_code(hi[rows_m], lo[rows_m], shift3k)
    cix, ciy, ciz = morton_decode(d_hi, d_lo)
    half_cell = float(1 << (cell_shift - 1)) if cell_shift > 0 else 0.5
    ccent = (
        jnp.stack([cix, ciy, ciz], axis=1).astype(jnp.float32)
        * float(1 << cell_shift)
        + half_cell
    ) * voxel_size + mn[None, :]
    n_dense = jnp.sum(jnp.minimum(dense_start.astype(jnp.int32), 1))
    cell_alive = jnp.arange(m, dtype=jnp.int32) < n_dense
    ccount = jnp.where(cell_alive, ccount, 0.0)
    centers = jnp.where(cell_alive[:, None], ccent, big)

    # ---- cell-graph clustering
    eps2 = eps * eps
    core_flood_over = None
    if m >= core_flood_cells:
        # big tables (the 16M/32k-cell envelope): a full-table flood's
        # label walks pay O(pairs) PER ROUND over a mostly-sparse table;
        # the core-flood restructure pays the pairwise pop once and
        # floods only the compacted core cells
        # (ops/frontend_exact.py::_core_flood_cluster)
        from pointcloudhookup_tpu.ops.frontend_exact import (
            _core_flood_cluster,
        )

        cell_labels, core_flood_over = _core_flood_cluster(
            centers, ccount, cell_alive, eps2, cp.min_points,
            core_cap=core_cap,
        )
    else:
        cell_labels, _pop = cluster_cells(
            centers, ccount, cell_alive, eps2, cp.min_points
        )
    cell_labels = compact_labels(cell_labels, jnp.int32(m))

    # ---- per-voxel labels: deliver each packed cell's label to its
    # start row (m-sized scatter — tiny) and forward-fill across the
    # cell run (one segmented max scan).
    lab_at_start = jnp.full(n, -1, jnp.int32).at[rows_m].set(
        jnp.where(cell_alive, cell_labels, -1), mode="drop"
    )
    lab_row = segmented_scan(jnp.maximum, lab_at_start, c_start)
    labels = jnp.where(keep & (lab_row >= 0), lab_row, -1)
    if return_cells_overflow:
        # dense cells beyond max_cells never get packed — their points
        # stay unlabeled.  Callers that surface quality flags ask for
        # the dropped-cell count instead of failing silently.
        cells_over = jnp.maximum(n_dense - jnp.int32(m), 0).astype(jnp.float32)
        if core_flood_over is not None:
            # an over-full core-flood table leaves the min-label flood
            # incomplete — same remedy as a cell-table spill (split the
            # tile / re-run denser), so it rides the same flag
            cells_over = cells_over + core_flood_over
        if precut_dropped is not None:
            # pre-cut capacity overflow drops above-cut rows outright —
            # same remedy as a cell-table spill (split the tile), so it
            # rides the same flag
            cells_over = cells_over + precut_dropped
        if sort_mode == "hier" or (sort_mode == "cell" and depth > 0):
            # hier/cell dedup-exactness guard: runs whose length exceeds
            # the guarantee (window length/2 + 1 for hier; dup-window
            # depth + 1 per equal-SORT-KEY run for cell) may count a
            # duplicate voxel twice (never drops towers; thresholds/box
            # centers unaffected) — surfaced for quality monitoring.
            if sort_mode == "hier":
                guarantee = hier_window // 2 + 1
                g_start = c_start
            else:
                guarantee = depth + 1
                g_start = (
                    (run_key != jnp.roll(run_key, 1)).at[0].set(True)
                )
            rtot = segmented_scan(
                jnp.add, jnp.ones(n, jnp.int32), g_start, reverse=True
            )
            hier_over = jnp.sum(
                (g_start & (rtot > guarantee)).astype(jnp.int32)
            ).astype(jnp.float32)
        else:
            hier_over = jnp.float32(0.0)
        if emit == "codes":
            return hi, lo, keep, labels, base, mn, cells_over, hier_over
        ds_xyz = jnp.where(voxel_valid[:, None], vcent, 0.0)
        return ds_xyz, keep, labels, base, cells_over, hier_over
    if emit == "codes":
        return hi, lo, keep, labels, base, mn
    ds_xyz = jnp.where(voxel_valid[:, None], vcent, 0.0)
    return ds_xyz, keep, labels, base


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_cells", "min_cell_points", "geometric_voxels",
        "per_cluster_cap", "points_cap", "obb", "sort_mode", "hier_window",
        "cell_plan", "precut_div",
    ),
)
def fused_extract_step(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    max_cells: int = 8192,
    min_cell_points: int = 2,
    geometric_voxels: bool = False,
    per_cluster_cap: int = 16384,
    points_cap: int | None = None,
    obb: str = "sort",
    sort_mode: str = "full",
    hier_window: int = 256,
    cell_plan=None,
    precut_div: int = 0,
):
    """Full fused front-end + OBB + filters (the bench fast path).

    In geometric mode the OBB consumes Morton CODES (sorting one payload
    column fewer) and decodes voxel centers on its dense [K, P] member
    tensor; positions are identical to the xyz path by construction.
    obb: "accum" accumulates sort-free over the Morton rows
    (ops/obb_accum.py: exact, no member cap), "sort" label-sorts +
    densifies (ops/obb.py).  points_cap compacts labeled rows before
    the sort-path label sort (exact as long as labeled rows fit;
    overflow is reported in stats)."""
    from pointcloudhookup_tpu.models.towers import filter_and_dedup
    from pointcloudhookup_tpu.ops.obb import (
        cluster_obb_stats,
        cluster_obb_stats_accum,
        cluster_obb_stats_codes,
    )

    if obb not in ("sort", "accum"):
        raise ValueError(f"obb must be 'sort' or 'accum', got {obb!r}")
    if geometric_voxels:
        (hi, lo, keep, labels, base, mn, cells_over,
         hier_over) = fused_downsample_ground_cluster(
            xyz, mask, params, max_cells=max_cells,
            min_cell_points=min_cell_points, geometric_voxels=True, emit="codes",
            return_cells_overflow=True, sort_mode=sort_mode,
            hier_window=hier_window, cell_plan=cell_plan,
            precut_div=precut_div,
        )
        if obb == "accum":
            stats = cluster_obb_stats_accum(
                hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
                num_angles=params.obb_angles,
            )
        else:
            stats = cluster_obb_stats_codes(
                hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
                num_angles=params.obb_angles, per_cluster_cap=per_cluster_cap,
                points_cap=points_cap,
            )
        accepted = filter_and_dedup(stats, params.filters)
        return dict(labels=labels, ground_keep=keep, base_height=base,
                    accepted=accepted, cells_overflow=cells_over,
                    hier_runs_over=hier_over, **stats)
    ds_xyz, keep, labels, base, cells_over, hier_over = fused_downsample_ground_cluster(
        xyz, mask, params, max_cells=max_cells, min_cell_points=min_cell_points,
        geometric_voxels=geometric_voxels, return_cells_overflow=True,
    )
    stats = cluster_obb_stats(
        ds_xyz, labels, keep, max_clusters=params.max_clusters,
        num_angles=params.obb_angles, per_cluster_cap=per_cluster_cap,
    )
    accepted = filter_and_dedup(stats, params.filters)
    return dict(labels=labels, ground_keep=keep, base_height=base,
                accepted=accepted, ds_xyz=ds_xyz, cells_overflow=cells_over,
                hier_runs_over=hier_over, **stats)
