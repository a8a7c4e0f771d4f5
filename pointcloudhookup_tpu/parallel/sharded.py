"""Multi-device (mesh) extraction.

The reference is single-process; its "parallelism" is chunked loops on
one CPU pool (SURVEY.md section 2.3).  The scale-out design (50M+ point
corridors over several devices) shards corridor points over a flat 1-D
device mesh ("tiles" axis = spatial/data parallelism), which suits
devices joined all to all (NVLink); every collective is small:

  * global ground percentile: per-shard histograms + `psum` (one
    all-reduce of a 4096-bin vector), identical result on every shard —
    the distributed equivalent of np.percentile over the whole corridor;
  * clustering + OBB statistics run shard-locally (zero communication);
  * per-shard cluster summaries are `all_gather`ed (K x stats, tiny) and
    every shard deterministically merges fragments / filters / dedups the
    global tower list (replicated compute instead of a gather-to-host).

Fragment merging joins clusters whose axis-aligned bounding boxes come
within `merge_radius` on every axis (the distributed generalization of
the cross-chunk union-find fix from /root/reference/test/tttt.py:104-174).
The merge is EXACT: shards gather the RAW per-(cluster, angle) OBB
accumulators (count/Σx/Σy/Σz/z extremes/rotating-rectangle projection
extremes — ops/obb_accum.py), each union-find group SUMS its
accumulators, and center/extent/angle are re-derived once from the
combined accumulators — so a tower split across shard boundaries gets
the identical geometry a single-device run over the union of its
members would produce (f32 summation-order tolerance), not the largest
fragment's box.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pointcloudhookup_tpu.config import ExtractParams
from pointcloudhookup_tpu.models.towers import filter_and_dedup
from pointcloudhookup_tpu.ops.cluster import dbscan
from pointcloudhookup_tpu.ops.percentile import (
    histogram_counts,
    percentile_from_histogram,
)

AXIS = "tiles"


def tile_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _global_ground_base(xyz, mask, params, num_bins=4096):
    """GLOBAL height percentile + retry decision (psum'd): the single
    source of the ground-cut parameters for both sharded step variants."""
    gp = params.ground
    z = xyz[:, 2]
    big = jnp.float32(3.0e38)
    lo = lax.pmin(jnp.min(jnp.where(mask, z, big)), AXIS)
    hi = lax.pmax(jnp.max(jnp.where(mask, z, -big)), AXIS)
    counts = lax.psum(histogram_counts(z, mask, lo, hi, num_bins), AXIS)
    base = percentile_from_histogram(counts, lo, hi, gp.percentile)
    n_keep = lax.psum(
        jnp.sum((mask & (z > base + gp.offset)).astype(jnp.int32)), AXIS
    )
    return base, n_keep < gp.min_points_after


def _fragment_union(aabb_min, aabb_max, alive, merge_radius):
    """Union-find over [K] fragments: two fragments join when their
    axis-aligned bounding boxes come within `merge_radius` on EVERY
    axis (a cluster split by a tile boundary always has eps-adjacent
    boxes) — much tighter than centroid distance, which misses large
    split clusters and over-merges small nearby ones.  Returns the
    min-index representative rep[K] (k for dead rows' group id use)."""
    k = alive.shape[0]
    gap_ok = jnp.all(
        (aabb_min[:, None, :] - aabb_max[None, :, :] <= merge_radius)
        & (aabb_min[None, :, :] - aabb_max[:, None, :] <= merge_radius),
        axis=-1,
    )
    adj = gap_ok & alive[:, None] & alive[None, :]
    rep = jnp.where(alive, jnp.arange(k, dtype=jnp.int32), jnp.int32(k))

    def step(state):
        r, _, it = state
        nm = jnp.min(jnp.where(adj, r[None, :], k), axis=1)
        new = jnp.where(alive, jnp.minimum(r, nm), r)
        new = jnp.where(alive, jnp.minimum(new, new[jnp.clip(new, 0, k - 1)]), new)
        return new, jnp.any(new != r), it + 1

    rep, _, _ = lax.while_loop(
        lambda s: s[1] & (s[2] < 16), step, (rep, jnp.bool_(True), jnp.int32(0))
    )
    return rep


_BIG = 3.0e38  # dead-row sentinel, matches ops/obb_accum.py


def _merge_accumulators(acc, merge_radius):
    """EXACT fragment merge over gathered [D*K] raw OBB accumulators.

    Union-find joins fragments by AABB-gap adjacency; each group's
    accumulators are then COMBINED (cnt/Σx/Σy/Σz summed, z and
    per-angle projection extremes min/maxed) onto the group's
    min-index representative row, with other rows zeroed out.  Because
    every accumulator component is a commutative monoid over members,
    the combined row equals the accumulator a single device would have
    produced over the union of the fragments' member points — the
    re-derived center/extent/angle are then identical to f32
    summation-order tolerance (the reference's cross-chunk merge,
    /root/reference/test/tttt.py:104-174, re-labels members and
    recomputes geometry; this is its O(K) distributed equivalent)."""
    counts = acc["cnt"]
    dk = counts.shape[0]
    alive = counts > 0.0
    big = jnp.float32(_BIG)
    # angle column 0 projects (u, v) onto (x, y): axis-aligned bounds
    aabb_min = jnp.stack(
        [acc["ulo"][:, 0], acc["vlo"][:, 0], acc["zlo"]], axis=1
    )
    aabb_max = jnp.stack(
        [acc["uhi"][:, 0], acc["vhi"][:, 0], acc["zhi"]], axis=1
    )
    rep = _fragment_union(aabb_min, aabb_max, alive, merge_radius)
    grp = jnp.where(alive, rep, dk)
    idx = jnp.arange(dk, dtype=jnp.int32)
    grp_min_idx = jax.ops.segment_min(
        jnp.where(alive, idx, dk), grp, num_segments=dk + 1
    )[:dk]
    is_rep = alive & (idx == grp_min_idx[jnp.clip(rep, 0, dk - 1)])
    repc = jnp.clip(rep, 0, dk - 1)

    def comb_sum(v):
        total = jax.ops.segment_sum(v, grp, num_segments=dk + 1)[:dk]
        keep = is_rep if v.ndim == 1 else is_rep[:, None]
        return jnp.where(keep, total[repc], 0.0)

    def comb_min(v):
        total = jax.ops.segment_min(v, grp, num_segments=dk + 1)[:dk]
        keep = is_rep if v.ndim == 1 else is_rep[:, None]
        return jnp.where(keep, total[repc], big)

    def comb_max(v):
        total = jax.ops.segment_max(v, grp, num_segments=dk + 1)[:dk]
        keep = is_rep if v.ndim == 1 else is_rep[:, None]
        return jnp.where(keep, total[repc], -big)

    return dict(
        cnt=comb_sum(counts),
        sx=comb_sum(acc["sx"]),
        sy=comb_sum(acc["sy"]),
        sz=comb_sum(acc["sz"]),
        zlo=comb_min(acc["zlo"]),
        zhi=comb_max(acc["zhi"]),
        ulo=comb_min(acc["ulo"]),
        uhi=comb_max(acc["uhi"]),
        vlo=comb_min(acc["vlo"]),
        vhi=comb_max(acc["vhi"]),
    )


def _halo_exchange(xyz, mask, n_dev: int, halo_width: float, halo_cap: int):
    """Exchange boundary slabs with mesh neighbors.

    Shard-local clustering decides core/border status from the points
    it can see; without context, a cell near a tile boundary misses its
    eps-neighborhood on the other side and a split tower's member set
    differs from the single-device run (round-4's residual merge error).
    Each shard therefore sends its points within `halo_width` of the
    NEIGHBOR's spatial edge (per-shard x-extents are all_gathered — two
    floats) to that neighbor via ppermute, and appends the received
    ghosts to its local batch.  halo_width defaults to 2*eps: a local
    border cell may be adopted by a core cell up to eps away whose own
    core status needs a further eps of context.

    Assumes mesh order == spatial slab order along x (the corridor
    axis, how TileStreamer shards corridors).  When it does not hold
    the exchange degrades gracefully: selection by the neighbor's true
    extent sends either nothing or redundant ghosts, and redundant
    ghost fragments always merge back into their home fragment (their
    AABBs coincide), so results stay correct — only boundary exactness
    needs the slab assumption.

    Returns (xyz_ext f32[N+2H,3], mask_ext, is_local bool[N+2H],
    overflow f32 — nonzero when a boundary slab held more than
    halo_cap points and the tail was dropped)."""
    n = xyz.shape[0]
    big = jnp.float32(3.0e38)
    x = xyz[:, 0]
    my = lax.axis_index(AXIS)
    mymin = jnp.min(jnp.where(mask, x, big))
    mymax = jnp.max(jnp.where(mask, x, -big))
    gmin = lax.all_gather(mymin, AXIS)  # [D]
    gmax = lax.all_gather(mymax, AXIS)
    has_r = my + 1 < n_dev
    has_l = my > 0
    nbrmin_r = jnp.where(has_r, gmin[jnp.clip(my + 1, 0, n_dev - 1)], big)
    nbrmax_l = jnp.where(has_l, gmax[jnp.clip(my - 1, 0, n_dev - 1)], -big)
    send_r = mask & (x >= nbrmin_r - halo_width) & has_r
    send_l = mask & (x <= nbrmax_l + halo_width) & has_l

    def select(sel):
        cnt = jnp.sum(sel.astype(jnp.int32))
        (idx,) = jnp.nonzero(sel, size=halo_cap, fill_value=0)
        valid = jnp.arange(halo_cap) < jnp.minimum(cnt, halo_cap)
        pts = jnp.where(valid[:, None], jnp.take(xyz, idx, axis=0), 0.0)
        over = jnp.maximum(cnt - halo_cap, 0).astype(jnp.float32)
        return pts, valid, over

    pts_r, val_r, over_r = select(send_r)
    pts_l, val_l, over_l = select(send_l)
    perm_r = [(i, i + 1) for i in range(n_dev - 1)]
    perm_l = [(i + 1, i) for i in range(n_dev - 1)]
    # ghosts from the left neighbor = what it sent rightward, and v.v.;
    # unpaired shards (edges) receive zeros -> valid stays False there
    ghost_l = lax.ppermute(pts_r, AXIS, perm_r)
    gval_l = lax.ppermute(val_r, AXIS, perm_r)
    ghost_r = lax.ppermute(pts_l, AXIS, perm_l)
    gval_r = lax.ppermute(val_l, AXIS, perm_l)
    xyz_ext = jnp.concatenate([xyz, ghost_l, ghost_r], axis=0)
    mask_ext = jnp.concatenate([mask, gval_l, gval_r], axis=0)
    is_local = jnp.concatenate(
        [jnp.ones(n, bool), jnp.zeros(2 * halo_cap, bool)]
    )
    overflow = lax.psum(over_r + over_l, AXIS)
    return xyz_ext, mask_ext, is_local, overflow


def _halo_capacity(n: int) -> int:
    """Fixed ghost capacity per side: generous for small (test) shards,
    a bounded fraction (N/32, in 16384-row steps) for big ones."""
    if n >= 131072:
        return max(16384, -(-(n // 32) // 16384) * 16384)
    return max(512, -(-(n // 4) // 256) * 256)


def _gather_merge_finish(acc, params, merge_radius):
    """all_gather raw accumulators -> exact merge -> finished stats."""
    from pointcloudhookup_tpu.ops.obb import obb_stats_from_accumulators

    gathered = {
        key: lax.all_gather(val, AXIS).reshape((-1,) + val.shape[1:])
        for key, val in acc.items()
    }
    merged_acc = _merge_accumulators(gathered, merge_radius)
    dk = merged_acc["cnt"].shape[0]
    merged = obb_stats_from_accumulators(merged_acc, dk, params.obb_angles)
    merged["accepted"] = filter_and_dedup(merged, params.filters)
    return merged


def make_sharded_extract(
    mesh: Mesh,
    params: ExtractParams = ExtractParams(),
    merge_radius: float = 6.0,
    fast: bool = False,
    fast_max_cells: int | None = None,
    mode: str | None = None,
    exact_cell_bits: tuple | None = None,
):
    """Build the jitted multi-chip extraction step.

    Input xyz f32[D*N, 3] / mask bool[D*N] sharded over AXIS; returns
    (per-shard labels i32[D*N] sharded, replicated global tower stats
    dict [D*K] + accepted mask).

    mode selects the per-shard front-end ('modular' default, 'fast', or
    'exact'; fast=True is back-compat for mode='fast'):

      * 'modular': ground filter -> grid/exact DBSCAN -> accumulators.
      * 'fast': the single-chip fused Morton front-end (one keys-only
        sort + pre-cut) against the GLOBAL psum'd ground percentile.
      * 'exact': the exact-semantics fast front-end
        (ops/frontend_exact.py) with a psum'd EXACT bisection
        percentile (bit-identical to np.percentile over the whole
        corridor), a pmin'd global cell-grid anchor, and halo ghosts
        excluded from accumulation by original-row index — the full
        reference-semantics path on a slice.  Requires
        exact_cell_bits (host-side exact_cell_plan over the GLOBAL
        span, so every shard packs the same u32 cell key).

    Every variant gathers RAW per-(cluster, angle) OBB accumulators
    ([K] + [K, A] rows per shard) and every shard performs the
    identical exact merge (union-find + accumulator recombination +
    one finisher pass) — a boundary-split tower's merged geometry
    equals the single-device result to f32 tolerance.  Shards also
    exchange an eps-halo of boundary points with mesh neighbors
    (ppermute) so core/border decisions at tile boundaries
    see their full neighborhood.

    The fused fast path keeps its dense 3.2 m-cell table (NOT the
    modular grid path's 0.1 m-cell table, so ClusterParams.max_cells —
    default 65536, sized for the latter — does not transfer 1:1) at its
    own default of 8192 entries.  Pass `fast_max_cells` to size it
    explicitly for dense corridors; when
    ClusterParams.max_cells was set BELOW the fused default it is
    honored, and any clamp of a larger request is warned about at build
    time rather than applied silently."""
    n_dev = mesh.devices.size
    if mode is None:
        mode = "fast" if fast else "modular"
    if mode not in ("modular", "fast", "exact"):
        raise ValueError(f"mode must be modular/fast/exact, got {mode!r}")
    fast = mode == "fast"
    if mode == "exact" and exact_cell_bits is None:
        raise ValueError(
            "mode='exact' needs exact_cell_bits: compute them host-side "
            "with ops.frontend_exact.exact_cell_plan over the GLOBAL "
            "corridor span (every shard must pack the same cell key)"
        )

    _FUSED_DEFAULT_CELLS = 8192
    if fast:
        cp0 = params.cluster
        if fast_max_cells is not None:
            fused_cells = fast_max_cells
        elif cp0.max_cells <= _FUSED_DEFAULT_CELLS:
            fused_cells = cp0.max_cells
        else:
            fused_cells = _FUSED_DEFAULT_CELLS
            if cp0.max_cells != 65536:  # non-default: the caller meant it
                import warnings

                warnings.warn(
                    f"sharded fast path: ClusterParams.max_cells={cp0.max_cells} "
                    f"exceeds the fused cell-table default {_FUSED_DEFAULT_CELLS}; "
                    "clamping. Pass fast_max_cells to size the fused table "
                    "explicitly.",
                    stacklevel=2,
                )

    def _with_halo(xyz, mask):
        """Halo exchange wrapper: ghosts give boundary cells their full
        eps-neighborhood so shard-local core/border decisions match the
        single-device run.  Ground base/histogram uses LOCAL rows only
        (ghosts would double-count into the global percentile)."""
        n = xyz.shape[0]
        if n_dev == 1:
            return xyz, mask, jnp.ones(n, bool), jnp.float32(0.0)
        return _halo_exchange(
            xyz, mask, n_dev, 2.0 * params.cluster.eps, _halo_capacity(n)
        )

    def fast_step(xyz, mask):
        from pointcloudhookup_tpu.ops.frontend_fused import (
            fused_downsample_ground_cluster,
        )
        from pointcloudhookup_tpu.ops.obb import cluster_obb_accumulators

        n = xyz.shape[0]
        base, use_retry = _global_ground_base(xyz, mask, params)
        xyz_e, mask_e, _is_local, halo_over = _with_halo(xyz, mask)
        cp = params.cluster
        # precut_div: each shard pre-cuts against the GLOBAL base (and
        # the globally-decided retry offset, so the threshold is exact)
        # and compacts survivors, running its sort and every [N] stage
        # at N/4; auto-disabled on small/unaligned shards.  Capacity
        # overflow rides the psum'd cells_overflow flag.
        hi, lo, keep, labels, _, mn, cells_over, _hier = fused_downsample_ground_cluster(
            xyz_e, mask_e, params, max_cells=fused_cells,
            min_cell_points=cp.min_cell_points, geometric_voxels=True,
            emit="codes", ground_override=(base, use_retry),
            return_cells_overflow=True, precut_div=4, axis_name=AXIS,
        )
        # ghost rows stay IN the accumulators here (the fused path's
        # rows are in sorted order, so the local/ghost flag is gone):
        # center/extent/angle/aabb derive from min/max extremes, which
        # are idempotent under the duplication — exact.  count/centroid
        # may include boundary-halo members twice (counts were already
        # per-shard-voxel-dedup approximate); the modular and exact
        # sharded variants exclude ghosts exactly.
        acc = cluster_obb_accumulators(
            hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        merged = _gather_merge_finish(acc, params, merge_radius)
        merged["base_height"] = base
        # dense cells beyond the per-shard kernel capacity never pack —
        # surface the total dropped-cell count instead of losing towers
        # silently (same quality flag as the single-chip fast path)
        merged["cells_overflow"] = lax.psum(cells_over, AXIS)
        merged["halo_overflow"] = halo_over
        # fast-path labels ride in compacted/sorted row order (their
        # length already differs from N under the pre-cut); ghosts are
        # interleaved — consumers of per-point labels use the modular
        # or exact variants
        return labels, merged

    def step(xyz, mask):
        from pointcloudhookup_tpu.ops.obb import cluster_obb_accumulators_xyz

        n = xyz.shape[0]
        base, use_retry = _global_ground_base(xyz, mask, params)
        xyz_e, mask_e, is_local, halo_over = _with_halo(xyz, mask)
        gp = params.ground
        off = jnp.where(use_retry, gp.retry_offset, gp.offset)
        keep = mask_e & (xyz_e[:, 2] > base + off)
        cp = params.cluster
        if cp.method == "grid" or (cp.method == "auto" and n > cp.auto_grid_threshold):
            from pointcloudhookup_tpu.ops.cluster_grid import grid_dbscan

            labels, _core, cells_over = grid_dbscan(
                xyz_e, keep, cp.eps, cp.min_points,
                max_cells=cp.max_cells, min_cell_points=cp.min_cell_points,
                return_overflow=True,
            )
        else:
            labels, _core = dbscan(xyz_e, keep, cp.eps, cp.min_points)
            cells_over = jnp.float32(0.0)
        # labels are input-order here, so ghosts are excluded exactly:
        # every point is accumulated by its home shard only, and the
        # merged accumulators equal the single-device run's
        acc = cluster_obb_accumulators_xyz(
            xyz_e, labels, keep & is_local, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        merged = _gather_merge_finish(acc, params, merge_radius)
        merged["base_height"] = base
        # same quality flag as the fast path: dense cells beyond the
        # per-shard table never pack, so losing them must be visible
        merged["cells_overflow"] = lax.psum(cells_over, AXIS)
        merged["halo_overflow"] = halo_over
        return labels[:n], merged

    def exact_step(xyz, mask):
        from pointcloudhookup_tpu.ops.frontend_exact import (
            exact_extract_graph,
        )

        n = xyz.shape[0]
        xyz_e, mask_e, _is_local, halo_over = _with_halo(xyz, mask)
        ne = xyz_e.shape[0]
        cap = max(ne // 4, min(ne, 1024))
        cp = params.cluster
        # dense cells are built FROM the compacted survivor table, so a
        # cell table larger than compact_cap can never fill: clamp it
        mc = min(cp.max_cells, cap)
        out = exact_extract_graph(
            xyz_e, mask_e, params,
            cell_bits=exact_cell_bits, compact_cap=cap,
            max_cells=mc, min_cell_points=cp.min_cell_points,
            axis_name=AXIS, local_rows=n, return_acc=True,
        )
        merged = _gather_merge_finish(out["acc"], params, merge_radius)
        merged["base_height"] = out["base_height"]
        merged["cells_overflow"] = lax.psum(
            out["cells_overflow"] + out["core_overflow"], AXIS
        )
        merged["halo_overflow"] = halo_over
        # labels ride in cell-sorted order with rows_sorted as the map
        # back to (extended) input rows, like the single-chip exact path
        return out["labels_sorted"], merged

    stats_specs = dict(
        count=P(),
        alive=P(),
        centroid=P(),
        center=P(),
        extent=P(),
        angle=P(),
        north_angle=P(),
        aabb_min=P(),
        aabb_max=P(),
        overflow=P(),
        accepted=P(),
        base_height=P(),
        cells_overflow=P(),
        halo_overflow=P(),
    )
    step_fn = {"modular": step, "fast": fast_step, "exact": exact_step}[mode]
    shardmapped = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), stats_specs),
        check_vma=False,
    )
    return jax.jit(shardmapped), NamedSharding(mesh, P(AXIS))
