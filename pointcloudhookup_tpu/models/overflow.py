"""Dense-tile overflow resolution: re-split instead of just reporting.

The fixed-shape device buffers bound the per-tile candidate space:
`ExtractParams.max_clusters` (default 128) cluster slots and, on the
fused fast path, `max_cells` dense-cell slots.  Round 2 surfaced
saturation as quality flags (`cells_overflow`, a full `alive` table);
this module RESOLVES it: when a tile saturates, the host driver splits
the tile into four overlapping xy quadrants and recurses, then merges
the per-quadrant tower lists with the same duplicate-suppression
semantics as the device dedup.

The reference handles arbitrary cluster counts implicitly (Python lists,
/root/reference/utils/tower_extraction.py:104-122); this is the
fixed-capacity equivalent with a recursion depth bound.

The quadrant halo (default max(duplicate_threshold, max_width, 4*eps))
guarantees every structure within halo of a cut line appears COMPLETE in
at least one quadrant; its fragments elsewhere either fail the size
filters or lose the count-ordered dedup to the complete copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pointcloudhookup_tpu.config import ExtractParams


def saturated(stats: dict, params: ExtractParams) -> bool:
    """True when the tile hit a fixed-capacity ceiling: every cluster
    slot used (candidates beyond max_clusters were dropped) or dense
    cells overflowed the fused cell table."""
    if float(np.asarray(stats.get("cells_overflow", 0.0))) > 0:
        return True
    return int(np.asarray(stats["alive"]).sum()) >= params.max_clusters


def _dedup_towers(towers: list, duplicate_threshold: float) -> list:
    """Greedy duplicate suppression across sub-tile results, biggest
    cluster first (so a boundary fragment can never displace the
    complete copy of its tower)."""
    order = sorted(towers, key=lambda t: -t.num_points)
    kept: list = []
    for t in order:
        dup = any(
            float(np.linalg.norm(t.center - k.center)) < duplicate_threshold
            for k in kept
        )
        if not dup:
            kept.append(t)
    # stable presentation: west-to-east like a corridor sweep
    kept.sort(key=lambda t: (t.center[0], t.center[1]))
    for i, t in enumerate(kept):
        t.id = f"tower_{i}"
        t.label = i
    return kept


def extract_from_points_resolving(
    points: np.ndarray,
    params: ExtractParams = ExtractParams(),
    *,
    fast: bool = False,
    max_depth: int = 3,
    halo: Optional[float] = None,
    _depth: int = 0,
):
    """Extraction with capacity-overflow resolution.

    Returns (towers, info) where info = dict(saturated_tiles, tiles_run,
    max_depth_used, resolved).  `resolved` is False only if saturation
    persisted at max_depth (pathologically dense data).

    Each recursion level re-pads sub-tiles, so new shapes may compile;
    production streaming keeps ONE capacity per level by construction
    (quadrants of a capacity-padded tile re-pad to capacity/2 rounded).
    """
    from pointcloudhookup_tpu.models.pipeline import extract_from_points

    points = np.asarray(points, np.float64).reshape(-1, 3)
    if halo is None:
        halo = max(
            params.filters.duplicate_threshold,
            params.filters.max_width,
            4.0 * params.cluster.eps,
        )

    if fast:
        towers, stats = _fast_extract(points, params)
    else:
        towers, stats, _origin = extract_from_points(points, params)
    info = dict(
        saturated_tiles=0, tiles_run=1, max_depth_used=_depth, resolved=True
    )
    if not saturated(stats, params):
        return towers, info
    if _depth >= max_depth or len(points) < 8:
        info["saturated_tiles"] = 1
        info["resolved"] = False
        return towers, info

    # ---- the ground percentile is a GLOBAL statistic (the reference
    # computes it once over the whole cloud, tower_extraction.py:83);
    # recomputing it per sub-tile would let the cut climb into the
    # towers as recursion zooms into structure-dense regions.  Apply the
    # TOP-LEVEL cut here on the host and hand children pre-filtered
    # points with a no-op ground stage.
    if _depth == 0:
        import dataclasses

        from pointcloudhookup_tpu.config import GroundParams

        gp = params.ground
        base = float(np.asarray(stats["base_height"]))
        # the device step saw coordinates centered on the tile mean, so
        # base_height lives in that frame
        zc = points[:, 2] - points.mean(axis=0)[2]
        keep = zc > base + gp.offset
        if keep.sum() < gp.min_points_after:
            keep = zc > base + gp.retry_offset
        points = points[keep]
        params = dataclasses.replace(
            params,
            ground=GroundParams(percentile=0.0, offset=-1.0, min_points_after=0),
        )

    # ---- split around the xy median with an overlap halo and recurse
    info["saturated_tiles"] = 1
    mx, my = np.median(points[:, 0]), np.median(points[:, 1])
    quads = [
        (points[:, 0] <= mx + halo) & (points[:, 1] <= my + halo),
        (points[:, 0] <= mx + halo) & (points[:, 1] > my - halo),
        (points[:, 0] > mx - halo) & (points[:, 1] <= my + halo),
        (points[:, 0] > mx - halo) & (points[:, 1] > my - halo),
    ]
    merged: list = []
    for sel in quads:
        sub = points[sel]
        if len(sub) == len(points):  # degenerate split: no progress
            info["resolved"] = False
            return towers, info
        t_sub, i_sub = extract_from_points_resolving(
            sub, params, fast=fast, max_depth=max_depth, halo=halo,
            _depth=_depth + 1,
        )
        merged.extend(t_sub)
        info["tiles_run"] += i_sub["tiles_run"]
        info["saturated_tiles"] += i_sub["saturated_tiles"]
        info["max_depth_used"] = max(info["max_depth_used"], i_sub["max_depth_used"])
        info["resolved"] = info["resolved"] and i_sub["resolved"]
    towers = _dedup_towers(merged, params.filters.duplicate_threshold)
    return towers, info


def _fast_extract(points: np.ndarray, params: ExtractParams):
    """Fused fast-path twin of pipeline.extract_from_points."""
    import jax.numpy as jnp

    from pointcloudhookup_tpu.core.batch import round_up
    from pointcloudhookup_tpu.models.towers import towers_from_stats
    from pointcloudhookup_tpu.ops.frontend_fused import fused_extract_step

    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    # the fast path is full sort + pre-cut (the pre-cut engages from
    # 131072 rows)
    cap = round_up(max(len(points), 1), 1024)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True
    # honor the configured cell-density floor (the fused default of 2 is
    # a bench denoising choice; at 1 a sparse mid-tower cell layer can
    # no longer split a structure vertically into sub-min_width parts)
    stats = fused_extract_step(
        jnp.asarray(xyz), jnp.asarray(mask), params, geometric_voxels=True,
        min_cell_points=max(params.cluster.min_cell_points, 1),
        sort_mode="full", precut_div=4,
    )
    stats = {k: np.asarray(v) for k, v in stats.items()}
    return towers_from_stats(stats, origin), stats
