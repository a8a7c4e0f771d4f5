"""Tower schema + the flagship jittable extraction model.

This is the device equivalent of the reference's
``extract_towers`` (/root/reference/utils/tower_extraction.py:20-240):
ground filter -> cluster -> per-cluster OBB -> size/aspect filters ->
duplicate suppression, as ONE compiled device program over fixed-shape
buffers.  The host wrapper that feeds it from LAS files lives in
pointcloudhookup_tpu/models/pipeline.py.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pointcloudhookup_tpu.config import ExtractParams, TowerFilterParams
from pointcloudhookup_tpu.ops.cluster import compact_labels, dbscan, dbscan_chunked
from pointcloudhookup_tpu.ops.ground import ground_filter
from pointcloudhookup_tpu.ops.obb import cluster_obb_stats


@dataclasses.dataclass
class Tower:
    """One extracted tower (host-side record, world coordinates).

    Field meanings mirror the reference's tower_info dict
    (/root/reference/utils/tower_extraction.py:180-188).
    """

    id: str
    center: np.ndarray  # f64[3] world coords (box center)
    extent: np.ndarray  # f64[3] (ex >= ey horizontal, ez vertical)
    height: float
    width: float
    north_angle: float
    angle: float  # long-axis yaw in radians
    num_points: int
    label: int
    properties: Optional[dict] = None


@functools.partial(jax.jit, static_argnames=("fp",))
def filter_and_dedup(stats: dict, fp: TowerFilterParams = TowerFilterParams()):
    """Apply tower acceptance filters + greedy duplicate suppression.

    Semantics follow /root/reference/utils/tower_extraction.py:142-161:
    accept if height > min_height, min_width < width < max_width,
    height/width > aspect_ratio_threshold; then scan candidates in
    cluster-id order, rejecting any whose 3D center is within
    duplicate_threshold of an already-accepted center.
    Returns accepted bool[K].
    """
    ext = stats["extent"]
    height = ext[:, 2]
    width = ext[:, 0]  # ex >= ey by construction
    aspect = height / jnp.maximum(width, 1e-6)
    ok = (
        stats["alive"]
        & (height > fp.min_height)
        & (width > fp.min_width)
        & (width < fp.max_width)
        & (aspect > fp.aspect_ratio_threshold)
    )
    centers = stats["center"]
    k = centers.shape[0]
    thr2 = jnp.square(jnp.float32(fp.duplicate_threshold))

    # Greedy dedup as a Jacobi fixpoint instead of a K-step sequential
    # scan: accepted[i] = ok[i] and no EARLIER accepted cluster within
    # the radius.  Iterating from accepted=ok converges to the greedy
    # solution in (conflict-chain depth) steps — one [K,K] matrix op per
    # step instead of K tiny sequential ones.
    d2 = jnp.sum(
        jnp.square(centers[:, None, :] - centers[None, :, :]), axis=-1
    )
    earlier_conflict = (
        (d2 < thr2)
        & (jnp.arange(k)[None, :] < jnp.arange(k)[:, None])
        & ok[None, :]
    )

    def body(state):
        acc, _, it = state
        new = ok & ~jnp.any(earlier_conflict & acc[None, :], axis=1)
        return new, jnp.any(new != acc), it + 1

    accepted, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < k),
        body,
        (ok, jnp.bool_(True), jnp.int32(0)),
    )
    return accepted


@functools.partial(jax.jit, static_argnames=("params",))
def extract_step(xyz, mask, params: ExtractParams = ExtractParams()):
    """Full extraction forward step on device.

    xyz: f32[N,3] centered coords (N a multiple of the cluster chunk/tile
    sizes), mask: bool[N].
    Returns dict with per-point 'labels' i32[N], 'ground_keep' bool[N],
    per-cluster OBB stats arrays [K], and 'accepted' bool[K].
    """
    keep, base = ground_filter(xyz, mask, params.ground)
    cp = params.cluster
    n = xyz.shape[0]
    cells_overflow = jnp.float32(0.0)  # non-grid paths have no cell table
    if cp.per_chunk:
        labels, core = dbscan_chunked(
            xyz, keep, cp.eps, cp.min_points, chunk_size=cp.chunk_size
        )
        # chunk-offset labels are sparse; compact them to [0, K) for the
        # fixed-capacity per-cluster reductions
        labels = compact_labels(jnp.where(labels >= 0, labels, n), jnp.int32(n))
    elif cp.method == "adaptive":
        from pointcloudhookup_tpu.ops.cluster_adaptive import adaptive_cluster

        labels, core, _ = adaptive_cluster(
            xyz, keep, cp.min_points,
            min_cluster_size=cp.min_cluster_size,
            max_cells=cp.max_cells, min_cell_points=cp.min_cell_points,
            eps_fallback=cp.eps,
        )
    elif cp.method == "grid" or (
        cp.method == "auto" and n > cp.auto_grid_threshold
    ):
        from pointcloudhookup_tpu.ops.cluster_grid import grid_dbscan

        labels, core, cells_overflow = grid_dbscan(
            xyz, keep, cp.eps, cp.min_points,
            max_cells=cp.max_cells, min_cell_points=cp.min_cell_points,
            return_overflow=True,
        )
    else:
        labels, core = dbscan(xyz, keep, cp.eps, cp.min_points)
    stats = cluster_obb_stats(
        xyz,
        labels,
        keep,
        max_clusters=params.max_clusters,
        num_angles=params.obb_angles,
    )
    accepted = filter_and_dedup(stats, params.filters)
    return dict(
        labels=labels,
        ground_keep=keep,
        base_height=base,
        accepted=accepted,
        cells_overflow=cells_overflow,
        **stats,
    )


def towers_from_stats(stats: dict, origin: np.ndarray) -> list[Tower]:
    """Host-side: turn device stats + accepted mask into Tower records in
    world coordinates."""
    # fetch each [K]-sized array ONCE: indexing a device array inside
    # the loop costs a device round trip PER FIELD PER TOWER
    keys = ("accepted", "center", "extent", "north_angle", "angle", "count")
    stats = {k: np.asarray(stats[k]) for k in keys if k in stats}
    accepted = stats["accepted"]
    out = []
    for k in np.nonzero(accepted)[0]:
        center = np.asarray(stats["center"][k], np.float64) + origin
        ext = np.asarray(stats["extent"][k], np.float64)
        out.append(
            Tower(
                id=f"tower_{int(k)}",
                center=center,
                extent=ext,
                height=float(ext[2]),
                width=float(ext[0]),
                north_angle=float(stats["north_angle"][k]),
                angle=float(stats["angle"][k]),
                num_points=int(stats["count"][k]),
                label=int(k),
            )
        )
    return out
