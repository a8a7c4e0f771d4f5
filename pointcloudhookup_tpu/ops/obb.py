"""Batched oriented-bounding-box statistics for clusters.

The reference computes a minimum-volume OBB per cluster with trimesh
(qhull convex hull — /root/reference/utils/tower_extraction.py:137-139)
and derives height = extents[2], width = max(extents[0], extents[1]),
and a north angle from the OBB x-axis (:164-177).  Convex hulls are
data-dependent and serial; on device we exploit that transmission towers
are gravity-aligned: the minimum-volume box of a tower is (to measurement
noise) the minimum-AREA rectangle of the XY footprint extruded over the
z extent.  That rectangle is found for ALL clusters at once by scanning
a dense grid of candidate orientations.

Device mapping (gather-light):
  * points are sorted by cluster label ONCE, carrying coordinates as
    sort payloads (row gathers are expensive; sort payloads are not);
  * per-cluster counts fall out of searchsorted run bounds for free;
  * cluster members are densified into a [K, P] tensor via K dynamic
    SLICES (each cluster is one contiguous run after the sort), and
    centroids/bounds/orientation scans become dense [K, P(, A)] masked
    reductions — plain elementwise work with a small compile footprint (a
    segmented-scan formulation OOM'd the XLA compile at corridor sizes);
  * the hierarchical angle search runs a 32-angle coarse pass plus a
    17-sample refinement around each cluster's winner.

`per_cluster_cap` bounds P; clusters with more members report the
overflow count in 'overflow' instead of silently clipping.

Angle resolution pi/2/A (A=256 -> 0.35 deg) bounds the extent error at
~0.6% of the cluster diagonal, well inside the reference's acceptance
thresholds; centroids are exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax




@functools.partial(
    jax.jit,
    static_argnames=("max_clusters", "num_angles", "angle_tile", "per_cluster_cap", "points_cap"),
)
def cluster_obb_stats(
    xyz,
    labels,
    mask,
    *,
    max_clusters: int = 128,
    num_angles: int = 256,
    angle_tile: int = 32,
    per_cluster_cap: int = 16384,
    points_cap: int | None = None,  # retained for API compat; unused
):
    """Per-cluster gravity-aligned OBB stats.

    xyz: f32[N,3]; labels: i32[N] in [0, max_clusters) or -1; mask: bool[N].
    Returns dict of [K]-shaped arrays:
      count, centroid[K,3] (mean of member points), center[K,3] (box center),
      extent[K,3] (ex >= ey horizontal extents, ez vertical), angle (rad of
      the long horizontal axis), north_angle (deg, reference convention),
      alive (bool), plus scalar 'overflow' = members beyond per_cluster_cap
      (0 when every cluster was fully measured).
    """
    del points_cap
    n = xyz.shape[0]
    k = max_clusters
    p = min(per_cluster_cap, n)
    big = jnp.float32(3.0e38)
    valid = (labels >= 0) & (labels < k) & mask
    lab = jnp.where(valid, labels, k).astype(jnp.int32)

    # ---- sort by label, carrying coordinates as payloads; members of
    # each cluster become one contiguous run at the front
    lab_s, sx, sy, sz = lax.sort(
        (lab, xyz[:, 0], xyz[:, 1], xyz[:, 2]), num_keys=1
    )
    gx, gy, gz, member, counts, alive, overflow = _densify_runs(
        lab_s, (sx, sy, sz), k, p
    )
    return _obb_from_members(
        gx, gy, gz, member, counts, alive, overflow, k,
        num_angles=num_angles, angle_tile=angle_tile,
    )


@functools.partial(
    jax.jit,
    static_argnames=("voxel_size", "max_clusters", "num_angles", "angle_tile", "per_cluster_cap", "points_cap"),
)
def cluster_obb_stats_codes(
    hi,
    lo,
    labels,
    mask,
    mn,
    *,
    voxel_size: float = 0.1,
    max_clusters: int = 128,
    num_angles: int = 256,
    angle_tile: int = 32,
    per_cluster_cap: int = 16384,
    points_cap: int | None = None,
):
    """cluster_obb_stats on Morton-coded voxel rows: sorts (label, hi,
    lo) — ONE payload column fewer than carrying x/y/z — and decodes
    geometric voxel centers only on the [K, P] member tensor.  This is
    the fused fast path's OBB: positions are voxel centers by
    construction there, so decode-after-densify is exact.

    points_cap: when set, labeled rows are first compacted to this
    fixed capacity (ops/compact.py) so
    the label sort runs over points_cap rows instead of N.  Labeled
    rows are typically <10% of a corridor tile after the ground cut, so
    a cap of N/4 keeps exactness with a 4x cheaper sort; rows beyond
    the cap are counted in 'overflow'."""
    from pointcloudhookup_tpu.ops.morton import morton_decode

    n = hi.shape[0]
    k = max_clusters
    valid = (labels >= 0) & (labels < k) & mask
    lab = jnp.where(valid, labels, k).astype(jnp.int32)
    cap_over = jnp.float32(0.0)
    if points_cap is not None and points_cap < n:
        from pointcloudhookup_tpu.ops.compact import compact_rows_multi

        (lab, hi, lo), n_valid = compact_rows_multi(
            valid, (lab, hi, lo), points_cap
        )
        # slots past the kept rows hold zeros: give them the skip label
        kept = jnp.arange(points_cap, dtype=jnp.int32) < n_valid
        lab = jnp.where(kept, lab, k)
        cap_over = jnp.maximum(n_valid - points_cap, 0).astype(jnp.float32)
        n = points_cap
    p = min(per_cluster_cap, n)
    lab_s, h_s, l_s = lax.sort((lab, hi, lo), num_keys=1)
    gh, gl, member, counts, alive, overflow = _densify_runs(lab_s, (h_s, l_s), k, p)
    overflow = overflow + cap_over
    ix, iy, iz = morton_decode(gh, gl)
    half = jnp.float32(voxel_size) * 0.5
    gx = ix.astype(jnp.float32) * voxel_size + (mn[0] + half)
    gy = iy.astype(jnp.float32) * voxel_size + (mn[1] + half)
    gz = iz.astype(jnp.float32) * voxel_size + (mn[2] + half)
    return _obb_from_members(
        gx, gy, gz, member, counts, alive, overflow, k,
        num_angles=num_angles, angle_tile=angle_tile,
    )


@functools.partial(
    jax.jit, static_argnames=("voxel_size", "max_clusters", "num_angles")
)
def cluster_obb_stats_accum(
    hi,
    lo,
    labels,
    mask,
    mn,
    *,
    voxel_size: float = 0.1,
    max_clusters: int = 128,
    num_angles: int = 256,
):
    """Sort-free OBB stats: per-(cluster, angle) projection extremes
    accumulated directly over the Morton-ordered rows
    (ops/obb_accum.py), replacing the label sort + [K, P] densify of
    cluster_obb_stats_codes.  Exact (no per_cluster_cap), 'overflow' is
    always 0.  The flat num_angles grid gives the same pi/2/A
    resolution as the sort path's coarse+refine search."""
    acc = cluster_obb_accumulators(
        hi, lo, labels, mask, mn, voxel_size=voxel_size,
        max_clusters=max_clusters, num_angles=num_angles,
    )
    return _obb_from_accum(acc, max_clusters, num_angles)


def cluster_obb_accumulators(
    hi,
    lo,
    labels,
    mask,
    mn,
    *,
    voxel_size: float = 0.1,
    max_clusters: int = 128,
    num_angles: int = 256,
):
    """RAW per-cluster OBB accumulators over Morton-coded rows:
    dict(cnt[K], sx, sy, sz, zlo, zhi, ulo[K,A], uhi, vlo, vhi).

    The accumulators are exactly combinable (sum / min / max), which is
    what the multi-device merge needs: summing two shards' accumulators
    for the same physical cluster and re-deriving stats equals a
    single-device run over the union of members (f32 summation order
    aside) — see parallel/sharded.py.  `obb_stats_from_accumulators`
    is the shared finisher."""
    from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate

    k = max_clusters
    lab = jnp.where((labels >= 0) & (labels < k) & mask, labels, -1)
    return obb_accumulate(
        hi, lo, lab, mn, voxel_size=voxel_size, max_clusters=k,
        num_angles=num_angles,
    )


def cluster_obb_accumulators_xyz(
    xyz,
    labels,
    mask,
    *,
    max_clusters: int = 128,
    num_angles: int = 256,
):
    """cluster_obb_accumulators over RAW coordinates (modular path: no
    Morton codes).  Same return contract."""
    from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate_xyz

    k = max_clusters
    lab = jnp.where((labels >= 0) & (labels < k) & mask, labels, -1)
    return obb_accumulate_xyz(
        xyz[:, 0], xyz[:, 1], xyz[:, 2], lab, max_clusters=k,
        num_angles=num_angles,
    )


def obb_stats_from_accumulators(acc, max_clusters: int, num_angles: int):
    """Public finisher: per-cluster stats dict from raw accumulators
    (single source of the center/extent/angle derivation for the
    single-chip accum path AND the multi-device exact merge)."""
    return _obb_from_accum(acc, max_clusters, num_angles)


def _obb_from_accum(acc, k, num_angles):
    big = jnp.float32(3.0e38)
    ar = jnp.arange(k, dtype=jnp.int32)
    counts = acc["cnt"]
    alive = counts > 0.0
    denom = jnp.maximum(counts, 1.0)
    centroid = jnp.stack(
        [acc["sx"] / denom, acc["sy"] / denom, acc["sz"] / denom], axis=1
    )
    centroid = jnp.where(alive[:, None], centroid, 0.0)

    eu = acc["uhi"] - acc["ulo"]  # [K, A]
    ev = acc["vhi"] - acc["vlo"]
    area = eu * ev
    best = jnp.argmin(area, axis=1)
    eu_b = eu[ar, best]
    ev_b = ev[ar, best]
    cu = (acc["uhi"] + acc["ulo"])[ar, best] * 0.5
    cv = (acc["vhi"] + acc["vlo"])[ar, best] * 0.5
    step = jnp.pi / 2.0 / num_angles
    theta = best.astype(jnp.float32) * step
    u_vec = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=1)
    v_vec = jnp.stack([-jnp.sin(theta), jnp.cos(theta)], axis=1)
    center_xy = cu[:, None] * u_vec + cv[:, None] * v_vec

    # angle 0 projects onto (x, y): axis-aligned bounds are column 0
    return _finalize_obb_stats(
        counts, alive, centroid, center_xy, theta, u_vec, v_vec,
        eu_b, ev_b,
        acc["ulo"][:, 0], acc["uhi"][:, 0],
        acc["vlo"][:, 0], acc["vhi"][:, 0],
        acc["zlo"], acc["zhi"],
        k, overflow=jnp.float32(0.0),
    )


def _finalize_obb_stats(
    counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
    x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, k, overflow,
):
    """Shared tail of both OBB paths: canonical long-axis swap, the
    reference's north-angle convention ((90 - atan2)% 360,
    /root/reference/utils/tower_extraction.py:173-177), and the stats
    dict.  PARITY-CRITICAL — keep the sort and accumulation paths on
    this single implementation."""
    big = jnp.float32(3.0e38)
    ez = z_hi - z_lo
    center = jnp.concatenate(
        [center_xy, ((z_hi + z_lo) * 0.5)[:, None]], axis=1
    )
    swap = ev_b > eu_b
    ex = jnp.where(swap, ev_b, eu_b)
    ey = jnp.where(swap, eu_b, ev_b)
    axis = jnp.where(swap[:, None], v_vec, u_vec)
    ang_deg = jnp.degrees(jnp.arctan2(axis[:, 1], axis[:, 0]))
    north = jnp.mod(90.0 - ang_deg, 360.0)

    zero3 = jnp.zeros((k, 3), jnp.float32)
    aabb_min = jnp.stack([x_lo, y_lo, z_lo], axis=1)
    aabb_max = jnp.stack([x_hi, y_hi, z_hi], axis=1)
    return dict(
        count=counts,
        alive=alive,
        centroid=centroid,
        center=jnp.where(alive[:, None], center, zero3),
        extent=jnp.where(alive[:, None], jnp.stack([ex, ey, ez], axis=1), zero3),
        angle=jnp.where(alive, theta + swap * (jnp.pi / 2.0), 0.0),
        north_angle=jnp.where(alive, north, 0.0),
        aabb_min=jnp.where(alive[:, None], aabb_min, big),
        aabb_max=jnp.where(alive[:, None], aabb_max, -big),
        overflow=overflow,
    )


def _densify_runs(lab_s, payloads, k, p):
    """Label-sorted rows -> per-cluster [K, P] dense member tensors via
    K dynamic slices (each cluster is one contiguous run)."""
    n = lab_s.shape[0]
    ar = jnp.arange(k, dtype=jnp.int32)
    lefts = jnp.searchsorted(lab_s, ar, side="left").astype(jnp.int32)
    rights = jnp.searchsorted(lab_s, ar, side="right").astype(jnp.int32)
    counts_i = rights - lefts
    alive = counts_i > 0
    counts = counts_i.astype(jnp.float32)
    overflow = jnp.sum(jnp.maximum(counts_i - p, 0).astype(jnp.float32))

    starts = jnp.minimum(lefts, n - p)
    pidx = jnp.arange(p, dtype=jnp.int32)[None, :]  # [1, P]
    pos = starts[:, None] + pidx  # [K, P] absolute rows
    member = (pos >= lefts[:, None]) & (pos < rights[:, None])

    def take(v):
        return jax.vmap(lambda s: lax.dynamic_slice_in_dim(v, s, p))(starts)

    return (*[take(v) for v in payloads], member, counts, alive, overflow)


def _obb_from_members(
    gx, gy, gz, member, counts, alive, overflow, k, *, num_angles, angle_tile
):
    if num_angles % angle_tile:
        raise ValueError("num_angles must be a multiple of angle_tile")
    big = jnp.float32(3.0e38)
    ar = jnp.arange(k, dtype=jnp.int32)

    # centroids from the member tensor (exact up to per_cluster_cap;
    # clusters beyond the cap are flagged via 'overflow')
    mw = member.astype(jnp.float32)
    denom = jnp.maximum(jnp.sum(mw, axis=1), 1.0)
    centroid = jnp.stack(
        [
            jnp.sum(gx * mw, axis=1) / denom,
            jnp.sum(gy * mw, axis=1) / denom,
            jnp.sum(gz * mw, axis=1) / denom,
        ],
        axis=1,
    )
    centroid = jnp.where(alive[:, None], centroid, 0.0)

    # ---- hierarchical angle search for the min-area XY rectangle:
    # a coarse pass over [0, pi/2) picks each cluster's basin, a refine
    # pass samples +-1 coarse step around it.  Effective resolution
    # (pi/2) / (coarse * refine//2) at coarse + refine evaluations
    # (e.g. 32 + 17 evals ~ a flat 256-angle scan).
    coarse = min(angle_tile * 2, num_angles, 32)
    refine = 17  # odd: center sample = the coarse winner itself
    step = jnp.pi / 2.0 / coarse

    def rect_stats(angles):  # angles [K, A] per-cluster -> extents/sums
        cos_a = jnp.cos(angles)[:, None, :]
        sin_a = jnp.sin(angles)[:, None, :]
        pu = gx[:, :, None] * cos_a + gy[:, :, None] * sin_a  # [K, P, A]
        pv = -gx[:, :, None] * sin_a + gy[:, :, None] * cos_a
        mk = member[:, :, None]
        pu_hi = jnp.max(jnp.where(mk, pu, -big), axis=1)
        pu_lo = jnp.min(jnp.where(mk, pu, big), axis=1)
        pv_hi = jnp.max(jnp.where(mk, pv, -big), axis=1)
        pv_lo = jnp.min(jnp.where(mk, pv, big), axis=1)
        return pu_hi - pu_lo, pv_hi - pv_lo, pu_hi + pu_lo, pv_hi + pv_lo

    a1 = jnp.arange(coarse, dtype=jnp.float32) * step
    eu1, ev1, _, _ = rect_stats(jnp.broadcast_to(a1[None, :], (k, coarse)))
    best1 = jnp.argmin(eu1 * ev1, axis=1)
    theta1 = best1.astype(jnp.float32) * step

    half = refine // 2
    deltas = (jnp.arange(refine, dtype=jnp.float32) - half) * (step / half)
    a2 = theta1[:, None] + deltas[None, :]  # [K, refine]
    eu, ev, su, sv = rect_stats(a2)
    area = eu * ev
    best = jnp.argmin(area, axis=1)
    eu_b = eu[ar, best]
    ev_b = ev[ar, best]
    cu = su[ar, best] * 0.5
    cv = sv[ar, best] * 0.5
    theta = a2[ar, best]
    u_vec = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=1)
    v_vec = jnp.stack([-jnp.sin(theta), jnp.cos(theta)], axis=1)
    center_xy = cu[:, None] * u_vec + cv[:, None] * v_vec

    # ---- axis-aligned bounds over the dense member tensor (the z pair
    # is the height extent; x/y feed cross-tile merge adjacency)
    x_hi = jnp.max(jnp.where(member, gx, -big), axis=1)
    x_lo = jnp.min(jnp.where(member, gx, big), axis=1)
    y_hi = jnp.max(jnp.where(member, gy, -big), axis=1)
    y_lo = jnp.min(jnp.where(member, gy, big), axis=1)
    z_hi = jnp.max(jnp.where(member, gz, -big), axis=1)
    z_lo = jnp.min(jnp.where(member, gz, big), axis=1)
    return _finalize_obb_stats(
        counts, alive, centroid, center_xy, theta, u_vec, v_vec,
        eu_b, ev_b, x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, k, overflow,
    )


def min_area_rect_numpy(xy):
    """Host oracle: exact min-area rectangle via convex-hull rotating
    calipers (scipy).  Returns (area, (eu, ev))."""
    import numpy as np
    from scipy.spatial import ConvexHull

    hull = xy[ConvexHull(xy).vertices]
    edges = np.roll(hull, -1, axis=0) - hull
    thetas = np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2)
    best = (np.inf, (0.0, 0.0))
    for t in thetas:
        c, s = np.cos(t), np.sin(t)
        u = xy @ np.array([c, s])
        v = xy @ np.array([-s, c])
        eu = u.max() - u.min()
        ev = v.max() - v.min()
        if eu * ev < best[0]:
            best = (eu * ev, (eu, ev))
    return best
