"""Ground removal strategies.

Canonical reference behavior: keep z > P25 + 3.0 m, retry with +1.0 m if
fewer than 1000 points survive (/root/reference/utils/tower_extraction.py:83-89).
The reference's scratch toolbox (/root/reference/test/main_ground.py) also
has: sklearn RANSACRegressor plane fit, Open3D segment_plane RANSAC,
tiled RANSAC over 10-20 m XY tiles, and a plain percentile cut
(z < P10 + 4).  All are provided here; RANSAC runs as fixed-trial batched
hypotheses (argmax inliers) instead of a sequential sampler.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from pointcloudhookup_tpu.config import GroundParams
from pointcloudhookup_tpu.ops.percentile import masked_percentile


@functools.partial(jax.jit, static_argnames=("params",))
def ground_filter(xyz, mask, params: GroundParams = GroundParams()):
    """Height-percentile ground filter (reference parity).

    Returns (keep_mask bool[N], base_height f32 scalar).
    """
    z = xyz[:, 2]
    base = masked_percentile(z, mask, params.percentile)
    keep = mask & (z > base + params.offset)
    n_keep = jnp.sum(keep.astype(jnp.int32))
    keep = lax.cond(
        n_keep < params.min_points_after,
        lambda: mask & (z > base + params.retry_offset),
        lambda: keep,
    )
    return keep, base


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_plane(xyz, mask, key, dist_thresh=0.3, num_hypotheses: int = 256):
    """Batched-hypothesis RANSAC plane fit.

    Samples `num_hypotheses` point triples at once, fits all candidate
    planes, counts inliers with one [N, H] distance evaluation, returns
    (normal f32[3] with unit norm and nz >= 0, offset d, inlier bool[N])
    of the best plane.  Equivalent role to Open3D segment_plane
    (/root/reference/test/main_ground.py:47-51) but with a fixed,
    compiler-friendly trial count.
    """
    n = xyz.shape[0]
    h = num_hypotheses
    # sample valid indices: draw uniform, map through sorted valid index trick
    probs = mask.astype(jnp.float32)
    logits = jnp.log(probs / jnp.sum(probs) + 1e-30)
    idx = jax.random.categorical(key, logits, shape=(h, 3))
    p0, p1, p2 = (xyz[idx[:, i]] for i in range(3))
    normal = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / jnp.maximum(norm, 1e-12)
    degenerate = norm[:, 0] < 1e-9
    d = -jnp.sum(normal * p0, axis=1)  # plane: n.p + d = 0
    # full f32: reduced-precision dots would swamp the inlier threshold
    dist = jnp.abs(
        jnp.dot(xyz, normal.T, precision=jax.lax.Precision.HIGHEST) + d[None, :]
    )  # [N, H]
    inl = (dist <= dist_thresh) & mask[:, None]
    scores = jnp.where(degenerate, -1, jnp.sum(inl.astype(jnp.int32), axis=0))
    best = jnp.argmax(scores)
    bn, bd = normal[best], d[best]
    flip = jnp.where(bn[2] < 0, -1.0, 1.0)
    return bn * flip, bd * flip, inl[:, best]


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def remove_ground_ransac(xyz, mask, key, dist_thresh=0.5, num_hypotheses: int = 256):
    """Remove the dominant plane's inliers and everything below it
    (keeps points above ground plane + dist_thresh)."""
    normal, d, _ = ransac_plane(xyz, mask, key, dist_thresh, num_hypotheses)
    # HIGHEST: the GPU may run a default-precision f32 dot in TF32,
    # whose ~1e-3 relative error at km-scale coordinates exceeds the
    # decimetre threshold this signed distance is compared against
    signed = jnp.dot(xyz, normal, precision=jax.lax.Precision.HIGHEST) + d
    return mask & (signed > dist_thresh), (normal, d)


@functools.partial(jax.jit, static_argnames=("grid", "num_hypotheses"))
def remove_ground_tiled_ransac(
    xyz, mask, key, tile_size=15.0, dist_thresh=0.5, grid: int = 8, num_hypotheses: int = 64
):
    """Tiled RANSAC for undulating terrain
    (ref: /root/reference/test/main_ground.py:77-115, 10-20 m XY tiles).

    Points are assigned to a grid x grid XY lattice of `tile_size` cells
    (clamped); a plane is fit per tile on that tile's points; a point is
    kept if it is above its own tile's plane.  Fixed shapes: the per-tile
    fit reuses the full point set with a tile-membership mask.
    """
    del tile_size  # lattice is derived from the data bounds below
    big = jnp.float32(3.0e38)
    mn = jnp.min(jnp.where(mask[:, None], xyz[:, :2], big), axis=0)
    mx = jnp.max(jnp.where(mask[:, None], xyz[:, :2], -big), axis=0)
    span = jnp.maximum(mx - mn, 1e-6)
    ij = jnp.clip(((xyz[:, :2] - mn) / span * grid).astype(jnp.int32), 0, grid - 1)
    tile_id = ij[:, 0] * grid + ij[:, 1]

    keys = jax.random.split(key, grid * grid)

    def fit_tile(t, k):
        tmask = mask & (tile_id == t)
        has = jnp.sum(tmask.astype(jnp.int32)) >= 3
        normal, d, _ = ransac_plane(xyz, tmask | (~has & mask), k, dist_thresh, num_hypotheses)
        return normal, d

    normals, ds = jax.vmap(fit_tile)(jnp.arange(grid * grid), keys)
    signed = jnp.sum(xyz * normals[tile_id], axis=1) + ds[tile_id]
    return mask & (signed > dist_thresh)


@jax.jit
def percentile_cut(xyz, mask, percentile=10.0, offset=4.0):
    """Simple low cut: drop z < P(percentile) + offset
    (ref: /root/reference/test/main_ground.py:118-131)."""
    z = xyz[:, 2]
    base = masked_percentile(z, mask, percentile)
    return mask & (z >= base + offset)
