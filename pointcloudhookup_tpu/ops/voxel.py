"""Voxel-grid downsampling on device.

Open3D-semantics (`voxel_down_sample`): voxel index = floor((p - min_bound)
/ voxel_size) with min_bound the cloud minimum; output = per-voxel centroid
(mean of member points).  The reference calls this per 500k-point chunk
(/root/reference/ui/import_PC.py:8-13,45-50), so voxel dedup is not global
there; `voxel_downsample_chunked` replicates that parity behavior while
`voxel_downsample` dedups globally.

Design: no hash maps — we sort points by their 3 integer voxel keys
(`lax.sort` with num_keys=3, fully on-device), detect segment boundaries,
and compute per-voxel centroids with `segment_sum`.  Everything is fixed
shape: the output is padded to the input capacity with a validity mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_SENTINEL = jnp.int32(2**30)


@functools.partial(jax.jit, static_argnames=("expand",))
def voxel_downsample(xyz, mask, voxel_size, *, expand: int = 1):
    """Global voxel-grid centroid downsample.

    xyz: f32[N,3] (centered coordinates), mask: bool[N], voxel_size: scalar.
    Returns (out_xyz f32[N,3], out_mask bool[N]): per-voxel centroids in
    voxel-key sorted order, one valid row per voxel (at each voxel's
    first point position), the rest masked out.

    Scatter-free: sort by the 3 integer voxel keys, then per-voxel sums
    are cumulative-sum differences at segment boundaries
    (ops/segments.py).
    `expand` is unused (API symmetry with the chunked variant).
    """
    del expand
    from pointcloudhookup_tpu.ops.segments import boundary_flags, segmented_scan

    big = jnp.float32(3.0e38)
    min_bound = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    ijk = jnp.floor((xyz - min_bound) / voxel_size).astype(jnp.int32)
    ijk = jnp.where(mask[:, None], ijk, _SENTINEL)

    # ONE sort carrying the coordinates as payloads instead of row
    # gathers after the sort
    w_in = mask.astype(jnp.float32)
    kx, ky, kz, sx, sy, sz, w = jax.lax.sort(
        (ijk[:, 0], ijk[:, 1], ijk[:, 2], xyz[:, 0], xyz[:, 1], xyz[:, 2], w_in),
        num_keys=3,
    )
    is_start = boundary_flags(kx, ky, kz)
    # reverse segmented scan -> each segment's TOTAL lands on its start row
    vals = jnp.stack([sx * w, sy * w, sz * w, w], axis=1)
    totals = segmented_scan(jnp.add, vals, is_start, reverse=True)
    counts = totals[:, 3]
    centroids = totals[:, :3] / jnp.maximum(counts, 1.0)[:, None]
    out_mask = is_start & (counts > 0.0) & (kx != _SENTINEL)
    return jnp.where(out_mask[:, None], centroids, 0.0), out_mask


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def voxel_downsample_chunked(xyz, mask, voxel_size, *, chunk_size: int):
    """Reference-parity chunked voxelization: each contiguous chunk of
    `chunk_size` points is voxelized independently against its own min
    bound (ref: ui/import_PC.py:45-50).  Capacity must be a multiple of
    chunk_size.  Output order: chunk-major, voxel-key sorted within chunk.
    """
    n = xyz.shape[0]
    if n % chunk_size:
        raise ValueError(f"capacity {n} not a multiple of chunk_size {chunk_size}")
    xyz_c = xyz.reshape(-1, chunk_size, 3)
    mask_c = mask.reshape(-1, chunk_size)
    out_xyz, out_mask = jax.vmap(
        lambda p, m: voxel_downsample(p, m, voxel_size)
    )(xyz_c, mask_c)
    return out_xyz.reshape(n, 3), out_mask.reshape(n)
