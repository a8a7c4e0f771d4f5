"""Sort-free per-cluster OBB accumulators.

The min-area box of every cluster comes from rotating-rectangle
projection extremes over a flat grid of A angles in [0, pi/2).  The
accumulators are, per cluster k in [0, K):

  cnt / sx / sy / sz / zlo / zhi                         [K] each
  ulo / uhi / vlo / vhi   (u = x cos + y sin,
                           v = y cos - x sin)           [K, A] each

Every component is a commutative monoid over members (sum, min, max),
so shards can merge them exactly (`parallel/sharded.py`).  Angle 0
projects onto (x, y), so the axis-aligned bounds are column 0.

`obb_accumulate_xyz` picks the implementation for the backend:

  * on the GPU, the Pallas kernel through Triton
    (`ops/pallas/obb_accum_triton.py`);
  * elsewhere, `obb_accumulate_xyz_sorted`: one label sort, then
    segment min/max over row chunks, so at most a [chunk, A] projection
    tile is live.

The dense one-hot `*_reference` oracles build [N, K, A] and are for
tests only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

BIG = 3.0e38  # empty-accumulator sentinel (min side +BIG, max side -BIG)


def _angles(a: int):
    ang = jnp.arange(a, dtype=jnp.float32) * (jnp.pi / 2.0 / a)
    return jnp.cos(ang), jnp.sin(ang)


@functools.partial(jax.jit, static_argnames=("max_clusters", "num_angles", "chunk"))
def obb_accumulate_xyz_sorted(
    x, y, z, labels, *, max_clusters: int = 128, num_angles: int = 256,
    chunk: int = 2048,
):
    """Accumulators by label sort + segment reductions (plain XLA).

    x/y/z f32[N]; labels i32[N], cluster id in [0, K) or anything else
    to skip.  Rows are sorted by label once; the labelled prefix is then
    folded chunk by chunk, each chunk's [chunk, A] projections reduced
    with segment min/max into the [K, A] tables."""
    k = max_clusters
    a = num_angles
    n = x.shape[0]
    lab = jnp.where((labels >= 0) & (labels < k), labels, k).astype(jnp.int32)
    lab, xs, ys, zs = lax.sort(
        (lab, x.astype(jnp.float32), y.astype(jnp.float32),
         z.astype(jnp.float32)),
        num_keys=1,
    )
    pad = (-n) % chunk
    if pad:
        lab = jnp.concatenate([lab, jnp.full(pad, k, jnp.int32)])
        xs, ys, zs = (
            jnp.concatenate([v, jnp.zeros(pad, jnp.float32)]) for v in (xs, ys, zs)
        )
    big = jnp.float32(BIG)
    seg = dict(num_segments=k + 1, indices_are_sorted=True)
    ones = (lab < k).astype(jnp.float32)
    cnt = jax.ops.segment_sum(ones, lab, **seg)[:k]
    # sums relative to each cluster's first row: the offsets are small
    # (cluster-sized), so the f32 running sum keeps its precision where
    # a sum of raw km-scale coordinates would not
    first = jnp.clip(
        jnp.searchsorted(lab, jnp.arange(k + 1, dtype=jnp.int32)), 0, lab.shape[0] - 1
    )

    def anchored_sum(v):
        anchor = v[first]
        rel = jax.ops.segment_sum(v - anchor[lab], lab, **seg)[:k]
        return rel + cnt * anchor[:k]

    sx, sy, sz = (anchored_sum(v) for v in (xs, ys, zs))
    zlo = jnp.minimum(jax.ops.segment_min(zs, lab, **seg)[:k], big)
    zhi = jnp.maximum(jax.ops.segment_max(zs, lab, **seg)[:k], -big)

    cos_a, sin_a = _angles(a)
    n_lab = jnp.sum((lab < k).astype(jnp.int32))
    n_chunks = (n_lab + (chunk - 1)) // chunk

    def body(i, acc):
        ulo, uhi, vlo, vhi = acc
        off = i * chunk
        lc = lax.dynamic_slice_in_dim(lab, off, chunk)
        xc = lax.dynamic_slice_in_dim(xs, off, chunk)[:, None]
        yc = lax.dynamic_slice_in_dim(ys, off, chunk)[:, None]
        u = xc * cos_a[None, :] + yc * sin_a[None, :]
        v = yc * cos_a[None, :] - xc * sin_a[None, :]
        return (
            jnp.minimum(ulo, jax.ops.segment_min(u, lc, **seg)),
            jnp.maximum(uhi, jax.ops.segment_max(u, lc, **seg)),
            jnp.minimum(vlo, jax.ops.segment_min(v, lc, **seg)),
            jnp.maximum(vhi, jax.ops.segment_max(v, lc, **seg)),
        )

    lo0 = jnp.full((k + 1, a), big)
    ulo, uhi, vlo, vhi = lax.fori_loop(0, n_chunks, body, (lo0, -lo0, lo0, -lo0))
    return dict(
        cnt=cnt, sx=sx, sy=sy, sz=sz, zlo=zlo, zhi=zhi,
        ulo=ulo[:k], uhi=uhi[:k], vlo=vlo[:k], vhi=vhi[:k],
    )


def obb_accumulate_xyz(x, y, z, labels, *, max_clusters: int = 128,
                       num_angles: int = 256):
    """Per-cluster OBB accumulators over raw coordinates (see module
    docstring); the implementation follows the default backend."""
    if jax.default_backend() == "gpu":
        from pointcloudhookup_tpu.ops.pallas.obb_accum_triton import (
            obb_accumulate_xyz_triton,
        )

        return obb_accumulate_xyz_triton(
            x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
        )
    return obb_accumulate_xyz_sorted(
        x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
    )


def morton_centers(hi, lo, mn, voxel_size: float):
    """Geometric voxel centers (x, y, z) of Morton-coded rows."""
    from pointcloudhookup_tpu.ops.morton import morton_decode

    ix, iy, iz = morton_decode(hi, lo)
    half = jnp.float32(voxel_size) * 0.5
    return tuple(
        i.astype(jnp.float32) * voxel_size + (mn[d] + half)
        for d, i in enumerate((ix, iy, iz))
    )


def obb_accumulate(hi, lo, labels, mn, *, voxel_size: float = 0.1,
                   max_clusters: int = 128, num_angles: int = 256):
    """obb_accumulate_xyz over Morton-coded voxel rows (decoded to their
    geometric voxel centers first)."""
    x, y, z = morton_centers(hi, lo, mn, voxel_size)
    return obb_accumulate_xyz(
        x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
    )


def obb_accumulate_xyz_reference(
    x, y, z, labels, *, max_clusters=128, num_angles=256
):
    """Dense one-hot [N, K, A] oracle (test sizes only)."""
    k = max_clusters
    big = jnp.float32(BIG)
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    z = z.astype(jnp.float32)
    lab = jnp.where(labels < k, labels, -1)
    oh = lab[:, None] == jnp.arange(k)[None, :]  # [N, K]
    ohf = oh.astype(jnp.float32)
    cos_a, sin_a = _angles(num_angles)
    u = x[:, None] * cos_a[None, :] + y[:, None] * sin_a[None, :]
    v = y[:, None] * cos_a[None, :] - x[:, None] * sin_a[None, :]

    def seg_min(w):  # [N, A] -> [K, A]
        return jnp.min(jnp.where(oh[:, :, None], w[:, None, :], big), axis=0)

    def seg_max(w):
        return jnp.max(jnp.where(oh[:, :, None], w[:, None, :], -big), axis=0)

    return dict(
        cnt=jnp.sum(ohf, axis=0),
        sx=jnp.sum(x[:, None] * ohf, axis=0),
        sy=jnp.sum(y[:, None] * ohf, axis=0),
        sz=jnp.sum(z[:, None] * ohf, axis=0),
        zlo=jnp.min(jnp.where(oh, z[:, None], big), axis=0),
        zhi=jnp.max(jnp.where(oh, z[:, None], -big), axis=0),
        ulo=seg_min(u),
        uhi=seg_max(u),
        vlo=seg_min(v),
        vhi=seg_max(v),
    )


def obb_accumulate_reference(
    hi, lo, labels, mn, *, voxel_size=0.1, max_clusters=128, num_angles=256
):
    """Dense oracle of obb_accumulate (test sizes only)."""
    x, y, z = morton_centers(hi, lo, mn, voxel_size)
    return obb_accumulate_xyz_reference(
        x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
    )
