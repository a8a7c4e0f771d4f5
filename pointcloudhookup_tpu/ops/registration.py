"""Batched rigid registration: Kabsch + point-to-point ICP.

The reference has NO registration code — its "matching" is greedy
nearest-neighbor under fixed thresholds (SURVEY.md section 0, negative
finding) — but BASELINE.json's north star upgrades the GIM<->cloud
matching path to batched ICP: align each extracted tower cluster to its
GIM pylon model, vmapped over a whole corridor's towers at once
(config 4: 50-tower batches).

Design: fixed-capacity padded clouds per tower; nearest neighbors by
tiled pairwise distance (an [N,3]x[3,M] matmul per tower at HIGHEST
precision, batched over towers); weighted Kabsch via batched 3x3 SVD.  Everything is
fixed-shape and jit/vmap friendly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def kabsch(src, dst, weights):
    """Weighted rigid alignment src -> dst (single pair).

    src, dst: f32[N,3] corresponding points; weights: f32[N].
    Returns (R f32[3,3], t f32[3]) minimizing sum w |R src + t - dst|^2.
    """
    w = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    mu_s = jnp.sum(src * w[:, None], axis=0)
    mu_d = jnp.sum(dst * w[:, None], axis=0)
    s = src - mu_s
    d = dst - mu_d
    h = jnp.einsum(
        "ni,nj->ij", s * w[:, None], d, precision=jax.lax.Precision.HIGHEST
    )
    u, _, vt = jnp.linalg.svd(h)
    det = jnp.linalg.det(_mm(vt.T, u.T))
    flip = jnp.diag(jnp.array([1.0, 1.0, 1.0]).at[2].set(jnp.sign(det)))
    r = _mm(_mm(vt.T, flip), u.T)
    t = mu_d - _mm(r, mu_s)
    return r, t


def _mm(a, b):
    """f32 product at full precision: the GPU may run a default one in
    TF32 (~1e-3 relative), which at km-scale coordinates moves points by
    metres — far beyond the correspondence distances ICP compares."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _nearest(src, src_mask, dst, dst_mask):
    """For each src point, index + squared distance of nearest dst point."""
    d2 = (
        jnp.sum(src * src, axis=1)[:, None]
        + jnp.sum(dst * dst, axis=1)[None, :]
        - 2.0 * jnp.dot(src, dst.T, precision=jax.lax.Precision.HIGHEST)
    )
    d2 = jnp.where(dst_mask[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
    best = jnp.where(src_mask, best, jnp.inf)
    return idx, best


@functools.partial(jax.jit, static_argnames=("iters",))
def icp(
    src,
    src_mask,
    dst,
    dst_mask,
    iters: int = 20,
    max_corr_dist=jnp.inf,
):
    """Point-to-point ICP aligning src onto dst (single pair).

    src f32[N,3]/mask, dst f32[M,3]/mask.  Fixed `iters` sweeps (static
    for compilation); correspondences beyond max_corr_dist are
    down-weighted to zero.  Returns dict(R, t, rmse, inlier_frac).
    """

    def body(carry, _):
        r, t = carry
        moved = _mm(src, r.T) + t
        idx, d2 = _nearest(moved, src_mask, dst, dst_mask)
        corr = dst[idx]
        w = (src_mask & (d2 <= max_corr_dist**2)).astype(jnp.float32)
        r2, t2 = kabsch(src, corr, w + 1e-9)
        return (r2, t2), None

    init = (jnp.eye(3, dtype=src.dtype), jnp.zeros(3, src.dtype))
    (r, t), _ = jax.lax.scan(body, init, None, length=iters)
    moved = _mm(src, r.T) + t
    _, d2 = _nearest(moved, src_mask, dst, dst_mask)
    w = src_mask.astype(jnp.float32)
    inl = (src_mask & (d2 <= max_corr_dist**2)).astype(jnp.float32)
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(src_mask, d2, 0.0)) / jnp.maximum(jnp.sum(w), 1.0)
    )
    return dict(
        R=r,
        t=t,
        rmse=rmse,
        inlier_frac=jnp.sum(inl) / jnp.maximum(jnp.sum(w), 1.0),
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def batched_icp(src, src_mask, dst, dst_mask, iters: int = 20, max_corr_dist=jnp.inf):
    """vmapped ICP over a tower batch: src f32[B,N,3], dst f32[B,M,3].
    This is BASELINE config 4's kernel (50-tower corridor batches)."""
    return jax.vmap(
        lambda s, sm, d, dm: icp(s, sm, d, dm, iters=iters, max_corr_dist=max_corr_dist)
    )(src, src_mask, dst, dst_mask)


def register_tower_pairs(
    pc_clouds,
    gim_clouds,
    iters: int = 20,
    max_corr_dist: float = 5.0,
):
    """Host conven­ience: list of (src, dst) numpy clouds of varying sizes
    -> padded batch -> batched_icp -> list of dicts with numpy R/t."""
    import numpy as np

    if not pc_clouds:
        return []
    n = max(max(len(c) for c in pc_clouds), 8)
    m = max(max(len(c) for c in gim_clouds), 8)
    b = len(pc_clouds)
    src = np.zeros((b, n, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dst = np.zeros((b, m, 3), np.float32)
    dm = np.zeros((b, m), bool)
    for i, (s, d) in enumerate(zip(pc_clouds, gim_clouds)):
        src[i, : len(s)] = s
        sm[i, : len(s)] = True
        dst[i, : len(d)] = d
        dm[i, : len(d)] = True
    out = batched_icp(
        jnp.asarray(src), jnp.asarray(sm), jnp.asarray(dst), jnp.asarray(dm),
        iters=iters, max_corr_dist=max_corr_dist,
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    return [
        dict(R=out["R"][i], t=out["t"][i], rmse=float(out["rmse"][i]),
             inlier_frac=float(out["inlier_frac"][i]))
        for i in range(b)
    ]
