"""Knob-free adaptive clustering — the device analogue of the
reference's HDBSCAN path (/root/reference/test/008.py:245-268, which
switches to HDBSCAN(boruvka_kdtree, min_cluster_size) when available so
the operator never tunes eps).

True HDBSCAN builds a mutual-reachability MST — inherently serial and
data-dependent, a poor fit for XLA.  What its usage in the reference
actually buys is (a) no eps knob and (b) min-cluster-SIZE semantics.
Both are captured with compiler-friendly pieces:

  1. eps is DERIVED from the data: the core-distance quantile.  A
     strided subsample's k-th-NN distances (k rescaled by the sampling
     ratio, matching HDBSCAN's core distance d_k with k = min_samples)
     are measured with one dense [S, S] block matrix; eps* = Q_q of
     them.  DBSCAN at the core-distance quantile is the classic flat
     cut of the mutual-reachability hierarchy (robust single linkage).
  2. grid_dbscan clusters at eps*.
  3. clusters smaller than min_cluster_size points are demoted to
     noise (HDBSCAN's min_cluster_size, which plain DBSCAN lacks —
     its min_points bounds the NEIGHBORHOOD, not the cluster).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_S = 4096  # subsample size for the core-distance probe


@functools.partial(jax.jit, static_argnames=("k", "sample", "quantile"))
def estimate_eps(xyz, mask, *, k: int = 4, sample: int = _S, quantile: float = 60.0):
    """Core-distance quantile from a strided subsample.

    xyz: f32[N,3]; mask: bool[N]; k: which NN ranks as the core
    distance IN THE SAMPLE (callers rescale from min_points by the
    sampling ratio).  Returns a scalar eps.
    """
    n = xyz.shape[0]
    s = min(sample, n)
    stride = max(n // s, 1)
    pts = xyz[::stride][:s]
    mk = mask[::stride][:s]
    big = jnp.float32(3.0e38)
    pts = jnp.where(mk[:, None], pts, big)
    # dense [S, S] distances in difference form (exact in f32 at
    # corridor scales); self + padded rows excluded via +inf
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(jnp.eye(s, dtype=bool) | ~mk[None, :], jnp.inf, d2)
    kk = min(max(k, 1), s - 1)
    dk2 = -lax.top_k(-d2, kk)[0][:, kk - 1]  # k-th smallest per row
    dk = jnp.sqrt(jnp.where(mk, dk2, jnp.nan))
    return jnp.nanpercentile(dk, quantile)


def adaptive_cluster(
    xyz,
    mask,
    min_points: int,
    *,
    min_cluster_size: int | None = None,
    max_cells: int = 65536,
    min_cell_points: int = 1,
    eps_quantile: float = 60.0,
    eps_floor: float = 0.5,
    eps_ceil: float = 64.0,
    eps_fallback: float | None = None,
):
    """HDBSCAN-analogue: data-derived eps + min-cluster-size filtering.

    Returns (labels i32[N] compact ids / -1 noise, core bool[N], eps).

    When the subsample has fewer than k valid points (sparse tiles) the
    k-th-NN core distances are inf and the estimate saturates; rather
    than silently clustering at the 64 m ceiling (which can merge
    unrelated structures), a non-finite or ceiling-saturated estimate
    falls back to `eps_fallback` (the configured DBSCAN eps) when one is
    supplied.
    """
    from pointcloudhookup_tpu.ops.cluster_grid import grid_dbscan

    n = xyz.shape[0]
    if min_cluster_size is None:
        min_cluster_size = min_points
    # rescale min_points to the subsample's NN rank: the k-th NN in an
    # r-fraction sample sits near the (k/r)-th NN of the full data
    n_valid = int(n)  # static upper bound; ratio uses capacity
    ratio = min(_S / max(n_valid, 1), 1.0)
    # keep the rank faithful to min_points (HDBSCAN core distance d_k,
    # k = min_samples): eps* must be the distance at which a min_points
    # neighborhood actually fills, else downstream DBSCAN finds no cores
    k = max(1, min(int(round(min_points * ratio)), 128))
    eps_raw = estimate_eps(xyz, mask, k=k, quantile=eps_quantile)
    eps = jnp.clip(eps_raw, eps_floor, eps_ceil)
    if eps_fallback is not None:
        bad = ~jnp.isfinite(eps_raw) | (eps_raw >= jnp.float32(eps_ceil))
        eps = jnp.where(bad, jnp.float32(eps_fallback), eps)

    labels, core = grid_dbscan(
        xyz, mask, eps, min_points,
        max_cells=max_cells, min_cell_points=min_cell_points,
    )
    # label ids are compact in [0, max_cells): size the filter's label
    # table to the FULL id space, else clusters with id >= the table
    # size would be mis-filtered by the clipped lookup
    labels = _filter_small_clusters(labels, min_cluster_size, max_labels=max_cells)
    core = core & (labels >= 0)
    return labels, core, eps


@functools.partial(jax.jit, static_argnames=("min_cluster_size", "max_labels"))
def _filter_small_clusters(labels, min_cluster_size: int, max_labels: int = 4096):
    """Demote clusters with fewer than min_cluster_size members to
    noise.  Sort-free on the read side: one label sort + searchsorted
    run bounds."""
    n = labels.shape[0]
    lab = jnp.where(labels >= 0, labels, max_labels).astype(jnp.int32)
    lab_s = lax.sort((lab,), num_keys=1)[0]
    ar = jnp.arange(max_labels, dtype=jnp.int32)
    lefts = jnp.searchsorted(lab_s, ar, side="left")
    rights = jnp.searchsorted(lab_s, ar, side="right")
    sizes = (rights - lefts).astype(jnp.int32)
    keep_label = sizes >= jnp.int32(min_cluster_size)
    ok = (labels >= 0) & keep_label[jnp.clip(labels, 0, max_labels - 1)]
    return jnp.where(ok, labels, -1)
