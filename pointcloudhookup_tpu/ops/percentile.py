"""Masked percentiles on device.

The reference computes ``np.percentile(z, 25)`` over the whole cloud for
ground filtering (/root/reference/utils/tower_extraction.py:83).  On
device we provide:

  * `masked_percentile` — exact, sort-based, matches numpy's 'linear'
    interpolation on the valid subset of a padded buffer.
  * `histogram_percentile` — fixed-cost approximate percentile via a
    sharded-friendly histogram + refinement; used by the multi-device
    path where the global sort would need a gather (see
    pointcloudhookup_tpu/parallel/percentile.py).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def masked_percentile(x, mask, q):
    """Exact percentile of x[mask], matching np.percentile(..., method='linear').

    x: f32[N]; mask: bool[N]; q: scalar in [0, 100].
    Padded entries are sorted to the end as +inf.  Assumes at least one
    valid element.
    """
    x = jnp.asarray(x)
    n = jnp.sum(mask.astype(jnp.int32))
    xs = jnp.sort(jnp.where(mask, x, jnp.inf))
    h = (n - 1).astype(jnp.float32) * (jnp.float32(q) / 100.0)
    lo = jnp.clip(jnp.floor(h).astype(jnp.int32), 0, n - 1)
    hi = jnp.clip(lo + 1, 0, n - 1)
    frac = h - lo.astype(jnp.float32)
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def _f32_ordered_bits(x):
    """Order-preserving u32 view of f32: u(a) < u(b) iff a < b in the
    lax.sort total order (which places -0.0 before +0.0, like this map)."""
    b = lax.bitcast_convert_type(x, jnp.uint32)
    flip = jnp.where(
        (b >> 31) == jnp.uint32(1),
        jnp.uint32(0xFFFFFFFF),
        jnp.uint32(0x80000000),
    )
    return b ^ flip


def _f32_from_ordered_bits(u):
    """Inverse of _f32_ordered_bits."""
    b = jnp.where(
        (u >> 31) == jnp.uint32(1), u ^ jnp.uint32(0x80000000), ~u
    )
    return lax.bitcast_convert_type(b, jnp.float32)


def _order_statistic_bits(ubits, mask, rank, axis_name=None):
    """Bit pattern of the (rank+1)-th smallest masked element.

    The wanted value v* is the largest u32 a with count(ubits < a) <=
    rank (count(< v*) is v*'s first-occurrence index <= rank, and
    count(< v*+1) >= rank+1).  The predicate is monotone in a, so a is
    built greedily from the MSB: 32 masked [N] count-reductions instead
    of a full [N] sort.  With axis_name, counts are psum'd so the
    statistic is over the UNION of all shards' masked elements.
    """
    rank = rank.astype(jnp.int32)

    def body(b, ans):
        trial = ans | (jnp.uint32(1) << (31 - b))
        cnt = jnp.sum((mask & (ubits < trial)).astype(jnp.int32))
        if axis_name is not None:
            cnt = lax.psum(cnt, axis_name)
        return jnp.where(cnt <= rank, trial, ans)

    return lax.fori_loop(0, 32, body, jnp.uint32(0))


def masked_percentile_bisect(x, mask, q, axis_name=None):
    """Exact masked percentile WITHOUT the full [N] sort.

    Bit-identical to masked_percentile (numpy 'linear' interpolation on
    the valid subset): the two order statistics are found by radix
    bisection on the order-preserving u32 view of f32 — 33 masked [N]
    count/min passes instead of one sort.
    Assumes at least one valid element.

    With axis_name (inside shard_map), the percentile is EXACT over the
    union of every shard's masked elements: each of the 33 passes psums
    one scalar count over ICI — the distributed twin of np.percentile
    with no histogram approximation.
    """
    x = jnp.asarray(x)
    n = jnp.sum(mask.astype(jnp.int32))
    if axis_name is not None:
        n = lax.psum(n, axis_name)
    h = (n - 1).astype(jnp.float32) * (jnp.float32(q) / 100.0)
    lo = jnp.clip(jnp.floor(h).astype(jnp.int32), 0, n - 1)
    hi = jnp.clip(lo + 1, 0, n - 1)
    frac = h - lo.astype(jnp.float32)

    u = _f32_ordered_bits(x)
    v_lo = _order_statistic_bits(u, mask, lo, axis_name)
    # (hi+1)-th smallest: if v_lo still covers rank hi it IS v_hi, else
    # v_hi is the smallest masked value strictly above v_lo — one more
    # combined count/min pass instead of a second 32-step bisection
    above = mask & (u > v_lo)
    cnt_le = jnp.sum((mask & (u <= v_lo)).astype(jnp.int32))
    nxt = jnp.min(jnp.where(above, u, jnp.uint32(0xFFFFFFFF)))
    if axis_name is not None:
        cnt_le = lax.psum(cnt_le, axis_name)
        nxt = lax.pmin(nxt, axis_name)
    v_hi = jnp.where(cnt_le >= hi + 1, v_lo, nxt)
    x_lo = _f32_from_ordered_bits(v_lo)
    x_hi = _f32_from_ordered_bits(v_hi)
    return x_lo * (1.0 - frac) + x_hi * frac


def histogram_counts(x, mask, lo, hi, num_bins):
    """Histogram of x[mask] over [lo, hi] with num_bins bins.

    Values are clipped into range.  Returns i32[num_bins].  This is the
    per-shard building block for the distributed percentile (each shard
    histograms locally, counts are summed with psum).

    Implemented as sort + searchsorted + adjacent difference (the 4096
    edge searches are binary lookups).
    """
    xs = jnp.sort(jnp.where(mask, jnp.clip(x, lo, hi), jnp.inf))
    n = jnp.sum(mask.astype(jnp.int32))
    edges = lo + (hi - lo) * jnp.arange(1, num_bins + 1, dtype=jnp.float32) / num_bins
    cdf = jnp.searchsorted(xs, edges, side="right").astype(jnp.int32)
    cdf = jnp.minimum(cdf, n)  # padding (+inf) never counts
    cdf = cdf.at[-1].set(n)  # top edge owns everything at hi
    return jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.int32), cdf]))


def percentile_from_histogram(counts, lo, hi, q):
    """Approximate percentile from histogram counts (bin-left-edge + linear
    within the selected bin by rank fraction)."""
    num_bins = counts.shape[0]
    total = jnp.sum(counts)
    target = (total - 1).astype(jnp.float32) * (jnp.float32(q) / 100.0)
    cum = jnp.cumsum(counts)
    bin_idx = jnp.searchsorted(cum.astype(jnp.float32), target, side="right")
    bin_idx = jnp.clip(bin_idx, 0, num_bins - 1)
    prev_cum = jnp.where(bin_idx > 0, cum[jnp.maximum(bin_idx - 1, 0)], 0)
    in_bin = jnp.maximum(counts[bin_idx], 1)
    frac = (target - prev_cum.astype(jnp.float32)) / in_bin.astype(jnp.float32)
    width = (hi - lo) / num_bins
    return lo + (bin_idx.astype(jnp.float32) + jnp.clip(frac, 0.0, 1.0)) * width


def histogram_percentile(x, mask, q, num_bins=4096):
    """Single-shard approximate percentile (histogram method)."""
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(mask, x, big))
    hi = jnp.max(jnp.where(mask, x, -big))
    counts = histogram_counts(x, mask, lo, hi, num_bins)
    return percentile_from_histogram(counts, lo, hi, q)
