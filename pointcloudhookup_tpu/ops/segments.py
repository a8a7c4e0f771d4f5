"""Scatter-free segment reductions over SORTED data.

This pipeline's segments (voxel cells, grid cells, cluster members)
always come from a device sort, which makes every reduction
expressible with sort-native, elementwise-parallel primitives:

  * boundary flags + prefix sums give segment ids;
  * forward/backward monotone scans give each row its segment's start
    and one-past-end positions;
  * per-segment sums = cumulative-sum differences at the boundaries;
  * per-segment max/min = segmented associative scans (flag-reset op);
  * packing a bounded table of segments = ONE more sort by packed index
    instead of a scatter.

These are the building blocks for ops/voxel.py, ops/cluster_grid.py and
ops/obb.py.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def boundary_flags(*keys):
    """is_start[i]: row i begins a new segment in key-sorted order."""
    n = keys[0].shape[0]
    flag = jnp.zeros(n, bool)
    for k in keys:
        flag = flag | (k != jnp.roll(k, 1))
    return flag.at[0].set(True)


def segment_spans(is_start):
    """For each row of sorted data: (start, nxt) where start is the
    first row of its segment and nxt is one past the last.

    Native lax.cummax/cummin (not the generic associative_scan): XLA
    has a dedicated cumulative-op lowering that compiles in seconds
    where the recursive associative_scan graph takes minutes at
    corridor sizes, and runs at memcpy speed."""
    n = is_start.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    start = lax.cummax(jnp.where(is_start, iota, -1), axis=0)
    behind = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
    nxt = lax.cummin(jnp.where(behind, iota + 1, n), axis=0, reverse=True)
    return start, nxt


def segment_sum_rows(values, is_start, nxt):
    """Per-row: sum of `values` over the row's whole segment.
    values: [N] or [N, C].

    Uses a segmented (boundary-resetting) scan rather than a global
    cumsum difference: global prefixes of millions of coordinates
    cancel catastrophically in f32, while segment-local accumulation
    keeps full precision for the short segments this pipeline produces.
    """
    scan = segmented_scan(jnp.add, values, is_start)
    n = values.shape[0]
    end = jnp.clip(nxt - 1, 0, n - 1)
    return scan[end]


def segmented_scan(op, values, is_start, reverse: bool = False):
    """Segmented inclusive scan of `op` (e.g. jnp.maximum) along axis 0,
    restarting at each is_start row (or segment end if reverse).

    A Hillis-Steele doubling loop of [N]-shaped shifted combines (log2 N
    unrolled steps, each a pad/slice + where — no gathers, no odd/even
    recursion).  The tupled associative_scan it replaces emitted a
    recursive slice/concat graph that took minutes of XLA compile at
    4M rows."""
    flags = is_start
    if reverse:
        # reset flags for a backward scan are the segment-END rows
        flags = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
        return _segmented_scan_fwd(op, values[::-1], flags[::-1])[::-1]
    return _segmented_scan_fwd(op, values, flags)


def _segmented_scan_fwd(op, values, flags):
    n = values.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    v = values
    f = flags
    d = 1
    while d < n:
        # state[i] <- combine(state[i-d], state[i]) for i >= d
        vprev = jnp.concatenate([v[:d], v[:-d]], axis=0)  # [i-d]; rows <d masked
        fprev = jnp.concatenate([f[:d], f[:-d]])
        valid = iota >= d
        blocked = f | ~valid  # own flag: segment starts here, don't merge
        if values.ndim == 2:
            v = jnp.where(blocked[:, None], v, op(vprev, v))
        else:
            v = jnp.where(blocked, v, op(vprev, v))
        f = f | (fprev & valid)
        d <<= 1
    return v


def segment_max_rows(values, is_start):
    """Per-row: max of `values` over the row's whole segment (forward +
    backward segmented scans combined)."""
    fwd = segmented_scan(jnp.maximum, values, is_start)
    bwd = segmented_scan(jnp.maximum, values, is_start, reverse=True)
    return jnp.maximum(fwd, bwd)


def segment_min_rows(values, is_start):
    fwd = segmented_scan(jnp.minimum, values, is_start)
    bwd = segmented_scan(jnp.minimum, values, is_start, reverse=True)
    return jnp.minimum(fwd, bwd)


def pack_segments(sort_key, payloads, capacity: int):
    """Pack one row per segment into a fixed-size table WITHOUT scatter.

    sort_key: i32[N], `capacity`-clipped packed index at the segment's
    representative rows, >= capacity elsewhere (those rows are dropped).
    payloads: tuple of [N] arrays.  Returns tuple of [capacity] arrays
    (padded rows keep whatever the >=capacity rows carried — mask via a
    payload).  Cost: one `lax.sort` over N rows.
    """
    n = sort_key.shape[0]
    sorted_all = lax.sort((sort_key, *payloads), num_keys=1)
    if capacity <= n:
        return tuple(p[:capacity] for p in sorted_all[1:])
    pad = capacity - n
    return tuple(
        jnp.concatenate([p, jnp.zeros((pad,) + p.shape[1:], p.dtype)])
        for p in sorted_all[1:]
    )
