"""Order-preserving stream compaction into fixed-capacity buffers.

The device frontends cut a tile to its above-ground survivors before
the sort, pack their dense-cell tables from per-row start flags, gather
core cells into the flood table and labelled rows into the OBB sort.
All are compactions: the selected rows move, in input order, to the
front of a fixed-size buffer.  XLA lowers `jnp.nonzero(size=...)` to a
prefix sum plus one scatter, which is bandwidth-bound on the GPU.  This
module is the one place that does it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.morton import SENTINEL_HI


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_rows_multi(keep, channels, capacity: int):
    """Compact every channel's rows where `keep` into [capacity] buffers.

    keep bool[N]; channels: tuple of [N] arrays.  Returns (compacted
    tuple, count): rows [0, min(count, capacity)) hold the kept rows in
    input order, the remainder holds zeros.  count is the TRUE number of
    kept rows; count > capacity means the tail was dropped.
    """
    n = keep.shape[0]
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    for c in channels:
        if c.shape[0] != n:
            raise ValueError(
                f"channel length {c.shape[0]} does not match mask length {n}"
            )
    count = jnp.sum(keep.astype(jnp.int32))
    (idx,) = jnp.nonzero(keep, size=capacity, fill_value=0)
    ok = jnp.arange(capacity, dtype=jnp.int32) < jnp.minimum(count, capacity)
    comp = tuple(
        jnp.where(ok, jnp.take(c, idx, indices_are_sorted=True), 0)
        for c in channels
    )
    return comp, count


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_rows(keep, hi, lo, capacity: int):
    """compact_rows_multi over Morton (hi, lo) rows; slots past the
    count carry the Morton sentinel in hi.  Returns (hi_c, lo_c, count)."""
    (hi_c, lo_c), count = compact_rows_multi(keep, (hi, lo), capacity)
    ok = jnp.arange(capacity, dtype=jnp.int32) < jnp.minimum(count, capacity)
    hi_c = jnp.where(ok, hi_c, jnp.int32(SENTINEL_HI))
    return hi_c, lo_c, count


@functools.partial(jax.jit, static_argnames=("m",))
def compact_indices(flag, m: int):
    """Positions (ascending) of the first m True entries of flag[N];
    slots beyond the total count hold N-1."""
    n = flag.shape[0]
    (idx,) = jnp.nonzero(flag, size=m, fill_value=n - 1)
    return idx.astype(jnp.int32)
