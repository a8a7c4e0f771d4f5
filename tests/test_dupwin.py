"""Windowed first-occurrence flags (frontend_fused._dup_window_flags):
must equal the numpy oracle and deliver the cell-mode guarantee, exact
voxel dedup for every cell run <= depth+1."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.frontend_fused import _dup_window_flags

_BLOCK = 32768


def first_occurrence_flags_reference(k1, w, depth: int = 64):
    """Numpy oracle: flag[i] = no j in [i-depth, i) with equal (k1, w)."""
    k1 = np.asarray(k1)
    w = np.asarray(w)
    n = len(k1)
    dup = np.zeros(n, bool)
    for d in range(1, depth + 1):
        dup[d:] |= (k1[d:] == k1[:-d]) & (w[d:] == w[:-d])
    return ~dup


def _flags(k1, w, depth):
    return np.asarray(
        _dup_window_flags(jnp.asarray(k1), jnp.asarray(w), depth, len(k1))
    )


def _make(n, max_run, dup_frac, seed=0):
    """k1 runs of random length; w values drawn with duplicates."""
    rng = np.random.default_rng(seed)
    runs = []
    total = 0
    while total < n:
        r = int(rng.integers(1, max_run + 1))
        runs.append(min(r, n - total))
        total += runs[-1]
    k1 = np.repeat(np.cumsum(rng.integers(1, 5, len(runs))), runs).astype(
        np.uint32
    )[:n]
    # small w alphabet inside runs so duplicates actually occur
    hi = max(2, int(max_run * (1.0 - dup_frac)))
    w = rng.integers(0, hi, n).astype(np.int32)
    return k1, w


@pytest.mark.parametrize("max_run,dup_frac", [(1, 0.0), (5, 0.5), (40, 0.3), (65, 0.6)])
def test_matches_oracle(max_run, dup_frac):
    n = 2 * _BLOCK
    k1, w = _make(n, max_run, dup_frac, seed=max_run)
    np.testing.assert_array_equal(
        _flags(k1, w, 64), first_occurrence_flags_reference(k1, w, depth=64)
    )


def test_guarantee_runs_le_depth_plus_1():
    """For runs <= D+1 the flags are TRUE first-occurrence flags."""
    n = 2 * _BLOCK
    depth = 64
    k1, w = _make(n, depth + 1, 0.5, seed=9)
    got = _flags(k1, w, depth)
    # oracle: true first occurrence within the whole k1-run
    seen = set()
    expect = np.zeros(n, bool)
    prev = None
    for i in range(n):
        if k1[i] != prev:
            seen = set()
            prev = k1[i]
        expect[i] = w[i] not in seen
        seen.add(int(w[i]))
    np.testing.assert_array_equal(got, expect)


def test_small_depth_and_validation():
    k1, w = _make(_BLOCK, 3, 0.5, seed=2)
    np.testing.assert_array_equal(
        _flags(k1, w, 2), first_occurrence_flags_reference(k1, w, depth=2)
    )
    # depth 0 compares nothing: every row is a first occurrence, and an
    # array that is not a multiple of any block size is fine
    assert _flags(k1[:1000], w[:1000], 0).all()
