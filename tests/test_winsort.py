"""frontend_fused.window_sort: two offset window sorts must equal the
numpy reference (sort within 256-windows at offsets 0 and 128) and
deliver the hier guarantee: exact (k1, w) order for every k1-run <= 129."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.frontend_fused import window_sort

_BLOCK = 32768


def _make(n, max_run, seed=0):
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
    w = rng.integers(0, 1 << 15, n).astype(np.uint16)
    return k1, w


def _reference(k1, w):
    """Two offset window sorts of (k1, w), W=256."""
    n = len(k1)
    out = w.astype(np.int32).copy()

    def winpass(off):
        for s in range(off, n - 255, 256):
            sl = slice(s, s + 256)
            order = np.lexsort((out[sl], k1[sl]))
            out[sl] = out[sl][order]

    winpass(0)
    winpass(128)
    return out


def _sorted_w(k1, w):
    k1_out, w_out = window_sort(jnp.asarray(k1), jnp.asarray(w), 256)
    np.testing.assert_array_equal(np.asarray(k1_out), k1)  # k1 invariant
    return np.asarray(w_out).astype(np.int32)


@pytest.mark.parametrize("max_run", [1, 3, 17, 129])
def test_matches_reference(max_run):
    n = 2 * _BLOCK
    k1, w = _make(n, max_run, seed=max_run)
    np.testing.assert_array_equal(_sorted_w(k1, w), _reference(k1, w))


def test_guarantee_runs_le_129():
    """Every k1-run <= 129 must be exactly (k1, w)-sorted afterwards."""
    n = 2 * _BLOCK
    k1, w = _make(n, 129, seed=7)
    got = _sorted_w(k1, w)
    # within each run, w must be ascending
    starts = np.flatnonzero(np.r_[True, k1[1:] != k1[:-1]])
    ends = np.r_[starts[1:], n]
    for s, e in zip(starts, ends):
        assert (np.diff(got[s:e]) >= 0).all(), f"run [{s},{e}) unsorted"
    # and the multiset per run is preserved
    np.testing.assert_array_equal(np.sort(got), np.sort(w.astype(np.int32)))


def test_k1_invariance_precondition():
    """The wrapper's contract: k1 itself is window-sort-invariant."""
    k1, w = _make(_BLOCK, 50, seed=3)
    for off in (0, 128):
        for s in range(off, _BLOCK - 255, 256):
            seg = k1[s : s + 256]
            assert (np.diff(seg.astype(np.int64)) >= 0).all()
