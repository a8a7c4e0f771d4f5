"""compact_rows / compact_rows_multi: order-preserving stream compaction
into fixed-capacity buffers (ops/compact.py) against numpy boolean
indexing, across densities, bursty runs, sentinel padding and capacity
overflow."""

import numpy as np
import pytest

pytestmark = pytest.mark.heavy  # compile-heavy on a cold 1-core host; quick tier = pytest -m 'not heavy'

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pointcloudhookup_tpu.ops.compact import (  # noqa: E402
    compact_rows,
    compact_rows_multi,
)
from pointcloudhookup_tpu.ops.morton import SENTINEL_HI  # noqa: E402

_BLOCK = 32768
_CHUNK = 32768


def _run(keep, hi, lo, cap):
    return compact_rows(jnp.asarray(keep), jnp.asarray(hi), jnp.asarray(lo), cap)


@pytest.mark.parametrize("p", [0.02, 0.22, 0.93])
def test_random_density(p):
    rng = np.random.default_rng(int(p * 100))
    n = _BLOCK
    keep = rng.random(n) < p
    hi = rng.integers(0, 2**30, n, dtype=np.int32)
    lo = rng.integers(0, 2**30, n, dtype=np.int32)
    cap = _CHUNK * ((int(keep.sum()) // _CHUNK) + 1)
    hi_c, lo_c, cnt = _run(keep, hi, lo, cap)
    assert int(cnt) == int(keep.sum())
    k = int(cnt)
    np.testing.assert_array_equal(np.asarray(hi_c[:k]), hi[keep])
    np.testing.assert_array_equal(np.asarray(lo_c[:k]), lo[keep])
    assert (np.asarray(hi_c[k:]) == SENTINEL_HI).all()
    assert (np.asarray(lo_c[k:]) == 0).all()


def test_none_and_all():
    n = _BLOCK
    hi = np.arange(n, dtype=np.int32)
    lo = np.arange(n, dtype=np.int32)[::-1].copy()
    hi_c, lo_c, cnt = _run(np.zeros(n, bool), hi, lo, _CHUNK)
    assert int(cnt) == 0
    assert (np.asarray(hi_c) == SENTINEL_HI).all()
    hi_c, lo_c, cnt = _run(np.ones(n, bool), hi, lo, n)
    assert int(cnt) == n
    np.testing.assert_array_equal(np.asarray(hi_c), hi)
    np.testing.assert_array_equal(np.asarray(lo_c), lo)


def test_bursty_runs():
    # long all-kept runs followed by long all-dropped runs
    n = _BLOCK * 4
    keep = np.zeros(n, bool)
    keep[5000:21000] = True
    keep[40000:40001] = True
    keep[90000:130000] = True
    hi = np.arange(n, dtype=np.int32)
    lo = (np.arange(n, dtype=np.int32) * 7) & 0x3FFFFFFF
    cap = _CHUNK * 4
    hi_c, lo_c, cnt = _run(keep, hi, lo, cap)
    assert int(cnt) == int(keep.sum())
    k = min(int(cnt), cap)
    np.testing.assert_array_equal(np.asarray(hi_c[:k]), hi[keep][:k])
    np.testing.assert_array_equal(np.asarray(lo_c[:k]), lo[keep][:k])


def test_capacity_overflow_reports_true_count():
    rng = np.random.default_rng(3)
    n = _BLOCK * 2
    keep = rng.random(n) < 0.8
    hi = rng.integers(0, 2**30, n, dtype=np.int32)
    lo = rng.integers(0, 2**30, n, dtype=np.int32)
    cap = _CHUNK  # deliberately too small
    hi_c, lo_c, cnt = _run(keep, hi, lo, cap)
    assert int(cnt) == int(keep.sum()) > cap
    # the prefix that fits is exact and in order
    np.testing.assert_array_equal(np.asarray(hi_c[:cap]), hi[keep][:cap])


def test_validation_errors():
    n = 1000
    z = jnp.zeros(n, jnp.int32)
    with pytest.raises(ValueError, match="does not match"):
        compact_rows(jnp.zeros(n + 1, bool), z, z, 64)
    with pytest.raises(ValueError, match="positive"):
        compact_rows(jnp.zeros(n, bool), z, z, 0)


def test_multi_channel_four():
    # the exact-semantics front-end routes (x, y, z, row index) — four
    # channels of mixed dtype, capacity not a power of two
    rng = np.random.default_rng(7)
    n = 50_000
    keep = rng.random(n) < 0.21
    chans = (
        rng.normal(0, 500, n).astype(np.float32),
        rng.normal(0, 500, n).astype(np.float32),
        rng.normal(0, 20, n).astype(np.float32),
        np.arange(n, dtype=np.int32),
    )
    cap = 12_345
    comp, cnt = compact_rows_multi(
        jnp.asarray(keep), tuple(jnp.asarray(c) for c in chans), cap
    )
    assert int(cnt) == int(keep.sum())
    k = min(int(cnt), cap)
    for got, c in zip(comp, chans):
        got = np.asarray(got)
        assert got.dtype == c.dtype
        np.testing.assert_array_equal(got[:k], c[keep][:k])
        assert (got[k:] == 0).all()
