"""segmented_scan (ops/segments.py, the XLA doubling scan) against a
sequential numpy oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.segments import segmented_scan

_OPS = {"add": (jnp.add, np.add), "max": (jnp.maximum, np.maximum),
        "min": (jnp.minimum, np.minimum)}


def _oracle(op, values, is_start, reverse=False):
    v = np.asarray(values)
    s = np.asarray(is_start)
    if reverse:
        ends = np.r_[s[1:], True]
        return _oracle(op, v[::-1], ends[::-1])[::-1]
    out = v.copy()
    for i in range(1, len(v)):
        if not s[i]:
            out[i] = op(out[i - 1], v[i])
    return out


def _case(rng, n, dtype):
    if dtype == np.int32:
        v = rng.integers(-50, 50, n).astype(np.int32)
    else:
        # multiples of 1/8: every partial sum is exact in f32, so any
        # summation order must give the oracle's values bit for bit
        v = (rng.integers(-400, 400, n) / 8.0).astype(np.float32)
    s = rng.random(n) < 0.01
    s[0] = True
    return v, s


@pytest.mark.heavy
def test_segscan_all_ops_match_oracle(rng):
    n = 65536
    for dtype in (np.int32, np.float32):
        v, s = _case(rng, n, dtype)
        for name, (op, np_op) in _OPS.items():
            for reverse in (False, True):
                got = segmented_scan(op, jnp.asarray(v), jnp.asarray(s),
                                     reverse=reverse)
                want = _oracle(np_op, v, s, reverse=reverse)
                np.testing.assert_array_equal(
                    np.asarray(got), want,
                    err_msg=f"{name} reverse={reverse} {dtype}",
                )


def test_segscan_segment_spanning_blocks(rng):
    """One segment covering the whole array: the scan must carry across
    every doubling step."""
    n = 3 * 32768
    v = jnp.ones(n, jnp.int32)
    s = jnp.zeros(n, bool).at[0].set(True)
    got = segmented_scan(jnp.add, v, s)
    np.testing.assert_array_equal(
        np.asarray(got), np.arange(1, n + 1, dtype=np.int32)
    )
    # reverse: totals accumulate toward the front
    got_r = segmented_scan(jnp.add, v, s, reverse=True)
    np.testing.assert_array_equal(
        np.asarray(got_r), np.arange(n, 0, -1, dtype=np.int32)
    )
