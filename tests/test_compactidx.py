"""compact_indices (ops/compact.py): positions of the first m set flags,
the frontend's dense-cell table pack, against numpy."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.compact import compact_indices

_BLOCK = 32768


def _expect(flag, m):
    idx = np.flatnonzero(flag)[:m]
    out = np.full(m, len(flag) - 1, np.int32)
    out[: len(idx)] = idx
    return out


def _check(flag, m):
    got = np.asarray(compact_indices(jnp.asarray(flag), m))
    np.testing.assert_array_equal(got, _expect(flag, m))


@pytest.mark.parametrize("density", [0.0, 0.001, 0.05, 0.9])
def test_random_densities(density):
    rng = np.random.default_rng(int(density * 1000))
    flag = rng.random(2 * _BLOCK) < density
    _check(flag, 512)


def test_block_boundaries():
    flag = np.zeros(2 * _BLOCK, bool)
    # around a 32k seam, the block ends, and the array ends
    for i in (0, 1, _BLOCK - 1, _BLOCK, _BLOCK + 1, 2 * _BLOCK - 1):
        flag[i] = True
    _check(flag, 16)


def test_count_exceeds_m():
    rng = np.random.default_rng(7)
    flag = rng.random(_BLOCK) < 0.5  # ~16k set bits, m = 64
    _check(flag, 64)


def test_lane_patterns():
    # a contiguous run of 128; every other row
    flag = np.zeros(_BLOCK, bool)
    flag[256:384] = True
    _check(flag, 256)
    flag = np.zeros(_BLOCK, bool)
    flag[::2] = True
    _check(flag, 128)
