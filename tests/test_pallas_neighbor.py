"""The tiled neighbour pass (ops/neighbor.py) against its dense
oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointcloudhookup_tpu.ops.neighbor import (
    neighbor_reduce,
    neighbor_reduce_reference,
)


def _safe_eps2(xyz, target=400.0):
    """An eps^2 with a wide margin to every pairwise distance, so no
    decision rests on the last bit of a fused multiply-add."""
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1).ravel()
    d2 = np.sort(d2[d2 > 0])
    i = np.searchsorted(d2, target)
    lo = d2[max(i - 1, 0)]
    hi = d2[min(i, len(d2) - 1)]
    return float((lo + hi) / 2) if hi - lo > 1e-3 else float(target)


@pytest.mark.parametrize("m", [1024, 2048])
def test_neighbor_reduce_matches_reference(rng, m):
    xyz = rng.normal(0, 50, size=(m, 3)).astype(np.float32)
    labels = rng.integers(0, m, m).astype(np.int32)
    weights = rng.uniform(0, 3, m).astype(np.float32)
    allowed = rng.uniform(size=m) > 0.3
    eps2 = _safe_eps2(xyz.astype(np.float64))
    args = (jnp.asarray(xyz), jnp.asarray(labels), jnp.asarray(weights),
            jnp.asarray(allowed), eps2)
    pop, lmin = neighbor_reduce(*args)
    pop_r, lmin_r = neighbor_reduce_reference(*args)
    np.testing.assert_allclose(np.asarray(pop), np.asarray(pop_r), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(lmin), np.asarray(lmin_r))


def test_neighbor_reduce_no_neighbors(rng):
    xyz = (np.arange(1024)[:, None] * np.array([1000.0, 0, 0])).astype(np.float32)
    labels = np.arange(1024, dtype=np.int32)
    pop, lmin = neighbor_reduce(
        jnp.asarray(xyz), jnp.asarray(labels),
        jnp.ones(1024, jnp.float32), jnp.zeros(1024, bool), 1.0,
    )
    assert (np.asarray(pop) == 0).all()
    assert (np.asarray(lmin) == 1024).all()
