"""Edge cases of the tiled neighbour pass (ops/neighbor.py): tiles that
do not divide the table, a table with no live row, and the eps boundary
itself."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointcloudhookup_tpu.ops.neighbor import (
    cluster_cells,
    cluster_cells_reference,
    neighbor_reduce,
    neighbor_reduce_reference,
)


def _cell_table(rng, m, n_alive, cell=4.0):
    """A packed cell table like the frontends': centers on the
    (k + 0.5) * cell lattice (exact in f32), live rows first, dead rows
    at +3e38."""
    centers = np.full((m, 3), 3.0e38, np.float32)
    ijk = rng.integers(0, 40, size=(n_alive, 3))
    centers[:n_alive] = (ijk + 0.5) * cell
    w = np.zeros(m, np.float32)
    w[:n_alive] = rng.integers(1, 30, n_alive)
    alive = np.arange(m) < n_alive
    return centers, w, alive


@pytest.mark.parametrize("tile", [100, 333, 1000])
def test_tiles_that_do_not_divide_m(rng, tile):
    m = 1500
    centers, w, alive = _cell_table(rng, m, 1100)
    labels = rng.permutation(m).astype(np.int32)
    eps2 = 64.0  # eps 8 m over 4 m cells: decisions on exact lattice d2
    args = (jnp.asarray(centers), jnp.asarray(labels), jnp.asarray(w),
            jnp.asarray(alive), eps2)
    pop, lmin = neighbor_reduce(*args, tile=tile)
    pop_r, lmin_r = neighbor_reduce_reference(*args)
    np.testing.assert_array_equal(np.asarray(pop), np.asarray(pop_r))
    np.testing.assert_array_equal(np.asarray(lmin), np.asarray(lmin_r))


def test_all_dead_table(rng):
    m = 2048
    centers = jnp.full((m, 3), 3.0e38, jnp.float32)
    alive = jnp.zeros(m, bool)
    pop, lmin = neighbor_reduce(
        centers, jnp.arange(m, dtype=jnp.int32), jnp.ones(m), alive, 64.0
    )
    assert (np.asarray(pop) == 0).all()
    assert (np.asarray(lmin) == m).all()
    labels, pop = cluster_cells(centers, jnp.ones(m), alive, 64.0, 1.0)
    assert (np.asarray(labels) == m).all()


def test_two_cell_offset_is_a_neighbour():
    """Cells two pitches apart on one axis sit exactly eps apart
    (d2 == eps2): the pass must count them, as grid_dbscan's <= does;
    one step further is out."""
    cell = 4.0
    m = 1024
    centers = np.full((m, 3), 3.0e38, np.float32)
    base = np.array([10.5, 20.5, 3.5]) * cell
    centers[0] = base
    centers[1] = base + [2 * cell, 0, 0]   # d2 == eps2
    centers[2] = base + [0, -2 * cell, 0]  # d2 == eps2
    centers[3] = base + [0, 0, 3 * cell]   # beyond eps
    alive = np.arange(m) < 4
    w = alive.astype(np.float32)
    eps = 2 * cell
    pop, lmin = neighbor_reduce(
        jnp.asarray(centers), jnp.arange(m, dtype=jnp.int32), jnp.asarray(w),
        jnp.asarray(alive), jnp.float32(eps) * jnp.float32(eps), tile=3,
    )
    np.testing.assert_array_equal(np.asarray(pop)[:4], [3, 2, 2, 1])
    np.testing.assert_array_equal(np.asarray(lmin)[:4], [0, 0, 0, 3])


def test_cluster_cells_independent_of_tile(rng):
    centers, w, alive = _cell_table(rng, 1500, 900)
    ref, pop_r = cluster_cells_reference(
        jnp.asarray(centers), jnp.asarray(w), jnp.asarray(alive),
        jnp.arange(1500, dtype=jnp.int32), 64.0, 40.0,
    )
    for tile in (128, 1000):
        lab, pop = cluster_cells(
            jnp.asarray(centers), jnp.asarray(w), jnp.asarray(alive), 64.0,
            40.0, tile=tile,
        )
        np.testing.assert_array_equal(np.asarray(lab), np.asarray(ref))
        np.testing.assert_array_equal(
            np.asarray(pop)[alive], np.asarray(pop_r)[alive]
        )
