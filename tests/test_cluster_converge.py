"""Cell-graph DBSCAN (ops/neighbor.py::cluster_cells) vs its dense
oracle, and the oracle vs a literal numpy DBSCAN."""

import numpy as np
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.neighbor import (
    cluster_cells,
    cluster_cells_reference,
)


def _table(rng, m=2048, n_alive=600, n_groups=6):
    """Cell table shaped like the frontend's: Morton-coherent groups,
    dead capacity rows at +3e38."""
    centers = np.full((m, 3), 3.0e38, np.float32)
    w = np.zeros(m, np.float32)
    alive = np.zeros(m, bool)
    per = n_alive // n_groups
    row = 0
    for g in range(n_groups):
        base = np.array([g * 120.0, 10.0 * g, 0.0])
        pts = base + rng.normal(0, 3.0, size=(per, 3))
        pts = pts[np.argsort(pts[:, 0])]  # pseudo-Morton coherence
        centers[row : row + per] = pts
        w[row : row + per] = rng.uniform(1, 30, per)
        alive[row : row + per] = True
        row += per
    return jnp.asarray(centers), jnp.asarray(w), jnp.asarray(alive)


def _partitions_match(a, b, sentinel):
    noise = (a >= sentinel) == (b >= sentinel)
    if not noise.all():
        return False
    m = a < sentinel
    pairs = set(zip(a[m].tolist(), b[m].tolist()))
    return len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})


def test_reference_matches_numpy_dbscan_semantics(rng):
    """The oracle agrees with a literal numpy cell-DBSCAN using the
    same difference-form d^2 (the neighbor_reduce matmul oracle differs
    at f32 eps-boundary cells, which is why it is not the comparator)."""
    centers, w, alive = _table(rng)
    m = centers.shape[0]
    eps2, minpts = 36.0, 40.0
    lab, pop = cluster_cells_reference(
        centers, w, alive, jnp.arange(m, dtype=jnp.int32), eps2, minpts
    )
    c = np.asarray(centers, np.float32)
    fin = np.abs(c[:, 0]) < 1e37
    wn = np.asarray(w)
    an = np.asarray(alive)
    d2 = np.zeros((fin.sum(), m), np.float32)
    rows = np.nonzero(fin)[0]
    for i, r in enumerate(rows):
        diff = c[r][None, :] - c
        d2[i] = np.where(fin, (diff * diff).sum(axis=1), np.inf)
    nbm = (d2 <= eps2) & an[None, :]
    pop_np = (nbm * wn[None, :]).sum(axis=1)
    np.testing.assert_allclose(np.asarray(pop)[rows], pop_np, rtol=1e-5)
    core_np = an[rows] & (pop_np >= minpts)
    # connected components over core cells (numpy BFS)
    core_rows = rows[core_np]
    idx_of = {r: i for i, r in enumerate(rows)}
    lab_np = {}
    for r in core_rows:
        if r in lab_np:
            continue
        stack = [r]
        lab_np[r] = r
        while stack:
            q = stack.pop()
            for s in core_rows:
                if s not in lab_np and d2[idx_of[q], s] <= eps2:
                    lab_np[s] = r
                    stack.append(s)
    got = np.asarray(lab)
    # partition equivalence on core cells
    pairs = {(int(got[r]), lab_np[r]) for r in core_rows}
    assert len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs})
    # noise/padding rows carry the sentinel
    assert (got[~fin] == m).all()


def test_kernel_matches_reference_interpret(rng):
    centers, w, alive = _table(rng)
    m = centers.shape[0]
    eps2, minpts = 36.0, 40.0
    iota = jnp.arange(m, dtype=jnp.int32)
    lab_r, pop_r = cluster_cells_reference(centers, w, alive, iota, eps2, minpts)
    lab_k, pop_k = cluster_cells(centers, w, alive, eps2, minpts)
    fin = np.abs(np.asarray(centers)[:, 0]) < 1e37
    np.testing.assert_allclose(
        np.asarray(pop_r)[fin], np.asarray(pop_k)[fin], rtol=1e-5
    )
    # labels identical on finite rows (same seed, same fixed point)
    np.testing.assert_array_equal(
        np.asarray(lab_r)[fin], np.asarray(lab_k)[fin]
    )


def test_non_core_bridge_does_not_merge(rng):
    """DBSCAN semantics: two core groups connected only through a
    non-core cell must stay separate clusters."""
    m = 1024
    centers = np.full((m, 3), 3.0e38, np.float32)
    w = np.zeros(m, np.float32)
    alive = np.zeros(m, bool)
    # group A: rows 0-9 at x=0..9; group B: rows 11-20 at x=17..26;
    # bridge cell row 10 at x=13 touches both (eps=4.5) but has weight
    # too small to be core
    for i in range(10):
        centers[i] = [i * 1.0, 0, 0]
        w[i] = 20.0
        alive[i] = True
        centers[11 + i] = [17.0 + i, 0, 0]
        w[11 + i] = 20.0
        alive[11 + i] = True
    centers[10] = [13.0, 0, 0]
    w[10] = 0.5
    alive[10] = True
    eps2 = 4.5 * 4.5
    lab, pop = cluster_cells_reference(
        jnp.asarray(centers), jnp.asarray(w), jnp.asarray(alive),
        jnp.arange(m, dtype=jnp.int32), eps2, 50.0,
    )
    lab = np.asarray(lab)
    a = set(lab[:10].tolist())
    b = set(lab[11:21].tolist())
    assert len(a) == 1 and len(b) == 1 and a != b  # separate clusters
    assert lab[10] in (a | b)  # bridge is a border cell of one side
