"""Tiled eps-neighbourhood reductions and the cell-graph min-label flood.

The clustering inner loop, "for every element, reduce over all elements
within eps", serves every clustering path: the exact point-level DBSCAN
(`ops/cluster.py`), the modular grid DBSCAN (`ops/cluster_grid.py`) and
both device frontends' cell graphs (`ops/frontend_exact.py`,
`ops/frontend_fused.py`).  All of them share ONE pass here: a loop over
column tiles in which XLA fuses the [M, tile] compare-and-reduce into a
single reduction kernel, so no [M, M] (or [M, tile]) array is written
to device memory.

d^2 is computed from coordinate DIFFERENCES (dx^2 + dy^2 + dz^2), never
the |x|^2 - 2x.y expansion: the expansion loses ~|x|^2 / 2^23 of absolute
accuracy in f32, which at corridor coordinate scales (km) exceeds eps^2
and flips borderline neighbour decisions.

Column tiles past the last `allowed` row are skipped (packed tables keep
their live rows first), and M need not be a multiple of the tile: the
last tile is padded with rows that are not allowed.

The dense `*_reference` functions at the bottom build [M, M] matrices.
They are test oracles only; no product path calls them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_TILE = 1024


@functools.partial(jax.jit, static_argnames=("sentinel", "mode", "tile"))
def neighbor_reduce(
    xyz,
    labels,
    weights,
    allowed,
    eps2,
    *,
    sentinel: int | None = None,
    mode: str = "both",
    tile: int = _TILE,
):
    """Fused eps-neighbourhood population + min-label reduction.

    xyz f32[M,3]; labels i32[M]; weights f32[M]; allowed bool[M];
    eps2 scalar.  Returns (pop f32[M], lmin i32[M]):

      pop[i]  = sum_j  (d2(i,j) <= eps2 & allowed_j) * weight_j
      lmin[i] = min_j  (d2(i,j) <= eps2 & allowed_j) ? label_j : sentinel

    mode "pop" / "lmin" skips the other reduction (its output is the
    identity: zeros / sentinel).
    """
    if mode not in ("both", "pop", "lmin"):
        raise ValueError(f"bad mode {mode!r}")
    m = xyz.shape[0]
    if sentinel is None:
        sentinel = m
    t = max(1, min(tile, m))
    pad = (-m) % t
    alw = allowed.astype(bool)
    cols = (
        xyz.astype(jnp.float32),
        labels.astype(jnp.int32),
        weights.astype(jnp.float32),
        alw,
    )
    if pad:
        cols = tuple(
            jnp.concatenate([c, jnp.zeros((pad,) + c.shape[1:], c.dtype)])
            for c in cols
        )
    cxyz, clab, cwgt, calw = cols
    rx, ry, rz = (xyz[:, a].astype(jnp.float32)[:, None] for a in range(3))
    eps2 = jnp.asarray(eps2, jnp.float32)
    # tiles past the last allowed column contribute nothing
    live = jnp.max(jnp.where(alw, jnp.arange(m, dtype=jnp.int32) + 1, 0))
    n_tiles = (live + (t - 1)) // t

    def body(j, carry):
        pop, lmin = carry
        off = j * t
        c = lax.dynamic_slice_in_dim(cxyz, off, t, axis=0)
        dx = rx - c[None, :, 0]
        dy = ry - c[None, :, 1]
        dz = rz - c[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        nb = (d2 <= eps2) & lax.dynamic_slice_in_dim(calw, off, t)[None, :]
        if mode in ("both", "pop"):
            w = lax.dynamic_slice_in_dim(cwgt, off, t)
            pop = pop + jnp.sum(jnp.where(nb, w[None, :], 0.0), axis=1)
        if mode in ("both", "lmin"):
            lab = lax.dynamic_slice_in_dim(clab, off, t)
            lmin = jnp.minimum(
                lmin, jnp.min(jnp.where(nb, lab[None, :], sentinel), axis=1)
            )
        return pop, lmin

    return lax.fori_loop(
        0,
        n_tiles,
        body,
        (jnp.zeros(m, jnp.float32), jnp.full(m, sentinel, jnp.int32)),
    )


@functools.partial(jax.jit, static_argnames=("max_iter", "tile"))
def cluster_cells(
    centers,
    ccount,
    alive,
    eps2,
    min_points,
    *,
    max_iter: int | None = None,
    tile: int = _TILE,
):
    """DBSCAN over a weighted element table (cells or points).

    centers f32[M,3]; ccount f32[M] (element weight: a cell's point
    count, or 1 per point); alive bool[M].  An element is core when the
    weight within eps (itself included) reaches min_points; core
    elements within eps of each other share a cluster (transitively);
    a non-core alive element adopts the smallest label of a core
    element within eps; everything else is noise.

    Returns (labels i32[M], pop f32[M]).  A core element's label is the
    smallest index of its core component; noise and dead rows carry M.
    The min-label fixpoint is seed-order independent, so the partition
    equals any other DBSCAN evaluation of the same graph.
    """
    m = centers.shape[0]
    if max_iter is None:
        max_iter = m
    alw = alive.astype(bool)
    reduce = functools.partial(
        neighbor_reduce, centers, eps2=eps2, sentinel=m, tile=tile
    )
    pop, _ = reduce(
        jnp.zeros(m, jnp.int32), ccount.astype(jnp.float32), alw, mode="pop"
    )
    core = alw & (pop >= jnp.float32(min_points))
    zeros = jnp.zeros(m, jnp.float32)

    def step(state):
        lab, _, it = state
        _, lmin = reduce(lab, zeros, core, mode="lmin")
        new = jnp.where(core, jnp.minimum(lab, lmin), lab)
        # pointer jumping: a label is a core index of the same component,
        # so following it shortcuts chains (m-sized gathers, ~free next
        # to one pairwise pass)
        for _ in range(4):
            new = jnp.where(
                core, jnp.minimum(new, new[jnp.clip(new, 0, m - 1)]), new
            )
        return new, jnp.any(new != lab), it + 1

    labels0 = jnp.where(core, jnp.arange(m, dtype=jnp.int32), m)
    labels, _, _ = lax.while_loop(
        lambda s: s[1] & (s[2] < max_iter),
        step,
        (labels0, jnp.bool_(True), jnp.int32(0)),
    )
    _, border = reduce(labels, zeros, core, mode="lmin")
    labels = jnp.where(core, labels, jnp.where(alw, border, m))
    return labels, pop


def neighbor_reduce_reference(
    xyz, labels, weights, allowed, eps2, sentinel=None, rows=None
):
    """Dense oracle of neighbor_reduce (test sizes only): [M, M], or
    [R, M] for the row coordinates `rows` f32[R,3] when given (so a
    large table can be checked block by block)."""
    m = xyz.shape[0]
    if sentinel is None:
        sentinel = m
    rows = xyz if rows is None else rows
    d2 = jnp.zeros((rows.shape[0], m), jnp.float32)
    for a in range(3):
        dv = rows[:, None, a] - xyz[None, :, a]
        d2 = d2 + dv * dv
    nb = (d2 <= eps2) & allowed[None, :]
    pop = jnp.sum(jnp.where(nb, weights[None, :], 0), axis=1)  # weights' dtype
    lmin = jnp.min(jnp.where(nb, labels[None, :], sentinel), axis=1)
    return pop, lmin


def cluster_cells_reference(
    centers, ccount, alive, labels0, eps2, min_points, max_iter: int | None = None
):
    """Dense [M, M] oracle of cluster_cells: pure Jacobi min-label rounds
    from an arbitrary seed labelling (test sizes only)."""
    m = centers.shape[0]
    if max_iter is None:
        max_iter = m
    d2 = jnp.sum(
        (centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1
    )
    alw = alive.astype(bool)
    nbm_alive = (d2 <= eps2) & alw[None, :]
    pop = jnp.sum(jnp.where(nbm_alive, ccount[None, :], 0.0), axis=1)
    pop = jnp.where(jnp.abs(centers[:, 0]) < 1e37, pop, 0.0)
    core = alw & (pop >= min_points)
    labels = jnp.where(core, labels0, m)
    nbm_core = (d2 <= eps2) & core[None, :]

    def body(carry):
        lab, _, it = carry
        lmin = jnp.min(jnp.where(nbm_core, lab[None, :], m), axis=1)
        new = jnp.where(core, jnp.minimum(lab, lmin), lab)
        return new, jnp.any(new != lab), it + 1

    labels, _, _ = lax.while_loop(
        lambda c: c[1] & (c[2] < max_iter),
        body,
        (labels, jnp.bool_(True), jnp.int32(0)),
    )
    border = jnp.min(jnp.where(nbm_core, labels[None, :], m), axis=1)
    labels = jnp.where(core, labels, jnp.where(alw, border, m))
    return labels, pop
