"""OBB accumulators as a Pallas kernel through Triton (GPU).

Same contract as `ops/obb_accum.py::obb_accumulate_xyz_sorted`, without
the label sort.  The grid is (row blocks, angle blocks).  Each program
loads its block of rows, then walks the DISTINCT labels present in it
(the next label is the smallest one above the current, so blocks with
no labelled rows exit at once).  For each label it folds the block's
member rows into per-angle projection extremes in registers and issues
ONE atomic min/max per (block, label, angle) into the [K, A] tables.
Rows arrive in cell-sorted order, where labels are piecewise constant,
so a block holds one or two labels and the atomics per address are few
(one per block of a cluster) instead of one per row.

f32 extremes go through an order-preserving int32 view, so the
atomics are plain signed-integer min/max, and the result does not
depend on the order in which blocks run.  The sums (count, x, y, z) are
not accumulated atomically: each block stores its per-label partial
sums in its own row of a [blocks, 4, K] table, which XLA then reduces
pairwise.  A running f32 total of ~1e4 coordinates of up to 2 km would
round every addition by up to half an ulp of a ~1e7 sum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pointcloudhookup_tpu.ops.obb_accum import BIG, _angles

_ROWS = 256  # rows per program
_ANGLES = 64  # angles per program


def _key(f):
    """Order-preserving f32 -> i32 (an involution: also the inverse)."""
    i = lax.bitcast_convert_type(f, jnp.int32)
    return jnp.where(i >= 0, i, i ^ jnp.int32(0x7FFFFFFF))


def _unkey(i):
    return lax.bitcast_convert_type(
        jnp.where(i >= 0, i, i ^ jnp.int32(0x7FFFFFFF)), jnp.float32
    )


def _kernel(x_ref, y_ref, z_ref, lab_ref, cos_ref, sin_ref, *refs,
            n: int, k: int, rows: int, angles: int):
    (part, zlo, zhi, ulo, uhi, vlo, vhi) = refs[7:]
    i = pl.program_id(0)
    j = pl.program_id(1)
    r = i * rows + jnp.arange(rows)
    ok = r < n
    lab = plgpu.load(lab_ref.at[r], mask=ok, other=-1)
    x = plgpu.load(x_ref.at[r], mask=ok, other=0.0)
    y = plgpu.load(y_ref.at[r], mask=ok, other=0.0)
    z = plgpu.load(z_ref.at[r], mask=ok, other=0.0)
    ca = j * angles + jnp.arange(angles)
    cos_a = plgpu.load(cos_ref.at[ca])[None, :]
    sin_a = plgpu.load(sin_ref.at[ca])[None, :]
    valid = (lab >= 0) & (lab < k)
    big = jnp.float32(BIG)

    def body(c):
        m = valid & (lab == c)
        m2 = m[:, None]
        u = x[:, None] * cos_a + y[:, None] * sin_a
        v = y[:, None] * cos_a - x[:, None] * sin_a
        cols = pl.ds(j * angles, angles)
        plgpu.atomic_min(ulo, (c, cols), _key(jnp.min(jnp.where(m2, u, big), axis=0)))
        plgpu.atomic_max(uhi, (c, cols), _key(jnp.max(jnp.where(m2, u, -big), axis=0)))
        plgpu.atomic_min(vlo, (c, cols), _key(jnp.min(jnp.where(m2, v, big), axis=0)))
        plgpu.atomic_max(vhi, (c, cols), _key(jnp.max(jnp.where(m2, v, -big), axis=0)))

        @pl.when(j == 0)
        def _scalars():
            plgpu.store(part.at[i, 0, c], jnp.sum(m.astype(jnp.float32)))
            plgpu.store(part.at[i, 1, c], jnp.sum(jnp.where(m, x, 0.0)))
            plgpu.store(part.at[i, 2, c], jnp.sum(jnp.where(m, y, 0.0)))
            plgpu.store(part.at[i, 3, c], jnp.sum(jnp.where(m, z, 0.0)))
            plgpu.atomic_min(zlo, c, _key(jnp.min(jnp.where(m, z, big))))
            plgpu.atomic_max(zhi, c, _key(jnp.max(jnp.where(m, z, -big))))

        return jnp.min(jnp.where(valid & (lab > c), lab, k))

    lax.while_loop(lambda c: c < k, body, jnp.min(jnp.where(valid, lab, k)))


@functools.partial(
    jax.jit, static_argnames=("max_clusters", "num_angles", "interpret")
)
def obb_accumulate_xyz_triton(
    x, y, z, labels, *, max_clusters: int = 128, num_angles: int = 256,
    interpret: bool = False,
):
    """x/y/z f32[N]; labels i32[N] in [0, K) or anything else to skip.
    Returns the accumulator dict of ops/obb_accum.py.  num_angles must
    be a power of two; `interpret` is for CPU tests only."""
    n = x.shape[0]
    k = max_clusters
    a = num_angles
    if a & (a - 1):
        raise ValueError(f"num_angles must be a power of two, got {a}")
    ba = min(_ANGLES, a)
    cos_a, sin_a = _angles(a)
    lo_key = _key(jnp.float32(BIG))
    hi_key = _key(jnp.float32(-BIG))
    nb = pl.cdiv(n, _ROWS)
    init = (
        jnp.zeros((nb, 4, k), jnp.float32),
        jnp.full(k, lo_key), jnp.full(k, hi_key),
        jnp.full((k, a), lo_key), jnp.full((k, a), hi_key),
        jnp.full((k, a), lo_key), jnp.full((k, a), hi_key),
    )
    outs = pl.pallas_call(
        functools.partial(_kernel, n=n, k=k, rows=_ROWS, angles=ba),
        out_shape=[jax.ShapeDtypeStruct(v.shape, v.dtype) for v in init],
        grid=(nb, a // ba),
        input_output_aliases={6 + t: t for t in range(len(init))},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="obb_accumulate",
    )(
        x.astype(jnp.float32), y.astype(jnp.float32), z.astype(jnp.float32),
        labels.astype(jnp.int32), cos_a, sin_a, *init,
    )
    part, zlo, zhi, ulo, uhi, vlo, vhi = outs
    cnt, sx, sy, sz = jnp.sum(part, axis=0)
    return dict(
        cnt=cnt, sx=sx, sy=sy, sz=sz,
        zlo=_unkey(zlo), zhi=_unkey(zhi),
        ulo=_unkey(ulo), uhi=_unkey(uhi), vlo=_unkey(vlo), vhi=_unkey(vhi),
    )
