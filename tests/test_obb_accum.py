"""Sort-free OBB accumulators (ops/obb_accum.py and the Triton kernel
in interpret mode) vs the dense oracles."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.core import pad_points
from pointcloudhookup_tpu.ops.morton import morton_encode
from pointcloudhookup_tpu.ops.obb_accum import (
    morton_centers,
    obb_accumulate,
    obb_accumulate_reference,
    obb_accumulate_xyz_sorted,
)
from pointcloudhookup_tpu.ops.pallas.obb_accum_triton import (
    obb_accumulate_xyz_triton,
)


def _triton_interpret(hi, lo, labels, mn, **kw):
    x, y, z = morton_centers(hi, lo, mn, 0.1)
    return obb_accumulate_xyz_triton(x, y, z, labels, interpret=True, **kw)


def _fixture(rng, n=4096, k=8):
    """Morton codes + spatially-coherent labels (run-structured like the
    frontend's output) with interleaved unlabeled rows."""
    pts = np.vstack(
        [
            [40 * c, 15 * c, 3 * c] + rng.normal(0, 4.0, size=(n // (k + 1), 3))
            for c in range(k)
        ]
        + [rng.uniform(0, 400, size=(n - (n // (k + 1)) * k, 3))]
    ).astype(np.float32)
    mn = pts.min(axis=0)
    v = np.floor((pts - mn) / 0.1).astype(np.int32)
    hi, lo = morton_encode(jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1]), jnp.asarray(v[:, 2]))
    labels = np.full(n, -1, np.int32)
    per = n // (k + 1)
    for c in range(k):
        labels[c * per : (c + 1) * per] = c
    # drop some rows to noise so blocks mix labeled/unlabeled
    labels[rng.random(n) < 0.2] = -1
    # morton-sort rows like the frontend does
    order = np.lexsort((np.asarray(lo), np.asarray(hi)))
    return (
        jnp.asarray(np.asarray(hi)[order]),
        jnp.asarray(np.asarray(lo)[order]),
        jnp.asarray(labels[order]),
        jnp.asarray(mn),
    )


def test_kernel_matches_reference_interpret(rng):
    hi, lo, labels, mn = _fixture(rng)
    ref = obb_accumulate_reference(
        hi, lo, labels, mn, max_clusters=8, num_angles=32
    )
    ker = _triton_interpret(hi, lo, labels, mn, max_clusters=8, num_angles=32)
    for key in ref:
        np.testing.assert_allclose(
            np.asarray(ref[key]), np.asarray(ker[key]), rtol=1e-5, atol=1e-4,
            err_msg=key,
        )


@pytest.mark.heavy
def test_accum_stats_match_sort_path(corridor):
    """cluster_obb_stats_accum must agree with the sort-based codes OBB
    at tower level on the corridor (flat-A vs coarse+refine angle search
    land within one angle step)."""
    import dataclasses

    from pointcloudhookup_tpu.config import ExtractParams
    from pointcloudhookup_tpu.ops.frontend_fused import fused_downsample_ground_cluster
    from pointcloudhookup_tpu.ops.obb import (
        cluster_obb_stats_accum,
        cluster_obb_stats_codes,
    )

    pts, centers = corridor
    origin = pts.mean(axis=0)
    xyz, mask = pad_points((pts - origin).astype(np.float32), 8192)
    p = ExtractParams()
    p = dataclasses.replace(
        p, cluster=dataclasses.replace(p.cluster, eps=5.0, min_points=20)
    )
    hi, lo, keep, labels, base, mn = fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), p,
        max_cells=2048, min_cell_points=1, geometric_voxels=True, emit="codes",
    )
    s_sort = cluster_obb_stats_codes(
        hi, lo, labels, keep, mn, max_clusters=p.max_clusters,
        num_angles=p.obb_angles,
    )
    s_acc = cluster_obb_stats_accum(
        hi, lo, labels, keep, mn, max_clusters=p.max_clusters,
        num_angles=p.obb_angles,
    )
    np.testing.assert_array_equal(
        np.asarray(s_sort["alive"]), np.asarray(s_acc["alive"])
    )
    np.testing.assert_allclose(
        np.asarray(s_sort["count"]), np.asarray(s_acc["count"])
    )
    alive = np.asarray(s_sort["alive"])
    for key, tol in [("centroid", 1e-3), ("center", 0.2), ("extent", 0.2)]:
        np.testing.assert_allclose(
            np.asarray(s_sort[key])[alive], np.asarray(s_acc[key])[alive],
            atol=tol, err_msg=key,
        )
    # aabb bounds are exact in both paths
    for key in ("aabb_min", "aabb_max"):
        np.testing.assert_allclose(
            np.asarray(s_sort[key])[alive], np.asarray(s_acc[key])[alive],
            atol=1e-4, err_msg=key,
        )
    assert float(s_acc["overflow"]) == 0.0


def test_accum_kernel_stats_interpret(corridor):
    """The Triton kernel (interpret) and the plain form behind
    cluster_obb_stats_accum agree with the oracle on real frontend
    output."""
    import dataclasses

    from pointcloudhookup_tpu.config import ExtractParams
    from pointcloudhookup_tpu.ops.frontend_fused import fused_downsample_ground_cluster

    pts, centers = corridor
    origin = pts.mean(axis=0)
    xyz, mask = pad_points((pts - origin).astype(np.float32), 8192)
    p = ExtractParams()
    p = dataclasses.replace(
        p, cluster=dataclasses.replace(p.cluster, eps=5.0, min_points=20)
    )
    hi, lo, keep, labels, base, mn = fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), p,
        max_cells=2048, min_cell_points=1, geometric_voxels=True, emit="codes",
    )
    lab = jnp.where(keep, labels, -1)
    ref = obb_accumulate_reference(hi, lo, lab, mn, max_clusters=32, num_angles=32)
    for ker in (
        _triton_interpret(hi, lo, lab, mn, max_clusters=32, num_angles=32),
        obb_accumulate(hi, lo, lab, mn, max_clusters=32, num_angles=32),
    ):
        for key in ref:
            np.testing.assert_allclose(
                np.asarray(ref[key]), np.asarray(ker[key]), rtol=1e-5,
                atol=1e-4, err_msg=key,
            )


def test_obb_accumulate_xyz_matches_reference(rng):
    """The plain form against the dense f32 oracle (extremes) and a
    float64 oracle (sums: the dense f32 sums carry their own rounding)."""
    from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate_xyz_reference

    n, k, a = 8192, 32, 32
    x = (rng.normal(size=n) * 50).astype(np.float32)
    y = (rng.normal(size=n) * 50).astype(np.float32)
    z = rng.uniform(0, 60, n).astype(np.float32)
    lab = rng.integers(-1, k, n).astype(np.int32)
    args = tuple(jnp.asarray(v) for v in (x, y, z, lab))
    ker = obb_accumulate_xyz_sorted(*args, max_clusters=k, num_angles=a)
    ref = obb_accumulate_xyz_reference(*args, max_clusters=k, num_angles=a)
    for key in ("cnt", "zlo", "zhi", "ulo", "uhi", "vlo", "vhi"):
        np.testing.assert_allclose(
            np.asarray(ker[key]), np.asarray(ref[key]), rtol=1e-5,
            atol=1e-3, err_msg=key,
        )
    _check_f64(ker, _f64_oracle(x, y, z, lab, k, a))


def _f64_oracle(x, y, z, lab, k, a):
    """float64 numpy accumulators (empty clusters at +-BIG)."""
    ang = np.arange(a) * (np.pi / 2.0 / a)
    big = 3.0e38
    out = dict(cnt=np.zeros(k), sx=np.zeros(k), sy=np.zeros(k), sz=np.zeros(k),
               zlo=np.full(k, big), zhi=np.full(k, -big),
               ulo=np.full((k, a), big), uhi=np.full((k, a), -big),
               vlo=np.full((k, a), big), vhi=np.full((k, a), -big))
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))
    for c in range(k):
        sel = lab == c
        if not sel.any():
            continue
        u = x[sel, None] * np.cos(ang) + y[sel, None] * np.sin(ang)
        v = y[sel, None] * np.cos(ang) - x[sel, None] * np.sin(ang)
        out["cnt"][c] = sel.sum()
        out["sx"][c], out["sy"][c], out["sz"][c] = x[sel].sum(), y[sel].sum(), z[sel].sum()
        out["zlo"][c], out["zhi"][c] = z[sel].min(), z[sel].max()
        out["ulo"][c], out["uhi"][c] = u.min(0), u.max(0)
        out["vlo"][c], out["vhi"][c] = v.min(0), v.max(0)
    return out


_IMPLS = {
    "sorted": lambda *a, **kw: obb_accumulate_xyz_sorted(*a, chunk=512, **kw),
    "triton": lambda *a, **kw: obb_accumulate_xyz_triton(*a, interpret=True, **kw),
}


def _check_f64(got, want):
    """cnt exact; extremes within 1e-3 m (f32 at km scale, FMA-fused
    projections); sums within f32 rounding of their magnitude."""
    np.testing.assert_array_equal(np.asarray(got["cnt"]), want["cnt"])
    for key in ("zlo", "zhi", "ulo", "uhi", "vlo", "vhi"):
        np.testing.assert_allclose(np.asarray(got[key], np.float64), want[key],
                                   rtol=1e-6, atol=1e-3, err_msg=key)
    for key in ("sx", "sy", "sz"):
        np.testing.assert_allclose(np.asarray(got[key], np.float64), want[key],
                                   rtol=1e-6, atol=1e-2, err_msg=key)


@pytest.mark.parametrize("impl", sorted(_IMPLS))
def test_labels_at_or_above_k_are_skipped(rng, impl):
    n, k, a = 3000, 8, 16
    x = (rng.normal(size=n) * 40 + 900).astype(np.float32)
    y = (rng.normal(size=n) * 40 - 1500).astype(np.float32)
    z = rng.uniform(0, 60, n).astype(np.float32)
    lab = np.sort(rng.integers(-3, 2 * k, n)).astype(np.int32)
    got = _IMPLS[impl](*(jnp.asarray(v) for v in (x, y, z, lab)),
                       max_clusters=k, num_angles=a)
    _check_f64(got, _f64_oracle(x, y, z, lab, k, a))


@pytest.mark.parametrize("impl", sorted(_IMPLS))
def test_all_noise_rows(rng, impl):
    n, k, a = 2000, 8, 16
    x, y, z = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    lab = np.full(n, -1, np.int32)
    got = _IMPLS[impl](*(jnp.asarray(v) for v in (x, y, z, lab)),
                       max_clusters=k, num_angles=a)
    assert (np.asarray(got["cnt"]) == 0).all()
    assert (np.asarray(got["ulo"]) == np.float32(3.0e38)).all()
    assert (np.asarray(got["vhi"]) == np.float32(-3.0e38)).all()
    assert (np.asarray(got["zlo"]) == np.float32(3.0e38)).all()


@pytest.mark.parametrize("impl", sorted(_IMPLS))
def test_one_cluster_over_every_row_chunk(rng, impl):
    """One tower-sized cluster whose rows are spread over every row
    chunk / block, interleaved with noise and a second cluster."""
    n, k, a = 5000, 4, 32
    x = (rng.normal(size=n) * 5 + 1800).astype(np.float32)
    y = (rng.normal(size=n) * 5 + 1800).astype(np.float32)
    z = rng.uniform(0, 40, n).astype(np.float32)
    lab = np.where(np.arange(n) % 3 == 0, 2, -1).astype(np.int32)
    lab[np.arange(n) % 7 == 1] = 0
    got = _IMPLS[impl](*(jnp.asarray(v) for v in (x, y, z, lab)),
                       max_clusters=k, num_angles=a)
    _check_f64(got, _f64_oracle(x, y, z, lab, k, a))


@pytest.mark.gpu
def test_triton_kernel_matches_plain_form_on_gpu(gpu_device, rng):
    """On the card: the compiled Triton kernel (the GPU product path)
    against the plain XLA form at a survivor-table width."""
    from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate_xyz

    n, k, a = 1 << 20, 128, 256
    x = (rng.normal(size=n) * 800).astype(np.float32)
    y = (rng.normal(size=n) * 800).astype(np.float32)
    z = rng.uniform(0, 60, n).astype(np.float32)
    lab = np.where(rng.random(n) < 0.3, (np.arange(n) // 4096) % (k + 8), -1)
    args = tuple(jnp.asarray(v) for v in (x, y, z, lab.astype(np.int32)))
    got = obb_accumulate_xyz(*args, max_clusters=k, num_angles=a)
    _check_f64(got, _f64_oracle(x, y, z, lab, k, a))
