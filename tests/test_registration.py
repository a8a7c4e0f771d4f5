import numpy as np
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.registration import (
    batched_icp,
    icp,
    kabsch,
    register_tower_pairs,
)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def test_kabsch_exact_recovery(rng):
    src = rng.normal(0, 5, size=(200, 3)).astype(np.float32)
    r_true = _rot_z(0.3) @ _rot_z(0.0)
    t_true = np.array([1.5, -2.0, 0.7], np.float32)
    dst = src @ r_true.T + t_true
    r, t = kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.ones(200))
    # f32 products at Precision.HIGHEST: ~1e-6 relative error, so 1e-4
    # holds on any backend; a TF32 product (~1e-3) would not pass
    np.testing.assert_allclose(np.asarray(r), r_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-4)


def test_kabsch_weighted_ignores_outliers(rng):
    src = rng.normal(0, 5, size=(100, 3)).astype(np.float32)
    r_true = _rot_z(-0.2)
    dst = src @ r_true.T
    dst[:10] += 100.0  # corrupted correspondences
    w = np.ones(100, np.float32)
    w[:10] = 0.0
    r, _ = kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(r), r_true, atol=1e-4)


def test_icp_converges_small_perturbation(rng):
    # lattice-tower-like cloud; perturb by a small rigid motion and recover
    n = 600
    t_param = rng.uniform(0, 1, n)
    half = 6.0 * (1 - 0.7 * t_param)
    cloud = np.column_stack(
        [
            rng.uniform(-1, 1, n) * half,
            rng.uniform(-1, 1, n) * half,
            t_param * 35.0,
        ]
    ).astype(np.float32)
    r_true = _rot_z(0.1)
    t_true = np.array([0.8, -0.5, 0.3], np.float32)
    dst = cloud @ r_true.T + t_true
    mask = np.ones(n, bool)
    out = icp(
        jnp.asarray(cloud), jnp.asarray(mask), jnp.asarray(dst), jnp.asarray(mask),
        iters=30,
    )
    assert float(out["rmse"]) < 0.15
    np.testing.assert_allclose(np.asarray(out["R"]), r_true, atol=0.02)
    np.testing.assert_allclose(np.asarray(out["t"]), t_true, atol=0.2)


def test_batched_icp_independent_pairs(rng):
    b, n = 4, 300
    src = rng.normal(0, 4, size=(b, n, 3)).astype(np.float32)
    rs = [_rot_z(a) for a in (0.05, -0.1, 0.15, 0.0)]
    ts = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0.5]], np.float32)
    dst = np.stack([src[i] @ rs[i].T + ts[i] for i in range(b)])
    mask = np.ones((b, n), bool)
    out = batched_icp(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst), jnp.asarray(mask),
        iters=25,
    )
    rmse = np.asarray(out["rmse"])
    assert (rmse < 0.2).all()
    for i in range(b):
        np.testing.assert_allclose(np.asarray(out["R"])[i], rs[i], atol=0.05)


def test_register_tower_pairs_varied_sizes(rng):
    a = rng.normal(0, 3, size=(120, 3))
    b = rng.normal(0, 3, size=(80, 3))
    res = register_tower_pairs(
        [a, b], [a + np.array([0.5, 0, 0]), b + np.array([0, 0.5, 0])], iters=15
    )
    assert len(res) == 2
    np.testing.assert_allclose(res[0]["t"], [0.5, 0, 0], atol=0.05)
    np.testing.assert_allclose(res[1]["t"], [0, 0.5, 0], atol=0.05)
    assert res[0]["rmse"] < 0.05
