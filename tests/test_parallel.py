import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloudhookup_tpu.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
)
from pointcloudhookup_tpu.parallel.sharded import make_sharded_extract, tile_mesh

# the device count is decided inside a fixture, never at import time
pytestmark = pytest.mark.usefixtures("four_devices")


def _params():
    return ExtractParams(
        ground=GroundParams(min_points_after=64),
        cluster=ClusterParams(eps=5.0, min_points=16),
        max_clusters=16,
        obb_angles=32,
    )


def _make_inputs(rng, n_dev, per_shard=1024):
    """Corridor where each shard holds one spatial tile with one tower."""
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

    total = per_shard * n_dev
    shard_pts = []
    centers = []
    for d in range(n_dev):
        pts, c = synthetic_corridor(
            rng,
            n_ground=per_shard - 300,
            n_veg=0,
            towers=((0.0, 0.0),),
            pts_per_tower=280,
            extent=120.0,
            origin=(d * 300.0, 0.0, 0.0),
        )
        # clamp to shard capacity
        pts = pts[:per_shard]
        shard_pts.append(pts)
        centers.append(c[0])
    xyz = np.zeros((total, 3), np.float32)
    mask = np.zeros(total, bool)
    for d, pts in enumerate(shard_pts):
        xyz[d * per_shard : d * per_shard + len(pts)] = pts
        mask[d * per_shard : d * per_shard + len(pts)] = True
    return xyz, mask, np.array(centers)


def test_sharded_extract_runs_and_finds_towers(rng):
    n_dev = 4
    mesh = tile_mesh(n_dev)
    step, in_sharding = make_sharded_extract(mesh, _params())
    xyz, mask, centers = _make_inputs(rng, n_dev)
    xa = jax.device_put(jnp.asarray(xyz), in_sharding)
    ma = jax.device_put(jnp.asarray(mask), in_sharding)
    labels, merged = step(xa, ma)
    accepted = np.asarray(merged["accepted"])
    got_centers = np.asarray(merged["center"])[accepted]
    assert accepted.sum() == len(centers)
    got = np.array(sorted(got_centers[:, 0].tolist()))
    want = np.array(sorted(centers[:, 0].tolist()))
    np.testing.assert_allclose(got, want, atol=2.5)


@pytest.mark.heavy
def test_sharded_extract_fast_path(rng):
    """fast=True (fused front-end + accum OBB per shard, global psum'd
    ground base) finds the same towers as the modular sharded step."""
    n_dev = 4
    mesh = tile_mesh(n_dev)
    step, in_sharding = make_sharded_extract(mesh, _params(), fast=True)
    xyz, mask, centers = _make_inputs(rng, n_dev)
    xa = jax.device_put(jnp.asarray(xyz), in_sharding)
    ma = jax.device_put(jnp.asarray(mask), in_sharding)
    labels, merged = step(xa, ma)
    accepted = np.asarray(merged["accepted"])
    got_centers = np.asarray(merged["center"])[accepted]
    assert accepted.sum() == len(centers)
    got = np.array(sorted(got_centers[:, 0].tolist()))
    want = np.array(sorted(centers[:, 0].tolist()))
    np.testing.assert_allclose(got, want, atol=2.5)


def test_sharded_merge_unifies_boundary_tower(rng):
    """A tower duplicated on two neighboring shards (as if split by a
    tile boundary) must be merged into ONE accepted tower."""
    n_dev = 4
    per_shard = 1024
    mesh = tile_mesh(n_dev)
    step, in_sharding = make_sharded_extract(mesh, _params(), merge_radius=6.0)
    xyz, mask, centers = _make_inputs(rng, n_dev, per_shard)
    # copy shard 0's tower points (rows 724:1004 of shard 0 = after its
    # 724 ground points) over 280 of shard 1's GROUND rows, keeping the
    # same world position -> two fragments of the same tower exist on
    # two shards; shard 1's own tower at x=300 is untouched
    src = slice(724, 1004)
    dst = slice(per_shard, per_shard + 280)
    xyz[dst] = xyz[src]
    mask[dst] = mask[src]
    xa = jax.device_put(jnp.asarray(xyz), in_sharding)
    ma = jax.device_put(jnp.asarray(mask), in_sharding)
    _, merged = step(xa, ma)
    assert int(np.asarray(merged["accepted"]).sum()) == len(centers)


@pytest.mark.heavy
def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert "accepted" in out


@pytest.mark.heavy
def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_exact_mode_matches_single_device(rng):
    """mode='exact' (psum'd bisection percentile + global cell anchor +
    halo with ghost-excluded accumulation) on 4 devices must reproduce
    the 1-device exact run's tower centers to ~f32 tolerance, on a
    corridor whose towers straddle shard boundaries."""
    import __graft_entry__ as ge

    from pointcloudhookup_tpu.ops.frontend_exact import exact_cell_plan

    n_dev = 4
    total = 8192
    xyz, mask, planted = ge._boundary_corridor(total, n_towers=4, seed=5)
    params = _params()
    span = xyz[mask].max(axis=0) - xyz[mask].min(axis=0)
    bits = exact_cell_plan(span, params.cluster.eps)
    assert bits is not None

    def run(nd):
        mesh = tile_mesh(nd)
        step, sh = make_sharded_extract(
            mesh, params, mode="exact", exact_cell_bits=bits
        )
        xa = jax.device_put(jnp.asarray(xyz), sh)
        ma = jax.device_put(jnp.asarray(mask), sh)
        _, merged = step(xa, ma)
        acc = np.asarray(merged["accepted"])
        assert float(np.asarray(merged["halo_overflow"])) == 0.0
        return np.asarray(merged["center"])[acc]

    c_multi = run(n_dev)
    c_single = run(1)
    assert len(c_multi) == len(c_single) == 4
    for c in c_multi:
        d = np.linalg.norm(c_single - c[None, :], axis=1)
        assert d.min() < 0.01
    # and the planted towers are where they should be
    for tc in planted:
        d = np.linalg.norm(c_multi[:, :2] - tc[None, :2], axis=1)
        assert d.min() < 3.0


def test_sharded_exact_mode_requires_plan():
    with pytest.raises(ValueError, match="exact_cell_bits"):
        make_sharded_extract(tile_mesh(2), _params(), mode="exact")


def test_merge_accumulators_exact(rng):
    """The exact fragment merge must reproduce the SINGLE accumulation
    over the union of members: split one cluster's points into two
    fragments, accumulate each separately, merge, and compare against
    accumulating the whole cluster at once (f32 order tolerance)."""
    from pointcloudhookup_tpu.ops.obb_accum import obb_accumulate_xyz_reference
    from pointcloudhookup_tpu.parallel.sharded import _merge_accumulators

    k, a = 8, 16
    pts = rng.normal(0.0, 5.0, (400, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.0, 40.0, 400).astype(np.float32)
    x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
    lab_whole = jnp.zeros(400, jnp.int32)
    whole = obb_accumulate_xyz_reference(
        x, y, z, lab_whole, max_clusters=k, num_angles=a
    )
    # fragment A = first 250 points as cluster 1, B = rest as cluster 5
    lab_split = jnp.where(jnp.arange(400) < 250, 1, 5).astype(jnp.int32)
    frag = obb_accumulate_xyz_reference(
        x, y, z, lab_split, max_clusters=k, num_angles=a
    )
    merged = jax.jit(lambda s: _merge_accumulators(s, 1e9))(frag)
    counts = np.asarray(merged["cnt"])
    assert counts[1] == 400.0 and counts[5] == 0.0
    for key in ("sx", "sy", "sz"):
        np.testing.assert_allclose(
            float(np.asarray(merged[key])[1]),
            float(np.asarray(whole[key])[0]),
            rtol=1e-5,
        )
    for key in ("zlo", "zhi"):
        assert float(np.asarray(merged[key])[1]) == float(
            np.asarray(whole[key])[0]
        )
    for key in ("ulo", "uhi", "vlo", "vhi"):
        np.testing.assert_array_equal(
            np.asarray(merged[key])[1], np.asarray(whole[key])[0]
        )


def test_merge_accumulators_equal_count_tiebreak():
    """Two equal-count fragments in one merge group must yield exactly
    ONE surviving row (the min-index representative) carrying the
    combined count."""
    from pointcloudhookup_tpu.parallel.sharded import _merge_accumulators

    k, a = 8, 4
    big = np.float32(3.0e38)
    acc = {
        "cnt": np.zeros(k, np.float32),
        "sx": np.zeros(k, np.float32),
        "sy": np.zeros(k, np.float32),
        "sz": np.zeros(k, np.float32),
        "zlo": np.full(k, big, np.float32),
        "zhi": np.full(k, -big, np.float32),
        "ulo": np.full((k, a), big, np.float32),
        "uhi": np.full((k, a), -big, np.float32),
        "vlo": np.full((k, a), big, np.float32),
        "vhi": np.full((k, a), -big, np.float32),
    }
    for i in (2, 5):
        acc["cnt"][i] = 4097.0
        acc["zlo"][i], acc["zhi"][i] = 0.0, 40.0
        acc["ulo"][i], acc["uhi"][i] = 0.0, 10.0
        acc["vlo"][i], acc["vhi"][i] = 0.0, 10.0
        acc["sx"][i] = acc["sy"][i] = 5.0 * 4097.0
        acc["sz"][i] = 20.0 * 4097.0
    acc = {key: jnp.asarray(v) for key, v in acc.items()}
    merged = jax.jit(lambda s: _merge_accumulators(s, 6.0))(acc)
    counts = np.asarray(merged["cnt"])
    assert (counts > 0).sum() == 1
    assert counts[2] == 8194.0  # lowest index wins the tie


@pytest.mark.heavy
def test_sharded_fast_precut_engages(rng):
    """Shards >= 131072 rows engage the ground pre-cut against the
    GLOBAL psum'd base (frontend precut_div): towers must still match
    the small-shard (pre-cut disabled) semantics."""
    n_dev = 2
    mesh = tile_mesh(n_dev)
    step, in_sharding = make_sharded_extract(mesh, _params(), fast=True)
    xyz, mask, centers = _make_inputs(rng, n_dev, per_shard=131072)
    xa = jax.device_put(jnp.asarray(xyz), in_sharding)
    ma = jax.device_put(jnp.asarray(mask), in_sharding)
    labels, merged = step(xa, ma)
    accepted = np.asarray(merged["accepted"])
    got_centers = np.asarray(merged["center"])[accepted]
    assert accepted.sum() == len(centers)
    got = np.array(sorted(got_centers[:, 0].tolist()))
    want = np.array(sorted(centers[:, 0].tolist()))
    np.testing.assert_allclose(got, want, atol=2.5)
    assert float(merged["cells_overflow"]) == 0.0


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_sharded_equals_single_device_on_boundary_towers(mode):
    """Towers cut by every shard boundary: 4 devices must give the
    1-device towers to f32 rounding (halo ghosts are not counted in the
    global ground percentile, and every shard shares one grid anchor)."""
    from pointcloudhookup_tpu.io.synthetic import boundary_corridor
    from pointcloudhookup_tpu.ops.frontend_exact import exact_cell_plan

    n = 131072
    xyz_np, mask_np, planted = boundary_corridor(
        n, n_towers=39, seed=7, extent=4000.0, span=0.95, tower_share=0.08
    )
    params = ExtractParams(
        cluster=ClusterParams(eps=8.0, min_points=80, min_cell_points=4,
                              max_cells=8192),
        max_clusters=64, obb_angles=64,
    )
    span = xyz_np[mask_np].max(axis=0) - xyz_np[mask_np].min(axis=0)
    plan = exact_cell_plan(span, params.cluster.eps)
    centers = []
    for d in (4, 1):
        step, sharding = make_sharded_extract(
            tile_mesh(d), params, mode=mode, exact_cell_bits=plan,
            fast_max_cells=8192,
        )
        _, merged = step(jax.device_put(jnp.asarray(xyz_np), sharding),
                         jax.device_put(jnp.asarray(mask_np), sharding))
        assert float(merged["halo_overflow"]) == 0.0
        acc = np.asarray(merged["accepted"])
        centers.append(np.asarray(merged["center"])[acc])
    multi, single = centers
    # at this density a few sparse towers fail the size filters; the
    # sharded and 1-device runs must agree on which
    assert len(multi) == len(single) >= 0.8 * len(planted)
    for c in multi:
        assert np.linalg.norm(single - c[None, :], axis=1).min() < 1e-3
