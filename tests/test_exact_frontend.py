"""Exact fast front-end (ops/frontend_exact.py) vs the modular
extract_step: same ground cut, same cluster partition, same per-cluster
point counts; centers/extents to the angle-grid tolerance."""

import numpy as np
import pytest
import jax.numpy as jnp

from pointcloudhookup_tpu.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
)
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.models.pipeline import (
    _exact_fast_plan,
    _extract_stats_exact_fast,
)
from pointcloudhookup_tpu.models.towers import extract_step
from pointcloudhookup_tpu.ops.frontend_exact import exact_cell_plan

CAP = 32768
# max_cells ample for the workload's ~2.8k occupied cells: zero-overflow
# configs are where the modular path and the fast path are defined to be
# partition-identical (overflow remedies differ by design: the modular
# table keeps the first max_cells dense cells in lex order, the fast
# wrapper escalates the density floor like pipeline.extract's retry)
PARAMS = ExtractParams(
    ground=GroundParams(min_points_after=100),
    cluster=ClusterParams(eps=5.0, min_points=30, method="grid", max_cells=4096),
    max_clusters=32,
    obb_angles=64,
)


def _workload():
    rng = np.random.default_rng(3)
    pts, centers = synthetic_corridor(
        rng,
        n_ground=20_000,
        n_veg=4_000,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        pts_per_tower=1_500,
        extent=300.0,
    )
    origin = pts.mean(axis=0)
    xyz = np.zeros((CAP, 3), np.float32)
    xyz[: len(pts)] = (pts - origin).astype(np.float32)
    mask = np.zeros(CAP, bool)
    mask[: len(pts)] = True
    return xyz, mask, centers


def _assert_partition_equal(lab_a, lab_b):
    lab_a = np.asarray(lab_a)
    lab_b = np.asarray(lab_b)
    assert ((lab_a < 0) == (lab_b < 0)).all(), "noise sets differ"
    map_ab, map_ba = {}, {}
    for a, b in zip(lab_a[lab_a >= 0], lab_b[lab_a >= 0]):
        assert map_ab.setdefault(int(a), int(b)) == int(b)
        assert map_ba.setdefault(int(b), int(a)) == int(a)


def test_exact_cell_plan():
    assert exact_cell_plan((4000.0, 4000.0, 300.0), 8.0) == (10, 10, 7)
    # a continental tile cannot pack into one u32 key
    assert exact_cell_plan((1e7, 1e7, 1e4), 8.0) is None


def test_exact_fast_matches_modular_extract_step():
    xyz, mask, centers = _workload()

    ref = extract_step(jnp.asarray(xyz), jnp.asarray(mask), PARAMS)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    plan = _exact_fast_plan(
        xyz[mask].astype(np.float64), PARAMS, CAP
    )
    assert plan is not None
    got = _extract_stats_exact_fast(xyz, mask, PARAMS, plan)
    assert got is not None

    # exact ground base + keep set.  The bisected percentile finds the
    # SAME two order statistics as the sort-based one; the final lerp
    # may differ by 1 ULP because XLA fuses it differently in the two
    # graph contexts (FMA vs separate mul/add).
    np.testing.assert_allclose(
        float(got["base_height"]), float(ref["base_height"]), rtol=1e-6
    )
    np.testing.assert_array_equal(got["ground_keep"], ref["ground_keep"])

    # identical cluster partition (ids may differ)
    _assert_partition_equal(ref["labels"], got["labels"])

    # per-cluster stats: counts exact, geometry to the angle-grid
    # tolerance (flat A-grid vs coarse+refine search)
    r_acc = np.nonzero(ref["accepted"])[0]
    g_acc = np.nonzero(got["accepted"])[0]
    assert len(r_acc) == len(g_acc) == len(centers)
    r_order = np.argsort(ref["center"][r_acc, 0])
    g_order = np.argsort(got["center"][g_acc, 0])
    for ri, gi in zip(r_acc[r_order], g_acc[g_order]):
        assert int(ref["count"][ri]) == int(got["count"][gi])
        np.testing.assert_allclose(
            got["center"][gi], ref["center"][ri], atol=0.4
        )
        np.testing.assert_allclose(
            got["centroid"][gi], ref["centroid"][ri], atol=1e-2
        )
        np.testing.assert_allclose(
            got["extent"][gi], ref["extent"][ri], atol=0.5
        )


@pytest.mark.heavy
def test_exact_fast_compaction_overflow_retries_at_full_capacity():
    """A tile whose survivors exceed the starting compaction capacity
    must retry at full capacity (always exact) rather than drop points:
    inject a tiny starting capacity and check the result still matches
    the modular path."""
    xyz, mask, centers = _workload()
    plan = _exact_fast_plan(xyz[mask].astype(np.float64), PARAMS, CAP)
    got = _extract_stats_exact_fast(xyz, mask, PARAMS, plan, _ccap=1024)
    assert got is not None
    ref = extract_step(jnp.asarray(xyz), jnp.asarray(mask), PARAMS)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    _assert_partition_equal(ref["labels"], got["labels"])
    np.testing.assert_array_equal(got["ground_keep"], ref["ground_keep"])
    assert int(got["accepted"].sum()) == len(centers)


def test_exact_fast_core_cap_resizes_from_spill_count():
    """A flood table smaller than the tile's core-cell count must be
    re-sized DIRECTLY from the reported spill (core_overflow = n_core -
    cap) and re-run — same result as the default-capacity run, no
    silent truncation."""
    xyz, mask, centers = _workload()
    plan = _exact_fast_plan(xyz[mask].astype(np.float64), PARAMS, CAP)
    ref = _extract_stats_exact_fast(xyz, mask, PARAMS, plan)
    got = _extract_stats_exact_fast(
        xyz, mask, PARAMS, plan, _core_cap0=8
    )
    assert got is not None
    _assert_partition_equal(ref["labels"], got["labels"])
    np.testing.assert_array_equal(got["ground_keep"], ref["ground_keep"])
    assert int(got["accepted"].sum()) == len(centers)


def test_extract_from_points_capacity_not_multiple_of_32768(monkeypatch):
    """The exact route takes any capacity: padded to 30,123 rows, the
    tile goes through the exact frontend (the modular fallback is
    disabled here) and matches the modular step on the same buffer."""
    from pointcloudhookup_tpu.models import pipeline

    xyz, mask, centers = _workload()
    pts = xyz[mask].astype(np.float64)
    cap = 30_123
    assert cap % 32768 and cap % 1024
    assert _exact_fast_plan(pts, PARAMS, cap) is not None
    modular = pipeline._extract_stats_modular

    def refuse(*a, **k):
        raise AssertionError("fell back to the modular path")

    monkeypatch.setattr(pipeline, "_extract_stats_modular", refuse)
    towers, got, origin = pipeline.extract_from_points(pts, PARAMS, capacity=cap)
    assert len(towers) == len(centers)
    assert got["labels"].shape == (cap,)
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(pts)] = (pts - origin).astype(np.float32)
    m = np.arange(cap) < len(pts)
    ref = modular(buf, m, PARAMS)
    _assert_partition_equal(ref["labels"], got["labels"])
    np.testing.assert_array_equal(
        np.sort(got["count"][got["accepted"]]), np.sort(ref["count"][ref["accepted"]])
    )
