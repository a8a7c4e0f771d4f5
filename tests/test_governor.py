"""Resource governor: RAM/HBM-aware chunk auto-sizing
(reference analogue: ui/Sampling.py:88-89, test/008.py:109,231-243)."""

import numpy as np
import pytest

from pointcloudhookup_tpu.core import governor


def test_host_available_bytes_positive():
    assert governor.host_available_bytes() > (1 << 28)


def test_device_memory_fallback_by_kind():
    """An accelerator that reports no memory limit is an error (there is
    no per-kind table to guess from); the CPU platform budgets host
    memory."""

    class FakeDev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return None

    with pytest.raises(ValueError, match="no memory limit"):
        governor.device_memory_bytes(FakeDev())

    class FakeDev2:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            raise RuntimeError("no stats")

    with pytest.raises(ValueError, match="no memory limit"):
        governor.device_memory_bytes(FakeDev2())

    class CpuDev:
        platform = "cpu"
        device_kind = "cpu"

        def memory_stats(self):
            return None

    assert governor.device_memory_bytes(CpuDev()) == governor.host_available_bytes()


def test_device_memory_from_stats():
    class FakeDev:
        device_kind = "whatever"

        def memory_stats(self):
            return {"bytes_limit": 7 << 30}

    assert governor.device_memory_bytes(FakeDev()) == 7 << 30


def test_auto_capacity_scales_with_ram(monkeypatch):
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {"bytes_limit": 16 << 30}

    monkeypatch.setattr(governor, "host_available_bytes", lambda: 4 << 30)
    small = governor.auto_capacity(device=Dev())
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 64 << 30)
    big = governor.auto_capacity(device=Dev())
    assert small < big
    # ladder values only (stable jit cache keys)
    assert small in governor._LADDER and big in governor._LADDER
    # 4 GB host: 30% budget / 88 B per point ~ 14.6M -> must be well below
    assert small * governor.HOST_BYTES_PER_POINT * 2 <= (4 << 30) * 0.31


def test_auto_capacity_respects_device_budget(monkeypatch):
    class TinyDev:
        device_kind = "x"

        def memory_stats(self):
            return {"bytes_limit": 1 << 30}

    monkeypatch.setattr(governor, "host_available_bytes", lambda: 256 << 30)
    cap = governor.auto_capacity(device=TinyDev())
    assert cap * governor.DEVICE_BYTES_PER_POINT <= (1 << 30) * 0.61


def test_auto_capacity_hard_cap_and_small_input(monkeypatch):
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 64 << 30)
    assert governor.auto_capacity(hard_cap=2_000_000) <= 2_000_000
    # small input: smallest ladder rung that holds it
    cap = governor.auto_capacity(n_points=20_000)
    assert cap >= 20_000
    assert cap == min(v for v in governor._LADDER if v >= 20_000)


def test_auto_chunk_size_reference_ladder(monkeypatch):
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 4 << 30)
    assert governor.auto_chunk_size() == 500_000
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 8 << 30)
    assert governor.auto_chunk_size() == 1_000_000
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 16 << 30)
    assert governor.auto_chunk_size() == 2_000_000


def test_budget_reason_string():
    b = governor.budget()
    assert b.capacity >= governor._LADDER[0]
    assert "capacity" in b.reason


def test_estimate_points_from_las_header(tmp_path):
    from pointcloudhookup_tpu.io.las import make_las, peek_point_count, write_las

    pts = np.random.default_rng(0).uniform(0, 100, (1234, 3))
    path = str(tmp_path / "t.las")
    write_las(make_las(pts), path)
    assert peek_point_count(path) == 1234
    assert governor.estimate_points(path) == 1234


def test_tile_streamer_auto_capacity(monkeypatch, tmp_path):
    """TileStreamer with capacity=None sizes itself and still yields
    every point exactly once."""
    from pointcloudhookup_tpu.core.streaming import TileStreamer

    pts = np.random.default_rng(1).uniform(0, 50, (3000, 3))
    ts = TileStreamer([pts], capacity=None)
    assert ts.capacity >= 3000
    total = 0
    for xyz, mask, meta in ts:
        total += int(np.asarray(mask).sum())
    assert total == 3000


@pytest.mark.heavy
def test_stream_extract_governed_runs(rng):
    """stream_extract with no capacity arg runs end to end (the VERDICT
    'no manual tuning' criterion, scaled to test size)."""
    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.core.streaming import stream_extract
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

    pts, centers = synthetic_corridor(
        rng, n_ground=3000, n_veg=500, pts_per_tower=300, extent=200.0
    )
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30))
    results = stream_extract([pts], params=params)
    assert len(results) >= 1
    found = sum(int(np.asarray(s["accepted"]).sum()) for s, _ in results)
    assert found >= len(centers) - 1
