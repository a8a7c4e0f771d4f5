"""chip_smoke.py's CPU-side contract: it refuses any platform but a GPU
(printing no result), and its corridor + GIM builder writes inputs the
CLI reads back."""

import json
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_refuses_a_non_gpu_platform(capsys):
    import jax

    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_builder_writes_corridor_and_shifted_gim(tmp_path, capsys):
    from pointcloudhookup_tpu.io.las import read_las
    from pointcloudhookup_tpu.ops.geo import tm_forward

    las, gim, pts, centers = chip_smoke.build_inputs(
        str(tmp_path), n_points=6000, n_towers=3
    )
    assert len(centers) == 3
    back = read_las(las).xyz()
    assert back.shape == pts.shape
    np.testing.assert_allclose(back, pts, atol=0.006)
    chip_smoke._cli(["import-gim", gim, "--output-folder", str(tmp_path / "o")])
    out = capsys.readouterr().out
    recs = re.findall(r"(P\d+): lat=([-\d.]+) lng=([-\d.]+)", out)
    assert [r[0] for r in recs] == ["P41", "P42", "P43"]
    for (pid, lat, lng), c in zip(recs, centers):
        e, n = tm_forward(float(lng), float(lat), xp=np)
        # every GIM tower sits GIM_SHIFT_M east of its planted tower
        assert abs(float(e) - c[0] - chip_smoke.GIM_SHIFT_M) < 0.2
        assert abs(float(n) - c[1]) < 0.2


def test_obb_oracle_and_comparison():
    rng = np.random.default_rng(0)
    x, y, z = (rng.normal(size=500) * 100 for _ in range(3))
    lab = rng.integers(-1, 4, 500)
    want = chip_smoke.obb_oracle(x, y, z, lab, 4, 8)
    got = {k: v.astype(np.float32) for k, v in want.items()}
    assert chip_smoke.compare_obb(got, want, "f32 copy") <= chip_smoke.OBB_ATOL_M
    got["ulo"] = got["ulo"] + np.float32(0.01)
    with pytest.raises(chip_smoke.SmokeFailure, match="deviation"):
        chip_smoke.compare_obb(got, want, "shifted")
