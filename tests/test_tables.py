"""Table outputs (--csv, --table, --excel) need no pandas: CSV goes
through the standard library, and only .xlsx asks for pandas."""

import csv
import sys

import numpy as np
import pytest

from pointcloudhookup_tpu.models.pipeline import (
    ConvertedTower,
    _build_result,
    export_towers_table,
)
from pointcloudhookup_tpu.models.towers import Tower


@pytest.fixture
def no_pandas(monkeypatch):
    """Make `import pandas` fail, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "pandas", None)


def _towers():
    return [
        Tower(id=f"tower_{i}", center=np.array([500.0 + i, 3100.0, 90.0]),
              extent=np.array([11.0, 9.0, 32.0]), height=32.0, width=11.0,
              north_angle=12.5 * i, angle=0.1, num_points=900 + i, label=i)
        for i in range(3)
    ]


def _rows(path):
    with open(path, encoding="utf-8", newline="") as f:
        return list(csv.reader(f))


def test_match_csv_without_pandas(no_pandas, tmp_path):
    gim = [
        dict(lat=28.0, lng=113.0, h=50.0, r=10.0, properties={"杆塔编号": "P1"}),
        dict(lat=28.1, lng=113.1, h=51.0, r=20.0, properties={"杆塔编号": "P2"}),
    ]
    pc = [
        ConvertedTower(
            id="PC-1", converted_center=[113.0, 28.0, 49.0], height=30.0,
            north_angle=5.0, original_center=[0, 0, 74.0], ellipsoid_height=74.0,
            orthometric_height=49.0, n_value=25.0, height_conversion_applied=True,
        )
    ]
    res = _build_result(gim, pc, [(0, 0)], corrected=False)
    path = str(tmp_path / "t.csv")
    res.to_csv(path)
    rows = _rows(path)
    assert rows[0][0] == "配对PC行" and rows[0][6] == "配对GIM行"
    assert len(rows) == 3  # header + the longer (GIM) table
    assert rows[1][:2] == ["0", "P1"] and rows[1][6:8] == ["0", "P1"]
    assert rows[2][1] == "P2" and rows[2][6:] == [""] * 6


def test_towers_table_csv_without_pandas(no_pandas, tmp_path):
    path = str(tmp_path / "towers_info.csv")
    assert export_towers_table(_towers(), path) == path
    rows = _rows(path)
    assert rows[0] == ["ID", "经度", "纬度", "海拔高度", "杆塔高度", "北方向偏角",
                       "宽度", "长宽比"]
    assert [r[0] for r in rows[1:]] == ["tower_0", "tower_1", "tower_2"]
    assert float(rows[2][5]) == 12.5


def test_xlsx_without_pandas_fails_clearly(no_pandas, tmp_path):
    with pytest.raises(ValueError, match="needs pandas"):
        export_towers_table(_towers(), str(tmp_path / "towers_info.xlsx"))
