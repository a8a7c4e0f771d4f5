"""Synthetic workload generators.

The reference has no test fixtures beyond captured parse output; we
generate our own: corridor-like point clouds (ground + vegetation +
lattice towers + catenary lines) and GIM model trees, used by the test
suite for round-trip/parity checks, by bench.py and by chip_smoke.py.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from pointcloudhookup_tpu.io.gim import write_gim


def synthetic_corridor(
    rng: np.random.Generator,
    n_ground: int = 20_000,
    n_veg: int = 4_000,
    towers: Sequence[tuple[float, float]] = ((0.0, 0.0), (120.0, 40.0), (-150.0, -60.0)),
    tower_height: float = 35.0,
    tower_width: float = 12.0,
    pts_per_tower: int = 1_500,
    extent: float = 400.0,
    n_line: int = 0,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
):
    """Synthetic power-line corridor.

    Returns (points f64[N,3], tower_centers f64[K,3]).  Ground is a
    gently rolling surface, towers are tapered lattice columns, optional
    catenary conductor points hang between consecutive towers.
    """
    ground_xy = rng.uniform(-extent, extent, size=(n_ground, 2))
    ground_z = 0.5 * np.sin(ground_xy[:, 0] / 90.0) + rng.normal(0, 0.15, n_ground)
    parts = [np.column_stack([ground_xy, ground_z])]

    if n_veg:
        veg_xy = rng.uniform(-extent, extent, size=(n_veg, 2))
        veg_z = rng.uniform(0.5, 6.0, n_veg)
        parts.append(np.column_stack([veg_xy, veg_z]))

    centers = []
    tower_list = np.asarray(towers, np.float64)
    for cx, cy in tower_list:
        t = rng.uniform(0, 1, pts_per_tower)
        half = tower_width / 2 * (1.0 - 0.7 * t)  # tapered lattice
        x = cx + rng.uniform(-1, 1, pts_per_tower) * half
        y = cy + rng.uniform(-1, 1, pts_per_tower) * half
        z = t * tower_height
        parts.append(np.column_stack([x, y, z]))
        centers.append([cx, cy, tower_height / 2])

    if n_line and len(tower_list) > 1:
        for a, b in zip(tower_list[:-1], tower_list[1:]):
            s = rng.uniform(0, 1, n_line)
            xy = a[None, :] + s[:, None] * (b - a)[None, :]
            sag = 4.0 * s * (1 - s) * 6.0
            z = tower_height - 2.0 - sag + rng.normal(0, 0.05, n_line)
            parts.append(np.column_stack([xy, z]))

    pts = np.vstack(parts)
    pts += np.asarray(origin, np.float64)
    return pts, np.array(centers) + np.asarray(origin, np.float64)


def corridor_tile(
    n: int,
    seed: int = 7,
    n_towers: int = 24,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
):
    """The benchmark corridor tile: n points over a 4 x 4 km square
    (80% ground, 12% vegetation, the rest split over `n_towers` towers
    along a gently winding line, no conductors).  Returns
    (points f64[<=n, 3], tower centers f64[n_towers, 3])."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1800, 1800, n_towers)
    ys = 80.0 * np.sin(xs / 500.0)
    pts, centers = synthetic_corridor(
        rng,
        n_ground=int(n * 0.80),
        n_veg=int(n * 0.12),
        towers=tuple(zip(xs, ys)),
        pts_per_tower=max((n - int(n * 0.92)) // n_towers, 1),
        extent=2000.0,
        n_line=0,
        origin=origin,
    )
    return pts[:n], centers


def boundary_corridor(
    total: int,
    n_towers: int = 10,
    seed: int = 3,
    extent: float = 800.0,
    span: float = 690.0 / 800.0,
    tower_share: float = 0.2,
):
    """Corridor whose points are SORTED BY X, so D contiguous shards are
    spatial slabs and towers straddle shard boundaries (the cross-chunk
    merge semantics of /root/reference/test/tttt.py:104-174 are what a
    sharded merge must reproduce).  Towers sit evenly over the central
    `span` fraction of the x extent and hold `tower_share` of the
    points (8% is vegetation, the rest ground); the corridor is
    narrowed to a quarter of its width.
    Returns (xyz f32[total, 3], mask bool[total], tower centers)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-span * extent, span * extent, n_towers)
    ys = 25.0 * np.sin(xs / (extent * 180.0 / 800.0))
    n_ground = int(total * (0.92 - tower_share))
    n_veg = int(total * 0.08)
    ppt = (total - n_ground - n_veg) // n_towers
    pts, centers = synthetic_corridor(
        rng,
        n_ground=n_ground,
        n_veg=n_veg,
        towers=tuple(zip(xs, ys)),
        pts_per_tower=ppt,
        extent=extent,
    )
    pts[:, 1] *= 0.25  # narrow the corridor (bounds the dense-cell count)
    centers[:, 1] *= 0.25
    pts = pts[:total]
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    xyz = np.zeros((total, 3), np.float32)
    xyz[: len(pts)] = pts.astype(np.float32)
    mask = np.zeros(total, bool)
    mask[: len(pts)] = True
    return xyz, mask, centers


DEFAULT_FAM_PROPS = {
    "杆塔编号": "P{i}",
    "呼高": "24",
    "杆塔高": "42.0",
    "Kv值": "220",
    "转角": "0.0",
}


def build_gim_tree(
    folder: str,
    towers: Sequence[dict],
    subsystems: int = 1,
) -> None:
    """Write a synthetic GIM model tree (Cbm/project.cbm + per-tower
    .cbm/.fam files) shaped like the reference's parse expectations
    (/root/reference/ui/parsetower.py:28-114).

    Each tower dict: {"id": str, "lat": float, "lng": float, "h": float,
    "r": float, "props": dict | None}.
    """
    cbm = os.path.join(folder, "Cbm")
    os.makedirs(cbm, exist_ok=True)
    groups = [[] for _ in range(subsystems)]
    for i, t in enumerate(towers):
        groups[i % subsystems].append((i, t))

    sub_names = []
    for s, group in enumerate(groups):
        sub_name = f"F{s + 1}.cbm"
        sub_names.append(sub_name)
        lines = [f"ENTITYNAME=线路{s + 1}", f"GROUPS.NUM={len(group)}"]
        for i, _t in group:
            lines.append(f"GROUP=T{i}.cbm")
        with open(os.path.join(cbm, sub_name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        for i, t in group:
            props = t.get("props") or {
                **{k: v for k, v in DEFAULT_FAM_PROPS.items() if k != "杆塔编号"},
                "杆塔编号": str(t.get("id", f"P{i}")),
            }
            fam_name = f"T{i}.fam"
            with open(os.path.join(cbm, f"T{i}.cbm"), "w", encoding="utf-8") as f:
                f.write(
                    "\n".join(
                        [
                            f"ENTITYNAME={t.get('id', f'塔{i}')}",
                            "GROUPTYPE=TOWER",
                            f"BLHA={t['lat']:.6f},{t['lng']:.6f},{t['h']:.3f},{t['r']:.3f}",
                            f"BASEFAMILY={fam_name}",
                        ]
                    )
                    + "\n"
                )
            with open(os.path.join(cbm, fam_name), "w", encoding="utf-8") as f:
                for k, v in props.items():
                    f.write(f"_={k}={v}\n")

    with open(os.path.join(cbm, "project.cbm"), "w", encoding="utf-8") as f:
        f.write("ENTITYNAME=工程\n")
        for name in sub_names:
            f.write(f"SUBSYSTEM={name}\n")


def build_synthetic_gim(
    gim_path: str,
    towers: Sequence[dict],
    workdir: Optional[str] = None,
    header: Optional[bytes] = None,
) -> str:
    """Build a complete synthetic .gim file; returns the tree folder."""
    import tempfile

    folder = workdir or tempfile.mkdtemp(prefix="gim_tree_")
    build_gim_tree(folder, towers)
    if header is None:
        header = b"GIMHDR\x01" + bytes(range(256)) * 3  # arbitrary 776-ish content
    write_gim(folder, gim_path, header=header, level=1)
    return folder
