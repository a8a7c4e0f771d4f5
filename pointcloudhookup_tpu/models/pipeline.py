"""Headless public pipeline API.

Mirrors the reference's workflow surface with the same parameter names
and defaults so configurations map 1:1, but fully decoupled from any
GUI:

  compress(...)   <- run_voxel_downsampling (/root/reference/ui/import_PC.py:15)
  extract(...)    <- extract_towers (/root/reference/utils/tower_extraction.py:20)
  match(...)      <- match_from_gim_tower_list (/root/reference/utils/table_match_gim.py:225)
  correct(...)    <- correct_from_gim_tower_list (:339)
  save_gim(...)   <- update_and_compress_from_correction (/root/reference/ui/save_cbm.py:268)
  import_gim(...) <- GIMExtractor + GIMTower.parse (/root/reference/ui/compress.py:50,
                     /root/reference/ui/parsetower.py:17)

Compute runs on device via the jitted ops; file I/O and the f64 CRS
reference path stay on host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pointcloudhookup_tpu.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
    TowerFilterParams,
)
from pointcloudhookup_tpu.core.batch import round_up
from pointcloudhookup_tpu.io.cbm import apply_corrections, load_towers_from_gim_folder
from pointcloudhookup_tpu.io.gim import extract_gim, write_gim
from pointcloudhookup_tpu.io.las import make_las, read_las, write_las
from pointcloudhookup_tpu.models.towers import Tower, extract_step, towers_from_stats
from pointcloudhookup_tpu.ops.geo import (
    GeoidGrid,
    ellipsoid_to_orthometric,
    haversine_matrix,
    tm_inverse,
)
from pointcloudhookup_tpu.ops.voxel import voxel_downsample, voxel_downsample_chunked
from pointcloudhookup_tpu.utils.logging import Reporter


# ------------------------------------------------------------ compress
def compress(
    input_path: str,
    output_path: str,
    voxel_size: float = 0.1,
    chunk_size: int = 500_000,
    progress_callback=None,
    log_callback=None,
    per_chunk: bool = False,
) -> int:
    """Voxel-grid downsample a LAS file on device; preserves header
    scales/offsets/point-format like the reference.  per_chunk=True
    replicates the reference's chunk-local voxel dedup.  Returns the
    output point count."""
    rep = Reporter(progress_callback, log_callback)
    las = read_las(input_path)
    pts = las.xyz()
    rep.log(f"read {len(pts)} points from {input_path}")
    rep.progress(10)

    origin = pts.mean(axis=0) if len(pts) else np.zeros(3)
    centered = (pts - origin).astype(np.float32)
    if per_chunk:
        cap = round_up(max(len(pts), 1), chunk_size)
    else:
        cap = round_up(max(len(pts), 1), 1024)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = centered
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True

    if per_chunk:
        out_xyz, out_mask = voxel_downsample_chunked(
            jnp.asarray(xyz), jnp.asarray(mask), voxel_size, chunk_size=chunk_size
        )
    else:
        out_xyz, out_mask = voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), voxel_size)
    rep.progress(80)
    out = np.asarray(out_xyz)[np.asarray(out_mask)].astype(np.float64) + origin

    reduced = make_las(
        out, scales=las.scales, offsets=las.offsets, point_format=las.point_format,
        version=las.version,
    )
    write_las(reduced, output_path)
    rep.progress(100)
    rep.log(f"downsampled to {len(out)} points -> {output_path}")
    return len(out)


# ------------------------------------------------------------ extract
def extract(
    input_las_path: str,
    progress_callback=None,
    log_callback=None,
    eps: float = 8.0,
    min_points: int = 80,
    aspect_ratio_threshold: float = 0.8,
    min_height: float = 15.0,
    max_width: float = 50.0,
    min_width: float = 8.0,
    duplicate_threshold: float = 30.0,
    params: Optional[ExtractParams] = None,
    output_dir: Optional[str] = None,
    excel_path: Optional[str] = None,
    max_clusters: int = 128,
) -> list[Tower]:
    """Extract transmission towers from a LAS tile.

    Kwarg names/defaults mirror extract_towers
    (/root/reference/utils/tower_extraction.py:20-32).  Set `params` to
    override the full parameter tree (per-chunk parity mode etc.).
    When `output_dir` is given, each tower's points are saved to
    output_dir/tower_<label>.las like the reference; `excel_path` writes
    the towers_info table (pipeline.write_table: .csv, or .xlsx through
    pandas).
    """
    rep = Reporter(progress_callback, log_callback)
    if params is None:
        params = ExtractParams(
            ground=GroundParams(),
            cluster=ClusterParams(eps=eps, min_points=min_points),
            filters=TowerFilterParams(
                aspect_ratio_threshold=aspect_ratio_threshold,
                min_height=min_height,
                max_width=max_width,
                min_width=min_width,
                duplicate_threshold=duplicate_threshold,
            ),
            max_clusters=max_clusters,
        )

    rep.log(f"reading {input_las_path}")
    rep.progress(5)
    las = read_las(input_las_path)
    pts = las.xyz()
    rep.log(f"read {len(pts)} points")

    towers, stats, origin = extract_from_points(pts, params)
    rep.progress(90)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        labels = np.asarray(stats["labels"])[: len(pts)]
        for t in towers:
            sel = labels == t.label
            tower_pts = pts[sel[: len(pts)]]
            out = make_las(
                tower_pts, scales=las.scales, offsets=las.offsets,
                point_format=las.point_format, version=las.version,
            )
            write_las(out, os.path.join(output_dir, f"tower_{t.label}.las"))
        rep.log(f"saved {len(towers)} tower LAS files to {output_dir}")

    if excel_path:
        export_towers_table(towers, excel_path)
        rep.log(f"tower table written to {excel_path}")

    rep.progress(100)
    rep.log(f"extraction complete: {len(towers)} towers")
    return towers


def _exact_fast_plan(points: np.ndarray, params: ExtractParams, cap: int):
    """Host-side routing decision for the exact fast front-end
    (ops/frontend_exact.py).  Returns the static cell-key bit plan, or
    None when the tile must take the modular extract_step path."""
    if os.environ.get("PCH_EXACT_FAST", "1") == "0":
        return None
    cp = params.cluster
    if cp.per_chunk or cp.method not in ("auto", "grid"):
        return None
    if cp.method == "auto" and cap <= cp.auto_grid_threshold:
        return None
    if not len(points):
        return None
    from pointcloudhookup_tpu.ops.frontend_exact import exact_cell_plan

    span = points.max(axis=0) - points.min(axis=0)
    return exact_cell_plan(span, cp.eps)


def _extract_stats_exact_fast(
    xyz: np.ndarray,
    mask: np.ndarray,
    params: ExtractParams,
    cell_bits,
    _ccap: Optional[int] = None,
    _core_cap0: int = 2048,
) -> Optional[dict]:
    """Run the exact fast front-end with the modular path's density-floor
    retry contract; reconstruct input-order labels/ground_keep on host.

    The survivor compaction starts at N/4 capacity; should a tile keep
    more, ONE retry at full capacity is always exact (survivors <= N).
    Density-floor escalation mirrors the modular retry loop
    (_extract_stats_modular).  The core flood table starts small (2048:
    corridor tiles have ~1k core cells in a much larger dense table, and
    the flood cost scales with the table) and on core_overflow is
    re-sized DIRECTLY from the spill count (core_overflow = n_core -
    cap, so cap + spill is the exact need); only a >32768-core tile
    falls back to the modular path.  _ccap injects a small starting
    capacity for tests."""
    cap = xyz.shape[0]
    ccap = _ccap if _ccap is not None else min(
        round_up(max(cap // 4, 1024), 1024), cap
    )
    settled = _exact_fast_settle(
        jnp.asarray(xyz), jnp.asarray(mask), params, cell_bits, ccap,
        _core_cap0,
    )
    if settled is None:
        return None
    stats, _ = settled
    stats.pop("core_overflow")
    labels = np.full(cap, -1, np.int32)
    labs = stats.pop("labels_sorted")
    rows = stats.pop("rows_sorted")
    sel = labs >= 0
    labels[rows[sel]] = labs[sel]
    off = (
        params.ground.retry_offset
        if bool(stats.pop("used_retry"))
        else params.ground.offset
    )
    base = np.float32(stats["base_height"])
    keep = mask & (xyz[:, 2].astype(np.float32) > base + np.float32(off))
    stats.pop("compact_count")
    stats["labels"] = labels
    stats["ground_keep"] = keep
    return stats


def _exact_fast_settle(xyz_j, mask_j, params: ExtractParams, cell_bits,
                       ccap: int, core_cap: int):
    """Run exact_extract_graph up its retry ladder (core table, survivor
    capacity, density floor) until the result is complete.  Returns
    (stats as numpy, the settled graph's static keyword arguments), or
    None when the tile has more core cells than the largest flood
    table."""
    from pointcloudhookup_tpu.ops.frontend_exact import exact_extract_graph

    cap = xyz_j.shape[0]
    floor = params.cluster.min_cell_points
    while True:
        kw = dict(
            cell_bits=cell_bits, compact_cap=ccap,
            max_cells=params.cluster.max_cells, min_cell_points=floor,
            core_cap=core_cap,
        )
        stats = exact_extract_graph(xyz_j, mask_j, params, **kw)
        stats = {k: np.asarray(v) for k, v in stats.items()}
        if float(stats["core_overflow"]) > 0.0:
            if core_cap < 32768:
                need = core_cap + int(stats["core_overflow"])
                core_cap = min(32768, 1 << (need - 1).bit_length())
                continue
            # more core cells than the largest flood table: the
            # min-label flood is incomplete — the modular path is the
            # correct fallback (a density-floor retry would not shrink
            # CORE cells)
            return None
        if int(stats["compact_count"]) > ccap:
            ccap = cap  # survivors <= N, so full capacity always fits
            continue
        if float(stats["cells_overflow"]) > 0.0 and floor < 16:
            floor = min(floor * 2 if floor > 1 else 2, 16)
            continue
        return stats, kw


def extract_from_points(
    points: np.ndarray,
    params: ExtractParams = ExtractParams(),
    capacity: Optional[int] = None,
) -> tuple[list[Tower], dict, np.ndarray]:
    """Extraction from an in-memory f64[N,3] world-coordinate array.
    Returns (towers, device stats dict as numpy, origin).  `capacity`
    pins the padded buffer size (same capacity -> reused executable).

    Large tiles route to the exact fast front-end
    (ops/frontend_exact.py) when eligible — identical semantics to the
    modular extract_step at fast-path cost; the modular path remains
    the fallback (ineligible tile geometry, per-chunk parity mode,
    survivor-compaction overflow, PCH_EXACT_FAST=0)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    if capacity is not None:
        cap = capacity
    elif params.cluster.per_chunk:
        cap = round_up(max(len(points), 1), params.cluster.chunk_size)
    else:
        cap = round_up(max(len(points), 1), 1024)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True

    plan = _exact_fast_plan(points, params, cap)
    stats = None
    if plan is not None:
        stats = _extract_stats_exact_fast(xyz, mask, params, plan)
    if stats is None:
        stats = _extract_stats_modular(xyz, mask, params)
    towers = towers_from_stats(stats, origin)
    return towers, stats, origin


def _extract_stats_modular(
    xyz: np.ndarray, mask: np.ndarray, params: ExtractParams
) -> dict:
    """The modular extract_step with its cell-table retry contract.

    Grid cell-table overflow silently drops dense cells — at corridor
    scale (4M raw points) the 65536-cell table can lose whole towers.
    Retry with a higher cell-density floor: each step drops more
    sparse-vegetation cells (pure noise at min_points=80) while dense
    structure cells survive."""
    xyz_j = jnp.asarray(xyz)
    mask_j = jnp.asarray(mask)
    stats = extract_step(xyz_j, mask_j, params)
    stats = {k: np.asarray(v) for k, v in stats.items()}
    floor = params.cluster.min_cell_points
    while float(stats.get("cells_overflow", 0.0)) > 0.0 and floor < 16:
        floor = min(floor * 2 if floor > 1 else 2, 16)
        retry = dataclasses.replace(
            params,
            cluster=dataclasses.replace(
                params.cluster, min_cell_points=floor
            ),
        )
        stats = extract_step(xyz_j, mask_j, retry)
        stats = {k: np.asarray(v) for k, v in stats.items()}
    return stats


_TOWER_COLUMNS = (
    "ID", "经度", "纬度", "海拔高度", "杆塔高度", "北方向偏角", "宽度", "长宽比",
)


def write_table(path: str, columns: Sequence[str], rows: Sequence[Sequence]) -> str:
    """Write one table as CSV (standard library), or as .xlsx when the
    path asks for it.  .xlsx needs pandas; when pandas has no Excel
    engine, the table goes to the .csv path beside it.  Returns the path
    written."""
    if path.lower().endswith(".xlsx"):
        try:
            import pandas as pd
        except ImportError as e:
            raise ValueError(
                f"writing {path} needs pandas; install it or give a .csv path"
            ) from e
        try:
            pd.DataFrame(list(rows), columns=list(columns)).to_excel(
                path, index=False
            )
            return path
        except ImportError:  # no Excel engine (openpyxl) installed
            path = path[:-5] + ".csv"
    import csv

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows(rows)
    return path


def export_towers_table(towers: Sequence[Tower], path: str) -> str:
    """Write the towers_info table with the reference's Chinese headers
    (/root/reference/utils/tower_extraction.py:193-202).  Returns the
    path written."""
    rows = [
        (
            t.id, t.center[0], t.center[1], t.center[2], t.height,
            t.north_angle, t.width, t.height / max(t.width, 1e-6),
        )
        for t in towers
    ]
    return write_table(path, _TOWER_COLUMNS, rows)


# ------------------------------------------------------------ reproject
def reproject_las(
    input_path: str,
    output_path: str,
    log_callback=None,
    batch: int = 1 << 20,
) -> int:
    """Transform every point of a LAS file EPSG:4547 -> WGS84 lon/lat
    (the whole-cloud CRS batch job prototyped in
    /root/reference/test/005.py — 1M-point chunks through pyproj).

    Device path: one host-f64 LocalTaylor expansion around the tile
    centroid, then f32 delta evaluation on device in `batch`-point
    blocks — sub-mm agreement with the f64 inverse over a +-2 km tile.
    Output LAS stores degrees at 1e-7 scale.  Returns the point count.
    """
    from pointcloudhookup_tpu.ops.geo import local_cgcs2000_to_wgs84

    rep = Reporter(None, log_callback)
    las = read_las(input_path)
    xyz = las.xyz()
    n = len(xyz)
    e0, n0 = (float(xyz[:, 0].mean()), float(xyz[:, 1].mean())) if n else (500000.0, 0.0)
    lt = local_cgcs2000_to_wgs84(e0, n0)

    lons = np.empty(n)
    lats = np.empty(n)
    taylor = jax.jit(lambda de, dn: lt.eval_delta(de, dn, jnp))
    for start in range(0, n, batch):
        sl = slice(start, min(start + batch, n))
        de = jnp.asarray((xyz[sl, 0] - e0).astype(np.float32))
        dn = jnp.asarray((xyz[sl, 1] - n0).astype(np.float32))
        dlon, dlat = taylor(de, dn)
        lons[sl] = lt.u0 + np.asarray(dlon, np.float64)
        lats[sl] = lt.v0 + np.asarray(dlat, np.float64)
    out = np.column_stack([lons, lats, xyz[:, 2]])
    deg = make_las(
        out,
        scales=[1e-7, 1e-7, las.scales[2]],
        offsets=[float(np.floor(lons.min())) if n else 0.0,
                 float(np.floor(lats.min())) if n else 0.0,
                 las.offsets[2]],
        point_format=las.point_format,
        version=las.version,
        # the reference's 005test path copies the source header; carry
        # the VLR block (CRS records etc.) through the reprojection
        vlr_bytes=las.vlr_bytes,
        num_vlrs=las.num_vlrs,
    )
    write_las(deg, output_path)
    rep.log(f"reprojected {n} points -> {output_path}")
    return n


# ------------------------------------------------------------ import GIM
def import_gim(gim_path: str, output_folder: str = "output", log_callback=None):
    """Unpack a .gim and parse its tower records.
    Returns (tower_records, extracted_folder, header)."""
    rep = Reporter(None, log_callback)
    folder, header = extract_gim(gim_path, output_folder)
    rep.log(f"extracted GIM to {folder}")
    records = load_towers_from_gim_folder(folder, rep.log)
    rep.log(f"parsed {len(records)} towers from GIM")
    return records, folder, header


# ------------------------------------------------------------ match
@dataclasses.dataclass
class ConvertedTower:
    """A point-cloud tower after CRS + elevation conversion (mirrors the
    reference's converted_tower dict,
    /root/reference/utils/table_match_gim.py:87-98)."""

    id: str
    converted_center: list  # [lon_wgs84, lat_wgs84, orthometric_h]
    height: float
    north_angle: float
    original_center: list  # [e_cgcs2000, n_cgcs2000, h_ellipsoid]
    ellipsoid_height: float
    orthometric_height: float
    n_value: float
    height_conversion_applied: bool
    # set when correct(icp=True) refined this tower's position
    icp_rmse: Optional[float] = None


@dataclasses.dataclass
class MatchResult:
    """Headless equivalent of the reference's Qt match/correct panel:
    the two tables plus the pair list and updated records."""

    pairs: list  # [(gim_idx, pc_idx)]
    converted_towers: list  # [ConvertedTower]
    gim_rows: list  # left table rows [id, lat, lng, h, r]
    pc_rows: list  # right table rows [id, lat, lng, h_ortho, north]
    corrected_gim: bool = False  # True when produced by correct()

    def to_csv(self, path: str) -> None:
        """Side-by-side tables; pairing is explicit via 配对 columns (the
        reference's Qt panel conveyed it with row highlight colors).
        The shorter table's rows are padded with empty cells."""
        pair_of_gim = {gi: pi for gi, pi in self.pairs}
        pair_of_pc = {pi: gi for gi, pi in self.pairs}
        columns = [
            "配对PC行", "杆塔编号", "纬度", "经度", "高程", "北方向偏角",
            "配对GIM行", "杆塔编号(PC)", "纬度(WGS84)", "经度(WGS84)",
            "高程(正高)", "北方向偏角(PC)",
        ]
        rows = []
        for i in range(max(len(self.gim_rows), len(self.pc_rows))):
            left = (
                [pair_of_gim.get(i, ""), *self.gim_rows[i]]
                if i < len(self.gim_rows) else [""] * 6
            )
            right = (
                [pair_of_pc.get(i, ""), *self.pc_rows[i]]
                if i < len(self.pc_rows) else [""] * 6
            )
            rows.append(left + right)
        write_table(path, columns, rows)

    # rotating row-highlight palette, as in the reference's Qt panel
    # (/root/reference/utils/table_match_gim.py:288: lightblue /
    # light yellow / gainsboro)
    _COLORS = ("#ADD8E6", "#FFFFCC", "#DCDCDC")

    def to_html(self, path: str, title: str = "匹配结果") -> None:
        """Self-contained review page: GIM and point-cloud tables side by
        side, matched pairs highlighted in rotating colors (the headless
        replacement for the reference's review panel)."""
        color_of_gim = {}
        color_of_pc = {}
        for i, (gi, pi) in enumerate(self.pairs):
            c = self._COLORS[i % len(self._COLORS)]
            color_of_gim[gi] = c
            color_of_pc[pi] = c

        def table(rows, headers, colors):
            out = ["<table border='1' cellspacing='0' cellpadding='4'>"]
            out.append(
                "<tr>" + "".join(f"<th>{h}</th>" for h in headers) + "</tr>"
            )
            for i, row in enumerate(rows):
                style = f" style='background:{colors[i]}'" if i in colors else ""
                out.append(
                    f"<tr{style}>" + "".join(f"<td>{v}</td>" for v in row) + "</tr>"
                )
            out.append("</table>")
            return "\n".join(out)

        left = table(
            self.gim_rows, ["杆塔编号", "纬度", "经度", "高程", "北方向偏角"], color_of_gim
        )
        right = table(
            self.pc_rows,
            ["杆塔编号", "纬度(WGS84)", "经度(WGS84)", "高程(正高)", "北方向偏角"],
            color_of_pc,
        )
        mode = "校对" if self.corrected_gim else "匹配"
        html = f"""<!doctype html><meta charset="utf-8"><title>{title}</title>
<h2>{title} ({mode}; {len(self.pairs)} 对)</h2>
<div style="display:flex; gap:24px; font-family:sans-serif; font-size:13px">
<div><h3>GIM 数据</h3>{left}</div>
<div><h3>点云数据 (正高转换后)</h3>{right}</div>
</div>"""
        with open(path, "w", encoding="utf-8") as f:
            f.write(html)


def convert_pointcloud_towers(
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    geoid: Optional[GeoidGrid] = None,
) -> list[ConvertedTower]:
    """CGCS2000 -> WGS84 + ellipsoid -> orthometric for extracted towers
    (mirrors convert_pointcloud_ellipsoid_to_orthometric,
    /root/reference/utils/table_match_gim.py:37-142).  Host f64 CRS: the
    tower list is small; precision beats device batching here."""
    out = []
    for i, t in enumerate(pc_towers):
        e, n, h_ellip = float(t.center[0]), float(t.center[1]), float(t.center[2])
        lon, lat = tm_inverse(e, n, xp=np)
        lon, lat = float(lon), float(lat)
        applied = True
        h_ortho = float(
            ellipsoid_to_orthometric(lat, lon, h_ellip, geoid, region_n_value, xp=np)
        )
        out.append(
            ConvertedTower(
                id=f"PC-{i + 1}",
                converted_center=[lon, lat, h_ortho],
                height=float(t.height),
                north_angle=float(t.north_angle),
                original_center=[e, n, h_ellip],
                ellipsoid_height=h_ellip,
                orthometric_height=h_ortho,
                n_value=h_ellip - h_ortho,
                height_conversion_applied=applied,
            )
        )
    return out


def match_towers(
    gim_list: Sequence,
    converted: Sequence[ConvertedTower],
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
) -> list[tuple[int, int]]:
    """Greedy first-match pairing, exactly the reference's loop
    (/root/reference/utils/table_match_gim.py:169-196): for each GIM
    tower in order, the FIRST point-cloud tower within both thresholds
    wins; point-cloud towers are NOT consumed (may pair repeatedly).
    Vectorized: one haversine matrix + per-row argmax of the first True.
    """
    if not len(gim_list) or not len(converted):
        return []
    g_lat = np.array([float(t.get("lat", 0) or 0) for t in gim_list])
    g_lon = np.array([float(t.get("lng", 0) or 0) for t in gim_list])
    g_h = np.array([float(t.get("h", 0) or 0) for t in gim_list])
    p_lon = np.array([c.converted_center[0] for c in converted])
    p_lat = np.array([c.converted_center[1] for c in converted])
    p_h = np.array([c.converted_center[2] for c in converted])
    dist = haversine_matrix(g_lat, g_lon, p_lat, p_lon, xp=np)
    ok = (dist <= distance_threshold) & (
        np.abs(g_h[:, None] - p_h[None, :]) <= height_threshold
    )
    pairs = []
    any_ok = ok.any(axis=1)
    first = ok.argmax(axis=1)
    for i in np.nonzero(any_ok)[0]:
        pairs.append((int(i), int(first[i])))
    return pairs


def _tower_prop(gim_tower, key, default=""):
    props = gim_tower.get("properties") or {}
    return props.get(key, default) if isinstance(props, dict) else default


def _build_result(
    gim_list, converted, pairs, corrected: bool
) -> MatchResult:
    gim_rows = [
        [
            _tower_prop(t, "杆塔编号"),
            f"{float(t.get('lat', 0) or 0):.6f}",
            f"{float(t.get('lng', 0) or 0):.6f}",
            f"{float(t.get('h', 0) or 0):.2f}",
            f"{float(t.get('r', 0) or 0):.1f}",
        ]
        for t in gim_list
    ]
    pc_rows = [
        [
            c.id,
            f"{c.converted_center[1]:.6f}",
            f"{c.converted_center[0]:.6f}",
            f"{c.converted_center[2]:.2f}",
            f"{c.north_angle:.1f}",
        ]
        for c in converted
    ]
    for gi, pi in pairs:
        gim_id = _tower_prop(gim_list[gi], "杆塔编号")
        gim_r = float(gim_list[gi].get("r", 0) or 0)
        # matched PC towers adopt the GIM id + north angle
        # (ref: table_match_gim.py:291-316)
        converted[pi].id = str(gim_id)
        converted[pi].north_angle = gim_r
        pc_rows[pi][0] = str(gim_id)
        pc_rows[pi][4] = f"{gim_r:.1f}"
        if corrected:
            # correct(): point-cloud coordinates flow back into the GIM
            # table; the GIM north angle is kept (ref: :403-444)
            c = converted[pi]
            gim_rows[gi][1] = f"{c.converted_center[1]:.6f}"
            gim_rows[gi][2] = f"{c.converted_center[0]:.6f}"
            gim_rows[gi][3] = f"{c.converted_center[2]:.2f}"
    return MatchResult(
        pairs=pairs,
        converted_towers=list(converted),
        gim_rows=gim_rows,
        pc_rows=pc_rows,
        corrected_gim=corrected,
    )


def match(
    gim_list: Sequence,
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
    geoid: Optional[GeoidGrid] = None,
) -> MatchResult:
    """Match GIM towers to extracted point-cloud towers (headless
    equivalent of match_from_gim_tower_list)."""
    converted = convert_pointcloud_towers(pc_towers, region_n_value, geoid)
    pairs = match_towers(gim_list, converted, distance_threshold, height_threshold)
    return _build_result(gim_list, converted, pairs, corrected=False)


def correct(
    gim_list: Sequence,
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
    geoid: Optional[GeoidGrid] = None,
    icp: bool = False,
    pc_clouds: Optional[Sequence] = None,
    icp_iters: int = 30,
    icp_max_corr_dist: float = 2.0,
) -> MatchResult:
    """Match + write point-cloud derived coordinates back into the GIM
    rows (headless correct_from_gim_tower_list).

    icp=True (opt-in; requires `pc_clouds`, the per-tower member points
    in world coordinates, aligned with `pc_towers`) refines each matched
    tower's position with batched ICP against an idealized pylon frame
    before the write-back — see models/refine.py.  Refined pairs carry
    their ICP rmse in ConvertedTower.icp_rmse."""
    converted = convert_pointcloud_towers(pc_towers, region_n_value, geoid)
    pairs = match_towers(gim_list, converted, distance_threshold, height_threshold)
    if icp and pairs:
        if pc_clouds is None:
            raise ValueError("correct(icp=True) requires pc_clouds")
        from pointcloudhookup_tpu.models.refine import refine_tower_centers

        # pylon-frame geometry from the matched GIM model where the
        # properties carry it (杆塔高 = total tower height) — the frame
        # being aligned is the MODEL's, not a self-template
        tmpl = {}
        for gi, pi in pairs:
            th = _tower_prop(gim_list[gi], "杆塔高", "")
            try:
                th = float(th)
            except (TypeError, ValueError):
                th = None
            if th:
                tmpl[pi] = (th, None)
        refined = refine_tower_centers(
            pc_towers, pc_clouds, [pi for _, pi in pairs],
            iters=icp_iters, max_corr_dist=icp_max_corr_dist,
            template_params=tmpl or None,
        )
        for pi, r in refined.items():
            e, n, h_ellip = (float(v) for v in r["center"])
            lon, lat = (float(v) for v in tm_inverse(e, n, xp=np))
            h_ortho = float(
                ellipsoid_to_orthometric(lat, lon, h_ellip, geoid, region_n_value, xp=np)
            )
            c = converted[pi]
            c.converted_center = [lon, lat, h_ortho]
            c.original_center = [e, n, h_ellip]
            c.ellipsoid_height = h_ellip
            c.orthometric_height = h_ortho
            c.n_value = h_ellip - h_ortho
            c.icp_rmse = float(r["rmse"])
    return _build_result(gim_list, converted, pairs, corrected=True)


# ------------------------------------------------------------ save
def corrected_rows_from_result(result: MatchResult, gim_list: Sequence) -> list[dict]:
    """Build the corrected-data rows save_gim consumes, carrying each
    matched tower's CBM path."""
    rows = []
    for gi, pi in result.pairs:
        c = result.converted_towers[pi]
        rows.append(
            {
                "杆塔编号": _tower_prop(gim_list[gi], "杆塔编号"),
                "纬度": c.converted_center[1],
                "经度": c.converted_center[0],
                "高度": c.converted_center[2],
                "北方向偏角": c.north_angle,
                "CBM路径": gim_list[gi].get("cbm_path", ""),
            }
        )
    return rows


def save_gim(
    extracted_gim_folder: str,
    corrected_data: Sequence[dict],
    output_gim_path: str,
    original_gim_path: Optional[str] = None,
    log_callback=None,
    level: int = 9,
) -> bool:
    """Update CBM BLHA lines from corrected rows and repack the .gim
    (headless update_and_compress_from_correction,
    /root/reference/ui/save_cbm.py:268-281)."""
    rep = Reporter(None, log_callback)
    try:
        rows = list(corrected_data)
        updated = apply_corrections(extracted_gim_folder, rows, rep.log)
        rep.log(f"updated {updated} CBM files")
        header = None
        if original_gim_path and os.path.exists(original_gim_path):
            with open(original_gim_path, "rb") as f:
                header = f.read(776)
        write_gim(extracted_gim_folder, output_gim_path, header=header, level=level)
        rep.log(f"GIM written: {output_gim_path}")
        return True
    except (OSError, ValueError) as e:
        rep.log(f"save failed: {e}")
        return False
