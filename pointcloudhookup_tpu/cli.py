"""Command-line driver: the reference's eight-button GUI workflow
(/root/reference/pyGUI_towers_test.py:73 — import GIM / import point
cloud / remove ground / extract towers / match / correct / save) as
headless subcommands, plus an end-to-end `run-all`.

Usage: python -m pointcloudhookup_tpu <command> [options]
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_import_pc(args):
    from pointcloudhookup_tpu.io.las import read_las

    las = read_las(args.las)
    xyz = las.xyz()
    info = dict(
        points=len(las),
        point_format=las.point_format,
        version=list(las.version),
        scales=las.scales.tolist(),
        offsets=las.offsets.tolist(),
        min=xyz.min(axis=0).tolist() if len(las) else None,
        max=xyz.max(axis=0).tolist() if len(las) else None,
    )
    print(json.dumps(info, indent=2))


def cmd_import_gim(args):
    from pointcloudhookup_tpu.models.pipeline import import_gim

    records, folder, _header = import_gim(
        args.gim, args.output_folder, log_callback=print
    )
    for r in records:
        props = r.properties or {}
        print(
            f"{props.get('杆塔编号', r.name)}: lat={r.lat:.6f} lng={r.lng:.6f} "
            f"h={r.h:.2f} r={r.r:.1f} ({r.cbm_path})"
        )
    if args.table:
        from pointcloudhookup_tpu.models.pipeline import write_table

        columns = (
            "系统层级", "系统类型", "经度", "纬度", "高度", "北方向偏角",
            "杆塔编号", "CBM路径",
        )
        rows = [
            (
                r.name, r.type, r.lng, r.lat, r.h, r.r,
                (r.properties or {}).get("杆塔编号", ""), r.cbm_path,
            )
            for r in records
        ]
        print(f"table -> {write_table(args.table, columns, rows)}")


def cmd_compress(args):
    from pointcloudhookup_tpu.models.pipeline import compress

    n = compress(
        args.input,
        args.output,
        voxel_size=args.voxel_size,
        chunk_size=args.chunk_size,
        per_chunk=args.per_chunk,
        log_callback=print,
    )
    print(f"{n} points written")


def cmd_extract(args):
    from pointcloudhookup_tpu.models.pipeline import extract

    params = None
    method = getattr(args, "cluster_method", "auto")
    if getattr(args, "per_chunk", False) or method != "auto":
        from pointcloudhookup_tpu.config import (
            ClusterParams,
            ExtractParams,
            TowerFilterParams,
        )

        params = ExtractParams(
            cluster=ClusterParams(
                eps=args.eps, min_points=args.min_points,
                per_chunk=getattr(args, "per_chunk", False),
                method=method,
            ),
            filters=TowerFilterParams(
                aspect_ratio_threshold=args.aspect_ratio_threshold,
                min_height=args.min_height,
                max_width=args.max_width,
                min_width=args.min_width,
                duplicate_threshold=args.duplicate_threshold,
            ),
        )
    towers = extract(
        args.las,
        log_callback=print,
        eps=args.eps,
        min_points=args.min_points,
        aspect_ratio_threshold=args.aspect_ratio_threshold,
        min_height=args.min_height,
        max_width=args.max_width,
        min_width=args.min_width,
        duplicate_threshold=args.duplicate_threshold,
        params=params,
        output_dir=args.output_dir,
        excel_path=args.excel,
    )
    for t in towers:
        print(
            f"{t.id}: center=({t.center[0]:.2f},{t.center[1]:.2f},{t.center[2]:.2f}) "
            f"h={t.height:.1f} w={t.width:.1f} north={t.north_angle:.1f} pts={t.num_points}"
        )


def _load_towers_for_match(args):
    from pointcloudhookup_tpu.models.pipeline import extract, import_gim

    records, folder, _ = import_gim(args.gim, args.output_folder)
    towers = extract(args.las, log_callback=print, eps=args.eps, min_points=args.min_points)
    return records, folder, towers


def cmd_match(args, corrected: bool = False):
    from pointcloudhookup_tpu.models import pipeline

    use_icp = corrected and getattr(args, "icp", False)
    if use_icp:
        # labels-aware extraction: ONE pass yields both the tower list
        # and per-point labels, so each matched tower's member cloud
        # feeds the ICP refinement
        from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
        from pointcloudhookup_tpu.io.las import read_las
        from pointcloudhookup_tpu.models.pipeline import extract_from_points

        records, folder, _ = pipeline.import_gim(args.gim, args.output_folder)
        pts = read_las(args.las).xyz()
        params = ExtractParams(
            cluster=ClusterParams(eps=args.eps, min_points=args.min_points)
        )
        towers, stats, _origin = extract_from_points(pts, params)
        print(f"extraction complete: {len(towers)} towers")
        labels = stats["labels"][: len(pts)]
        clouds = [pts[labels == t.label] for t in towers]
        res = pipeline.correct(
            records, towers, region_n_value=args.region_n_value,
            icp=True, pc_clouds=clouds, icp_iters=args.icp_iters,
            icp_max_corr_dist=args.icp_max_corr_dist,
        )
        for c in res.converted_towers:
            if c.icp_rmse is not None:
                print(f"  {c.id}: icp rmse {c.icp_rmse:.3f} m")
    else:
        records, folder, towers = _load_towers_for_match(args)
        fn = pipeline.correct if corrected else pipeline.match
        res = fn(records, towers, region_n_value=args.region_n_value)
    print(f"{len(res.pairs)} pairs matched")
    for gi, pi in res.pairs:
        print(f"  GIM[{gi}] {res.gim_rows[gi][0]} <-> PC[{pi}] {res.pc_rows[pi][0]}")
    if args.csv:
        res.to_csv(args.csv)
        print(f"tables -> {args.csv}")
    if getattr(args, "html", None):
        res.to_html(args.html)
        print(f"review page -> {args.html}")
    if corrected and args.save:
        rows = pipeline.corrected_rows_from_result(res, records)
        ok = pipeline.save_gim(folder, rows, args.save, original_gim_path=args.gim, log_callback=print)
        print("saved" if ok else "save FAILED")


def cmd_reproject(args):
    from pointcloudhookup_tpu.models.pipeline import reproject_las

    n = reproject_las(args.input, args.output, log_callback=print)
    print(f"{n} points reprojected")


def cmd_viz_export(args):
    from pointcloudhookup_tpu.models.pipeline import extract
    from pointcloudhookup_tpu.viz.boxes import (
        export_geometries_json,
        tower_display_geometries,
    )

    towers = extract(args.las, log_callback=print, eps=args.eps, min_points=args.min_points)
    geoms = tower_display_geometries(
        towers,
        method="kuangxuan" if args.preset.startswith("kuangxuan") else "symmetric",
        preset=args.preset,
    )
    export_geometries_json(geoms, args.output)
    print(f"{len(geoms)} tower boxes -> {args.output}")


def cmd_export_scene(args):
    """LAS (+ extraction) -> colored binary PLY for external viewers.

    The headless counterpart of the reference's interactive scene
    (ui/vtk_widget.py:41 display_full_scene / towers.py:155-197
    Open3D window): per-point cluster colors (height colormap without
    --towers) and the enlarged tower wireframes as PLY edge elements.
    The colored points load in any PLY viewer; the nonstandard edge
    element renders in MeshLab (CloudCompare/Open3D skip it)."""
    import numpy as np

    from pointcloudhookup_tpu.io.las import read_las
    from pointcloudhookup_tpu.viz.boxes import tower_display_geometries
    from pointcloudhookup_tpu.viz.export import export_scene_ply

    pts = read_las(args.las).xyz()
    las_out = args.output.lower().endswith((".las", ".laz"))
    labels, accepted, geoms = None, None, []
    if args.towers:
        from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
        from pointcloudhookup_tpu.models.pipeline import extract_from_points

        params = ExtractParams(
            cluster=ClusterParams(eps=args.eps, min_points=args.min_points)
        )
        towers, stats, _ = extract_from_points(pts, params)
        labels = np.asarray(stats["labels"])[: len(pts)]
        accepted = [t.label for t in towers]
        if las_out:
            if towers:
                print(
                    "note: tower wireframes are not representable in "
                    "LAS/LAZ — use a .ply output to get box edges"
                )
        else:
            geoms = tower_display_geometries(towers, preset=args.preset)
        print(f"{len(towers)} tower boxes")
    if las_out:
        from pointcloudhookup_tpu.viz.export import export_scene_las

        summary = export_scene_las(
            args.output, pts, labels=labels, accepted_labels=accepted,
            display_cap=args.display_cap,
        )
    else:
        summary = export_scene_ply(
            args.output, pts, labels=labels, accepted_labels=accepted,
            geoms=geoms, display_cap=args.display_cap,
        )
    print(
        f"scene -> {args.output} ({summary['vertices']} vertices, "
        f"{summary['edges']} wireframe edges)"
    )


def cmd_render(args):
    """Offscreen scene render: LAS (+ extracted tower boxes) -> PNG.

    Headless twin of the reference's VTK display path
    (ui/vtk_widget.py:41 display_full_scene): height-colored point
    splat with the 500k display cap + enlarged tower wireframes."""
    from pointcloudhookup_tpu.io.las import read_las
    from pointcloudhookup_tpu.viz.boxes import tower_display_geometries
    from pointcloudhookup_tpu.viz.render import render_to_png

    pts = read_las(args.las).xyz()
    geoms = []
    if args.towers:
        # reuse the already-decoded array instead of re-reading the LAS
        from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
        from pointcloudhookup_tpu.models.pipeline import extract_from_points

        params = ExtractParams(
            cluster=ClusterParams(eps=args.eps, min_points=args.min_points)
        )
        towers, _, _ = extract_from_points(pts, params)
        geoms = tower_display_geometries(towers, preset=args.preset)
        print(f"{len(geoms)} tower boxes")
    render_to_png(
        pts, geoms, args.output, width=args.width, height=args.height,
        display_cap=args.display_cap,
    )
    print(f"scene -> {args.output}")


def cmd_elevation_report(args):
    from pointcloudhookup_tpu.models.elevation_report import (
        convert_to_orthometric,
        write_report,
    )
    from pointcloudhookup_tpu.models.pipeline import import_gim

    records, _, _ = import_gim(args.gim, args.output_folder)
    geoid = None
    if args.geoid:
        from pointcloudhookup_tpu.io.geoid import load_geoid

        geoid = load_geoid(args.geoid)
    towers = [
        dict(id=(r.properties or {}).get("杆塔编号", r.name), lat=r.lat, lon=r.lng, h=r.h)
        for r in records
    ]
    rows = convert_to_orthometric(towers, geoid=geoid, empirical_n=args.empirical_n)
    report = write_report(
        rows, csv_path=args.csv, text_path=args.text, chart_path=args.chart
    )
    print(report)


def cmd_register(args):
    """Batched ICP: align each extracted tower to its matched GIM tower
    footprint (the north-star upgrade over greedy matching)."""
    import numpy as np

    from pointcloudhookup_tpu.io.las import read_las
    from pointcloudhookup_tpu.models import pipeline
    from pointcloudhookup_tpu.ops.registration import register_tower_pairs

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.models.pipeline import extract_from_points

    records, folder, _ = pipeline.import_gim(args.gim, args.output_folder)
    # ONE extraction produces both the tower list and the per-point
    # labels, so labels == t.label selects exactly t's cluster even with
    # non-default eps/min_points.
    las = read_las(args.las)
    pts = las.xyz()
    params = ExtractParams(
        cluster=ClusterParams(eps=args.eps, min_points=args.min_points)
    )
    towers, stats, origin = extract_from_points(pts, params)
    print(f"extraction complete: {len(towers)} towers")
    res = pipeline.match(records, towers, region_n_value=args.region_n_value)
    if not res.pairs:
        print("no matched pairs to register")
        return
    # source: tower points from the LAS; target: synthetic pylon frame at
    # the GIM position (no geometry in GIM text model -> use the matched
    # tower's own box frame displaced to the GIM location)
    labels = stats["labels"][: len(pts)]
    pc_clouds, gim_clouds = [], []
    from pointcloudhookup_tpu.ops.geo import wgs84_to_cgcs2000

    for gi, pi in res.pairs:
        t = towers[pi]
        cloud = pts[labels == t.label] - t.center
        e, n = wgs84_to_cgcs2000(records[gi].lng, records[gi].lat, xp=np)
        gim_center = np.array([float(e), float(n), t.center[2]])
        pc_clouds.append((pts[labels == t.label] - gim_center).astype(np.float32))
        gim_clouds.append(cloud.astype(np.float32))
    out = register_tower_pairs(pc_clouds, gim_clouds, iters=args.iters)
    for (gi, pi), cloud, r in zip(res.pairs, pc_clouds, out):
        print(
            f"GIM[{gi}] <- PC[{pi}]: n={len(cloud)} "
            f"t=({r['t'][0]:+.2f},{r['t'][1]:+.2f},{r['t'][2]:+.2f}) "
            f"rmse={r['rmse']:.3f} inliers={r['inlier_frac']:.0%}"
        )


def cmd_stream_extract(args):
    """Tower extraction over arbitrarily large inputs: tiles stream
    host->device double-buffered, per-tile towers merge with the
    two-tier quality dedup, and chunk capacity auto-sizes to host RAM +
    device HBM via the resource governor (no manual tuning — the
    reference's RAM-ladder analogue, ui/Sampling.py:88-89)."""
    import numpy as np

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, TowerFilterParams
    from pointcloudhookup_tpu.core.governor import budget
    from pointcloudhookup_tpu.core.streaming import stream_extract
    from pointcloudhookup_tpu.models.towers import towers_from_stats
    from pointcloudhookup_tpu.utils.validate import quality_dedup

    from pointcloudhookup_tpu.core.governor import estimate_points

    sizes = [estimate_points(p) or 0 for p in args.las]
    b = budget(
        max_memory_percent=args.max_memory_percent,
        hard_cap=args.capacity,
        n_points=max(sizes) or None,
    )
    capacity = args.capacity or b.capacity
    print(f"governor: {b.reason}" + (" (explicit --capacity)" if args.capacity else ""))
    params = ExtractParams(
        cluster=ClusterParams(
            eps=args.eps, min_points=args.min_points,
            method=getattr(args, "cluster_method", "auto"),
        ),
        filters=TowerFilterParams(
            aspect_ratio_threshold=args.aspect_ratio_threshold,
            min_height=args.min_height,
            max_width=args.max_width,
            min_width=args.min_width,
            duplicate_threshold=args.duplicate_threshold,
        ),
    )
    results = stream_extract(
        args.las, capacity=capacity, params=params, fast=args.fast,
        precut_div=getattr(args, "precut_div", 4),
    )
    towers = []
    for stats, meta in results:
        towers.extend(towers_from_stats(stats, np.asarray(meta["origin"])))
    towers = quality_dedup(towers, loose_radius=args.duplicate_threshold)
    print(f"{len(towers)} towers across {len(results)} tiles (capacity {capacity:,})")
    for i, t in enumerate(towers):
        print(
            f"tower_{i}: center=({t.center[0]:.2f},{t.center[1]:.2f},{t.center[2]:.2f}) "
            f"h={t.height:.1f} w={t.width:.1f} north={t.north_angle:.1f} pts={t.num_points}"
        )


def cmd_run_all(args):
    """import pc -> compress -> extract -> import gim -> correct -> save."""
    from pointcloudhookup_tpu.models import pipeline

    ds = args.las.rsplit(".", 1)[0] + "_ds.las"
    pipeline.compress(args.las, ds, voxel_size=args.voxel_size, log_callback=print)
    towers = pipeline.extract(ds, log_callback=print, eps=args.eps, min_points=args.min_points)
    records, folder, _ = pipeline.import_gim(args.gim, args.output_folder)
    res = pipeline.correct(records, towers, region_n_value=args.region_n_value)
    print(f"{len(res.pairs)} towers corrected")
    rows = pipeline.corrected_rows_from_result(res, records)
    ok = pipeline.save_gim(folder, rows, args.out_gim, original_gim_path=args.gim, log_callback=print)
    if args.csv:
        res.to_csv(args.csv)
    sys.exit(0 if ok else 1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pointcloudhookup_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("import-pc", help="inspect a LAS file")
    sp.add_argument("las")
    sp.set_defaults(fn=cmd_import_pc)

    sp = sub.add_parser("import-gim", help="unpack + parse a GIM file")
    sp.add_argument("gim")
    sp.add_argument("--output-folder", default="output")
    sp.add_argument("--table", help="write tower_data table (xlsx/csv)")
    sp.set_defaults(fn=cmd_import_gim)

    sp = sub.add_parser("compress", help="voxel-grid downsample a LAS file")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--voxel-size", type=float, default=0.1)
    sp.add_argument("--chunk-size", type=int, default=500_000)
    sp.add_argument("--per-chunk", action="store_true", help="reference-parity per-chunk voxel dedup")
    sp.set_defaults(fn=cmd_compress)

    def add_extract_args(sp):
        sp.add_argument("--eps", type=float, default=8.0)
        sp.add_argument("--min-points", type=int, default=80)
        sp.add_argument("--aspect-ratio-threshold", type=float, default=0.8)
        sp.add_argument("--min-height", type=float, default=15.0)
        sp.add_argument("--max-width", type=float, default=50.0)
        sp.add_argument("--min-width", type=float, default=8.0)
        sp.add_argument("--duplicate-threshold", type=float, default=30.0)
        sp.add_argument(
            "--cluster-method", default="auto",
            choices=["auto", "exact", "grid", "adaptive"],
            help="clustering backend; 'adaptive' derives eps from the data "
                 "(the reference's HDBSCAN-path analogue)",
        )

    sp = sub.add_parser("extract", help="extract towers from a LAS tile")
    sp.add_argument("las")
    add_extract_args(sp)
    sp.add_argument("--output-dir", help="save per-tower LAS files here")
    sp.add_argument("--excel", help="towers_info table path")
    sp.add_argument(
        "--per-chunk", action="store_true",
        help="reference-parity per-50k-chunk clustering (labels never merge across chunks)",
    )
    sp.set_defaults(fn=cmd_extract)

    for name, corrected in (("match", False), ("correct", True)):
        sp = sub.add_parser(name, help=f"{name} GIM towers against a LAS tile")
        sp.add_argument("gim")
        sp.add_argument("las")
        add_extract_args(sp)
        sp.add_argument("--region-n-value", type=float, default=25.0)
        sp.add_argument("--output-folder", default="output")
        sp.add_argument("--csv", help="write the side-by-side tables")
        sp.add_argument("--html", help="write the highlighted review page")
        if corrected:
            sp.add_argument("--save", help="write the corrected .gim here")
            sp.add_argument(
                "--icp", action="store_true",
                help="refine matched tower positions with batched ICP "
                "against an idealized pylon frame before write-back",
            )
            sp.add_argument("--icp-iters", type=int, default=30)
            sp.add_argument("--icp-max-corr-dist", type=float, default=2.0)
        sp.set_defaults(fn=lambda a, c=corrected: cmd_match(a, c))

    sp = sub.add_parser("reproject", help="EPSG:4547 -> WGS84 whole-LAS transform")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_reproject)

    sp = sub.add_parser("viz-export", help="export enlarged tower wireframes as JSON")
    sp.add_argument("las")
    sp.add_argument("output")
    add_extract_args(sp)
    sp.add_argument("--preset", default="kuangxuan_original")
    sp.set_defaults(fn=cmd_viz_export)

    sp = sub.add_parser("export-scene", help="export a colored PLY scene (points + tower wireframes) for external viewers")
    sp.add_argument("las")
    sp.add_argument("output")
    sp.add_argument("--towers", action="store_true", help="extract + color clusters + wireframes")
    sp.add_argument("--eps", type=float, default=8.0)
    sp.add_argument("--min-points", type=int, default=80)
    sp.add_argument("--preset", default="kuangxuan_original")
    sp.add_argument("--display-cap", type=int, default=500_000)
    sp.set_defaults(fn=cmd_export_scene)

    sp = sub.add_parser("render", help="offscreen render of a LAS scene (+ tower boxes) to PNG")
    sp.add_argument("las")
    sp.add_argument("output")
    sp.add_argument("--towers", action="store_true", help="extract + overlay tower boxes")
    sp.add_argument("--eps", type=float, default=8.0)
    sp.add_argument("--min-points", type=int, default=80)
    sp.add_argument("--preset", default="kuangxuan_original")
    sp.add_argument("--width", type=int, default=1280)
    sp.add_argument("--height", type=int, default=960)
    sp.add_argument("--display-cap", type=int, default=500_000)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("elevation-report", help="ellipsoid->orthometric conversion report for GIM towers")
    sp.add_argument("gim")
    sp.add_argument("--geoid", help=".gtx or .npz geoid grid")
    sp.add_argument("--empirical-n", type=float, default=28.0)
    sp.add_argument("--csv")
    sp.add_argument("--text")
    sp.add_argument("--chart")
    sp.add_argument("--output-folder", default="output")
    sp.set_defaults(fn=cmd_elevation_report)

    sp = sub.add_parser("register", help="batched ICP alignment of matched towers")
    sp.add_argument("gim")
    sp.add_argument("las")
    add_extract_args(sp)
    sp.add_argument("--region-n-value", type=float, default=25.0)
    sp.add_argument("--iters", type=int, default=20)
    sp.add_argument("--output-folder", default="output")
    sp.set_defaults(fn=cmd_register)

    sp = sub.add_parser(
        "stream-extract",
        help="streamed tower extraction over huge/multiple LAS files (auto-sized chunks)",
    )
    sp.add_argument("las", nargs="+")
    add_extract_args(sp)
    sp.add_argument("--capacity", type=int, help="points per device chunk (default: auto from RAM/HBM)")
    sp.add_argument("--max-memory-percent", type=float, default=30.0,
                    help="host RAM fraction the streamer may stage into (ref test/008.py:109)")
    sp.add_argument("--fast", action="store_true",
                    help="fused geometric front-end + sort-free OBB per tile (bench fast mode)")
    sp.add_argument("--precut-div", type=int, default=4, dest="precut_div",
                    help="fast mode: ground pre-cut capacity divisor "
                         "(sort runs at capacity/DIV; 0 disables the "
                         "pre-cut and its raw-z percentile estimate)")
    sp.set_defaults(fn=cmd_stream_extract)

    sp = sub.add_parser("run-all", help="full workflow: compress -> extract -> correct -> save")
    sp.add_argument("las")
    sp.add_argument("gim")
    sp.add_argument("out_gim")
    add_extract_args(sp)
    sp.add_argument("--voxel-size", type=float, default=0.1)
    sp.add_argument("--region-n-value", type=float, default=25.0)
    sp.add_argument("--output-folder", default="output")
    sp.add_argument("--csv")
    sp.set_defaults(fn=cmd_run_all)

    args = p.parse_args(argv)
    try:
        args.fn(args)
    except FileNotFoundError as e:
        p.exit(2, f"error: file not found: {e.filename or e}\n")
    except ValueError as e:
        p.exit(2, f"error: {e}\n")


if __name__ == "__main__":
    main()
