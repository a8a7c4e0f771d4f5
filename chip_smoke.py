"""Smoke run of the extraction product on one NVIDIA GPU.

    python chip_smoke.py           # phases 0-5 on one card
    python chip_smoke.py --four    # sharded extraction on four cards

The single-card run drives the main path once at product scale: a
4,194,304-point corridor tile with 24 towers (io/synthetic.py::
corridor_tile, seed 7) written to LAS, plus a GIM for the same towers,
with the product defaults (eps 8, min_points 80, max_cells 65536).

  0. card     the card's name and power limit; exits unless JAX runs
              on a GPU (there is no CPU fallback)
  1. compile  the exact extraction step at the tile's shapes; prints
              compiled.memory_analysis() and fails if any buffer holds
              [max_cells, max_cells] elements or more (the dense
              pairwise and one-hot forms)
  2. ops      each translated op against its plain reference at real
              widths: the tiled neighbour pass against the dense oracle
              in row blocks (identical decisions), and the OBB
              accumulators against a float64 numpy oracle
  3. parity   extract_from_points (exact frontend) against the modular
              extract_step: same accepted towers, equal per-tower point
              counts, centers within 1 cm
  4. workflow run-all -> import-gim (24 towers corrected, BLHA lines
              rewritten), stream-extract and stream-extract --fast
  5. lines    wall time, compile time and peak device bytes per input
              point, after every phase

`--four` runs only the sharded path: a 16,777,216-point corridor sorted
by x (towers on the three shard boundaries) through make_sharded_extract
in exact and fast mode on a 4-device mesh and on a 1-device mesh; the
two must accept the same towers, centers within 1 cm, with no halo
overflow.

Every line is labelled with the card and its power limit.  A failed
phase exits non-zero and prints no result; the last line of a passing
run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TILE_POINTS = 4 * 1024 * 1024
FOUR_POINTS = 16 * 1024 * 1024
N_TOWERS = 24
SEED = 7
# the GIM's towers are displaced this far east of the planted towers, so
# a corrected GIM must have moved every tower back
GIM_SHIFT_M = 10.0
# OBB fields other than cnt: f32 at +-2 km has a ulp of ~1.2e-4 m, and
# the card may fuse x*cos + y*sin into one FMA
OBB_ATOL_M = 1e-3
# the exact and modular frontends must place each tower's box alike
CENTER_ATOL_M = 0.01

_LABEL = ""
_COMPILE_S = [0.0]


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[{_LABEL}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SmokeFailure(
            f"JAX found no GPU (platform {platform!r}); this check runs on "
            "the card only"
        )


def build_inputs(workdir: str, n_points: int = TILE_POINTS,
                 n_towers: int = N_TOWERS, seed: int = SEED):
    """Write the corridor LAS and its GIM under workdir.

    Returns (las_path, gim_path, points f64[N,3], planted centers
    f64[T,3]).  Points sit in CGCS2000 / 3-degree TM coordinates around
    (113.5 E, 28.2 N); the GIM records every tower GIM_SHIFT_M east of
    its planted position."""
    from pointcloudhookup_tpu.io.las import make_las, write_las
    from pointcloudhookup_tpu.io.synthetic import build_synthetic_gim, corridor_tile
    from pointcloudhookup_tpu.ops.geo import tm_forward, tm_inverse

    e0, n0 = tm_forward(113.5, 28.2, xp=np)
    pts, centers = corridor_tile(
        n_points, seed=seed, n_towers=n_towers,
        origin=(float(e0), float(n0), 80.0),
    )
    las_path = os.path.join(workdir, "corridor.las")
    write_las(make_las(pts, scales=[0.01, 0.01, 0.01]), las_path)
    # points on disk are quantized to the LAS scale
    pts = np.round(pts / 0.01) * 0.01
    towers = []
    for i, c in enumerate(centers):
        lon, lat = tm_inverse(c[0] + GIM_SHIFT_M, c[1], xp=np)
        towers.append(dict(id=f"P{41 + i}", lat=float(lat), lng=float(lon),
                           h=float(c[2]) - 25.0, r=33.0))
    gim_path = os.path.join(workdir, "corridor.gim")
    build_synthetic_gim(gim_path, towers, workdir=os.path.join(workdir, "gtree"))
    return las_path, gim_path, pts, centers


def _peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


@contextlib.contextmanager
def phase(name: str, device, n_points: int):
    """Run one phase; afterwards print its wall time, the XLA compile
    time spent inside it, and the device's peak bytes per input point."""
    say(f"phase {name}: start")
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    peak = _peak_bytes(device)
    say(
        f"phase {name}: PASS wall {wall:.2f} s, compile "
        f"{_COMPILE_S[0] - c0:.2f} s, peak_bytes_in_use {peak} "
        f"({peak / n_points:.1f} B per input point)"
    )


def _count_compiles() -> None:
    import jax

    def listener(event, duration, **_):
        if "backend_compile" in event:
            _COMPILE_S[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)


def _median_time(fn, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _tile_arrays(points, params):
    """The extract_from_points device inputs for `points`: centered f32
    coordinates, mask, cell-key plan and the capacities it starts at."""
    from pointcloudhookup_tpu.core.batch import round_up
    from pointcloudhookup_tpu.models.pipeline import _exact_fast_plan

    cap = round_up(len(points), 1024)
    origin = points.mean(axis=0)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True
    plan = _exact_fast_plan(points, params, cap)
    check(plan is not None, "the tile is not eligible for the exact frontend")
    return xyz, mask, plan, cap


def phase_compile(xyz, mask, plan, params):
    """Lower + compile the exact step's first attempt, as
    extract_from_points runs it first."""
    from pointcloudhookup_tpu.ops.frontend_exact import exact_extract_graph

    n = xyz.shape[0]
    m = params.cluster.max_cells
    kw = dict(
        cell_bits=plan, compact_cap=n // 4, max_cells=m,
        min_cell_points=params.cluster.min_cell_points, core_cap=2048,
    )
    t0 = time.perf_counter()
    compiled = exact_extract_graph.lower(xyz, mask, params, **kw).compile()
    say(f"exact_extract_graph compiled in {time.perf_counter() - t0:.2f} s "
        f"(N {n}, compact_cap {n // 4}, max_cells {m})")
    mem = compiled.memory_analysis()
    say(f"memory_analysis: {mem}")
    temp = int(getattr(mem, "temp_size_in_bytes", 0))
    check(temp < 4 * m * m,
          f"compiled temporaries {temp} B reach a dense [m, m] f32 table")
    biggest = _largest_buffer(compiled.as_text())
    say(f"largest buffer in the compiled step: {biggest} elements "
        f"(dense [m, m] would be {m * m})")
    check(biggest < m * m, "the compiled step holds an [m, m]-sized buffer")


def _largest_buffer(hlo_text: str) -> int:
    import re

    best = 0
    for dims in re.findall(r"\b(?:pred|[suf]\d+|bf16)\[([0-9,]+)\]", hlo_text):
        size = 1
        for d in dims.split(","):
            size *= int(d)
        best = max(best, size)
    return best


def obb_oracle(x, y, z, labels, k: int, a: int) -> dict:
    """float64 numpy accumulators over the labelled rows."""
    ang = np.arange(a, dtype=np.float64) * (np.pi / 2.0 / a)
    cos_a, sin_a = np.cos(ang), np.sin(ang)
    out = {key: np.zeros(k) for key in ("cnt", "sx", "sy", "sz")}
    out["zlo"] = np.full(k, np.inf)
    out["zhi"] = np.full(k, -np.inf)
    for key in ("ulo", "vlo"):
        out[key] = np.full((k, a), np.inf)
    for key in ("uhi", "vhi"):
        out[key] = np.full((k, a), -np.inf)
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))
    labels = np.asarray(labels)
    for c in np.unique(labels[(labels >= 0) & (labels < k)]):
        sel = labels == c
        xc, yc, zc = x[sel], y[sel], z[sel]
        u = xc[:, None] * cos_a[None, :] + yc[:, None] * sin_a[None, :]
        v = yc[:, None] * cos_a[None, :] - xc[:, None] * sin_a[None, :]
        out["cnt"][c] = sel.sum()
        out["sx"][c], out["sy"][c], out["sz"][c] = xc.sum(), yc.sum(), zc.sum()
        out["zlo"][c], out["zhi"][c] = zc.min(), zc.max()
        out["ulo"][c], out["uhi"][c] = u.min(0), u.max(0)
        out["vlo"][c], out["vhi"][c] = v.min(0), v.max(0)
    return out


def compare_obb(got: dict, want: dict, name: str) -> float:
    """cnt exactly; centroids and extremes of live clusters within
    OBB_ATOL_M.  Returns the largest deviation."""
    cnt = np.asarray(got["cnt"])
    check(np.array_equal(cnt, want["cnt"]), f"{name}: cnt differs")
    live = want["cnt"] > 0
    worst = 0.0
    for key in ("sx", "sy", "sz"):
        d = np.abs(np.asarray(got[key], np.float64)[live] / cnt[live]
                   - want[key][live] / want["cnt"][live])
        worst = max(worst, float(d.max(initial=0.0)))
    for key in ("zlo", "zhi", "ulo", "uhi", "vlo", "vhi"):
        d = np.abs(np.asarray(got[key], np.float64)[live] - want[key][live])
        worst = max(worst, float(d.max(initial=0.0)))
    check(worst <= OBB_ATOL_M, f"{name}: deviation {worst:.2e} m > {OBB_ATOL_M}")
    return worst


def phase_ops(xyz, mask, plan, params):
    """The neighbour pass and the OBB accumulators at the tile's widths,
    on the graph extract_from_points settles on: its retry ladder runs
    first, so the dense-cell table compared and timed here does not
    spill."""
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.models.pipeline import _exact_fast_settle
    from pointcloudhookup_tpu.ops.frontend_exact import exact_extract_graph
    from pointcloudhookup_tpu.ops.neighbor import (
        neighbor_reduce,
        neighbor_reduce_reference,
    )
    from pointcloudhookup_tpu.ops.obb_accum import (
        obb_accumulate_xyz,
        obb_accumulate_xyz_sorted,
    )

    xyz_j, mask_j = jnp.asarray(xyz), jnp.asarray(mask)
    settled = _exact_fast_settle(xyz_j, mask_j, params, plan,
                                 xyz.shape[0] // 4, 2048)
    check(settled is not None, "the exact step found too many core cells")
    stats, kw = settled
    check(float(stats["cells_overflow"]) == 0.0,
          "the settled exact step still spills its dense-cell table")
    say(f"settled exact step: min_cell_points {kw['min_cell_points']}, "
        f"compact_cap {kw['compact_cap']}, core_cap {kw['core_cap']}")
    table = exact_extract_graph(xyz_j, mask_j, params, _cut=4, **kw)
    centers, ccount, alive = table["centers"], table["ccount"], table["cell_alive"]
    m = centers.shape[0]
    eps = params.cluster.eps
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    pop, _ = neighbor_reduce(centers, jnp.zeros(m, jnp.int32), ccount, alive,
                             eps2, mode="pop")
    core = alive & (pop >= params.cluster.min_points)
    iota = jnp.arange(m, dtype=jnp.int32)
    _, lmin = neighbor_reduce(centers, iota, jnp.zeros(m), core, eps2, mode="lmin")
    # the dense oracle runs on [block, block] pieces of the pairwise
    # matrix, combined on the host (one [2048, 65536] reduction took XLA
    # minutes to compile); cell counts are integers, so the oracle sums
    # them as int32, exact in any order, and the comparison with the f32
    # pass is bit for bit
    ccount_i = ccount.astype(jnp.int32)
    dense = jax.jit(
        lambda rows, cols, lab, w, alw: neighbor_reduce_reference(
            cols, lab, w, alw, eps2, sentinel=m, rows=rows)
    )
    block = 4096
    pop_ref = np.zeros(m, np.int64)
    lmin_ref = np.full(m, m, np.int64)
    for r0 in range(0, m, block):
        rows = centers[r0:r0 + block]
        for c0 in range(0, m, block):
            c = slice(c0, c0 + block)
            p_blk, _ = dense(rows, centers[c], iota[c], ccount_i[c], alive[c])
            _, l_blk = dense(rows, centers[c], iota[c], ccount_i[c], core[c])
            pop_ref[r0:r0 + block] += np.asarray(p_blk)
            lmin_ref[r0:r0 + block] = np.minimum(lmin_ref[r0:r0 + block],
                                                 np.asarray(l_blk))
    check(np.array_equal(np.asarray(pop), pop_ref.astype(np.float32)),
          "neighbour populations differ from the dense oracle")
    check(np.array_equal(np.asarray(lmin), lmin_ref),
          "neighbour min-labels differ from the dense oracle")
    t_pass = _median_time(lambda: neighbor_reduce(
        centers, iota, ccount, alive, eps2, mode="pop"))
    say(f"neighbour pass: {int(np.asarray(alive).sum())} live cells of {m}, "
        f"{int(np.asarray(core).sum())} core; pop and min-label identical to "
        f"the dense oracle; one pass {t_pass * 1e3:.3f} ms")

    rows = exact_extract_graph(xyz_j, mask_j, params, _cut=6, **kw)
    k, a = params.max_clusters, params.obb_angles
    lab = rows["labels_s"]
    want = obb_oracle(rows["xs"], rows["ys"], rows["zs"], lab, k, a)
    say(f"OBB rows: {lab.shape[0]} survivors, "
        f"{int((np.asarray(lab) >= 0).sum())} labelled, "
        f"{int((want['cnt'] > 0).sum())} clusters")
    impls = [("product", obb_accumulate_xyz), ("sorted-xla", obb_accumulate_xyz_sorted)]
    for name, fn in impls:
        f = jax.jit(lambda x, y, z, l, fn=fn: fn(x, y, z, l, max_clusters=k,
                                                  num_angles=a))
        args = (rows["xs"], rows["ys"], rows["zs"], lab)
        worst = compare_obb(f(*args), want, name)
        t = _median_time(lambda: f(*args))
        t_step = _exact_step_time(fn, xyz_j, mask_j, params, kw)
        say(f"OBB accumulators [{name}]: cnt exact, max deviation "
            f"{worst:.2e} m (atol {OBB_ATOL_M}); op {t * 1e3:.3f} ms, exact "
            f"step end to end {t_step * 1e3:.3f} ms")


def _exact_step_time(obb_fn, xyz, mask, params, kw) -> float:
    """Median time of the whole exact step with `obb_fn` as its OBB
    accumulation (the product's choice against its plain alternative)."""
    import functools

    import jax

    from pointcloudhookup_tpu.ops import frontend_exact as fe

    product = fe.obb_accumulate_xyz
    fe.obb_accumulate_xyz = obb_fn
    try:
        step = jax.jit(functools.partial(fe.exact_extract_graph.__wrapped__,
                                         params=params, **kw))
        return _median_time(lambda: step(xyz, mask), reps=5)
    finally:
        fe.obb_accumulate_xyz = product


def _pair_towers(a, b, what: str) -> float:
    """Greedy 1:1 pairing of two center arrays; returns the worst
    distance."""
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} towers")
    used, worst = set(), 0.0
    for c in a:
        d = np.linalg.norm(b - c[None, :], axis=1)
        j = int(np.argmin(d))
        check(j not in used, f"{what}: two towers pair with one")
        used.add(j)
        worst = max(worst, float(d[j]))
    return worst


def phase_parity(points, params, centers):
    """Exact frontend vs the modular extract_step, on the card."""
    from pointcloudhookup_tpu.models.pipeline import (
        _extract_stats_modular,
        extract_from_points,
    )
    from pointcloudhookup_tpu.models.towers import towers_from_stats

    towers, stats, origin = extract_from_points(points, params)
    check(len(towers) == N_TOWERS,
          f"exact frontend accepted {len(towers)} of {N_TOWERS} towers")
    xyz = np.zeros((stats["labels"].shape[0], 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(xyz.shape[0], bool)
    mask[: len(points)] = True
    mod_stats = _extract_stats_modular(xyz, mask, params)
    mod = towers_from_stats(mod_stats, origin)
    c_ex = np.array([t.center for t in towers])
    c_mod = np.array([t.center for t in mod])
    worst = _pair_towers(c_ex, c_mod, "exact vs modular")
    check(worst <= CENTER_ATOL_M,
          f"exact vs modular centers differ by {worst:.4f} m")
    n_ex = sorted(t.num_points for t in towers)
    n_mod = sorted(t.num_points for t in mod)
    check(n_ex == n_mod, "per-tower point counts differ between the frontends")
    planted = _pair_towers(c_ex[:, :2], centers[:, :2], "exact vs planted")
    say(f"exact == modular: {len(towers)} towers, equal point counts, max "
        f"center delta {worst:.5f} m; max offset from planted {planted:.2f} m")


def _cli(argv) -> str:
    """Run the CLI in this process; returns its stdout.  A non-zero
    exit is a failure."""
    from pointcloudhookup_tpu.cli import main

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    out = buf.getvalue()
    for line in out.splitlines()[-6:]:
        say(f"  | {line}")
    check(code == 0, f"{argv[0]} exited with {code}")
    return out


def phase_workflow(workdir, las, gim):
    import csv
    import re

    out_gim = os.path.join(workdir, "corrected.gim")
    table = os.path.join(workdir, "t.csv")
    out = _cli(["run-all", las, gim, out_gim, "--csv", table,
                "--output-folder", os.path.join(workdir, "o1")])
    check(f"{N_TOWERS} towers corrected" in out,
          "run-all did not correct every tower")
    with open(table, encoding="utf-8", newline="") as f:
        rows = list(csv.reader(f))[1:]
    # the GIM half of the table: id, lat, lng after correction
    want = {r[1]: (float(r[2]), float(r[3])) for r in rows if r[1]}
    before = _cli(["import-gim", gim, "--output-folder",
                   os.path.join(workdir, "o0")])
    after = _cli(["import-gim", out_gim, "--output-folder",
                  os.path.join(workdir, "o2")])
    pat = r"(P\d+): lat=([-\d.]+) lng=([-\d.]+)"
    old = {p: (float(a), float(b)) for p, a, b in re.findall(pat, before)}
    new = {p: (float(a), float(b)) for p, a, b in re.findall(pat, after)}
    check(len(new) == N_TOWERS == len(want),
          f"corrected GIM holds {len(new)} towers, table {len(want)}")
    # degrees -> metres near 28 N
    scale = np.array([110574.0, 111320.0 * np.cos(np.radians(28.2))])
    moved = []
    for pid, ll in new.items():
        check(np.allclose(ll, want[pid], atol=2e-6),
              f"{pid}: BLHA {ll} is not the corrected {want[pid]}")
        moved.append(float(np.linalg.norm((np.subtract(ll, old[pid])) * scale)))
    check(min(moved) > 1.0, "a BLHA line was not rewritten")
    say(f"corrected GIM: {len(new)} BLHA lines rewritten to the corrected "
        f"table, moved {min(moved):.2f}..{max(moved):.2f} m (GIM was "
        f"{GIM_SHIFT_M} m off)")
    for fast in (False, True):
        argv = ["stream-extract", las] + (["--fast"] if fast else [])
        out = _cli(argv)
        m = re.search(r"(\d+) towers across", out)
        check(m is not None and int(m.group(1)) == N_TOWERS,
              f"{' '.join(argv[:1] + argv[2:])} found "
              f"{m.group(1) if m else 'no'} towers")


def run_single() -> dict:
    import jax

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams

    dev = jax.devices()[0]
    params = ExtractParams(cluster=ClusterParams(eps=8.0, min_points=80,
                                                 max_cells=65536))
    n = TILE_POINTS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        t0 = time.perf_counter()
        las, gim, points, centers = build_inputs(workdir, n)
        say(f"inputs: {len(points)} points, {len(centers)} towers written "
            f"in {time.perf_counter() - t0:.1f} s")
        xyz, mask, plan, _ = _tile_arrays(points, params)
        with phase("1 compile", dev, n):
            phase_compile(xyz, mask, plan, params)
        with phase("2 ops", dev, n):
            phase_ops(xyz, mask, plan, params)
        with phase("3 parity", dev, n):
            phase_parity(points, params, centers)
        with phase("4 workflow", dev, n):
            phase_workflow(workdir, las, gim)
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))


def run_four() -> dict:
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.io.synthetic import boundary_corridor
    from pointcloudhookup_tpu.ops.frontend_exact import exact_cell_plan
    from pointcloudhookup_tpu.parallel.sharded import make_sharded_extract, tile_mesh

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, JAX sees {len(devs)}")
    n = FOUR_POINTS
    extent = 4000.0
    # 39 towers 5% of the extent apart: three of them sit on the x
    # quartiles, i.e. on the shard boundaries of the sorted points
    xyz_np, mask_np, planted = boundary_corridor(
        n, n_towers=39, seed=SEED, extent=extent, span=0.95, tower_share=0.08,
    )
    bounds = [float(xyz_np[d * n // 4, 0]) for d in (1, 2, 3)]
    straddle = sum(
        int(np.any(np.abs(planted[:, 0] - b) < 6.0)) for b in bounds
    )
    say(f"corridor: {n} points, {len(planted)} towers, shard boundaries at x "
        f"{[round(b, 1) for b in bounds]}, {straddle} of 3 cut a tower")
    check(straddle == 3, "not every shard boundary cuts a tower")
    # no retry ladder in the sharded step: the cell-density floor is set
    # so the whole corridor's dense-cell table fits max_cells
    params = ExtractParams(cluster=ClusterParams(
        eps=8.0, min_points=80, max_cells=65536, min_cell_points=4))
    span = xyz_np[mask_np].max(axis=0) - xyz_np[mask_np].min(axis=0)
    plan = exact_cell_plan(span, params.cluster.eps)
    check(plan is not None, "corridor too large for one cell key")
    results = {}
    for mode in ("exact", "fast"):
        for d in (4, 1):
            mesh = tile_mesh(d)
            step, sharding = make_sharded_extract(
                mesh, params, mode=mode, exact_cell_bits=plan,
                fast_max_cells=65536,
            )
            xyz = jax.device_put(jnp.asarray(xyz_np), sharding)
            mask = jax.device_put(jnp.asarray(mask_np), sharding)
            t0 = time.perf_counter()
            _, merged = jax.block_until_ready(step(xyz, mask))
            first = time.perf_counter() - t0
            t = _median_time(lambda: step(xyz, mask), reps=3)
            acc = np.asarray(merged["accepted"])
            halo = float(merged["halo_overflow"])
            cells = float(merged["cells_overflow"])
            say(f"{mode} on {d} device(s): {int(acc.sum())} towers, "
                f"halo_overflow {halo}, cells_overflow {cells}, first call "
                f"{first:.2f} s, step {t * 1e3:.1f} ms")
            check(halo == 0.0, f"{mode}/{d}: halo overflow {halo}")
            check(cells == 0.0, f"{mode}/{d}: cell table overflow {cells}")
            results[(mode, d)] = np.asarray(merged["center"])[acc]
        worst = _pair_towers(results[(mode, 4)], results[(mode, 1)],
                             f"{mode}: 4 devices vs 1")
        check(worst <= CENTER_ATOL_M,
              f"{mode}: sharded centers differ by {worst:.4f} m")
        check(len(results[(mode, 1)]) == len(planted),
              f"{mode}: {len(results[(mode, 1)])} of {len(planted)} towers")
        say(f"{mode}: 4 devices == 1 device ({len(planted)} towers, max "
            f"center delta {worst:.5f} m)")
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=4)


def main(argv=None) -> int:
    global _LABEL
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="sharded extraction on four cards (and only that)")
    args = ap.parse_args(argv)
    try:
        import jax

        from pointcloudhookup_tpu.utils.cache import setup_compilation_cache

        devices = jax.devices()
        require_gpu(devices)
        card = card_line()
        _LABEL = card
        setup_compilation_cache()
        _count_compiles()
        say(f"card: {card}")
        say(f"jax {jax.__version__} devices: {devices}")
        device = (run_four if args.four else run_single)()
    except Exception as e:  # every failure exits non-zero, with no result
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        import traceback

        traceback.print_exc()
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
