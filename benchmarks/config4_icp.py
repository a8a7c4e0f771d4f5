"""BASELINE config 4: GIM<->cloud registration.

Two parts in one JSON line:
  * throughput: batched ICP over a 50-tower corridor batch
    (tower-ICP-iters/s);
  * gim_scenario: the END-TO-END recovery story — synthetic corridor
    with one-sided conductor-stub artifacts (which bias every extracted
    box center) -> extract -> match against a synthetic GIM built from
    the PLANTED truth -> correct(icp=True) aligning pylon frames built
    from the GIM models' 杆塔高 property -> per-tower center error vs
    truth before/after ICP.  This is the scenario BASELINE.json names
    ("align extracted tower clusters to GIM pylon models"); the
    reference's correct() writes the biased box center straight back
    (/root/reference/utils/table_match_gim.py:403-444).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def gim_scenario():
    import tempfile, os
    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor, build_synthetic_gim
    from pointcloudhookup_tpu.models.pipeline import (
        correct, extract_from_points, import_gim,
    )
    from pointcloudhookup_tpu.ops.geo import tm_forward, tm_inverse

    rng = np.random.default_rng(11)
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2, xp=np))
    tower_height = 35.0
    pts, centers = synthetic_corridor(
        rng, n_ground=4000, n_veg=800, pts_per_tower=500,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        tower_height=tower_height, extent=300.0,
        origin=(e0, n0, 80.0),
    )
    # one-sided artifacts: a conductor stub leaving each tower top
    # toward +x — the box center shifts by ~half the stub reach
    stubs = []
    for c in centers:
        s = rng.uniform(0, 1, 120)
        stubs.append(np.column_stack([
            c[0] + 1.0 + s * 7.0,
            c[1] + rng.normal(0, 0.2, 120),
            c[2] + tower_height / 2 - 2.0 - 3.0 * s,
        ]))
    pts = np.vstack([pts] + stubs)

    params = ExtractParams(
        ground=GroundParams(min_points_after=100),
        cluster=ClusterParams(eps=5.0, min_points=30),
        max_clusters=32, obb_angles=128,
    )
    towers, stats, origin = extract_from_points(pts, params, capacity=8192)
    labels = stats["labels"][: len(pts)]
    clouds = [pts[labels == t.label] for t in towers]

    # synthetic GIM from the PLANTED truth, carrying 杆塔高
    gts = []
    for i, c in enumerate(centers):
        lon, lat = (float(v) for v in tm_inverse(c[0], c[1], xp=np))
        gts.append(dict(
            id=f"P{41 + i}", lat=lat, lng=lon, h=float(c[2]) - 25.0, r=0.0,
            props={"杆塔编号": f"P{41 + i}", "杆塔高": f"{tower_height}",
                   "呼高": "24", "Kv值": "220", "转角": "0.0"},
        ))
    tmpd = tempfile.mkdtemp(prefix="cfg4_")
    gim_path = os.path.join(tmpd, "truth.gim")
    build_synthetic_gim(gim_path, gts, workdir=os.path.join(tmpd, "tree"))
    records, _, _ = import_gim(gim_path, output_folder=os.path.join(tmpd, "out"))

    res_icp = correct(records, towers, icp=True, pc_clouds=clouds)
    assert len(res_icp.pairs) == len(centers), res_icp.pairs

    def xy_err(center_xy, truth):
        return float(np.linalg.norm(np.asarray(center_xy) - truth[:2]))

    before, after = [], []
    for gi, pi in res_icp.pairs:
        # gim row -> planted truth by tower id (unique)
        gid = records[gi].get("properties", {}).get("杆塔编号")
        truth = centers[[g["id"] for g in gts].index(gid)]
        t = towers[pi]
        before.append(xy_err(t.center[:2], truth))
        c_icp = res_icp.converted_towers[pi].original_center
        after.append(xy_err(c_icp[:2], truth))
    before = np.array(before)
    after = np.array(after)
    return dict(
        towers=len(before),
        template_source="gim_杆塔高",
        mean_center_error_before_m=round(float(before.mean()), 3),
        mean_center_error_after_m=round(float(after.mean()), 3),
        max_center_error_after_m=round(float(after.max()), 3),
        bias_recovered_frac=round(
            float(1.0 - after.mean() / max(before.mean(), 1e-9)), 3
        ),
    )


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()

    from pointcloudhookup_tpu.ops.registration import batched_icp

    rng = np.random.default_rng(0)
    b, n, iters = 50, 2048, 20
    t_param = rng.uniform(0, 1, (b, n))
    half = 6.0 * (1 - 0.7 * t_param)
    src = np.stack(
        [
            rng.uniform(-1, 1, (b, n)) * half,
            rng.uniform(-1, 1, (b, n)) * half,
            t_param * 35.0,
        ],
        axis=-1,
    ).astype(np.float32)
    angles = rng.uniform(-0.15, 0.15, b)
    ts = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    dst = np.empty_like(src)
    for i in range(b):
        c, s = np.cos(angles[i]), np.sin(angles[i])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        dst[i] = src[i] @ rot.T + ts[i]
    mask = np.ones((b, n), bool)

    args = (jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst), jnp.asarray(mask))
    out = jax.block_until_ready(batched_icp(*args, iters=iters))
    times = []
    for _i in range(20):
        t0 = time.perf_counter()
        out = jax.block_until_ready(batched_icp(*args, iters=iters))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    rmse = float(np.asarray(out["rmse"]).mean())
    scenario = gim_scenario()
    print(json.dumps(dict(
        metric="batched_icp", value=round(b * iters / dt, 1),
        unit="tower-ICP-iters/s", towers=b, points_per_tower=n,
        wall_ms=dt * 1e3, mean_rmse=rmse,
        device=str(jax.devices()[0].device_kind),
        gim_scenario=scenario,
    )))


if __name__ == "__main__":
    main()
