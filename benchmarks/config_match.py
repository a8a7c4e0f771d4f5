"""BASELINE target row 2: full-corridor tower matching, device vs CPU
reference — the ">=10x CPU reference" artifact.

CPU reference: a faithful scalar re-implementation of the reference's
matching pipeline (minus its per-pair print statements, which would
unfairly inflate our ratio):
  * per-tower CGCS2000 -> WGS84 conversion + ellipsoid -> orthometric
    with the empirical regional N (the loop at
    /root/reference/utils/table_match_gim.py:37-142, pyproj replaced by
    our own f64 host tm_inverse so both sides share the same math), then
  * the greedy first-match double loop with scalar math.* haversine and
    an early break (/root/reference/utils/table_match_gim.py:169-196).

Device path: bulk LocalTaylor2D conversion + geoid subtraction + one
[G, P] haversine matrix + first-True argmax (ops/geo.py::
greedy_match_arrays), all inside ONE jit, timed to block_until_ready.

Workload: G = P = 10,000 towers on a ~300 m grid; every GIM tower has
exactly one PC tower within 50 m, so the CPU loop's early break fires
after scanning ~j prior towers (the reference's own best case).  The
device result is validated pair-for-pair against the CPU reference
before timing is reported.

Prints one JSON line.
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

G = P = 10_000
DIST_T = 50.0
HEIGHT_T = 100.0
N_VALUE = 25.0


def build_workload(rng):
    """GIM towers (lat/lon/h orthometric) on a grid; PC towers as
    CGCS2000 easting/northing + ellipsoidal h, jittered <=20 m."""
    from pointcloudhookup_tpu.ops.geo import tm_forward, tm_inverse

    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2, xp=np))
    cols = 25
    rows = (G + cols - 1) // cols
    ii = np.arange(G)
    de = (ii % cols) * 300.0 - cols * 150.0
    dn = (ii // cols) * 300.0 - rows * 150.0
    h_ortho = rng.uniform(40.0, 90.0, G)

    # PC towers: same grid order, jittered; ellipsoidal height
    jit = rng.uniform(-20.0, 20.0, (G, 2)) / math.sqrt(2.0)
    pc_e = e0 + de + jit[:, 0]
    pc_n = n0 + dn + jit[:, 1]
    pc_h_ellip = h_ortho + N_VALUE + rng.uniform(-5.0, 5.0, G)

    # GIM side is lat/lon (exact f64 inverse — the "model truth")
    g_lon, g_lat = tm_inverse(e0 + de, n0 + dn, xp=np)
    return (
        np.asarray(g_lat, np.float64),
        np.asarray(g_lon, np.float64),
        np.asarray(h_ortho, np.float64),
        pc_e,
        pc_n,
        pc_h_ellip,
        (e0, n0),
    )


def cpu_reference(g_lat, g_lon, g_h, pc_e, pc_n, pc_h_ellip):
    """Scalar per-tower conversion + greedy first-match double loop —
    the reference algorithm verbatim in shape (loops, early break),
    with our f64 TM inverse standing in for pyproj."""
    from pointcloudhookup_tpu.ops.geo import tm_inverse

    t0 = time.perf_counter()
    converted = []
    for j in range(len(pc_e)):
        lon, lat = tm_inverse(float(pc_e[j]), float(pc_n[j]), xp=np)
        converted.append((float(lon), float(lat), float(pc_h_ellip[j]) - N_VALUE))
    t_convert = time.perf_counter() - t0

    t0 = time.perf_counter()
    R = 6371.0
    pairs = []
    for i in range(len(g_lat)):
        gl, go, gh = float(g_lat[i]), float(g_lon[i]), float(g_h[i])
        for j, (lon, lat, h) in enumerate(converted):
            la1, lo1, la2, lo2 = map(math.radians, (gl, go, lat, lon))
            dlat = la2 - la1
            dlon = lo2 - lo1
            a = (
                math.sin(dlat / 2) ** 2
                + math.cos(la1) * math.cos(la2) * math.sin(dlon / 2) ** 2
            )
            d = R * 2 * math.atan2(math.sqrt(a), math.sqrt(1 - a)) * 1000.0
            if d <= DIST_T and abs(gh - h) <= HEIGHT_T:
                pairs.append((i, j))
                break
    t_match = time.perf_counter() - t0
    return pairs, t_convert, t_match


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()

    from pointcloudhookup_tpu.ops.geo import (
        greedy_match_arrays,
        local_cgcs2000_to_wgs84,
    )

    rng = np.random.default_rng(7)
    g_lat, g_lon, g_h, pc_e, pc_n, pc_h, (e0, n0) = build_workload(rng)

    # ---------------- CPU reference ----------------
    cpu_pairs, t_convert, t_match = cpu_reference(g_lat, g_lon, g_h, pc_e, pc_n, pc_h)
    t_cpu = t_convert + t_match

    # ---------------- device path ----------------
    lt = local_cgcs2000_to_wgs84(e0, n0)
    gl = jnp.asarray(g_lat, jnp.float32)
    go = jnp.asarray(g_lon, jnp.float32)
    gh = jnp.asarray(g_h, jnp.float32)
    de = jnp.asarray(pc_e - e0, jnp.float32)
    dn = jnp.asarray(pc_n - n0, jnp.float32)
    ph = jnp.asarray(pc_h, jnp.float32)

    @jax.jit
    def device_match(de, dn, ph):
        dlon, dlat = lt.eval_delta(de, dn, jnp)
        lon = lt.u0 + dlon
        lat = lt.v0 + dlat
        h = ph - N_VALUE
        return greedy_match_arrays(gl, go, gh, lat, lon, h, DIST_T, HEIGHT_T)

    matched, first = device_match(de, dn, ph)  # compile
    # fetch ONCE, not one device read per pair
    matched_np = np.asarray(matched)
    first_np = np.asarray(first)
    dev_pairs = [
        (int(i), int(first_np[i])) for i in np.nonzero(matched_np)[0]
    ]
    if dev_pairs != cpu_pairs:
        a, b = set(dev_pairs), set(cpu_pairs)
        raise AssertionError(
            f"device pairs != CPU reference pairs: {len(a - b)} extra, "
            f"{len(b - a)} missing of {len(b)}"
        )

    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(device_match(de, dn, ph))
        times.append(time.perf_counter() - t0)
    t_dev = float(np.median(times))

    ratio = t_cpu / t_dev
    result = dict(
        metric="match_speedup_vs_cpu_reference",
        value=ratio,
        unit="x",  # target: >=10x
        towers_gim=G,
        towers_pc=P,
        pairs=len(cpu_pairs),
        cpu_seconds=round(t_cpu, 2),
        cpu_convert_seconds=round(t_convert, 2),
        cpu_match_seconds=round(t_match, 2),
        device_seconds=t_dev,
        device=str(jax.devices()[0].device_kind),
        pairs_validated=True,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
