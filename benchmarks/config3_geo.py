"""BASELINE config 3: batch CRS + geoid conversion — 10k tower
coordinates through an EGM2008-style 0.25-degree grid + CGCS2000->WGS84.
Prints one JSON line with coords/sec."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from pointcloudhookup_tpu.utils.cache import setup_compilation_cache
    setup_compilation_cache()

    from pointcloudhookup_tpu.ops.geo import (
        GeoidGrid,
        grid_window,
        local_cgcs2000_to_wgs84,
        tm_forward,
    )

    rng = np.random.default_rng(0)
    # production batch size: reproject_las converts 1M-point chunks
    n = 1_000_000
    lat = np.linspace(-90, 90, 721)
    grid = GeoidGrid(
        lat0=-90.0, lon0=-180.0, dlat=0.25, dlon=0.25,
        values=jnp.asarray(
            25.0 + 5.0 * np.sin(np.linspace(0, 20, 721))[:, None]
            * np.cos(np.linspace(0, 40, 1441))[None, :],
            jnp.float32,
        ),
    )
    # gather-free local geoid window (ops/geo.py::GeoidPatch)
    patch = grid_window(grid, 28.2, 113.5)
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2, xp=np))
    lt = local_cgcs2000_to_wgs84(e0, n0)
    de = jnp.asarray(rng.uniform(-2000, 2000, n), jnp.float32)
    dn = jnp.asarray(rng.uniform(-2000, 2000, n), jnp.float32)
    h = jnp.asarray(rng.uniform(50, 150, n), jnp.float32)

    @jax.jit
    def convert(de, dn, h):
        dlon, dlat = lt.eval_delta(de, dn, jnp)
        lon = lt.u0 + dlon
        lat = lt.v0 + dlat
        n_val = patch.interp(lat, lon, jnp)
        return lon, lat, h - n_val

    jax.block_until_ready(convert(de, dn, h))
    times = []
    for _i in range(50):
        t0 = time.perf_counter()
        jax.block_until_ready(convert(de, dn, h))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    print(json.dumps(dict(
        metric="crs_geoid_batch", value=n / dt / 1e6,
        unit="Mcoords/s", n=n, wall_ms=dt * 1e3,
        device=str(jax.devices()[0].device_kind),
    )))


if __name__ == "__main__":
    main()
