import math

import numpy as np
import jax.numpy as jnp

from pointcloudhookup_tpu.ops.geo import (
    GeoidGrid,
    cgcs2000_to_wgs84,
    ellipsoid_to_orthometric,
    haversine_m,
    haversine_matrix,
    tm_forward,
    tm_inverse,
    wgs84_to_cgcs2000,
)


def test_tm_roundtrip_f64_submm():
    # Corridor-scale coordinates around the EPSG:4547 zone (CM 114E).
    lons = np.array([112.9, 113.5, 114.0, 114.7, 115.4])
    lats = np.array([26.0, 28.2, 30.0, 32.5, 34.9])
    e, n = tm_forward(lons, lats, xp=np)
    lon2, lat2 = tm_inverse(e, n, xp=np)
    np.testing.assert_allclose(lon2, lons, atol=1e-9)  # ~0.1 mm
    np.testing.assert_allclose(lat2, lats, atol=1e-9)


def test_tm_known_values():
    # On the central meridian, easting = false easting and northing =
    # the ellipsoidal meridian arc length (independent numeric oracle).
    e, n = tm_forward(114.0, 0.0, xp=np)
    assert abs(e - 500000.0) < 1e-6
    assert abs(n - 0.0) < 1e-6

    # Meridian arc to lat 30 deg via direct numerical integration.
    from scipy.integrate import quad

    a, f = 6378137.0, 1 / 298.257222101
    e2 = f * (2 - f)

    def integrand(phi):
        return a * (1 - e2) / (1 - e2 * math.sin(phi) ** 2) ** 1.5

    arc, _ = quad(integrand, 0, math.radians(30.0), epsabs=1e-10)
    _, n30 = tm_forward(114.0, 30.0, xp=np)
    assert abs(n30 - arc) < 1e-3  # mm agreement

    # Scale behavior off-axis: for small dlon, E-FE ~ dlon * cos(lat) * a-ish.
    e1, _ = tm_forward(115.0, 30.0, xp=np)
    approx = math.radians(1.0) * math.cos(math.radians(30.0)) * 6378137.0
    assert abs((e1 - 500000.0) - approx) / approx < 2e-3


def test_tm_f32_device_sanity():
    # The raw f32 device path quantizes at the magnitude of the easting/
    # northing (plus backend transcendental error); it is only a sanity
    # path — precision work on device goes through LocalTaylor2D (below).
    lons = jnp.asarray([113.2, 114.6], jnp.float32)
    lats = jnp.asarray([28.0, 29.5], jnp.float32)
    e32, n32 = tm_forward(lons, lats, xp=jnp)
    e64, n64 = tm_forward(np.asarray(lons, np.float64), np.asarray(lats, np.float64), xp=np)
    assert np.max(np.abs(np.asarray(e32, np.float64) - e64)) < 500.0
    assert np.max(np.abs(np.asarray(n32, np.float64) - n64)) < 500.0


def test_local_taylor_inverse_submm_on_device():
    # The device precision path: f64 Taylor build on host, f32 delta
    # evaluation on device -> sub-mm agreement with the f64 inverse over
    # a +-2 km tile.
    from pointcloudhookup_tpu.ops.geo import local_cgcs2000_to_wgs84

    e0, n0 = tm_forward(113.7, 28.3, xp=np)
    lt = local_cgcs2000_to_wgs84(float(e0), float(n0))
    rng = np.random.default_rng(0)
    de = rng.uniform(-2000, 2000, 64)
    dn = rng.uniform(-2000, 2000, 64)
    # device path (f32 deltas)
    dlon32, dlat32 = lt.eval_delta(
        jnp.asarray(de, jnp.float32), jnp.asarray(dn, jnp.float32), jnp
    )
    lon_dev = lt.u0 + np.asarray(dlon32, np.float64)
    lat_dev = lt.v0 + np.asarray(dlat32, np.float64)
    lon_ref, lat_ref = tm_inverse(e0 + de, n0 + dn, xp=np)
    # 1e-8 deg ~ 1 mm
    np.testing.assert_allclose(lon_dev, lon_ref, atol=2e-8)
    np.testing.assert_allclose(lat_dev, lat_ref, atol=2e-8)


def test_wgs84_cgcs2000_aliases():
    e, n = wgs84_to_cgcs2000(113.9, 28.2, xp=np)
    lon, lat = cgcs2000_to_wgs84(e, n, xp=np)
    assert abs(lon - 113.9) < 1e-9 and abs(lat - 28.2) < 1e-9


def test_haversine_reference_formula():
    # Mirror the reference's scalar implementation exactly.
    def ref(lat1, lon1, lat2, lon2):
        R = 6371.0
        lat1, lon1, lat2, lon2 = map(math.radians, [lat1, lon1, lat2, lon2])
        dlat, dlon = lat2 - lat1, lon2 - lon1
        a = math.sin(dlat / 2) ** 2 + math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2
        return R * 2 * math.atan2(math.sqrt(a), math.sqrt(1 - a)) * 1000

    got = float(haversine_m(28.0, 113.0, 28.0004, 113.0004, xp=np))
    want = ref(28.0, 113.0, 28.0004, 113.0004)
    assert abs(got - want) < 1e-6

    m = np.asarray(
        haversine_matrix([28.0, 28.1], [113.0, 113.1], [28.0, 28.05, 28.2], [113.0, 113.0, 113.3], xp=np)
    )
    assert m.shape == (2, 3)
    assert abs(m[0, 0]) < 1e-9
    assert abs(m[0, 1] - ref(28.0, 113.0, 28.05, 113.0)) < 1e-6


def test_geoid_interp_and_fallback():
    lat = np.linspace(20, 40, 21)
    lon = np.linspace(100, 120, 21)
    # N = planar function -> bilinear interp is exact
    vals = (0.5 * lat[:, None] + 0.25 * lon[None, :]).astype(np.float32)
    grid = GeoidGrid(lat0=20.0, lon0=100.0, dlat=1.0, dlon=1.0, values=jnp.asarray(vals))
    n = float(grid.interp(28.37, 113.81))
    assert abs(n - (0.5 * 28.37 + 0.25 * 113.81)) < 1e-3
    h = float(ellipsoid_to_orthometric(28.37, 113.81, 100.0, grid))
    assert abs(h - (100.0 - n)) < 1e-3
    # fallback empirical N (ref default 25 m)
    assert float(ellipsoid_to_orthometric(0, 0, 100.0, None, xp=np)) == 75.0


def test_geoid_regional_grid_clips_west_queries():
    """On a REGIONAL grid, a query just west of lon0 must clip to the
    west edge, not wrap 360 degrees to the east edge."""
    import numpy as np

    vals = np.tile(np.arange(6, dtype=np.float32), (5, 1))  # N == lon index
    grid = GeoidGrid(lat0=20.0, lon0=110.0, dlat=1.0, dlon=1.0, values=jnp.asarray(vals))
    west = float(grid.interp(22.0, 109.0))
    assert abs(west - 0.0) < 1e-5  # west edge, NOT ~5 (east edge)
    # global grid still wraps both conventions
    gvals = np.tile(np.arange(360, dtype=np.float32), (5, 1))
    gglob = GeoidGrid(lat0=-2.0, lon0=0.0, dlat=1.0, dlon=1.0, values=jnp.asarray(gvals))
    assert abs(float(gglob.interp(0.0, -10.0)) - 350.0) < 1e-4


class TestGeoidPatch:
    def _grid(self):
        import jax.numpy as jnp

        from pointcloudhookup_tpu.ops.geo import GeoidGrid

        lat = np.linspace(0, 20, 81)
        lon = np.linspace(100, 130, 121)
        vals = (
            25.0
            + 3.0 * np.sin(lat / 3.0)[:, None] * np.cos(lon / 5.0)[None, :]
        ).astype(np.float32)
        return GeoidGrid(lat0=0.0, lon0=100.0, dlat=0.25, dlon=0.25,
                         values=jnp.asarray(vals))

    def test_patch_matches_grid_inside_window(self):
        from pointcloudhookup_tpu.ops.geo import grid_window

        grid = self._grid()
        patch = grid_window(grid, 10.0, 113.5, half_cells=8)
        rng = np.random.default_rng(0)
        lat = rng.uniform(10.0 - 1.5, 10.0 + 1.5, 500)
        lon = rng.uniform(113.5 - 1.5, 113.5 + 1.5, 500)
        a = np.asarray(grid.interp(lat, lon, np))
        b = np.asarray(patch.interp(lat, lon, np))
        np.testing.assert_allclose(a, b, atol=1e-5)
        # device path agrees too
        import jax.numpy as jnp

        c = np.asarray(patch.interp(jnp.asarray(lat), jnp.asarray(lon)))
        np.testing.assert_allclose(a, c, atol=1e-4)

    def test_patch_scalar_and_edge_clamp(self):
        from pointcloudhookup_tpu.ops.geo import grid_window

        grid = self._grid()
        patch = grid_window(grid, 0.2, 100.2, half_cells=8)  # grid corner
        v = float(patch.interp(0.1, 100.1, np))
        ref = float(grid.interp(0.1, 100.1, np))
        assert abs(v - ref) < 1e-5
        # far outside the window: clamps to the edge, stays finite
        far = float(patch.interp(19.9, 129.9, np))
        assert np.isfinite(far)

    def test_patch_in_elevation_conversion(self):
        from pointcloudhookup_tpu.ops.geo import (
            ellipsoid_to_orthometric,
            grid_window,
        )

        grid = self._grid()
        patch = grid_window(grid, 10.0, 113.5)
        lat = np.array([10.0, 10.1]); lon = np.array([113.4, 113.6])
        h = np.array([100.0, 120.0])
        a = np.asarray(ellipsoid_to_orthometric(lat, lon, h, grid, xp=np))
        b = np.asarray(ellipsoid_to_orthometric(lat, lon, h, patch, xp=np))
        np.testing.assert_allclose(a, b, atol=1e-5)
