"""Geodesy ops: CGCS2000 Gauss-Krüger <-> WGS84, haversine, geoid lookup.

The reference delegates to PROJ: ``Transformer.from_crs("EPSG:4547",
"EPSG:4326")`` (/root/reference/utils/table_match_gim.py:232) and
``+proj=vgridshift +grids=egm08_25.gtx`` for ellipsoid->orthometric
heights (/root/reference/utils/elevation_converter.py:29-31).  Here both
are closed-form and array-native so they run batched on device:

  * Transverse Mercator via Karney (2011) Krüger series to n^6 — sub-mm
    agreement with PROJ in f64.  Every function takes an ``xp`` module:
    pass ``numpy`` for host f64 precision (tower tables) or ``jax.numpy``
    for device-batched f32 (bulk point transforms, ~5 cm at CGCS2000
    eastings — far inside the 50 m matching threshold).
  * EPSG:4547 = CGCS2000 / 3-degree Gauss-Kruger CM 114E (false easting
    500 000 m, k0 = 1).
  * Geoid undulation via bilinear interpolation over a regular grid
    (replaces PROJ vgridshift; grids loaded by io/geoid.py).
  * Haversine with R = 6371 km to match the reference's matcher
    (/root/reference/utils/table_match_gim.py:17-34).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax.numpy as jnp
import numpy as np

# CGCS2000 ellipsoid (identical to WGS84 semi-major; flattening differs in
# the 10th significant digit — PROJ also treats the datum shift as null).
A_CGCS2000 = 6378137.0
F_CGCS2000 = 1.0 / 298.257222101

_EARTH_R_M = 6371.0 * 1000.0  # reference haversine radius


@dataclasses.dataclass(frozen=True)
class TMProjection:
    """A transverse-Mercator projection definition."""

    lon0_deg: float = 114.0  # EPSG:4547 central meridian
    k0: float = 1.0
    false_easting: float = 500_000.0
    false_northing: float = 0.0
    a: float = A_CGCS2000
    f: float = F_CGCS2000


EPSG_4547 = TMProjection()


def _series_coeffs(f: float):
    """Karney (2011) alpha/beta series coefficients in n = f/(2-f)."""
    n = f / (2.0 - f)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    rect_a = (1.0 + n2 / 4 + n4 / 64 + n6 / 256) / (1.0 + n)
    alpha = (
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630 - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    )
    beta = (
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512 + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    )
    return rect_a, alpha, beta


def tm_forward(lon_deg, lat_deg, proj: TMProjection = EPSG_4547, xp: Any = jnp):
    """Geographic (deg) -> projected (easting, northing) in meters."""
    rect_a, alpha, _ = _series_coeffs(proj.f)
    big_a = proj.a * rect_a
    e = math.sqrt(proj.f * (2.0 - proj.f))
    lat = xp.radians(xp.asarray(lat_deg))
    dlon = xp.radians(xp.asarray(lon_deg) - proj.lon0_deg)
    s = xp.sin(lat)
    t = xp.sinh(xp.arctanh(s) - e * xp.arctanh(e * s))
    xi = xp.arctan2(t, xp.cos(dlon))
    eta = xp.arcsinh(xp.sin(dlon) / xp.sqrt(t * t + xp.cos(dlon) ** 2))
    xi_s, eta_s = xi, eta
    for j, aj in enumerate(alpha, start=1):
        xi_s = xi_s + aj * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_s = eta_s + aj * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
    easting = proj.false_easting + proj.k0 * big_a * eta_s
    northing = proj.false_northing + proj.k0 * big_a * xi_s
    return easting, northing


def tm_inverse(easting, northing, proj: TMProjection = EPSG_4547, xp: Any = jnp, newton_iters: int = 5):
    """Projected (m) -> geographic (lon_deg, lat_deg)."""
    rect_a, _, beta = _series_coeffs(proj.f)
    big_a = proj.a * rect_a
    e = math.sqrt(proj.f * (2.0 - proj.f))
    e2 = e * e
    xi = (xp.asarray(northing) - proj.false_northing) / (proj.k0 * big_a)
    eta = (xp.asarray(easting) - proj.false_easting) / (proj.k0 * big_a)
    xi_p, eta_p = xi, eta
    for j, bj in enumerate(beta, start=1):
        xi_p = xi_p - bj * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - bj * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
    dlon = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
    tau_p = xp.sin(xi_p) / xp.sqrt(xp.sinh(eta_p) ** 2 + xp.cos(xi_p) ** 2)
    # Newton-solve tau'(tau) = tau*sqrt(1+sigma^2) - sigma*sqrt(1+tau^2)
    tau = tau_p / (1.0 - e2)
    for _ in range(newton_iters):
        sig = xp.sinh(e * xp.arctanh(e * tau / xp.sqrt(1.0 + tau * tau)))
        f_val = tau * xp.sqrt(1.0 + sig * sig) - sig * xp.sqrt(1.0 + tau * tau) - tau_p
        dtau = (xp.sqrt((1.0 + sig * sig) * (1.0 + tau * tau)) - sig * tau) * (
            1.0 - e2
        ) * xp.sqrt(1.0 + tau * tau) / (1.0 + (1.0 - e2) * tau * tau)
        tau = tau - f_val / dtau
    lat = xp.degrees(xp.arctan(tau))
    lon = proj.lon0_deg + xp.degrees(dlon)
    return lon, lat


def cgcs2000_to_wgs84(easting, northing, xp: Any = jnp):
    """EPSG:4547 -> EPSG:4326 lon/lat (degrees); the datum shift is null,
    so this is the inverse TM projection."""
    return tm_inverse(easting, northing, EPSG_4547, xp)


def wgs84_to_cgcs2000(lon_deg, lat_deg, xp: Any = jnp):
    return tm_forward(lon_deg, lat_deg, EPSG_4547, xp)


@dataclasses.dataclass(frozen=True)
class LocalTaylor2D:
    """Second-order local expansion of a smooth R^2 -> R^2 map.

    Raw f32 evaluation of the TM series loses ~10 m at CGCS2000 easting
    magnitudes (~5e5); the fix is to build this expansion
    around a tile reference point in f64 ON HOST (one call), then
    evaluate only origin-relative deltas in f32 ON DEVICE.  Truncation
    error of the quadratic term is < 1e-9 deg over a +-2 km tile; f32
    rounding on the small deltas is ~1e-9 deg (~0.1 mm).
    """

    x0: float
    y0: float
    u0: float  # f64 outputs at the reference point (host-side adds)
    v0: float
    cu: np.ndarray  # f64[5]: du = cu . [dx, dy, dx^2, dx dy, dy^2]
    cv: np.ndarray

    def eval_delta(self, dx, dy, xp: Any = jnp):
        """(dx, dy) -> (du, dv) output deltas relative to (u0, v0)."""
        dx = xp.asarray(dx)
        dy = xp.asarray(dy)
        cu = self.cu if xp is np else jnp.asarray(self.cu, jnp.float32)
        cv = self.cv if xp is np else jnp.asarray(self.cv, jnp.float32)
        terms = [dx, dy, dx * dx, dx * dy, dy * dy]
        du = sum(c * t for c, t in zip(cu, terms))
        dv = sum(c * t for c, t in zip(cv, terms))
        return du, dv

    def __call__(self, x, y, xp: Any = np):
        """Full evaluation (host f64 or device f32 + f64 constants)."""
        du, dv = self.eval_delta(xp.asarray(x) - self.x0, xp.asarray(y) - self.y0, xp)
        return self.u0 + du, self.v0 + dv


def local_taylor(fn, x0: float, y0: float, h: float = 128.0) -> LocalTaylor2D:
    """Build a LocalTaylor2D of fn(x, y) -> (u, v) via f64 central
    differences with step h (meters for projected inputs)."""
    def g(x, y):
        u, v = fn(np.float64(x), np.float64(y))
        return np.array([np.float64(u), np.float64(v)])

    f0 = g(x0, y0)
    fx = (g(x0 + h, y0) - g(x0 - h, y0)) / (2 * h)
    fy = (g(x0, y0 + h) - g(x0, y0 - h)) / (2 * h)
    fxx = (g(x0 + h, y0) - 2 * f0 + g(x0 - h, y0)) / (h * h)
    fyy = (g(x0, y0 + h) - 2 * f0 + g(x0, y0 - h)) / (h * h)
    fxy = (
        g(x0 + h, y0 + h) - g(x0 + h, y0 - h) - g(x0 - h, y0 + h) + g(x0 - h, y0 - h)
    ) / (4 * h * h)
    cu = np.array([fx[0], fy[0], fxx[0] / 2, fxy[0], fyy[0] / 2])
    cv = np.array([fx[1], fy[1], fxx[1] / 2, fxy[1], fyy[1] / 2])
    return LocalTaylor2D(float(x0), float(y0), float(f0[0]), float(f0[1]), cu, cv)


def local_cgcs2000_to_wgs84(e0: float, n0: float, h: float = 128.0) -> LocalTaylor2D:
    """Device-evaluable EPSG:4547 -> lon/lat around a tile origin."""
    return local_taylor(lambda e, n: tm_inverse(e, n, EPSG_4547, np), e0, n0, h)


def haversine_m(lat1, lon1, lat2, lon2, xp: Any = jnp):
    """Great-circle distance (m), R = 6371 km, broadcasting over inputs —
    matches /root/reference/utils/table_match_gim.py:17-34."""
    lat1, lon1, lat2, lon2 = (xp.radians(xp.asarray(v)) for v in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = xp.sin(dlat / 2) ** 2 + xp.cos(lat1) * xp.cos(lat2) * xp.sin(dlon / 2) ** 2
    return _EARTH_R_M * 2.0 * xp.arctan2(xp.sqrt(a), xp.sqrt(1.0 - a))


def haversine_matrix(lats1, lons1, lats2, lons2, xp: Any = jnp):
    """Pairwise distances [len(1), len(2)] in meters."""
    return haversine_m(
        xp.asarray(lats1)[:, None],
        xp.asarray(lons1)[:, None],
        xp.asarray(lats2)[None, :],
        xp.asarray(lons2)[None, :],
        xp,
    )


@dataclasses.dataclass(frozen=True)
class GeoidGrid:
    """Regular lat/lon geoid-undulation grid (row 0 at lat0, increasing)."""

    lat0: float
    lon0: float
    dlat: float
    dlon: float
    values: Any  # f32[nlat, nlon]

    def interp(self, lat_deg, lon_deg, xp: Any = jnp):
        """Bilinear undulation N(lat, lon) in meters (clamped at the lat
        edges).  On GLOBAL grids (nlon*dlon spans ~360 deg) longitude is
        wrapped into the grid window so -180..180 and 0..360 conventions
        both work; on regional grids queries clip in the grid's native
        window (wrapping would map points just west of lon0 to the far
        east edge)."""
        vals = self.values if xp is jnp else np.asarray(self.values)
        nlat, nlon = vals.shape
        fi = (xp.asarray(lat_deg) - self.lat0) / self.dlat
        lon = xp.asarray(lon_deg)
        if nlon * self.dlon >= 360.0 - 1e-6:
            lon = xp.mod(lon - self.lon0, 360.0) + self.lon0
        fj = (lon - self.lon0) / self.dlon
        fi = xp.clip(fi, 0.0, nlat - 1.000001)
        fj = xp.clip(fj, 0.0, nlon - 1.000001)
        i0 = xp.floor(fi).astype(xp.int32)
        j0 = xp.floor(fj).astype(xp.int32)
        wi = fi - i0
        wj = fj - j0
        v00 = vals[i0, j0]
        v01 = vals[i0, j0 + 1]
        v10 = vals[i0 + 1, j0]
        v11 = vals[i0 + 1, j0 + 1]
        return (
            v00 * (1 - wi) * (1 - wj)
            + v01 * (1 - wi) * wj
            + v10 * wi * (1 - wj)
            + v11 * wi * wj
        )


@dataclasses.dataclass(frozen=True)
class GeoidPatch:
    """Gather-free local window of a GeoidGrid.

    Device bilinear interpolation over the full grid costs 4 dynamic
    gathers per point, but a corridor tile spans a handful of 0.25-deg
    cells.
    A K x K window extracted ON HOST evaluates the SAME piecewise-
    bilinear surface as hat-basis forms u(fi)^T W q(fj): two [N, K]
    elementwise basis builds plus one skinny [N,K]x[K,K] matmul, no
    gathers.

    Exact (to f32 summation) vs GeoidGrid.interp for queries INSIDE the
    window; queries outside clamp to the window edge — callers size the
    window to cover their tile (GeoidGrid.window default spans ~4 deg,
    ~440 km).  Duck-typed interp(lat, lon, xp) so every
    ellipsoid_to_orthometric caller can pass a patch instead of the
    grid.  Ref semantics: /root/reference/utils/elevation_converter.py
    :29-44 (PROJ vgridshift lookup of the same grid).
    """

    lat0: float
    lon0: float
    dlat: float
    dlon: float
    values: Any  # f32[K, K] window

    def interp(self, lat_deg, lon_deg, xp: Any = jnp):
        vals = self.values if xp is jnp else np.asarray(self.values)
        k = vals.shape[0]
        fi = (xp.atleast_1d(xp.asarray(lat_deg)) - self.lat0) / self.dlat
        fj = (xp.atleast_1d(xp.asarray(lon_deg)) - self.lon0) / self.dlon
        scalar = xp.asarray(lat_deg).ndim == 0
        fi = xp.clip(fi, 0.0, k - 1.000001)
        fj = xp.clip(fj, 0.0, vals.shape[1] - 1.000001)
        grid_a = xp.arange(k, dtype=xp.float32)
        grid_b = xp.arange(vals.shape[1], dtype=xp.float32)
        # hat (tent) basis: exactly two adjacent nonzeros per row, so
        # u @ W @ q reproduces bilinear interpolation exactly
        u = xp.maximum(0.0, 1.0 - xp.abs(fi[:, None] - grid_a[None, :]))
        q = xp.maximum(0.0, 1.0 - xp.abs(fj[:, None] - grid_b[None, :]))
        if xp is jnp:
            import jax.lax as _lax

            uw = jnp.matmul(u, vals, precision=_lax.Precision.HIGHEST)
        else:
            uw = u @ vals
        out = xp.sum(uw * q, axis=-1)
        return out[0] if scalar else out


def grid_window(grid: GeoidGrid, lat_c: float, lon_c: float,
                half_cells: int = 8) -> GeoidPatch:
    """Extract a (2*half_cells) x (2*half_cells) GeoidPatch centered on
    (lat_c, lon_c), clamped inside the grid (and wrapped in longitude on
    global grids, matching GeoidGrid.interp's convention)."""
    vals = np.asarray(grid.values)
    nlat, nlon = vals.shape
    lon_q = lon_c
    if nlon * grid.dlon >= 360.0 - 1e-6:
        lon_q = (lon_c - grid.lon0) % 360.0 + grid.lon0
    k = 2 * half_cells
    i_c = int(round((lat_c - grid.lat0) / grid.dlat))
    j_c = int(round((lon_q - grid.lon0) / grid.dlon))
    i0 = max(0, min(i_c - half_cells, nlat - k))
    j0 = max(0, min(j_c - half_cells, nlon - k))
    window = vals[i0:i0 + k, j0:j0 + k]
    import jax.numpy as _jnp

    return GeoidPatch(
        lat0=grid.lat0 + i0 * grid.dlat,
        lon0=grid.lon0 + j0 * grid.dlon,
        dlat=grid.dlat,
        dlon=grid.dlon,
        values=_jnp.asarray(window, _jnp.float32),
    )


def ellipsoid_to_orthometric(lat_deg, lon_deg, h_ellip, geoid: GeoidGrid | GeoidPatch | None, region_n_value: float = 25.0, xp: Any = jnp):
    """h_ortho = h_ellip - N.  With no grid, fall back to the regional
    empirical N (ref: utils/elevation_converter.py:50-55, default 25 m)."""
    if geoid is None:
        return xp.asarray(h_ellip) - region_n_value
    return xp.asarray(h_ellip) - geoid.interp(lat_deg, lon_deg, xp)


def greedy_match_arrays(
    g_lat, g_lon, g_h, p_lat, p_lon, p_h,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
    xp: Any = jnp,
):
    """Array form of the reference's greedy first-match loop
    (/root/reference/utils/table_match_gim.py:169-196): for each GIM
    tower, the FIRST point-cloud tower (lowest index) within both the
    haversine and height thresholds; PC towers are not consumed.

    Returns (matched bool[G], first i32[G]) — `first[i]` is meaningful
    only where `matched[i]`.  Jit-friendly (one [G, P] distance matrix +
    a per-row argmax of the first True); this is the device side of the
    ">=10x CPU reference" corridor-matching target (BASELINE.md row 2,
    benchmarks/config_match.py).
    """
    dist = haversine_matrix(g_lat, g_lon, p_lat, p_lon, xp)
    ok = (dist <= distance_threshold) & (
        xp.abs(xp.asarray(g_h)[:, None] - xp.asarray(p_h)[None, :])
        <= height_threshold
    )
    return ok.any(axis=1), xp.argmax(ok, axis=1).astype(xp.int32)
