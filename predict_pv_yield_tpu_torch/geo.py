"""OSGB36 National Grid conversions and a coarse coastline of Great Britain
(a copy of the JAX package's ``geo.py``).

* :func:`osgb_from_latlon` / :func:`latlon_from_osgb` — WGS84 ↔ OSGB36
  National Grid, implemented as the standard 7-parameter Helmert datum
  transform plus the Ordnance Survey's transverse-Mercator projection on the
  Airy 1830 ellipsoid (constants from the OS "A guide to coordinate systems
  in Great Britain"). Accuracy a few metres — far below a satellite pixel.
* :func:`gb_coastline_osgb` — a hand-digitised outline of Great Britain in
  OSGB metres, the offline basemap of the validation plots.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# Airy 1830 (OSGB36) and GRS80/WGS84 ellipsoids
_AIRY_A, _AIRY_B = 6377563.396, 6356256.909
_WGS_A, _WGS_B = 6378137.000, 6356752.3141

# National Grid projection constants
_F0 = 0.9996012717
_LAT0, _LON0 = math.radians(49.0), math.radians(-2.0)
_E0, _N0 = 400000.0, -100000.0

# Helmert WGS84 -> OSGB36 (OS guide table; arcsec rotations, ppm scale)
_HELMERT = dict(
    tx=-446.448, ty=125.157, tz=-542.060,
    rx=-0.1502, ry=-0.2470, rz=-0.8421, s=20.4894,
)


def _latlon_to_cartesian(lat, lon, a, b):
    e2 = 1 - (b * b) / (a * a)
    nu = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = nu * np.cos(lat) * np.cos(lon)
    y = nu * np.cos(lat) * np.sin(lon)
    z = (1 - e2) * nu * np.sin(lat)
    return x, y, z


def _cartesian_to_latlon(x, y, z, a, b):
    e2 = 1 - (b * b) / (a * a)
    p = np.sqrt(x * x + y * y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(5):  # converges in 2-3 iterations
        nu = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        lat = np.arctan2(z + e2 * nu * np.sin(lat), p)
    lon = np.arctan2(y, x)
    return lat, lon


def _helmert(x, y, z, sign: float):
    t = _HELMERT
    s = 1 + sign * t["s"] * 1e-6
    rx = sign * math.radians(t["rx"] / 3600.0)
    ry = sign * math.radians(t["ry"] / 3600.0)
    rz = sign * math.radians(t["rz"] / 3600.0)
    x2 = sign * t["tx"] + s * x - rz * y + ry * z
    y2 = sign * t["ty"] + rz * x + s * y - rx * z
    z2 = sign * t["tz"] - ry * x + rx * y + s * z
    return x2, y2, z2


def _tm_project(lat, lon):
    """OSGB36 lat/lon (radians) → easting/northing (OS TM formulas)."""
    a, b = _AIRY_A * _F0, _AIRY_B * _F0
    e2 = 1 - (b * b) / (a * a)
    n = (a - b) / (a + b)
    sin_lat, cos_lat, tan_lat = np.sin(lat), np.cos(lat), np.tan(lat)
    nu = a / np.sqrt(1 - e2 * sin_lat**2)
    rho = a * (1 - e2) / (1 - e2 * sin_lat**2) ** 1.5
    eta2 = nu / rho - 1

    dlat, plat = lat - _LAT0, lat + _LAT0
    m = b * (
        (1 + n + 1.25 * n**2 + 1.25 * n**3) * dlat
        - (3 * n + 3 * n**2 + 21 / 8 * n**3) * np.sin(dlat) * np.cos(plat)
        + (15 / 8 * (n**2 + n**3)) * np.sin(2 * dlat) * np.cos(2 * plat)
        - (35 / 24 * n**3) * np.sin(3 * dlat) * np.cos(3 * plat)
    )
    i = m + _N0
    ii = nu / 2 * sin_lat * cos_lat
    iii = nu / 24 * sin_lat * cos_lat**3 * (5 - tan_lat**2 + 9 * eta2)
    iiia = nu / 720 * sin_lat * cos_lat**5 * (61 - 58 * tan_lat**2 + tan_lat**4)
    iv = nu * cos_lat
    v = nu / 6 * cos_lat**3 * (nu / rho - tan_lat**2)
    vi = nu / 120 * cos_lat**5 * (
        5 - 18 * tan_lat**2 + tan_lat**4 + 14 * eta2 - 58 * tan_lat**2 * eta2
    )
    dlon = lon - _LON0
    northing = i + ii * dlon**2 + iii * dlon**4 + iiia * dlon**6
    easting = _E0 + iv * dlon + v * dlon**3 + vi * dlon**5
    return easting, northing


def _tm_unproject(easting, northing):
    """easting/northing → OSGB36 lat/lon (radians)."""
    a, b = _AIRY_A * _F0, _AIRY_B * _F0
    e2 = 1 - (b * b) / (a * a)
    n = (a - b) / (a + b)

    easting = np.asarray(easting, np.float64)
    northing = np.asarray(northing, np.float64)
    lat = np.full_like(northing, _LAT0, dtype=np.float64)
    m = np.zeros_like(northing, dtype=np.float64)
    for _ in range(10):
        lat = (northing - _N0 - m) / a + lat
        dlat, plat = lat - _LAT0, lat + _LAT0
        m = b * (
            (1 + n + 1.25 * n**2 + 1.25 * n**3) * dlat
            - (3 * n + 3 * n**2 + 21 / 8 * n**3) * np.sin(dlat) * np.cos(plat)
            + (15 / 8 * (n**2 + n**3)) * np.sin(2 * dlat) * np.cos(2 * plat)
            - (35 / 24 * n**3) * np.sin(3 * dlat) * np.cos(3 * plat)
        )
        if np.max(np.abs(northing - _N0 - m)) < 1e-5:
            break

    sin_lat, cos_lat, tan_lat = np.sin(lat), np.cos(lat), np.tan(lat)
    nu = a / np.sqrt(1 - e2 * sin_lat**2)
    rho = a * (1 - e2) / (1 - e2 * sin_lat**2) ** 1.5
    eta2 = nu / rho - 1
    vii = tan_lat / (2 * rho * nu)
    viii = tan_lat / (24 * rho * nu**3) * (5 + 3 * tan_lat**2 + eta2 - 9 * tan_lat**2 * eta2)
    ix = tan_lat / (720 * rho * nu**5) * (61 + 90 * tan_lat**2 + 45 * tan_lat**4)
    x = 1 / (cos_lat * nu)
    xi = 1 / (cos_lat * 6 * nu**3) * (nu / rho + 2 * tan_lat**2)
    xii = 1 / (cos_lat * 120 * nu**5) * (5 + 28 * tan_lat**2 + 24 * tan_lat**4)
    de = easting - _E0
    lat_out = lat - vii * de**2 + viii * de**4 - ix * de**6
    lon_out = _LON0 + x * de - xi * de**3 + xii * de**5
    return lat_out, lon_out


def osgb_from_latlon(lat, lon) -> Tuple[np.ndarray, np.ndarray]:
    """WGS84 degrees → OSGB36 National Grid (easting, northing) metres."""
    lat = np.radians(np.asarray(lat, np.float64))
    lon = np.radians(np.asarray(lon, np.float64))
    x, y, z = _latlon_to_cartesian(lat, lon, _WGS_A, _WGS_B)
    x, y, z = _helmert(x, y, z, +1.0)
    lat36, lon36 = _cartesian_to_latlon(x, y, z, _AIRY_A, _AIRY_B)
    return _tm_project(lat36, lon36)


def latlon_from_osgb(easting, northing) -> Tuple[np.ndarray, np.ndarray]:
    """OSGB36 National Grid metres → WGS84 degrees (lat, lon)."""
    lat36, lon36 = _tm_unproject(easting, northing)
    x, y, z = _latlon_to_cartesian(lat36, lon36, _AIRY_A, _AIRY_B)
    x, y, z = _helmert(x, y, z, -1.0)
    lat, lon = _cartesian_to_latlon(x, y, z, _WGS_A, _WGS_B)
    return np.degrees(lat), np.degrees(lon)


#: Coarse Great Britain outline (WGS84 lat, lon) — offline basemap layer.
#: Hand-digitised at ~30 km fidelity; orientation only, not navigation.
GB_COASTLINE_LATLON = np.array([
    (50.07, -5.70), (50.05, -5.20), (50.22, -4.80), (50.33, -4.20),
    (50.37, -3.55), (50.61, -3.40), (50.72, -3.05), (50.60, -2.45),
    (50.58, -1.95), (50.73, -1.70), (50.78, -1.10), (50.73, -0.75),
    (50.80, -0.20), (50.85, 0.30), (51.13, 1.35), (51.37, 1.45),
    (51.45, 0.90), (51.48, 0.55), (51.53, 0.70), (51.72, 0.95),
    (51.78, 1.15), (51.95, 1.30), (52.08, 1.60), (52.45, 1.73),
    (52.93, 1.30), (52.97, 0.65), (52.87, 0.20), (53.05, 0.30),
    (53.35, 0.15), (53.60, 0.05), (53.63, -0.25), (53.70, -0.55),
    (53.63, -0.10), (54.05, -0.20), (54.15, -0.40), (54.50, -0.60),
    (54.65, -1.10), (54.95, -1.45), (55.40, -1.60), (55.80, -2.00),
    (56.00, -2.60), (56.05, -3.30), (56.10, -2.85), (56.45, -2.70),
    (56.70, -2.45), (57.10, -2.05), (57.50, -1.80), (57.70, -2.10),
    (57.68, -3.10), (57.60, -4.00), (57.85, -3.90), (58.20, -3.40),
    (58.60, -3.10), (58.62, -4.50), (58.50, -5.10), (58.25, -5.25),
    (57.95, -5.35), (57.85, -5.70), (57.55, -5.80), (57.35, -5.65),
    (57.25, -5.75), (56.95, -5.80), (56.75, -6.00), (56.65, -5.90),
    (56.50, -5.60), (56.35, -5.45), (56.10, -5.60), (55.90, -5.65),
    (55.30, -5.50), (55.00, -5.15), (54.85, -4.95), (54.70, -4.90),
    (54.85, -4.35), (54.65, -3.95), (54.50, -3.60), (54.20, -3.25),
    (54.05, -2.90), (53.95, -3.05), (53.75, -3.05), (53.55, -3.10),
    (53.35, -3.35), (53.30, -3.85), (53.30, -4.55), (53.10, -4.35),
    (52.90, -4.75), (52.80, -4.15), (52.55, -4.05), (52.30, -4.10),
    (52.10, -4.45), (51.95, -5.20), (51.70, -5.10), (51.60, -4.90),
    (51.55, -4.20), (51.70, -4.00), (51.60, -3.60), (51.50, -3.20),
    (51.45, -2.90), (51.60, -2.60), (51.45, -2.95), (51.20, -3.45),
    (51.20, -4.20), (51.05, -4.55), (50.70, -4.60), (50.35, -5.15),
    (50.07, -5.70),
])


def gb_coastline_osgb() -> Tuple[np.ndarray, np.ndarray]:
    """The coastline as OSGB (easting, northing) arrays, computed on demand."""
    lat = GB_COASTLINE_LATLON[:, 0]
    lon = GB_COASTLINE_LATLON[:, 1]
    return osgb_from_latlon(lat, lon)
