"""First-party solar-position computation (NOAA low-accuracy algorithm; a
copy of the JAX package's ``sun.py``).

The reference's dataset pipeline fills the BatchML ``sun`` group
(``sun_elevation_angle`` / ``sun_azimuth_angle``, degrees — consumed from
the v15 files at reference ``configs/datamodule/netcdf_datamodule.yaml``
era; computed upstream by ``nowcasting_dataset``'s pvlib sun data source).
pvlib is not in this image, so this module implements the NOAA "General
Solar Position Calculations" equations first-party: vectorized numpy,
~0.1° accuracy over 1900–2100, which is far inside the envelope a PV
nowcast can exploit (the archive's own angles are stored as float32
degrees).

Conventions match pvlib/nowcasting_dataset: elevation in degrees above the
horizon (negative at night), azimuth in degrees clockwise from true north
(0..360). ``refraction=True`` adds NOAA's atmospheric-refraction
correction (pvlib's "apparent" elevation).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi


def _julian_century(datetimes_utc: np.ndarray) -> np.ndarray:
    ns = np.asarray(datetimes_utc, dtype="datetime64[ns]").astype(np.int64)
    days = ns / (86400.0 * 1e9)  # days since unix epoch
    jd = days + 2440587.5
    return (jd - 2451545.0) / 36525.0


def solar_position(
    datetimes_utc,
    latitude_deg,
    longitude_deg,
    refraction: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(elevation°, azimuth°) of the sun, broadcast over inputs.

    ``datetimes_utc``: datetime64 array (UTC). ``latitude_deg`` /
    ``longitude_deg``: degrees, east-positive; broadcast against the time
    axis (scalar site + time vector is the common case).
    """
    jc = _julian_century(datetimes_utc)
    lat = np.asarray(latitude_deg, dtype=np.float64) * _D2R
    lon = np.asarray(longitude_deg, dtype=np.float64)

    # geometric mean longitude / anomaly of the sun (degrees)
    gml = (280.46646 + jc * (36000.76983 + jc * 0.0003032)) % 360.0
    gma = 357.52911 + jc * (35999.05029 - 0.0001537 * jc)
    ecc = 0.016708634 - jc * (0.000042037 + 0.0000001267 * jc)

    gma_r = gma * _D2R
    eq_ctr = (
        np.sin(gma_r) * (1.914602 - jc * (0.004817 + 0.000014 * jc))
        + np.sin(2 * gma_r) * (0.019993 - 0.000101 * jc)
        + np.sin(3 * gma_r) * 0.000289
    )
    true_long = gml + eq_ctr
    omega = (125.04 - 1934.136 * jc) * _D2R
    app_long = true_long - 0.00569 - 0.00478 * np.sin(omega)

    mean_obliq = 23.0 + (
        26.0 + (21.448 - jc * (46.815 + jc * (0.00059 - jc * 0.001813))) / 60.0
    ) / 60.0
    obliq = (mean_obliq + 0.00256 * np.cos(omega)) * _D2R

    declination = np.arcsin(np.sin(obliq) * np.sin(app_long * _D2R))

    var_y = np.tan(obliq / 2.0) ** 2
    gml_r = gml * _D2R
    eq_time = 4.0 * _R2D * (
        var_y * np.sin(2 * gml_r)
        - 2.0 * ecc * np.sin(gma_r)
        + 4.0 * ecc * var_y * np.sin(gma_r) * np.cos(2 * gml_r)
        - 0.5 * var_y * var_y * np.sin(4 * gml_r)
        - 1.25 * ecc * ecc * np.sin(2 * gma_r)
    )  # minutes

    ns = np.asarray(datetimes_utc, dtype="datetime64[ns]").astype(np.int64)
    minutes_utc = (ns / (60.0 * 1e9)) % 1440.0
    true_solar_min = (minutes_utc + eq_time + 4.0 * lon) % 1440.0
    # NOAA writes a <0 branch here, but % 1440 keeps tst in [0, 1440)
    hour_angle = (true_solar_min / 4.0 - 180.0) * _D2R

    cos_zenith = np.sin(lat) * np.sin(declination) + np.cos(lat) * np.cos(
        declination
    ) * np.cos(hour_angle)
    zenith = np.arccos(np.clip(cos_zenith, -1.0, 1.0))
    elevation = 90.0 - zenith * _R2D

    if refraction:
        elevation = elevation + _refraction_correction(elevation)

    # azimuth east-of-north; the arccos form is reflected by hour-angle sign
    sin_zenith = np.sin(zenith)
    with np.errstate(invalid="ignore", divide="ignore"):
        cos_az = (np.sin(lat) * np.cos(zenith) - np.sin(declination)) / (
            np.cos(lat) * sin_zenith
        )
    az_base = np.arccos(np.clip(cos_az, -1.0, 1.0)) * _R2D
    azimuth = np.where(hour_angle > 0.0, (az_base + 180.0) % 360.0,
                       (540.0 - az_base) % 360.0)
    # at the poles / exact zenith the azimuth is undefined; pin to 0
    azimuth = np.where(np.isfinite(azimuth), azimuth, 0.0)
    return elevation, azimuth


def _refraction_correction(elevation_deg: np.ndarray) -> np.ndarray:
    """NOAA atmospheric refraction (degrees to add), piecewise in elevation."""
    e = np.asarray(elevation_deg, dtype=np.float64)
    te = np.tan(np.clip(e, -89.9, 89.9) * _D2R)
    # all three branches evaluate eagerly; the masked-out lanes may divide
    # by zero (te == 0 at the horizon) — silence like the azimuth path does
    with np.errstate(divide="ignore", invalid="ignore"):
        high = 58.1 / te - 0.07 / te**3 + 0.000086 / te**5
        mid = 1735.0 + e * (-518.2 + e * (103.4 + e * (-12.79 + e * 0.711)))
        low = -20.774 / np.tan(np.clip(e, -89.9, 89.9) * _D2R)
    corr = np.where(
        e > 85.0,
        0.0,
        np.where(e > 5.0, high, np.where(e > -0.575, mid, low)),
    )
    return corr / 3600.0


def sun_angles_osgb(datetimes_utc, easting, northing, refraction: bool = False):
    """Solar (elevation°, azimuth°) at an OSGB National Grid location.

    Composes the first-party OSGB36→WGS84 transform (``geo.py``) with
    :func:`solar_position` — the native form of nowcasting_dataset's
    sun-at-example-centre computation.
    """
    from predict_pv_yield_tpu_torch.geo import latlon_from_osgb

    lat, lon = latlon_from_osgb(easting, northing)
    return solar_position(datetimes_utc, lat, lon, refraction=refraction)
