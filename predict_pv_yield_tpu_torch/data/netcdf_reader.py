"""Pieces of the JAX package's ``data/netcdf_reader.py`` that the zarr and
shard paths need (copies): the CF time decode of zarr time axes and the v15
per-source directory names that mark a NetCDF dataset.

The reader of the reference's per-batch NetCDF/HDF5 files itself is not
ported yet (ROADMAP M16b); :class:`~predict_pv_yield_tpu_torch.data.loader.NetCDFDataModule`
raises ``NotImplementedError`` for a NetCDF directory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

#: CF time-unit resolutions → nanoseconds (xarray writes one of these)
_CF_UNITS_NS = {
    "nanoseconds": 1, "microseconds": 1_000, "milliseconds": 1_000_000,
    "seconds": 1_000_000_000, "minutes": 60 * 1_000_000_000,
    "hours": 3_600 * 1_000_000_000, "days": 86_400 * 1_000_000_000,
}


def _decode_cf_time(values: np.ndarray, units) -> Optional[np.ndarray]:
    """``int64 offsets + "minutes since 2021-01-01 00:00:00"`` → int64 ns
    since epoch (xarray/h5netcdf's default datetime64 encoding).

    Float offsets (xarray's encoding for arrays containing NaT, or
    non-unit-exact times) are ROUNDED, not floored, and NaN maps to the
    int64 NaT sentinel. float64 ns magnitudes exceed 2^53, so sub-µs
    rounding error (≤ ~256 ns) is possible on float-encoded inputs."""
    if isinstance(units, bytes):
        units = units.decode("utf-8", "replace")
    if not isinstance(units, str) or " since " not in units:
        return None
    resolution, epoch_str = units.split(" since ", 1)
    per = _CF_UNITS_NS.get(resolution.strip().lower())
    if per is None:
        return None
    try:
        epoch = np.datetime64(epoch_str.strip().replace(" ", "T"), "ns")
    except ValueError:
        return None
    origin = epoch.astype(np.int64)
    values = np.asarray(values)
    if values.dtype.kind == "f":
        ns = values.astype(np.float64) * per + origin
        nat = np.iinfo(np.int64).min  # datetime64 NaT
        with np.errstate(invalid="ignore"):
            return np.where(np.isnan(values), nat, np.rint(ns)).astype(np.int64)
    return (np.asarray(values, np.int64) * per + origin).astype(np.int64)


#: v15 per-source directory names → (Batch group, {file variable: field})
_V15_SOURCES: Dict[str, Tuple[str, Dict[str, str]]] = {
    "satellite": ("satellite", {"data": "data", "x": "x", "y": "y",
                                "x_osgb": "x", "y_osgb": "y",
                                "x_geostationary": "x", "y_geostationary": "y",
                                "time": "datetime_index"}),
    "hrvsatellite": ("hrvsatellite", {"data": "data", "x": "x", "y": "y",
                                      "x_osgb": "x", "y_osgb": "y"}),
    "nwp": ("nwp", {"data": "data", "time": "target_time",
                    "target_time": "target_time"}),
    "pv": ("pv", {"power_mw": "pv_yield", "pv_yield": "pv_yield", "data": "pv_yield",
                  "pv_system_row_number": "pv_system_row_number",
                  "pv_system_id": "pv_system_id", "id": "pv_system_id"}),
    "gsp": ("gsp", {"power_mw": "gsp_yield", "gsp_yield": "gsp_yield", "data": "gsp_yield",
                    "gsp_id": "gsp_id", "id": "gsp_id",
                    "capacity_mwp": "gsp_capacity", "gsp_capacity": "gsp_capacity",
                    "time": "gsp_datetime_index",
                    "gsp_datetime_index": "gsp_datetime_index"}),
    "sun": ("sun", {"sun_elevation_angle": "sun_elevation_angle",
                    "elevation": "sun_elevation_angle",
                    "sun_azimuth_angle": "sun_azimuth_angle",
                    "azimuth": "sun_azimuth_angle"}),
    "topographic": ("topographic", {"data": "topo_data", "topo_data": "topo_data"}),
    "metadata": ("metadata", {"t0_datetime_utc": "t0_datetime_utc",
                              "t0_dt": "t0_datetime_utc"}),
}
