"""v15 prepared-batch NetCDF writer (h5netcdf-faithful HDF5): a port of the
JAX package's ``data/netcdf_writer.py`` that writes the same files from a
Batch of tensors or arrays.

The reference's training data is directories of per-source per-batch
``{batch_idx:06d}.nc`` files written by the external ``nowcasting_dataset``
pipeline through xarray's h5netcdf engine (consumed at reference
``data/dataloader.py:97-115``; per-source tree documented by its
``configs/datamodule/netcdf_datamodule.yaml`` v15 paths). Without xarray or
h5netcdf, this module reproduces the *byte conventions* those libraries
leave on disk (through ``h5py``, imported where a file is written) — the same conventions
``data/netcdf_reader.py`` must survive against real archives:

* every dimension is an HDF5 **dimension scale**. A dim with coordinate
  values is a *coordinate variable* (dataset named after the dim, holding
  the values, ``CLASS=DIMENSION_SCALE``, ``NAME=<dim>``); a dim without one
  is a phony scale whose ``NAME`` is netCDF4's sentinel string ("This is a
  netCDF dimension but not a netCDF variable...") — readers must not
  mistake it for data;
* data variables carry ``DIMENSION_LIST`` and scales carry
  ``REFERENCE_LIST`` (h5py's ``attach_scale`` maintains both), plus the
  ``_Netcdf4Dimid`` ordinal netCDF4 adds;
* the root carries ``_NCProperties``;
* datetimes are CF-encoded: int64 offsets + ``units = "<resolution> since
  <epoch>"`` + ``calendar = "proleptic_gregorian"`` (xarray's default
  datetime64 encoding), NOT raw nanosecond integers.

``write_v15_batch`` maps a Batch pytree back onto the on-disk field names
and layouts (satellite stored **channel-last** ``(example, time, y, x,
channel)``; pv/gsp store RAW ``power_mw`` megawatts next to
``capacity_mwp`` — normalisation to [0, 1] yield is the *reader's* job, as
in the reference dataloader). Used by ``python -m
predict_pv_yield_tpu_torch.prepare --format netcdf`` and by the reader's
tests.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from predict_pv_yield_tpu_torch.data.netcdf_reader import netcdf_filename

#: mimics a real h5netcdf-written file's root attribute
_NC_PROPERTIES = "version=2,h5netcdf=0.11.0,hdf5=1.12.1,h5py=3.6.0"

#: netCDF4's sentinel NAME for a dimension with no coordinate variable
PHONY_DIM_NAME = (
    "This is a netCDF dimension but not a netCDF variable.{:10d}"
)

#: coarsest-first, like xarray's datetime64 encoder
_NS = (
    ("days", 86_400_000_000_000),
    ("hours", 3_600_000_000_000),
    ("minutes", 60_000_000_000),
    ("seconds", 1_000_000_000),
    ("milliseconds", 1_000_000),
    ("microseconds", 1_000),
    ("nanoseconds", 1),
)


def cf_encode_time(values_ns, resolution: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
    """int64 ns-since-epoch → (int64 offsets, CF attrs) the way xarray's
    datetime64 encoder writes them: offset from the first value, at the
    COARSEST unit that represents every value exactly (a fixed unit would
    silently floor finer-grained timestamps). Pass ``resolution`` to pin
    the unit (must divide every value exactly — asserted)."""
    values_ns = np.asarray(values_ns, np.int64)
    if resolution is None:
        for name, per in _NS:
            if values_ns.size == 0 or not np.any(values_ns % per):
                resolution = name
                break
    per = dict(_NS)[resolution]
    if values_ns.size and np.any(values_ns % per):
        # data-integrity guard, not an internal invariant: flooring here
        # would silently corrupt timestamps on disk (so no `assert`, which
        # python -O strips)
        raise ValueError(
            f"{resolution} cannot represent these timestamps exactly"
        )
    origin_ns = int(values_ns.flat[0]) if values_ns.size else 0
    offsets = (values_ns - origin_ns) // per
    epoch = np.datetime64(origin_ns, "ns")
    # epoch printed at its own exact resolution (seconds when possible)
    if origin_ns % 1_000_000_000 == 0:
        epoch = epoch.astype("datetime64[s]")
    epoch_str = str(epoch).replace("T", " ")
    return offsets.astype(np.int64), {
        "units": f"{resolution} since {epoch_str}",
        "calendar": "proleptic_gregorian",
    }


def write_netcdf_variables(
    path: str,
    variables: Mapping[str, tuple],
    global_attrs: Optional[Mapping] = None,
) -> None:
    """Write ``{name: (dims, values[, attrs])}`` as an h5netcdf-convention
    netCDF4/HDF5 file (see module docstring for the conventions)."""
    import h5py

    normalised: Dict[str, Tuple[Tuple[str, ...], np.ndarray, Dict]] = {}
    for name, spec in variables.items():
        dims, values = spec[0], np.asarray(spec[1])
        attrs = dict(spec[2]) if len(spec) > 2 else {}
        if values.dtype.kind == "M":  # datetime64 → CF encoding
            values, time_attrs = cf_encode_time(
                values.astype("datetime64[ns]").astype(np.int64)
            )
            attrs = {**time_attrs, **attrs}
        if values.dtype.kind == "U":  # HDF5 has no UTF-32: store as bytes
            values = values.astype("S")
        normalised[name] = (tuple(dims), values, attrs)

    dim_sizes: Dict[str, int] = {}
    for name, (dims, values, _) in normalised.items():
        if len(dims) != values.ndim:
            # zip() truncation would silently mislabel axes and corrupt the
            # dimension scales — fail with the variable name
            raise ValueError(
                f"{name}: {len(dims)} dims {dims} for a "
                f"{values.ndim}-d array {values.shape}"
            )
        for dim, size in zip(dims, values.shape):
            known = dim_sizes.setdefault(dim, size)
            if known != size:
                raise ValueError(
                    f"{name}: dimension {dim!r} has size {size} but another "
                    f"variable already set it to {known}"
                )

    with h5py.File(path, "w") as fh:
        fh.attrs["_NCProperties"] = np.bytes_(_NC_PROPERTIES)
        for key, value in (global_attrs or {}).items():
            fh.attrs[key] = value

        scales = {}
        for dimid, (dim, size) in enumerate(dim_sizes.items()):
            if dim in normalised:  # coordinate variable
                _, values, attrs = normalised[dim]
                scale = fh.create_dataset(dim, data=values)
                scale.make_scale(dim)
                for key, value in attrs.items():
                    scale.attrs[key] = value
            else:  # phony dimension: empty float dataset + sentinel NAME
                scale = fh.create_dataset(
                    dim, shape=(size,), dtype=np.float32, fillvalue=np.nan
                )
                scale.make_scale(PHONY_DIM_NAME.format(size))
            scale.attrs["_Netcdf4Dimid"] = np.int32(dimid)
            scales[dim] = scale

        for name, (dims, values, attrs) in normalised.items():
            if name in scales:
                continue  # coordinate variables are already on disk
            dataset = fh.create_dataset(name, data=values)
            for axis, dim in enumerate(dims):
                dataset.dims[axis].attach_scale(scales[dim])
            for key, value in attrs.items():
                dataset.attrs[key] = value


def _np(array) -> Optional[np.ndarray]:
    if array is None:
        return None
    if hasattr(array, "detach"):  # a torch tensor
        return array.detach().cpu().numpy()
    return np.asarray(array)


def write_v15_batch(
    root: str,
    batch_idx: int,
    batch,
    pv_capacity_mw: float = 10.0,
    gsp_capacity_mw: float = 50.0,
) -> None:
    """Batch pytree → ``<root>/<source>/{batch_idx:06d}.nc`` per-source files
    in the published v15 layout. Only groups present in the batch are
    written. Satellite/NWP imagery keeps its dtype (int16 wire supported)."""
    filename = netcdf_filename(batch_idx)

    def emit(source: str, variables: Dict[str, tuple]) -> None:
        directory = os.path.join(root, source)
        os.makedirs(directory, exist_ok=True)
        write_netcdf_variables(os.path.join(directory, filename), variables)

    sat = batch.satellite
    if sat is not None and sat.data is not None:
        data = _np(sat.data).transpose(0, 2, 3, 4, 1)  # → channel-LAST
        variables: Dict[str, tuple] = {
            "data": (("example", "time_index", "y_geostationary_index",
                      "x_geostationary_index", "channels_index"), data),
        }
        if sat.x is not None:
            variables["x_osgb"] = (
                ("example", "x_geostationary_index"), _np(sat.x)
            )
        if sat.y is not None:
            variables["y_osgb"] = (
                ("example", "y_geostationary_index"), _np(sat.y)
            )
        if sat.datetime_index is not None:
            offsets, attrs = cf_encode_time(_np(sat.datetime_index))
            variables["time"] = (("example", "time_index"), offsets, attrs)
        emit("satellite", variables)

    nwp = batch.nwp
    if nwp is not None and nwp.data is not None:
        variables = {
            "data": (("example", "channels_index", "time_index",
                      "y_osgb_index", "x_osgb_index"), _np(nwp.data)),
        }
        if nwp.target_time is not None:
            offsets, attrs = cf_encode_time(_np(nwp.target_time))
            variables["target_time"] = (("example", "time_index"), offsets, attrs)
        emit("nwp", variables)

    pv = batch.pv
    if pv is not None and pv.pv_yield is not None:
        capacity = np.full(_np(pv.pv_yield).shape[::2], pv_capacity_mw, np.float32)
        variables = {
            # raw megawatts on disk; [0,1] yield is the reader's job
            "power_mw": (("example", "time_index", "id_index"),
                         _np(pv.pv_yield) * pv_capacity_mw),
            "capacity_mwp": (("example", "id_index"), capacity),
        }
        if pv.pv_system_row_number is not None:
            variables["pv_system_row_number"] = (
                ("example", "id_index"), _np(pv.pv_system_row_number)
            )
        if pv.pv_system_id is not None:
            variables["id"] = (("example", "id_index"), _np(pv.pv_system_id))
        emit("pv", variables)

    gsp = batch.gsp
    if gsp is not None and gsp.gsp_yield is not None:
        capacity = _np(gsp.gsp_capacity)
        if capacity is None:
            capacity = np.full(
                _np(gsp.gsp_yield).shape, gsp_capacity_mw, np.float32
            )
        variables = {
            "power_mw": (("example", "time_index", "id_index"),
                         _np(gsp.gsp_yield) * capacity),
            "capacity_mwp": (("example", "time_index", "id_index"), capacity),
        }
        if gsp.gsp_id is not None:
            variables["id"] = (("example", "id_index"), _np(gsp.gsp_id))
        if gsp.gsp_datetime_index is not None:
            offsets, attrs = cf_encode_time(_np(gsp.gsp_datetime_index))
            variables["time"] = (("example", "time_index"), offsets, attrs)
        emit("gsp", variables)

    sun = batch.sun
    if sun is not None:
        sun_variables = {}
        if sun.sun_elevation_angle is not None:
            sun_variables["elevation"] = (
                ("example", "time_index"), _np(sun.sun_elevation_angle)
            )
        if sun.sun_azimuth_angle is not None:
            sun_variables["azimuth"] = (
                ("example", "time_index"), _np(sun.sun_azimuth_angle)
            )
        if sun_variables:
            emit("sun", sun_variables)

    topo = batch.topographic
    if topo is not None and topo.topo_data is not None:
        emit("topographic", {
            "data": (("example", "y_index", "x_index"), _np(topo.topo_data)),
        })

    hrv = batch.hrvsatellite
    if hrv is not None and hrv.data is not None:
        emit("hrvsatellite", {
            "data": (("example", "time_index", "y_index", "x_index",
                      "channels_index"),
                     _np(hrv.data).transpose(0, 2, 3, 4, 1)),
        })

    metadata = batch.metadata
    if metadata is not None and metadata.t0_datetime_utc is not None:
        offsets, attrs = cf_encode_time(_np(metadata.t0_datetime_utc))
        emit("metadata", {
            "t0_datetime_utc": (("example",), offsets, attrs),
        })
