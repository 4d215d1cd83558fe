"""Reader for the reference's prepared-batch NetCDF files (a port of the
JAX package's ``data/netcdf_reader.py``: the same files give the same
batches, field for field, as CPU tensors).

The reference trains from pre-prepared batch files: one ``{batch_idx:06d}.nc``
per batch, fetched per ``__getitem__`` by the external
``nowcasting_dataloader.datasets.NetCDFDataset`` (reference
``data/dataloader.py:97-115``). Two on-disk layouts existed:

* **v15 per-source directories** — ``<path>/train/<source>/000123.nc`` with
  one file per batch per data source (satellite, hrvsatellite, nwp, pv, gsp,
  sun, topographic, metadata), each an xarray Dataset written through
  h5netcdf (i.e. HDF5 wire format);
* **legacy single files** — ``<path>/train/000123.nc`` holding the v2/v6-era
  flat keys (``sat_data``, ``nwp``, ``pv_yield``, ``pv_system_row_number``,
  coordinate arrays, datetime features), documented by the reference's own
  ``netcdf_dataset.py:84-90``.

Both are handled here, first-party:

* netCDF4 files are HDF5 — read with ``h5py``, imported where an HDF5 file
  is met (a machine without it raises ``ImportError`` naming it), with
  dimension names recovered from HDF5 dimension scales so arrays can be
  transposed into the canonical (B, C, T, H, W) layout regardless of the
  on-disk dim order (nowcasting_dataset writes satellite channel-last);
* netCDF3 "classic" files (magic ``CDF\\x01``/``CDF\\x02``) are parsed by a
  first-party decoder of the classic binary format — no netCDF library is
  needed.

int16 satellite payloads are left undecoded: the decode (−1 → NaN, then
normalisation) runs on the card inside the step (``data/preprocess.py``;
reference ``netcdf_dataset.py:96-101``). Large payloads are memory-mapped
private and copy-on-write, as the raw shards are (``data/shards.py``): the
tensors are writable views that keep their mapping alive.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from predict_pv_yield_tpu_torch.data.batch import Batch

log = logging.getLogger(__name__)

Variable = Tuple[Tuple[str, ...], np.ndarray]  # (dim names, values)


# ---------------------------------------------------------------------------
# file decoding
# ---------------------------------------------------------------------------


def read_netcdf_variables(path: str) -> Dict[str, Variable]:
    """All variables of a NetCDF file as {name: (dims, array)}."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:3] == b"CDF":
        return _read_classic(path)
    if magic == b"\x89HDF":
        return _read_hdf5(path)
    raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")


#: CF time-unit resolutions → nanoseconds (xarray writes one of these)
_CF_UNITS_NS = {
    "nanoseconds": 1, "microseconds": 1_000, "milliseconds": 1_000_000,
    "seconds": 1_000_000_000, "minutes": 60 * 1_000_000_000,
    "hours": 3_600 * 1_000_000_000, "days": 86_400 * 1_000_000_000,
}

_PHONY_DIM_SENTINEL = b"This is a netCDF dimension but not a netCDF variable"


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


def _is_cf_time_units(units) -> bool:
    """Would :func:`_decode_cf_time` decode with these units? Classifier for
    the schema cache: CF time units embed a per-file epoch and must be
    re-read per file; anything else is layout-static. Must agree EXACTLY
    with the decoder (a stricter regex here silently froze later files onto
    the probe file's epoch for e.g. date-only units — a reproduced bug)."""
    return _decode_cf_time(np.zeros(1, np.int64), units) is not None


def _parse_string_datetimes(values: np.ndarray) -> Optional[np.ndarray]:
    """ISO char-array datetimes ("2021-01-01 12:00:00") → int64 ns."""
    try:
        text = np.char.replace(values.astype("U"), " ", "T")
        return text.astype("datetime64[ns]").astype(np.int64)
    except ValueError:
        return None


def _h5py():
    """``h5py``, imported on first need; its absence raises naming it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("reading a netCDF4/HDF5 file needs h5py, which is not installed") from exc
    return h5py


def _mmap_contiguous(path: str, dataset) -> Optional[np.ndarray]:
    """Zero-copy view of a contiguous, uncompressed HDF5 dataset.

    HDF5's library-wide lock serialises ``dataset[...]`` across threads, so
    a threaded loader tops out near one core of h5py throughput no matter
    how many workers it has. The big imagery payloads in prepared-batch
    files are contiguous and uncompressed, so the bytes can be mapped
    straight out of the file like the raw shards — the lock then only
    guards cheap metadata. Returns None (caller falls back to h5py) for
    chunked, filtered, fill-value-only or non-native datasets."""
    if dataset.chunks is not None or dataset.compression is not None:
        return None
    offset = dataset.id.get_offset()
    if offset is None:  # no storage allocated (all fill-value)
        return None
    dtype = dataset.dtype
    if dtype.kind not in "iuf" or dtype.byteorder == ">":
        return None
    return np.memmap(path, dtype=dtype, mode="c", offset=offset,
                     shape=dataset.shape)


def _dim_labels(dataset) -> Tuple[str, ...]:
    """Dimension names of an h5py dataset via attached dimension scales,
    ``phony_{axis}`` where none are recorded. Shared by the direct reader
    and the schema probe — the two MUST classify dims identically or the
    mmap fast path would transpose axes differently from its fallback."""
    dims: List[str] = []
    for axis in range(dataset.ndim):
        label = ""
        try:
            label = dataset.dims[axis].label
            if not label and len(dataset.dims[axis]) > 0:
                label = dataset.dims[axis][0].name.rsplit("/", 1)[-1]
        except Exception:
            pass
        dims.append(label or f"phony_{axis}")
    return tuple(dims)


def _parse_char_values(name: str, values: np.ndarray) -> np.ndarray:
    """Char arrays: time-named variables parse to int64 ns datetimes, the
    rest decode to str (shared by the direct reader and the schema path)."""
    parsed = None
    lowered = name.lower()
    if "time" in lowered or lowered.startswith("t0"):
        parsed = _parse_string_datetimes(values)
    return parsed if parsed is not None else values.astype("U")


def _read_hdf5(path: str) -> Dict[str, Variable]:
    h5py = _h5py()

    out: Dict[str, Variable] = {}
    with h5py.File(path, "r") as fh:
        for name, dataset in fh.items():
            if not isinstance(dataset, h5py.Dataset):
                continue
            # netCDF4 represents a dimension WITHOUT a coordinate variable as
            # an empty dataset whose NAME is a sentinel string — structural,
            # not data (a phony "time" scale must not shadow real values).
            scale_name = dataset.attrs.get("NAME")
            if isinstance(scale_name, bytes) and scale_name.startswith(
                _PHONY_DIM_SENTINEL
            ):
                continue
            dims = _dim_labels(dataset)
            values = None
            if dataset.nbytes >= 1 << 20:  # big payloads: bypass the HDF5 lock
                values = _mmap_contiguous(path, dataset)
            if values is None:
                values = dataset[...]
            if "units" in dataset.attrs:  # CF-encoded datetimes
                decoded = _decode_cf_time(values, dataset.attrs["units"])
                if decoded is not None:
                    values = decoded
            if values.dtype.kind == "S":  # char arrays
                values = _parse_char_values(name, values)
            out[name] = (tuple(dims), values)
    return out


# netCDF3 classic constants
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_NC_TYPES = {
    1: np.dtype(">i1"), 2: np.dtype("S1"), 3: np.dtype(">i2"),
    4: np.dtype(">i4"), 5: np.dtype(">f4"), 6: np.dtype(">f8"),
}


def _read_classic(path: str) -> Dict[str, Variable]:
    """First-party netCDF3 classic-format parser (CDF-1 and CDF-2)."""
    # a writable buffer: the arrays below are views of it and become tensors
    data = bytearray(os.path.getsize(path))
    with open(path, "rb") as fh:
        fh.readinto(data)
    if data[:3] != b"CDF" or data[3] not in (1, 2):
        raise ValueError(f"{path}: not a classic NetCDF file")
    offset_fmt = ">I" if data[3] == 1 else ">Q"
    pos = 4

    def u32() -> int:
        nonlocal pos
        (value,) = struct.unpack_from(">I", data, pos)
        pos += 4
        return value

    def name() -> str:
        nonlocal pos
        n = u32()
        value = data[pos : pos + n].decode()
        pos += (n + 3) & ~3  # pad to 4
        return value

    def read_attributes() -> Dict[str, bytes]:
        """Char-typed attribute values by name (``units`` drives CF time
        decoding — xarray's scipy engine writes classic files with the same
        encoded datetimes as the HDF5 path, and raw minute offsets must not
        masquerade as ns-since-epoch)."""
        nonlocal pos
        attrs: Dict[str, bytes] = {}
        tag, nelems = u32(), u32()
        if tag == 0:  # ABSENT
            return attrs
        for _ in range(nelems):
            attr_name = name()
            nc_type, n = u32(), u32()
            size = n * _NC_TYPES[nc_type].itemsize
            if nc_type == 2:  # NC_CHAR
                attrs[attr_name] = bytes(data[pos : pos + size])
            pos += (size + 3) & ~3
        return attrs

    numrecs = u32()
    dim_tag, n_dims = u32(), u32()
    dims: List[Tuple[str, int]] = []
    if dim_tag == _NC_DIMENSION:
        for _ in range(n_dims):
            dims.append((name(), u32()))
    read_attributes()  # global attributes (unused)

    var_tag, n_vars = u32(), u32()
    out: Dict[str, Variable] = {}
    record_vars = []
    if var_tag == _NC_VARIABLE:
        headers = []
        for _ in range(n_vars):
            var_name = name()
            ndims = u32()
            dimids = [u32() for _ in range(ndims)]
            attrs = read_attributes()
            nc_type = u32()
            u32()  # vsize (includes padding; recomputed below)
            (begin,) = struct.unpack_from(offset_fmt, data, pos)
            pos += struct.calcsize(offset_fmt)
            headers.append((var_name, dimids, nc_type, begin, attrs))
        for var_name, dimids, nc_type, begin, attrs in headers:
            dtype = _NC_TYPES[nc_type]
            dim_names = tuple(dims[i][0] for i in dimids)
            shape = tuple(dims[i][1] for i in dimids)
            if shape and shape[0] == 0:  # record variable
                record_vars.append(
                    (var_name, dim_names, shape, dtype, begin, attrs)
                )
            else:
                count = int(np.prod(shape, dtype=np.int64)) if shape else 1
                values = np.frombuffer(
                    data, dtype, count=count, offset=begin
                ).reshape(shape)
                out[var_name] = (dim_names, _decode_classic(values, attrs))

    if record_vars:
        slab_sizes = []
        for _, _, shape, dtype, _, _ in record_vars:
            per_record = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
            if len(record_vars) > 1:
                per_record = (per_record + 3) & ~3
            slab_sizes.append(per_record)
        record_size = sum(slab_sizes)
        for (var_name, dim_names, shape, dtype, begin, attrs), slab in zip(
            record_vars, slab_sizes
        ):
            count = int(np.prod(shape[1:], dtype=np.int64))
            records = [
                np.frombuffer(
                    data, dtype, count=count, offset=begin + rec * record_size
                )
                for rec in range(numrecs)
            ]
            values = np.stack(records).reshape((numrecs, *shape[1:])) if numrecs \
                else np.empty((0, *shape[1:]), dtype)
            out[var_name] = (dim_names, _decode_classic(values, attrs))
    return out


def _decode_classic(values: np.ndarray, attrs: Dict[str, bytes]) -> np.ndarray:
    values = _native_order(values)
    units = attrs.get("units")
    if units is not None:  # CF-encoded datetimes (same rule as _read_hdf5)
        decoded = _decode_cf_time(values, units)
        if decoded is not None:
            return decoded
    return values


def _native_order(values: np.ndarray) -> np.ndarray:
    if values.dtype.byteorder == ">":
        return values.astype(values.dtype.newbyteorder("="))
    return values


# ---------------------------------------------------------------------------
# dim-name-driven layout normalisation
# ---------------------------------------------------------------------------


def _classify_dim(dim: str, axis: int, ndim: int) -> str:
    d = dim.lower()
    if "example" in d or d == "batch":
        return "b"
    if "channel" in d or "variable" in d:
        return "c"
    if "time" in d or d.startswith("t_") or d == "t":
        return "t"
    if d == "y" or d.startswith("y_") or "_y_" in d or d.endswith("_y"):
        return "y"
    if d == "x" or d.startswith("x_") or "_x_" in d or d.endswith("_x"):
        return "x"
    if "id" in d or "system" in d or "gsp" in d:
        return "n"
    # positional fallback: axis 0 is the batch dim in every prepared file
    return "b" if axis == 0 else "?"


def to_canonical_image(dims: Tuple[str, ...], values: np.ndarray) -> np.ndarray:
    """Reorder an image-like variable to (B, C, T, H, W) — the framework
    layout — from whatever dim order the file used (nowcasting_dataset
    writes satellite as (example, time, y, x, channel))."""
    if values.ndim < 4:
        return values
    kinds = [_classify_dim(d, i, values.ndim) for i, d in enumerate(dims)]
    order = "bctyx" if values.ndim == 5 else "btyx"
    if sorted(kinds) != sorted(order):
        return values  # unknown dims: trust the on-disk order
    perm = [kinds.index(k) for k in order]
    out = values.transpose(perm)
    if perm != sorted(perm):
        # Materialise the strided copy HERE, in the loader worker thread —
        # deferring it leaves a lazy transposed view whose copy then runs on
        # the single training-loop thread at device_put time (measured: the
        # whole b128 pipeline collapsed to ~20 batches/s on that one-thread
        # 100 MB strided copy; doing it in the workers restores scaling).
        out = np.ascontiguousarray(out)
    if values.ndim == 4:
        out = out[:, None]  # add a singleton channel axis
    return out


def canonical_or_deferred(dims: Tuple[str, ...], values: np.ndarray):
    """``(values, channel_last)`` for the satellite wire layout.

    nowcasting_dataset writes satellite channel-LAST (example, time, y, x,
    channel). Instead of transposing on the host — a serial strided copy of
    the whole payload that halved the measured pipeline rate on a small host
    — the mmap view ships as-is and ``channel_last=True`` tells the fused
    on-device preprocess to transpose in HBM (one fused pass, free next to
    the int16 decode). Any OTHER non-canonical layout still goes through
    :func:`to_canonical_image` on the host."""
    if values.ndim == 5:
        kinds = [_classify_dim(d, i, 5) for i, d in enumerate(dims)]
        if kinds == ["b", "t", "y", "x", "c"]:
            return values, True
    return to_canonical_image(dims, values), False


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------

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

#: legacy flat keys (reference netcdf_dataset.py:84-90) → (group, field)
_LEGACY_KEYS: Dict[str, Tuple[str, str]] = {
    "sat_data": ("satellite", "data"),
    "sat_x_coords": ("satellite", "x"),
    "sat_y_coords": ("satellite", "y"),
    "sat_datetime_index": ("satellite", "datetime_index"),
    "sat_time_coords": ("satellite", "datetime_index"),
    "nwp": ("nwp", "data"),
    "nwp_target_time": ("nwp", "target_time"),
    "nwp_time_coords": ("nwp", "target_time"),
    "pv_yield": ("pv", "pv_yield"),
    "pv_system_id": ("pv", "pv_system_id"),
    "pv_system_row_number": ("pv", "pv_system_row_number"),
    "hour_of_day_sin": ("datetime", "hour_of_day_sin"),
    "hour_of_day_cos": ("datetime", "hour_of_day_cos"),
    "day_of_year_sin": ("datetime", "day_of_year_sin"),
    "day_of_year_cos": ("datetime", "day_of_year_cos"),
}

_IMAGE_FIELDS = {("satellite", "data"), ("hrvsatellite", "data"), ("nwp", "data")}


def _datetime_to_int64(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "M":
        return values.astype("datetime64[ns]").astype(np.int64)
    return values


def _normalise_power(group: str, fields: Dict[str, np.ndarray],
                     variables: Dict) -> Dict[str, np.ndarray]:
    """v15 pv/gsp files store RAW megawatts (``power_mw``) next to
    ``capacity_mwp``; the Batch contract is the dataloader's normalised
    [0, 1] yield (reference ``base_model.py:222-234`` multiplies
    ``gsp_yield`` by ``gsp_capacity`` to recover MW). Divide at load when —
    and only when — the file carried raw power and no pre-normalised key."""
    yield_field = f"{group}_yield"
    has_normalised_key = yield_field in variables or "data" in variables
    if "power_mw" not in variables or has_normalised_key:
        return fields
    power = fields.get(yield_field)
    # Only megawatt-peak capacity names: dividing MW power by a capacity in
    # other units (e.g. a watts-peak field) would silently produce
    # near-zero "fractions", which is worse than not normalising.
    capacity = None
    for cap_name in ("capacity_mwp", "gsp_capacity"):
        if cap_name in variables:
            capacity = np.asarray(variables[cap_name][1], np.float32)
            break
    if power is None:
        return fields
    if capacity is None:
        # power_mw exists but no recognised capacity variable: raw megawatts
        # would flow into training disguised as [0, 1] yields. Fail loudly.
        log.warning(
            "%s file carries power_mw but no capacity variable "
            "(looked for capacity_mwp/gsp_capacity among %s); "
            "%s is left as RAW MW, not normalised yield",
            group, sorted(variables), yield_field,
        )
        return fields
    if capacity.ndim == power.ndim - 1:  # (B, n) capacity vs (B, T, n) power
        capacity = capacity[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        normalised = np.where(capacity > 0, power / capacity, 0.0)
    fields[yield_field] = normalised.astype(np.float32)
    return fields


def assemble_v15_batch(source_variables: Dict[str, Dict[str, Variable]]) -> Batch:
    """Map per-source variable dicts onto the Batch pytree (v15 field names)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for source, variables in source_variables.items():
        group, field_map = _V15_SOURCES[source]
        # When a pv/gsp file carries BOTH raw power and a pre-normalised key
        # ('data' / '*_yield'), the normalised one wins deterministically —
        # otherwise HDF5 iteration order decides which value lands in the
        # yield field and _normalise_power's skip guard could leave raw MW.
        skip_vars = set()
        if group in ("pv", "gsp") and (
            "data" in variables or f"{group}_yield" in variables
        ):
            skip_vars.add("power_mw")
        fields: Dict[str, np.ndarray] = {}
        for var_name, (dims, values) in variables.items():
            if var_name in skip_vars:
                continue
            field = field_map.get(var_name)
            if field is None:
                continue
            if (group, field) in _IMAGE_FIELDS:
                if group in ("satellite", "hrvsatellite"):
                    # channel-last imagery ships as-is; device transposes
                    values, deferred = canonical_or_deferred(dims, values)
                    if deferred:
                        fields["channel_last"] = True
                else:
                    values = to_canonical_image(dims, values)
            fields[field] = _datetime_to_int64(values)
        if group in ("pv", "gsp"):
            fields = _normalise_power(group, fields, variables)
        if fields:
            groups[group] = fields
    if not groups:
        # files existed but no variable matched the v15 field maps — fail
        # loudly here rather than as an opaque empty-Batch error downstream
        raise ValueError(
            "v15 batch files contained no recognised variables "
            f"(sources read: {sorted(source_variables)})"
        )
    return Batch.from_host(groups)


def batch_from_source_files(root: str, batch_idx: int) -> Batch:
    """Assemble a Batch from a v15 per-source directory tree."""
    source_variables: Dict[str, Dict[str, Variable]] = {}
    filename = netcdf_filename(batch_idx)
    for source in _V15_SOURCES:
        path = os.path.join(root, source, filename)
        if not os.path.exists(path):
            continue
        source_variables[source] = read_netcdf_variables(path)
    if not source_variables:
        raise FileNotFoundError(
            f"no per-source NetCDF files for batch {batch_idx} under {root}"
        )
    return assemble_v15_batch(source_variables)


def assemble_legacy_batch(variables: Dict[str, Variable], path: str) -> Batch:
    """Map a legacy flat-file variable dict onto the Batch pytree."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for var_name, (dims, values) in variables.items():
        mapped = _LEGACY_KEYS.get(var_name)
        if mapped is None:
            continue
        group, field = mapped
        if (group, field) in _IMAGE_FIELDS:
            if group in ("satellite", "hrvsatellite"):
                values, deferred = canonical_or_deferred(dims, values)
                if deferred:
                    groups.setdefault(group, {})["channel_last"] = True
            else:
                values = to_canonical_image(dims, values)
        groups.setdefault(group, {})[field] = _datetime_to_int64(values)
    if not groups:
        raise ValueError(f"{path}: no recognised batch keys")
    return Batch.from_host(groups)


def batch_from_legacy_file(path: str) -> Batch:
    """Assemble a Batch from a legacy single-file batch (v2/v6 keys)."""
    return assemble_legacy_batch(read_netcdf_variables(path), path)


def netcdf_filename(batch_idx: int) -> str:
    """nowcasting_dataset's get_netcdf_filename: zero-padded 6 digits."""
    return f"{batch_idx:06d}.nc"


class _SourceSchema:
    """Variable layout of one source's batch files, probed once per store.

    Every batch file of a v15 source is written by the same code with the
    same shapes, so dims, dtypes, attrs AND the HDF5 data offsets are
    identical file-to-file. Opening h5py per file costs library-lock-
    serialised metadata work per source; with the layout probed once, later
    files are read by ``np.memmap`` at the cached offsets with NO HDF5 calls
    at all. A file-size mismatch (the layout fingerprint) falls back to the
    full h5py path, so a heterogeneous store is still read correctly."""

    __slots__ = ("file_size", "variables")

    def __init__(self, file_size: int, variables: Dict[str, tuple]):
        self.file_size = file_size
        #: {name: (dims, shape, dtype, offset, units-or-None)}
        self.variables = variables


def _probe_schema(path: str) -> Optional[_SourceSchema]:
    """Layout of one batch file, or None if any variable cannot be mapped
    (chunked/compressed/vlen/big-endian → always use the h5py path)."""
    h5py = _h5py()

    variables: Dict[str, tuple] = {}
    blob: Optional[bytes] = None  # whole-file bytes, read at most once
    with h5py.File(path, "r") as fh:
        for name, dataset in fh.items():
            if not isinstance(dataset, h5py.Dataset):
                return None
            scale_name = dataset.attrs.get("NAME")
            if isinstance(scale_name, bytes) and scale_name.startswith(
                _PHONY_DIM_SENTINEL
            ):
                continue
            if dataset.chunks is not None or dataset.compression is not None:
                return None
            offset = dataset.id.get_offset()
            if offset is None:
                return None
            dtype = dataset.dtype
            if dtype.kind not in "iufS" or dtype.byteorder == ">":
                return None
            dims = _dim_labels(dataset)
            # The units string embeds a per-FILE epoch (xarray derives it
            # from each file's first timestamp), so its VALUE cannot be
            # cached — but its byte LOCATION in the object header is stable
            # across identically-laid-out files (the file-size fingerprint
            # guards layout drift, and the reader re-verifies the bytes
            # against the CF pattern), so no file needs an h5py open just
            # for this one attribute.
            units_loc = None
            if "units" in dataset.attrs:
                units = dataset.attrs["units"]
                text = units.decode("utf-8", "replace") if isinstance(
                    units, bytes
                ) else str(units)
                if not _is_cf_time_units(text):
                    # NOT a CF time encoding ("degrees", "m", ...): the
                    # value is layout-static — cache it and stay pure-mmap
                    units_loc = ("value", text)
                else:
                    # CF time: the epoch is per-file, so cache the byte
                    # LOCATION of the attribute value when it is unique
                    units_loc = "h5py"  # safe fallback: attrs-only open
                    raw = units if isinstance(units, bytes) else text.encode()
                    if blob is None:
                        with open(path, "rb") as fh_bytes:
                            blob = fh_bytes.read()
                    first = blob.find(raw)
                    if first != -1 and blob.find(raw, first + 1) == -1:
                        units_loc = ("at", first, len(raw))
            variables[name] = (tuple(dims), dataset.shape, dtype, offset, units_loc)
    return _SourceSchema(os.path.getsize(path), variables)


def _units_at(path: str, offset: int, length: int) -> Optional[str]:
    """The cached-location fast path for a CF units attribute: read the
    bytes and accept them only if the decoder itself would decode them."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        raw = fh.read(length)
    try:
        text = raw.decode("ascii")
    except UnicodeDecodeError:
        return None
    return text if _is_cf_time_units(text) else None


def _read_with_schema(path: str, schema: _SourceSchema) -> Optional[Dict[str, Variable]]:
    """Read a batch file through a cached layout: the big payloads come in
    by ``np.memmap`` at the cached offsets; CF-time variables (whose
    ``units`` attribute embeds a per-file epoch) are the one thing that
    still needs a (cheap, attrs-only) h5py open."""
    if os.path.getsize(path) != schema.file_size:
        return None
    out: Dict[str, Variable] = {}
    units_by_name: Dict[str, object] = {}
    h5py_names = []
    for name, (_, _, _, _, units_loc) in schema.variables.items():
        if units_loc is None:
            continue
        if units_loc == "h5py":
            h5py_names.append(name)
            continue
        if units_loc[0] == "value":  # layout-static non-CF units
            units_by_name[name] = units_loc[1]
            continue
        _, attr_offset, attr_length = units_loc
        text = _units_at(path, attr_offset, attr_length)
        if text is None:  # header layout drifted after all: full fallback
            h5py_names.append(name)
        else:
            units_by_name[name] = text
    if h5py_names:
        with _h5py().File(path, "r") as fh:
            for name in h5py_names:
                units_by_name[name] = fh[name].attrs.get("units")
    for name, (dims, shape, dtype, offset, units_loc) in schema.variables.items():
        values: np.ndarray = np.memmap(
            path, dtype=dtype, mode="c", offset=offset, shape=shape
        )
        if units_loc is not None:
            decoded = _decode_cf_time(values, units_by_name.get(name))
            if decoded is not None:
                values = decoded
        if values.dtype.kind == "S":
            values = _parse_char_values(name, values)
        out[name] = (dims, values)
    return out


class NetCDFBatchDataset:
    """Map-style dataset over prepared-batch NetCDF files — the native
    equivalent of the external ``NetCDFDataset`` the reference wraps
    (reference ``data/dataloader.py:97-115``): one ``__getitem__`` = one
    whole pre-prepared batch, as CPU tensors. Remote (``gs://``,
    ``file://``, ``memory://``) paths are fetched through fsspec, imported
    where a remote store is met, into ``tmp_path`` per item, as the
    reference does.

    Layout is auto-detected: a ``satellite``/``gsp``/... subdirectory means
    the v15 per-source tree; otherwise single legacy files are expected.
    """

    def __init__(
        self,
        n_batches: int,
        src_path: str,
        tmp_path: Optional[str] = None,
        configuration=None,
    ):
        self.n_batches = int(n_batches)
        self.src_path = src_path
        self.tmp_path = tmp_path
        self.configuration = configuration
        self._per_source: Optional[bool] = None  # layout cached on first access
        self._present_sources: Optional[tuple] = None  # store property, cached
        self._fs = None  # one fsspec filesystem, reused for every fetch
        #: per-source file layouts (None = unmappable, always h5py); a benign
        #: data race between loader threads just re-probes the same layout
        self._schemas: Dict[str, Optional[_SourceSchema]] = {}

    def __len__(self) -> int:
        return self.n_batches

    def _local_root(self) -> str:
        if "://" not in self.src_path:
            return self.src_path
        if not self.tmp_path:
            raise ValueError("remote src_path needs tmp_path")
        return self.tmp_path

    def _ensure_local(self, relative: str) -> str:
        if "://" not in self.src_path:
            return os.path.join(self.src_path, relative)
        import time

        local = os.path.join(self.tmp_path, relative)
        if not os.path.exists(local):
            os.makedirs(os.path.dirname(local), exist_ok=True)
            # atomic + retried, matching the shard fetcher's posture
            # (data/shards.py; the reference patched gcsfs the same way,
            # SURVEY §5.3): a killed download never leaves a truncated file
            # that later epochs would trust.
            last_error: Optional[Exception] = None
            fs, base = self._remote_fs()  # fsspec-gated, as data/shards.py
            for attempt in range(5):
                try:
                    import shutil

                    with fs.open(os.path.join(base, relative), "rb") as src:
                        with open(local + ".tmp", "wb") as dst:
                            # stream: N worker threads each holding a whole
                            # batch file in RAM would cost memory
                            shutil.copyfileobj(src, dst, length=1 << 20)
                    os.replace(local + ".tmp", local)
                    break
                except FileNotFoundError:
                    # genuinely absent — not transient; the caller decides
                    # whether a missing per-source file is skippable
                    raise
                except Exception as exc:  # transient cloud-FS errors
                    last_error = exc
                    time.sleep(min(2**attempt, 8))
            else:
                raise RuntimeError(
                    f"failed to fetch {relative} after 5 attempts"
                ) from last_error
        return local

    def _is_per_source(self) -> bool:
        # the layout is a property of the store, not the item: detect once
        if self._per_source is not None:
            return self._per_source
        self._per_source = self._detect_per_source()
        return self._per_source

    def _remote_fs(self):
        """One fsspec filesystem per dataset, built lazily and reused —
        reconstructing it per batch costs an auth/session setup each time."""
        if self._fs is None:
            import fsspec

            self._fs = fsspec.core.url_to_fs(self.src_path)
        return self._fs

    def _detect_per_source(self) -> bool:
        return bool(self._sources_present())

    def _sources_present(self) -> tuple:
        """Which v15 per-source directories exist — a property of the STORE,
        not of any batch index, so it is probed exactly once (the remote
        ``exists`` round-trips would otherwise repeat for all 8 sources on
        every ``__getitem__``)."""
        if self._present_sources is not None:
            return self._present_sources
        if "://" in self.src_path:
            fs, base = self._remote_fs()
            self._present_sources = tuple(
                source
                for source in _V15_SOURCES
                if fs.exists(os.path.join(base, source))
            )
        else:
            self._present_sources = tuple(
                source
                for source in _V15_SOURCES
                if os.path.isdir(os.path.join(self.src_path, source))
            )
        return self._present_sources

    def _read_source(self, source: str, path: str) -> Dict[str, Variable]:
        """One source file, through the cached-layout mmap fast path when the
        store's layout allows it, else the full h5py/classic reader."""
        if source not in self._schemas:
            try:
                self._schemas[source] = _probe_schema(path)
            except Exception:  # not HDF5 (e.g. netCDF3 classic) → slow path
                self._schemas[source] = None
        schema = self._schemas[source]
        if schema is not None:
            variables = _read_with_schema(path, schema)
            if variables is not None:
                return variables
        return read_netcdf_variables(path)

    def __getitem__(self, batch_idx: int) -> Batch:
        if not 0 <= batch_idx < self.n_batches:
            raise IndexError(batch_idx)
        filename = netcdf_filename(batch_idx)
        if self._is_per_source():
            if "://" in self.src_path:
                # local files are read in place; remote stores fetch one file
                # per present source (presence cached store-wide above). A
                # source directory may legitimately hold fewer batch files
                # than others — skip it for this batch, like the local path's
                # os.path.exists check below.
                for source in self._sources_present():
                    try:
                        self._ensure_local(os.path.join(source, filename))
                    except FileNotFoundError:
                        continue
            root = self._local_root()
            source_variables: Dict[str, Dict[str, Variable]] = {}
            for source in self._sources_present():
                path = os.path.join(root, source, filename)
                if not os.path.exists(path):
                    continue
                source_variables[source] = self._read_source(source, path)
            if not source_variables:
                raise FileNotFoundError(
                    f"no per-source NetCDF files for batch {batch_idx} "
                    f"under {root}"
                )
            return assemble_v15_batch(source_variables)
        path = self._ensure_local(filename)
        # legacy flat files share one layout per store too: same
        # schema-cached mmap fast path, keyed under a reserved name
        return assemble_legacy_batch(self._read_source("__legacy__", path), path)

    def __iter__(self):
        for i in range(self.n_batches):
            yield self[i]
