"""The ``Batch`` container — the data contract of the forecast models (a
mirror of the JAX package's ``data/batch.py``).

Nine groups of plain dataclasses with the JAX package's field names, torch
tensors as leaves (shapes as there):

* ``batch.satellite.data``            — (B, C, T5, H, W)
* ``batch.nwp.data``                  — (B, C, T60, Hn, Wn)
* ``batch.pv.pv_yield``               — (B, T5, n_pv_systems)
* ``batch.pv.pv_system_row_number``   — (B, n_pv_systems) int32
* ``batch.gsp.gsp_yield``             — (B, T30, n_gsp)
* ``batch.gsp.gsp_id``                — (B, n_gsp) int32
* ``batch.gsp.gsp_capacity``          — (B, T30, n_gsp)
* ``batch.gsp.gsp_datetime_index``    — (B, T30) int64 ns since the epoch
* ``batch.metadata.t0_datetime_utc``  — (B,) int64 ns since the epoch

The int64 datetime fields are host metadata: ``Batch.to(device)`` leaves
them on the host and ``Batch.numeric()`` drops them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

Tensor = Optional[torch.Tensor]

_INT32_FIELDS = {"pv_system_row_number", "pv_system_id", "gsp_id"}
_INT64_FIELDS = {"datetime_index", "target_time", "gsp_datetime_index", "t0_datetime_utc"}
#: dataclass fields that are layout markers, not tensors
_STATIC_FIELDS = {"channel_last"}


@dataclass
class SatelliteBatch:
    data: Tensor = None  # (B, C, T5, H, W) float32 or int16 (undecoded)
    x: Tensor = None  # (B, W) OSGB easting per column
    y: Tensor = None  # (B, H) OSGB northing per row
    datetime_index: Tensor = None  # (B, T5) int64 ns
    #: ``data`` is still in the channel-last wire layout (B, T5, H, W, C);
    #: ``data/preprocess.py`` moves it to canonical with the decode
    channel_last: bool = False


@dataclass
class NWPBatch:
    data: Tensor = None  # (B, C, T60, Hn, Wn) float32
    target_time: Tensor = None  # (B, T60) int64 ns


@dataclass
class PVBatch:
    pv_yield: Tensor = None  # (B, T5, n_systems) float32 in [0, 1]
    pv_system_row_number: Tensor = None  # (B, n_systems) int32
    pv_system_id: Tensor = None  # (B, n_systems) int32


@dataclass
class GSPBatch:
    gsp_yield: Tensor = None  # (B, T30, n_gsp) float32 in [0, 1]
    gsp_id: Tensor = None  # (B, n_gsp) int32
    gsp_capacity: Tensor = None  # (B, T30, n_gsp) float32 MW
    gsp_datetime_index: Tensor = None  # (B, T30) int64 ns (host only)


@dataclass
class HRVSatelliteBatch:
    """High-resolution visible channel, on its own grid."""

    data: Tensor = None  # (B, 1, T5, Hh, Wh)
    x: Tensor = None
    y: Tensor = None
    #: see SatelliteBatch.channel_last
    channel_last: bool = False


@dataclass
class SunBatch:
    sun_elevation_angle: Tensor = None  # (B, T5) degrees
    sun_azimuth_angle: Tensor = None  # (B, T5) degrees


@dataclass
class TopographicBatch:
    topo_data: Tensor = None  # (B, Ht, Wt) metres


@dataclass
class DatetimeBatch:
    """Cyclic datetime features at 5-minute cadence."""

    hour_of_day_sin: Tensor = None  # (B, T5)
    hour_of_day_cos: Tensor = None  # (B, T5)
    day_of_year_sin: Tensor = None  # (B, T5)
    day_of_year_cos: Tensor = None  # (B, T5)


@dataclass
class Metadata:
    t0_datetime_utc: Tensor = None  # (B,) int64 ns (host only)


_GROUPS = {
    "satellite": SatelliteBatch,
    "hrvsatellite": HRVSatelliteBatch,
    "nwp": NWPBatch,
    "pv": PVBatch,
    "gsp": GSPBatch,
    "sun": SunBatch,
    "topographic": TopographicBatch,
    "datetime": DatetimeBatch,
    "metadata": Metadata,
}


def _map_group(group, fn):
    """A copy of ``group`` with ``fn(name, leaf)`` applied to every leaf that
    is set (layout markers are kept as they are)."""
    changes = {
        f.name: fn(f.name, getattr(group, f.name))
        for f in dataclasses.fields(group)
        if f.name not in _STATIC_FIELDS and getattr(group, f.name) is not None
    }
    return dataclasses.replace(group, **changes)


@dataclass
class Batch:
    satellite: SatelliteBatch = field(default_factory=SatelliteBatch)
    hrvsatellite: HRVSatelliteBatch = field(default_factory=HRVSatelliteBatch)
    nwp: NWPBatch = field(default_factory=NWPBatch)
    pv: PVBatch = field(default_factory=PVBatch)
    gsp: GSPBatch = field(default_factory=GSPBatch)
    sun: SunBatch = field(default_factory=SunBatch)
    topographic: TopographicBatch = field(default_factory=TopographicBatch)
    datetime: DatetimeBatch = field(default_factory=DatetimeBatch)
    metadata: Metadata = field(default_factory=Metadata)

    # --- dict-style access (the reference models' ``x["nwp"]``) -------------
    def __getitem__(self, key: str) -> torch.Tensor:
        if key == "pv_yield":
            return self.pv.pv_yield
        if key == "gsp_yield":
            return self.gsp.gsp_yield
        if key == "nwp":
            return self.nwp.data
        if key == "satellite":
            return self.satellite.data
        raise KeyError(key)

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def leaves(self) -> Iterator[Any]:
        """Every set leaf, groups and fields in declaration order."""
        for group_field in dataclasses.fields(self):
            group = getattr(self, group_field.name)
            for f in dataclasses.fields(group):
                value = getattr(group, f.name)
                if f.name not in _STATIC_FIELDS and value is not None:
                    yield value

    def map(self, fn) -> "Batch":
        """A copy with ``fn(name, leaf)`` applied to every set leaf."""
        return self.replace(**{
            f.name: _map_group(getattr(self, f.name), fn) for f in dataclasses.fields(self)
        })

    # --- host/device split ---------------------------------------------------
    def numeric(self) -> "Batch":
        """The batch without its int64 datetime fields (host metadata)."""
        return self.replace(
            satellite=dataclasses.replace(self.satellite, datetime_index=None),
            nwp=dataclasses.replace(self.nwp, target_time=None),
            gsp=dataclasses.replace(self.gsp, gsp_datetime_index=None),
            metadata=Metadata(),
        )

    def to(self, device, non_blocking: bool = False) -> "Batch":
        """Every tensor moved to ``device`` except the int64 datetime fields,
        which stay on the host. With ``non_blocking`` a copy from pinned host
        memory is asynchronous on the current stream."""
        return self.map(
            lambda name, x: x if name in _INT64_FIELDS else x.to(device, non_blocking=non_blocking)
        )

    def pin_memory(self) -> "Batch":
        """Every tensor copied into page-locked host memory (needs CUDA)."""
        return self.map(lambda name, x: x.pin_memory())

    @classmethod
    def stack(cls, batches, pin_memory: bool = False) -> "Batch":
        """Batches with the same fields set → one batch whose every leaf has
        a new leading axis of ``len(batches)`` (a group of train steps).
        With ``pin_memory`` the leaves are stacked straight into page-locked
        host memory (needs CUDA)."""
        columns = iter(list(zip(*(b.leaves() for b in batches))))

        def stacked(name, x):
            leaves = [torch.as_tensor(leaf) for leaf in next(columns)]
            out = torch.empty((len(leaves), *leaves[0].shape), dtype=leaves[0].dtype, pin_memory=pin_memory)
            return torch.stack(leaves, out=out)

        return batches[0].map(stacked)

    @property
    def batch_size(self) -> int:
        for leaf in self.leaves():
            return int(leaf.shape[0])
        raise ValueError("empty Batch")

    # --- construction ---------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Batch":
        """Promote a nested dict (the loader wire format) to a Batch; unknown
        groups' fields raise ``TypeError``, as the reference's
        ``BatchML(**x)`` does."""

        def build(group_cls, sub: Dict[str, Any]):
            names = {f.name for f in dataclasses.fields(group_cls)}
            unknown = (sub or {}).keys() - names
            if unknown:
                raise TypeError(
                    f"{group_cls.__name__} got unknown fields {sorted(unknown)}; known: {sorted(names)}"
                )
            return group_cls(**(sub or {}))

        return cls(**{name: build(group_cls, data.get(name, {})) for name, group_cls in _GROUPS.items()})

    @classmethod
    def from_host(cls, batch) -> "Batch":
        """A Batch (or nested dict) whose leaves may be numpy arrays → a Batch
        of CPU tensors (numpy leaves are wrapped without a copy)."""
        batch = as_batch(batch)
        return batch.map(lambda name, x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x)


def as_batch(x: Any) -> Batch:
    """Accept a Batch or a nested dict."""
    if isinstance(x, Batch):
        return x
    if isinstance(x, dict):
        return Batch.from_dict(x)
    raise TypeError(f"cannot promote {type(x)} to Batch")


def batch_shapes(configuration) -> Dict[str, Dict[str, tuple]]:
    """Shapes of every Batch field implied by a dataset Configuration."""
    from predict_pv_yield_tpu_torch.seqlen import SeqLens

    input_data = configuration.input_data
    batch_size = configuration.process.batch_size

    def lens(source) -> SeqLens:
        history = source.history_minutes
        forecast = source.forecast_minutes
        if history is None:
            history = input_data.default_history_minutes
        if forecast is None:
            forecast = input_data.default_forecast_minutes
        return SeqLens(history, forecast)

    sat = input_data.satellite
    hrv = input_data.hrvsatellite
    nwp = input_data.nwp
    pv = input_data.pv
    gsp = input_data.gsp

    hrv_lens = lens(hrv)
    sat_lens = lens(sat)
    nwp_lens = lens(nwp)
    pv_lens = lens(pv)
    gsp_lens = lens(gsp)

    n_pv = pv.n_pv_systems_per_example
    n_gsp = gsp.n_gsp_per_example
    sat_px = sat.satellite_image_size_pixels
    hrv_px = hrv.hrvsatellite_image_size_pixels
    nwp_px = nwp.nwp_image_size_pixels
    topo_px = input_data.topographic.topographic_image_size_pixels

    return {
        "satellite": {
            "data": (batch_size, len(sat.satellite_channels), sat_lens.seq_len_5, sat_px, sat_px),
            "x": (batch_size, sat_px),
            "y": (batch_size, sat_px),
            "datetime_index": (batch_size, sat_lens.seq_len_5),
        },
        "hrvsatellite": {
            "data": (batch_size, len(hrv.hrvsatellite_channels), hrv_lens.seq_len_5, hrv_px, hrv_px),
        },
        "sun": {
            "sun_elevation_angle": (batch_size, sat_lens.seq_len_5),
            "sun_azimuth_angle": (batch_size, sat_lens.seq_len_5),
        },
        "topographic": {"topo_data": (batch_size, topo_px, topo_px)},
        "nwp": {
            "data": (batch_size, len(nwp.nwp_channels), nwp_lens.seq_len_60, nwp_px, nwp_px),
            "target_time": (batch_size, nwp_lens.seq_len_60),
        },
        "pv": {
            "pv_yield": (batch_size, pv_lens.seq_len_5, n_pv),
            "pv_system_row_number": (batch_size, n_pv),
            "pv_system_id": (batch_size, n_pv),
        },
        "gsp": {
            "gsp_yield": (batch_size, gsp_lens.seq_len_30, n_gsp),
            "gsp_id": (batch_size, n_gsp),
            "gsp_capacity": (batch_size, gsp_lens.seq_len_30, n_gsp),
            "gsp_datetime_index": (batch_size, gsp_lens.seq_len_30),
        },
        "datetime": {
            "hour_of_day_sin": (batch_size, sat_lens.seq_len_5),
            "hour_of_day_cos": (batch_size, sat_lens.seq_len_5),
            "day_of_year_sin": (batch_size, sat_lens.seq_len_5),
            "day_of_year_cos": (batch_size, sat_lens.seq_len_5),
        },
        "metadata": {"t0_datetime_utc": (batch_size,)},
    }


def field_dtype(name: str) -> np.dtype:
    if name in _INT32_FIELDS:
        return np.dtype(np.int32)
    if name in _INT64_FIELDS:
        return np.dtype(np.int64)
    return np.dtype(np.float32)
