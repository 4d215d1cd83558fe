"""Fake-data backend — random batches shaped by a dataset Configuration (a
port of the JAX package's ``data/fake.py``).

Each ``FakeDataset[i]`` is one full :class:`Batch` of CPU tensors, drawn from
``np.random.default_rng((seed, i))`` field by field in the JAX package's
order, so a batch here equals the JAX package's batch value for value.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from predict_pv_yield_tpu_torch.data.batch import Batch, batch_shapes, field_dtype

#: 2021-06-01 00:00 UTC in ns — an arbitrary but fixed fake-time origin.
_T0_NS = 1_622_505_600_000_000_000
_NS_PER_MIN = 60_000_000_000

#: float fields drawn uniformly from a range; every other float field
#: (imagery, NWP) is unit-normal like decoded data
_UNIFORM_RANGES = {
    "sun_elevation_angle": (-10.0, 60.0),
    "sun_azimuth_angle": (0.0, 360.0),
    "topo_data": (0.0, 600.0),
    "x": (0.0, 650_000.0),  # OSGB easting per column
    "y": (0.0, 1_000_000.0),  # OSGB northing per row
    "gsp_capacity": (10.0, 500.0),
    "pv_yield": (0.0, 1.0),
    "gsp_yield": (0.0, 1.0),
}


def _cadence_minutes(name: str) -> int:
    """Timestep of a datetime axis by field name."""
    if "gsp" in name:
        return 30
    if name in ("target_time", "init_time"):
        return 60  # NWP hourly target grid
    return 5  # satellite / hrvsatellite 5-minute imagery


def _uniform_range(name: str):
    if name.endswith("_sin") or name.endswith("_cos"):
        return -1.0, 1.0
    return _UNIFORM_RANGES.get(name)


def fake_batch(configuration, rng: np.random.Generator) -> Batch:
    """One random Batch with the shapes implied by ``configuration``."""
    data: dict = {}
    for group, fields in batch_shapes(configuration).items():
        data[group] = {}
        for name, shape in fields.items():
            dtype = field_dtype(name)
            if dtype == np.float32:
                bounds = _uniform_range(name)
                if bounds is None:
                    arr = rng.standard_normal(size=shape).astype(np.float32)
                else:
                    arr = rng.uniform(*bounds, size=shape).astype(np.float32)
            elif dtype == np.int32:
                # id ranges sized to the smallest embedding table that
                # consumes them (940-way)
                high = 940 if name == "pv_system_row_number" else 340
                arr = rng.integers(0, high, size=shape, dtype=np.int32)
            else:  # int64 datetimes: each axis advances at its own cadence
                steps = rng.integers(0, 2**16, size=shape[:1], dtype=np.int64)
                base = _T0_NS + steps * (30 * _NS_PER_MIN)
                if len(shape) == 1:
                    arr = base
                else:
                    idx = np.arange(shape[1], dtype=np.int64)
                    arr = base[:, None] + idx[None, :] * (_cadence_minutes(name) * _NS_PER_MIN)
            data[group][name] = arr
    return Batch.from_host(data)


def model_configuration(model, batch_size=None):
    """A dataset Configuration in the geometry of ``model``: its history and
    forecast windows and, where the model has them, its satellite and NWP
    image sizes and channel counts (the first channels of each list), at
    ``batch_size`` (the model's own when None)."""
    from predict_pv_yield_tpu_torch.config.dataset import Configuration

    configuration = Configuration()
    configuration.process.batch_size = model.batch_size if batch_size is None else batch_size
    configuration.input_data.default_history_minutes = model.history_minutes
    configuration.input_data.default_forecast_minutes = model.forecast_minutes
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    sat = configuration.input_data.satellite
    if hasattr(model, "image_size_pixels"):
        sat.satellite_image_size_pixels = model.image_size_pixels
    if hasattr(model, "number_sat_channels"):
        sat.satellite_channels = sat.satellite_channels[: model.number_sat_channels]
    nwp = configuration.input_data.nwp
    if hasattr(model, "nwp_image_size_pixels"):
        nwp.nwp_image_size_pixels = model.nwp_image_size_pixels
    if hasattr(model, "number_nwp_channels"):
        nwp.nwp_channels = nwp.nwp_channels[: model.number_nwp_channels]
    return configuration


class FakeDataset:
    """Map-style dataset of random full batches: construct with
    ``configuration=``, iterate or index, override ``.length``."""

    def __init__(self, configuration, length: int = 10, seed: int = 0):
        self.configuration = configuration
        self.length = length
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Batch:
        if not 0 <= index < self.length:
            raise IndexError(index)
        rng = np.random.default_rng((self.seed, index))
        return fake_batch(self.configuration, rng)

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.length):
            yield self[i]
