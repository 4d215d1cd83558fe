"""Dataset configuration (a copy of the JAX package's ``config/dataset.py``).

The configuration describes the prepared dataset on disk (batch size, image
sizes, channel lists, temporal extents) and is shipped with the data as
``configuration.yaml``; the field paths follow the external
``nowcasting_dataset.config.model.Configuration``. The fake-data backend and
``data/batch.py::batch_shapes`` derive every tensor shape from it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from predict_pv_yield_tpu_torch.consts import (
    N_GSPS_PER_EXAMPLE,
    N_PV_SYSTEMS_PER_EXAMPLE,
    NWP_VARIABLE_NAMES,
    SAT_VARIABLE_NAMES,
)


@dataclass
class General:
    """Free-text metadata about the dataset."""

    name: str = "example"
    description: str = "example configuration"


@dataclass
class Process:
    """How the dataset was prepared (per-batch files)."""

    batch_size: int = 32
    seed: int = 1234
    local_temp_path: str = "~/temp/"
    upload_every_n_batches: int = 16


@dataclass
class _TimedDataSource:
    """Base for per-source configs: temporal extents fall back to defaults."""

    #: History minutes for this source; None means use the global default.
    history_minutes: Optional[int] = None
    #: Forecast minutes for this source; None means use the global default.
    forecast_minutes: Optional[int] = None


@dataclass
class Satellite(_TimedDataSource):
    satellite_channels: List[str] = field(default_factory=lambda: list(SAT_VARIABLE_NAMES[1:]))
    satellite_image_size_pixels: int = 64
    satellite_zarr_path: str = ""


@dataclass
class HRVSatellite(_TimedDataSource):
    hrvsatellite_channels: List[str] = field(default_factory=lambda: ["HRV"])
    hrvsatellite_image_size_pixels: int = 64
    hrvsatellite_zarr_path: str = ""


@dataclass
class NWP(_TimedDataSource):
    nwp_channels: List[str] = field(default_factory=lambda: list(NWP_VARIABLE_NAMES))
    nwp_image_size_pixels: int = 64
    nwp_zarr_path: str = ""


@dataclass
class PV(_TimedDataSource):
    pv_filename: str = ""
    pv_metadata_filename: str = ""
    n_pv_systems_per_example: int = N_PV_SYSTEMS_PER_EXAMPLE


@dataclass
class GSP(_TimedDataSource):
    gsp_zarr_path: str = ""
    n_gsp_per_example: int = N_GSPS_PER_EXAMPLE


@dataclass
class Sun(_TimedDataSource):
    sun_zarr_path: str = ""


@dataclass
class Topographic(_TimedDataSource):
    topographic_filename: str = ""
    topographic_image_size_pixels: int = 64


@dataclass
class OpticalFlow(_TimedDataSource):
    opticalflow_zarr_path: str = ""
    opticalflow_input_image_size_pixels: int = 94
    opticalflow_output_image_size_pixels: int = 24
    opticalflow_source_data_source_class_name: str = "SatelliteDataSource"
    opticalflow_channels: List[str] = field(default_factory=lambda: ["IR_016"])


@dataclass
class InputData:
    """Per-data-source configuration plus global temporal defaults."""

    default_history_minutes: int = 30
    default_forecast_minutes: int = 60

    satellite: Satellite = field(default_factory=Satellite)
    hrvsatellite: HRVSatellite = field(default_factory=HRVSatellite)
    nwp: NWP = field(default_factory=NWP)
    pv: PV = field(default_factory=PV)
    gsp: GSP = field(default_factory=GSP)
    sun: Sun = field(default_factory=Sun)
    topographic: Topographic = field(default_factory=Topographic)
    opticalflow: OpticalFlow = field(default_factory=OpticalFlow)

    def set_all_to_defaults(self) -> "InputData":
        """Fill every source's missing history/forecast minutes from the
        defaults. Returns self, so ``x = x.set_all_to_defaults()`` works."""
        for f in dataclasses.fields(self):
            source = getattr(self, f.name)
            if not isinstance(source, _TimedDataSource):
                continue
            if source.history_minutes is None:
                source.history_minutes = self.default_history_minutes
            if source.forecast_minutes is None:
                source.forecast_minutes = self.default_forecast_minutes
        return self


@dataclass
class OutputData:
    filepath: str = ""


@dataclass
class Configuration:
    """Top-level dataset configuration."""

    general: General = field(default_factory=General)
    process: Process = field(default_factory=Process)
    input_data: InputData = field(default_factory=InputData)
    output_data: OutputData = field(default_factory=OutputData)
    git: Optional[dict] = None


def _apply(obj, data: dict):
    """Recursively apply a nested dict onto a dataclass tree, ignoring
    unknown keys (the on-disk YAML carries keys that are not modelled)."""
    names = {f.name for f in dataclasses.fields(obj)}
    for key, value in (data or {}).items():
        if key not in names:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply(current, value)
        else:
            setattr(obj, key, value)


def load_yaml_configuration(filename) -> Configuration:
    """Load a dataset ``configuration.yaml`` from a path or from YAML bytes.

    PyYAML is imported here, not with the module: only this loader needs it.
    """
    import yaml

    if isinstance(filename, bytes):
        raw = yaml.safe_load(filename) or {}
    else:
        with open(filename, "r") as fh:
            raw = yaml.safe_load(fh) or {}
    configuration = Configuration()
    _apply(configuration, raw)
    return configuration
