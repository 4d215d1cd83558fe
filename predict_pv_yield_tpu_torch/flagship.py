"""The flagship configurations the benchmarks and probes run (copies of
the JAX package's ``bench.py`` helpers): conv3d_sat_nwp at the widths of
``configs/model/conv3d_sat_nwp.yaml`` with its dataset geometry, and the
perceiver_conv3d_sat_nwp data shapes. ``smoke=True`` gives the narrow
versions the tests run on the CPU."""

from __future__ import annotations


def flagship_configuration(batch_size: int = 32, smoke: bool = False):
    from predict_pv_yield_tpu_torch.config.dataset import Configuration

    configuration = Configuration()
    configuration.process.batch_size = batch_size
    configuration.input_data.default_history_minutes = 30
    configuration.input_data.default_forecast_minutes = 120
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 12 if smoke else 24
    configuration.input_data.nwp.nwp_image_size_pixels = 12 if smoke else 64
    return configuration


def flagship_model(batch_size: int = 32, smoke: bool = False):
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model

    return Model(
        batch_size=batch_size,
        include_pv_or_gsp_yield_history=True,
        include_nwp=True,
        forecast_minutes=120,
        history_minutes=30,
        number_of_conv3d_layers=2 if smoke else 6,
        image_size_pixels=12 if smoke else 24,
        nwp_image_size_pixels=12 if smoke else 64,
        number_sat_channels=11,
        number_nwp_channels=10,
        conv3d_channels=8 if smoke else 32,
        fc1_output_features=16 if smoke else 128,
        fc2_output_features=16 if smoke else 128,
        fc3_output_features=16 if smoke else 64,
        output_variable="gsp_yield",
        include_pv_yield_history=False,
        include_future_satellite=True,
    )


def perceiver_configuration(batch_size: int = 32, smoke: bool = False):
    """The perceiver's production data shapes: 64 px satellite and NWP
    grids, history 60 / forecast 30."""
    from predict_pv_yield_tpu_torch.config.dataset import Configuration

    configuration = Configuration()
    configuration.process.batch_size = batch_size
    configuration.input_data.default_history_minutes = 30 if smoke else 60
    configuration.input_data.default_forecast_minutes = 30
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 8 if smoke else 64
    configuration.input_data.nwp.nwp_image_size_pixels = 8 if smoke else 64
    return configuration
