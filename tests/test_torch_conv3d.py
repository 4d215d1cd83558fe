"""The port's conv3d and conv3d_nwp against the JAX package's models.

Forward parity to rtol/atol 1e-4 (``tests/test_convert.py:427``) on flax
weights carried over by ``conv3d_from_flax`` / ``conv3d_nwp_from_flax``;
one Adam step at NMAE atol 2e-6 and parameters atol 5e-5
(``tests/test_convert.py:506-516``); the widths the flax layers take from
the data (conv3d's ``fc3`` and ``fc_nwp``) at two data sizes; the reference
layout's names (``tests/test_convert.py:28-60``) loading with
``strict=True``; and the PRED-189 runbook (``weights/conv3d/readme.md``)
through the port's predict entry point against ``tools/predict.py`` on the
same ``export_conv3d`` checkpoint.

Sizes are small (2 conv layers of 4 channels at 12 px, widths unequal so a
wrong flatten order cannot pass); torch runs on 2 threads.
"""

import contextlib
import functools
import importlib.util
import io
import pathlib
import re
import shlex
import sys

import jax
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.convert import export_conv3d
from predict_pv_yield_tpu.losses import nmae_loss
from predict_pv_yield_tpu.models.conv3d import Model as JaxConv3d
from predict_pv_yield_tpu.models.conv3d_nwp import Model as JaxConv3dNwp
from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.convert import conv3d_from_flax, conv3d_nwp_from_flax
from predict_pv_yield_tpu_torch.data.batch import batch_shapes
from predict_pv_yield_tpu_torch.models import get_model
from predict_pv_yield_tpu_torch.models.conv3d import Model as Conv3d
from predict_pv_yield_tpu_torch.models.conv3d_nwp import Model as Conv3dNwp
from predict_pv_yield_tpu_torch.training.engine import Trainer
from tests.test_convert import TorchConv3d
from tests.test_torch_conv3d_sat_nwp import _jax_batch, _port_batch

REPO = pathlib.Path(__file__).resolve().parents[1]

#: sat tower: C 4, T 19 − 4, H 8; NWP 2 channels × 3 steps × 5 px
BASE = dict(batch_size=2, history_minutes=30, forecast_minutes=60, number_of_conv3d_layers=2, conv3d_channels=4,
            fc1_output_features=16, fc2_output_features=12, fc3_output_features=8)
CONV3D = dict(BASE, image_size_pixels=12, number_sat_channels=3)
CONV3D_NWP = dict(BASE, nwp_image_size_pixels=9, number_nwp_channels=2)

#: case → (JAX class, port class, converter, config)
CASES = {
    "conv3d_gsp": (JaxConv3d, Conv3d, conv3d_from_flax, dict(CONV3D, output_variable="gsp_yield")),
    "conv3d_pv": (JaxConv3d, Conv3d, conv3d_from_flax, dict(CONV3D, output_variable="pv_yield")),
    "conv3d_sat_only": (JaxConv3d, Conv3d, conv3d_from_flax,
                        dict(CONV3D, output_variable="gsp_yield", include_pv_yield=False, include_nwp=False)),
    "conv3d_nwp": (JaxConv3dNwp, Conv3dNwp, conv3d_nwp_from_flax, CONV3D_NWP),
}

_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def configuration_for(model, n_gsp=32, n_pv=128, nwp_channels=None, nwp_px=None, sat_channels=None, sat_px=None):
    """A dataset configuration in the model's windows, with the given
    series counts and grids (by default the model's own grids, else 3
    satellite channels at 12 px and 2 NWP channels at 5 px)."""
    nwp_channels = nwp_channels or getattr(model, "number_nwp_channels", 2)
    nwp_px = nwp_px or getattr(model, "nwp_image_size_pixels", 5)
    sat_channels = sat_channels or getattr(model, "number_sat_channels", 3)
    sat_px = sat_px or getattr(model, "image_size_pixels", 12)
    configuration = Configuration()
    configuration.process.batch_size = 2
    configuration.input_data.default_history_minutes = model.history_minutes
    configuration.input_data.default_forecast_minutes = model.forecast_minutes
    input_data = configuration.input_data = configuration.input_data.set_all_to_defaults()
    input_data.satellite.satellite_channels = input_data.satellite.satellite_channels[:sat_channels]
    input_data.satellite.satellite_image_size_pixels = sat_px
    input_data.nwp.nwp_channels = input_data.nwp.nwp_channels[:nwp_channels]
    input_data.nwp.nwp_image_size_pixels = nwp_px
    input_data.gsp.n_gsp_per_example = n_gsp
    input_data.pv.n_pv_systems_per_example = n_pv
    return configuration


def fields_for(configuration, seed=0):
    """Seeded numpy inputs in the shapes of ``configuration`` for every
    field the conv3d and experiment models read, with NaNs in the yields."""
    rng = np.random.default_rng(seed)
    shapes = batch_shapes(configuration)

    def normal(group, name):
        return rng.standard_normal(shapes[group][name]).astype(np.float32)

    def uniform(group, name, low=0.0, high=1.0):
        return rng.uniform(low, high, size=shapes[group][name]).astype(np.float32)

    fields = {
        "satellite": {"data": normal("satellite", "data"), "x": uniform("satellite", "x", 0, 650_000),
                      "y": uniform("satellite", "y", 0, 1_000_000)},
        "nwp": {"data": normal("nwp", "data")},
        "gsp": {"gsp_yield": uniform("gsp", "gsp_yield"),
                "gsp_id": rng.integers(0, 340, size=shapes["gsp"]["gsp_id"], dtype=np.int32)},
        "pv": {"pv_yield": uniform("pv", "pv_yield"),
               "pv_system_row_number": rng.integers(0, 940, size=shapes["pv"]["pv_system_row_number"],
                                                    dtype=np.int32)},
        "datetime": {name: uniform("datetime", name, -1, 1) for name in shapes["datetime"]},
    }
    fields["gsp"]["gsp_yield"][0, 0, :3] = np.nan
    fields["pv"]["pv_yield"][1, 1, :5] = np.nan
    return fields


def _forward(model, fields):
    with torch.no_grad():
        return model(_port_batch(fields)).numpy()


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX model, flax variables, the port model with them, fields, the
    jitted loss-and-gradient of the JAX model's NMAE with its forward)."""
    jcls, cls, convert, config = CASES[case]
    jmodel = jcls(**config)
    fields = fields_for(configuration_for(jmodel))
    variables = jax.device_get(_jit(jmodel.init)(jax.random.key(0), _jax_batch(fields)))
    model = cls(**config).eval()
    model.load_state_dict(convert(variables, model), strict=True)

    def loss(variables, batch):
        y_hat = jmodel.apply(variables, batch)
        return nmae_loss(y_hat.astype(np.float32), jmodel.target(batch)), y_hat

    return jmodel, variables, model, fields, _jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jmodel, variables, model, fields, loss_and_grads = _case(case)
    (_, expected), _ = loss_and_grads(variables, _jax_batch(fields))
    actual = _forward(model, fields)
    assert actual.shape == (2, model.forecast_len) == np.shape(expected)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, np.asarray(expected), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(model.target(_port_batch(fields)).numpy(),
                                  np.asarray(jmodel.target(_jax_batch(fields))))


def _adam_step(variables, grads, lr=5e-4, eps=1e-8):
    """optax.adam's first step on the host: −lr · g / (|g| + eps)."""
    return jax.tree_util.tree_map(
        lambda p, g: np.asarray(p) - lr * np.asarray(g) / (np.abs(np.asarray(g)) + eps), variables, grads)


@pytest.mark.parametrize("case", ["conv3d_gsp", "conv3d_nwp"])
def test_one_adam_step_matches_jax(case):
    """One step of the port's Trainer (NMAE, Adam 5e-4) against Adam's
    first step on the JAX model's NMAE gradients, from the same weights."""
    jmodel, variables, model, fields, loss_and_grads = _case(case)
    _, cls, convert, config = CASES[case]
    (loss, _), grads = loss_and_grads(variables, _jax_batch(fields))
    port = cls(**config)
    expected = convert(_adam_step(variables, jax.device_get(grads)), port)
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu")
    trainer.setup(port)
    port.load_state_dict(model.state_dict(), strict=True)
    metrics = trainer.train_step(_port_batch(fields))
    np.testing.assert_allclose(float(metrics["NMAE"]), float(loss), rtol=0, atol=2e-6)
    actual = port.state_dict()
    assert expected.keys() == actual.keys()
    for key in expected:
        np.testing.assert_allclose(actual[key].numpy(), expected[key].numpy(), rtol=0, atol=5e-5, err_msg=key)


@pytest.mark.parametrize("output_variable", ["gsp_yield", "pv_yield"])
@pytest.mark.parametrize("n_series,nwp_channels,nwp_px", [(1, 1, 4), (40, 3, 7)])
def test_widths_follow_the_data(output_variable, n_series, nwp_channels, nwp_px):
    """conv3d's ``fc3`` (yield series per example) and ``fc_nwp`` (the
    flattened NWP) take the JAX model's widths from the dataset
    configuration, and the model then runs that data as the JAX one does."""
    config = dict(CONV3D, output_variable=output_variable)
    jmodel = JaxConv3d(**config)
    configuration = configuration_for(jmodel, n_gsp=n_series, n_pv=n_series, nwp_channels=nwp_channels,
                                      nwp_px=nwp_px)
    fields = fields_for(configuration, seed=4)
    expected, variables = jax.device_get(_jit(jmodel.init_with_output)(jax.random.key(1), _jax_batch(fields)))
    model = Conv3d(**config)
    model.match_configuration(configuration)
    params = variables["params"]
    assert model.fc3.in_features == params["fc3"]["kernel"].shape[0]
    assert model.fc_nwp.in_features == params["fc_nwp"]["kernel"].shape[0] == nwp_channels * 3 * nwp_px**2
    model.load_state_dict(conv3d_from_flax(variables, Conv3d(**config)), strict=True)
    np.testing.assert_allclose(_forward(model.eval(), fields), expected, rtol=1e-4, atol=1e-4)


def test_reference_layout_loads_strict():
    """The reference conv3d replica's ``state_dict`` (sat branch and yield
    history) loads into the port with ``strict=True`` and forecasts as the
    replica does."""
    config = dict(CONV3D, output_variable="pv_yield", include_nwp=False)
    torch.manual_seed(0)
    replica = TorchConv3d(JaxConv3d(**config)).eval()
    model = Conv3d(**config).eval()
    model.load_state_dict(replica.state_dict(), strict=True)
    fields = fields_for(configuration_for(model), seed=5)
    fields["pv"]["pv_yield"] = np.nan_to_num(fields["pv"]["pv_yield"])
    with torch.no_grad():
        expected = replica(torch.from_numpy(fields["satellite"]["data"]),
                           torch.from_numpy(fields["pv"]["pv_yield"])).numpy()
    np.testing.assert_allclose(_forward(model, fields), expected, rtol=1e-5, atol=1e-6)
    assert list(model.state_dict())[:4] == ["sat_conv0.weight", "sat_conv0.bias", "conv3d_1.weight", "conv3d_1.bias"]


def test_registry_and_targets():
    for name, cls in (("conv3d", Conv3d), ("conv3d_nwp", Conv3dNwp)):
        assert get_model(name) is cls
    assert get_model("predict_pv_yield.models.conv3d.model.Model") is Conv3d
    assert get_model("predict_pv_yield.models.conv3d.model_nwp.Model") is Conv3dNwp
    assert get_model("predict_pv_yield_tpu.models.conv3d_nwp.Model") is Conv3dNwp


def _runbook_command():
    """The documented predict command, verbatim from the runbook."""
    text = (REPO / "weights" / "conv3d" / "readme.md").read_text()
    match = re.search(r"```\n(python tools/predict\.py.*?)```", text, re.S)
    return shlex.split(match.group(1).replace("\\\n", " "))


def test_pred189_runbook_through_the_port(tmp_path, monkeypatch):
    """The runbook's command, run by ``tools/predict.py`` and by the port's
    ``python -m predict_pv_yield_tpu_torch.predict`` (on the CPU) on one
    Lightning ``.ckpt`` that the JAX package's ``export_conv3d`` wrote at
    the PRED-189 widths: the same forecasts to 1e-4 and the same NMAE. One
    batch of 32 in place of the runbook's 5 keeps the JAX tool to ~9 s
    (``tests/test_pred189_runbook.py`` runs the command as written)."""
    from predict_pv_yield_tpu.convert import convert_conv3d
    from predict_pv_yield_tpu_torch import predict as serve

    hparams = serve.load_model_config(str(REPO / "configs" / "model" / "conv3d.yaml"))
    jmodel = JaxConv3d(**{k: v for k, v in hparams.items() if k != "_target_"})
    # JAX variables at the PRED-189 widths, from the reference layout of a
    # seeded port model (the JAX package's own converter), exported back
    seeded = serve.build_model("conv3d", hparams, seed=189)
    variables = convert_conv3d(seeded.state_dict(), jmodel)
    state_dict = {k: torch.from_numpy(np.array(v)) for k, v in export_conv3d(variables, jmodel).items()}
    ckpt = tmp_path / "PRED-189.ckpt"
    torch.save({"state_dict": state_dict, "hyper_parameters": dict(hparams), "epoch": 10}, ckpt)

    command = _runbook_command()
    assert command[:2] == ["python", "tools/predict.py"]
    command[command.index("path/to/PRED-189.ckpt")] = str(ckpt)
    command[command.index("--n-batches") + 1] = "1"
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("JAX_NO_PERSISTENT_CACHE", "1")
    outputs = {}
    for who in ("jax", "port"):
        out = tmp_path / f"{who}.csv"
        argv = list(command)
        argv[argv.index("forecasts.csv")] = str(out)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            if who == "jax":
                spec = importlib.util.spec_from_file_location("predict_tool", REPO / "tools" / "predict.py")
                tool = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(tool)
                monkeypatch.setattr(sys, "argv", argv[1:])
                tool.main()
            else:
                serve.main(argv[2:] + ["--device", "cpu"])
        rows = np.loadtxt(out, delimiter=",", skiprows=1)
        nmae = float(re.search(r"NMAE: ([0-9.]+)", printed.getvalue()).group(1))
        outputs[who] = rows, nmae
    (jax_rows, jax_nmae), (rows, nmae) = outputs["jax"], outputs["port"]
    assert rows.shape == jax_rows.shape == (32 * 4, 4)
    np.testing.assert_array_equal(rows[:, :3], jax_rows[:, :3])
    np.testing.assert_allclose(rows[:, 3], jax_rows[:, 3], rtol=0, atol=1e-4)
    assert np.isfinite(nmae) and abs(nmae - jax_nmae) <= 2e-6  # both printed to 6 decimals
