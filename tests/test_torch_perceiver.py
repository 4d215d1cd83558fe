"""The port's perceiver family against the JAX package's models.

The weights cross over both ways: the port model's seeded ``state_dict``
(perceiver_pytorch's layout) becomes the flax tree through the JAX
package's own ``convert_perceiver_model``, and ``perceiver_from_flax``
carries that tree back into a fresh port model. Forward parity at rtol/atol
1e-4 (``tests/test_convert.py:427``) for each model, both
``output_variable``s and ``use_future_satellite_images`` both ways; one
train step of the JAX engine's compiled Adam step at NMAE atol 2e-6 and
parameters atol 5e-5 (``tests/test_convert.py:506-516``); the encoder's
hoisted K/V against the plain depth loop; a strict load of the JAX
package's perceiver_pytorch export; NaN rows for invalid ids; the input
widths ``match_configuration`` sets; the composed experiments through the
port's ``run`` on the CPU.

Sizes are tiny: 3 satellite and 2 NWP channels at 8 px, 6 latents of 16,
depth 4 for PV targets and 7 for GSP targets (a 30-minute forecast is 6
five-minute steps). Torch runs on 2 threads, as the other training tests.
"""

import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.convert import (
    conv3d_kernel,
    convert_perceiver_model,
    convert_perceiver_pytorch_encoder,
    export_perceiver_model,
)
from predict_pv_yield_tpu.models.perceiver import PerceiverModel as JaxPerceiverModel
from predict_pv_yield_tpu.models.perceiver_conv3d_nwp_sat import Model as JaxConv3dNwpSat
from predict_pv_yield_tpu.models.perceiver_core import Perceiver as JaxPerceiver
from predict_pv_yield_tpu.models.perceiver_nwp_sat import Model as JaxNwpSat
from predict_pv_yield_tpu.losses import nmae_loss
from predict_pv_yield_tpu_torch.config.composer import compose
from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.config.instantiate import instantiate
from predict_pv_yield_tpu_torch.convert import perceiver_from_flax
from predict_pv_yield_tpu_torch.data.fake import model_configuration
from predict_pv_yield_tpu_torch.models import MODEL_REGISTRY, get_model
from predict_pv_yield_tpu_torch.models.layers import init_parameters
from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
from predict_pv_yield_tpu_torch.models.perceiver_conv3d_nwp_sat import Model as Conv3dNwpSat
from predict_pv_yield_tpu_torch.models.perceiver_core import FeedForward, Perceiver, ShardedFeedForward
from predict_pv_yield_tpu_torch.models.perceiver_nwp_sat import Model as NwpSat
from predict_pv_yield_tpu_torch.predict import build_model
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.pipeline import train
from tests.test_torch_conv3d_sat_nwp import _jax_batch, _port_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
C_SAT, C_NWP, PX = 3, 2, 8
TINY = dict(batch_size=2, num_latents=6, latent_dim=16)
PV = dict(output_variable="pv_yield", history_minutes=5, forecast_minutes=10)  # depth 4
GSP = dict(output_variable="gsp_yield", history_minutes=0, forecast_minutes=30)  # depth 7

#: case → (JAX class, port class, config)
CASES = {
    "perceiver_pv": (JaxPerceiverModel, PerceiverModel, {**PV, "embedding_dem": 4}),
    "perceiver_gsp": (JaxPerceiverModel, PerceiverModel, {**GSP, "embedding_dem": 4}),
    "nwp_sat_pv": (JaxNwpSat, NwpSat, {**PV, "embedding_dem": 0}),
    "nwp_sat_gsp": (JaxNwpSat, NwpSat, {**GSP, "embedding_dem": 4}),
    "conv3d_pv_future": (JaxConv3dNwpSat, Conv3dNwpSat,
                         {**PV, "embedding_dem": 4, "conv3d_channels": 4, "use_future_satellite_images": True}),
    "conv3d_gsp_past": (JaxConv3dNwpSat, Conv3dNwpSat,
                        {**GSP, "embedding_dem": 0, "conv3d_channels": 4, "use_future_satellite_images": False}),
}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configuration(c_sat=C_SAT, c_nwp=C_NWP, px=PX, n_pv=128):
    """The dataset configuration of :func:`_inputs`."""
    configuration = Configuration()
    input_data = configuration.input_data = configuration.input_data.set_all_to_defaults()
    input_data.satellite.satellite_channels = input_data.satellite.satellite_channels[:c_sat]
    input_data.satellite.satellite_image_size_pixels = px
    input_data.nwp.nwp_channels = input_data.nwp.nwp_channels[:c_nwp]
    input_data.nwp.nwp_image_size_pixels = px
    input_data.pv.n_pv_systems_per_example = n_pv
    return configuration


def _inputs(model, seed=0, batch=2):
    """Seeded numpy inputs for every field the perceivers read."""
    rng = np.random.default_rng(seed)
    lens = model.seq_lens
    return {
        "satellite": {"data": rng.standard_normal((batch, C_SAT, lens.seq_len_5, PX, PX)).astype(np.float32)},
        "nwp": {"data": rng.standard_normal((batch, C_NWP, lens.seq_len_60, PX, PX)).astype(np.float32)},
        "gsp": {"gsp_yield": rng.uniform(size=(batch, lens.seq_len_30, 32)).astype(np.float32),
                "gsp_id": rng.integers(0, 2048, size=(batch, 32)).astype(np.int32)},
        "pv": {"pv_yield": rng.uniform(size=(batch, lens.seq_len_5, 128)).astype(np.float32),
               "pv_system_row_number": rng.integers(0, 2048, size=(batch, 128)).astype(np.int32)},
    }


def _port_model(case, seed=0):
    _, cls, config = CASES[case]
    model = cls(**TINY, **config)
    model.match_configuration(_configuration())
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _flax_variables(model, jmodel):
    """The JAX package's flax tree for the port model's weights: its own
    converter, plus the stems (which that converter does not cover)."""
    variables = convert_perceiver_model(model.state_dict(), jmodel)
    for stem in ("sat_conv3d_maxpool", "nwp_conv3d_maxpool"):
        if hasattr(model, stem):
            conv = getattr(model, stem).conv
            variables["params"][stem] = {"conv": {"kernel": conv3d_kernel(conv.weight),
                                                  "bias": conv.bias.detach().numpy()}}
    return variables


#: the JAX programs here are tiny and their compile dominates: XLA's backend
#: optimisations off (the numbers are the same to float32 rounding)
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

#: the cases whose one Adam step is held to the JAX package's (one per model)
STEP_CASES = ("perceiver_pv", "nwp_sat_pv", "conv3d_pv_future")


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX model, the port model, the flax variables, the JAX forward):
    the forward is jitted once per case, and for a case of ``STEP_CASES``
    it is the loss-and-gradient program's, so each case compiles once."""
    jcls, _, config = CASES[case]
    jmodel = jcls(**TINY, **config)
    model = _port_model(case)
    variables = _flax_variables(model, jmodel)
    if case in STEP_CASES:
        step = _jax_loss_and_grads(jmodel)
        return jmodel, model, variables, lambda v, batch: step(v, batch)[0][1]
    return jmodel, model, variables, _jit(jmodel.apply)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(jmodel):
    """jit(value_and_grad) of the JAX engine's train loss, the NMAE of the
    forward against the target; the forward rides along."""
    def loss(variables, batch):
        y_hat = jmodel.apply(variables, batch)
        return nmae_loss(y_hat, jmodel.target(batch)), y_hat

    return _jit(jax.value_and_grad(loss, has_aux=True))


def _adam_step(variables, grads, lr=5e-4, eps=1e-8):
    """The first step of optax.adam (the JAX engine's optimiser) on the
    host: with bias correction the moments are g and g², so each parameter
    moves by −lr · g / (|g| + eps)."""
    return jax.tree_util.tree_map(
        lambda p, g: np.asarray(p) - lr * np.asarray(g) / (np.sqrt(np.square(np.asarray(g))) + eps),
        variables, grads)


def _forward(model, fields):
    with torch.no_grad():
        return model(_port_batch(fields)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jmodel, model, variables, apply = _case(case)
    fields = _inputs(jmodel, seed=1)
    expected = np.asarray(apply(variables, _jax_batch(fields)))
    actual = _forward(model, fields)
    assert actual.shape == (2, model.forecast_len) == expected.shape
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-4)
    # the flax tree carried back into a fresh model by the port's converter
    fresh = CASES[case][1](**TINY, **CASES[case][2])
    fresh.match_configuration(_configuration())
    fresh.load_state_dict(perceiver_from_flax(variables, fresh), strict=True)
    np.testing.assert_allclose(_forward(fresh.eval(), fields), expected, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(model.target(_port_batch(fields)).numpy(),
                                  np.asarray(jmodel.target(_jax_batch(fields))))
    assert (model.forecast_len, model.total_seq_length) == (jmodel.forecast_len, jmodel.total_seq_length)


@pytest.mark.parametrize("case,group,name", [
    ("perceiver_gsp", "gsp", "gsp_id"),  # this model's ids follow the target
    ("nwp_sat_gsp", "pv", "pv_system_row_number"),  # always the PV ids (the reference's quirk)
])
def test_invalid_ids_give_nan_rows(case, group, name):
    jmodel, model, variables, apply = _case(case)
    fields = _inputs(jmodel, seed=2)
    fields[group][name][0, 0] = 2048
    expected = np.asarray(apply(variables, _jax_batch(fields)))
    actual = _forward(model, fields)
    assert np.isnan(actual[0]).all() and np.isnan(expected[0]).all()
    np.testing.assert_allclose(actual[1], expected[1], rtol=1e-4, atol=1e-4)
    fields[group][name][0, 0] = -1
    assert np.isnan(_forward(model, fields)[0]).all()


def _encoder(**kwargs):
    return Perceiver(input_channels=C_SAT, depth=4, num_latents=6, latent_dim=16, num_classes=5,
                     latent_heads=2, cross_dim_head=8, latent_dim_head=8, **kwargs)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("self_per_cross_attn", [1, 2])
def test_encoder_hoisting_matches_the_depth_loop(tied, self_per_cross_attn):
    """K/V of the input computed once per distinct block equal the plain
    loop that recomputes them at every depth, forward and gradients."""
    torch.manual_seed(0)
    encoder = _encoder(weight_tie_layers=tied, self_per_cross_attn=self_per_cross_attn)
    assert len(encoder.layers[0][2]) == self_per_cross_attn
    assert (encoder.layers[1] is encoder.layers[3]) == tied and encoder.layers[0] is not encoder.layers[1]
    data = torch.randn(2, 5, 4, C_SAT)

    def loop(x):
        pos = encoder.positions(tuple(x.shape[1:-1]), x.dtype, x.device)
        tokens = torch.cat([x, pos.expand(x.shape[0], *pos.shape)], -1).flatten(1, 2)
        latents = encoder.latents.expand(x.shape[0], -1, -1)
        for layer in encoder.layers:
            latents = layer(latents, tokens)
        return encoder.to_logits(latents)

    outputs = []
    for fn in (encoder, loop):
        encoder.zero_grad()
        out = fn(data)
        out.square().sum().backward()
        outputs.append((out.detach(), [p.grad.clone() for p in encoder.parameters()]))
    (hoisted, grads), (plain, plain_grads) = outputs
    torch.testing.assert_close(hoisted, plain, rtol=0, atol=1e-6)
    for a, b in zip(grads, plain_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_encoder_matches_jax_and_checks_its_input():
    torch.manual_seed(1)
    encoder = _encoder(weight_tie_layers=True).eval()
    jencoder = JaxPerceiver(input_channels=C_SAT, depth=4, num_latents=6, latent_dim=16, num_classes=5,
                            weight_tie_layers=True, latent_heads=2, cross_dim_head=8, latent_dim_head=8)
    variables = {"params": convert_perceiver_pytorch_encoder(encoder.state_dict())}
    data = np.random.default_rng(1).standard_normal((2, 5, 4, C_SAT)).astype(np.float32)
    expected = np.asarray(_jit(jencoder.apply)(variables, data))
    with torch.no_grad():
        actual = encoder(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="4-d input"):
        encoder(torch.zeros(2, 20, C_SAT))
    with pytest.raises(ValueError, match="input_channels=3"):
        encoder(torch.zeros(2, 5, 4, C_SAT + 1))
    # partitioned at one rank (tensor parallelism's layout, no process group)
    # it computes what the fused encoder does
    partitioned = _encoder(weight_tie_layers=True, partition_attention=True)
    partitioned.load_state_dict(encoder.state_dict(), strict=True)
    partitioned.partition(0, 1)
    assert isinstance(partitioned.layers[0][1].fn, ShardedFeedForward)
    with torch.no_grad():
        np.testing.assert_allclose(partitioned(torch.from_numpy(data)).numpy(), actual, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", STEP_CASES)
def test_one_adam_step_matches_jax(case):
    """One train step of the port's Trainer (NMAE, Adam 5e-4) against
    Adam's first step on the JAX model's NMAE gradients, from the same
    weights.

    torch's GRU has two biases on its r and z gates where flax's cell has
    one: the gradient of each equals that of flax's one bias, so each
    takes the step flax's takes."""
    jmodel, model, variables, _ = _case(case)
    fields = _inputs(jmodel, seed=3)
    (loss, _), grads = _jax_loss_and_grads(jmodel)(variables, _jax_batch(fields))
    flax_after = perceiver_from_flax(_adam_step(variables, jax.device_get(grads)), model)
    flax_before, port_before = perceiver_from_flax(variables, model), model.state_dict()
    expected = {}
    for key, after in flax_after.items():
        delta = after - flax_before[key]
        if ".bias_hh_l" in key:  # r and z: the step of flax's one bias, in bias_ih's rows
            hidden = delta.shape[0] // 3
            ih = key.replace("bias_hh", "bias_ih")
            delta[: 2 * hidden] = flax_after[ih][: 2 * hidden] - flax_before[ih][: 2 * hidden]
        expected[key] = port_before[key] + delta

    trainer = Trainer(max_epochs=1, profiler=None, device="cpu")
    port = CASES[case][1](**TINY, **CASES[case][2])
    port.match_configuration(_configuration())
    trainer.setup(port)
    port.load_state_dict(port_before, strict=True)
    metrics = trainer.train_step(_port_batch(fields))
    np.testing.assert_allclose(float(metrics["NMAE"]), float(loss), rtol=0, atol=2e-6)
    actual = port.state_dict()
    assert expected.keys() == actual.keys()
    for key in expected:
        np.testing.assert_allclose(actual[key].numpy(), expected[key].numpy(), rtol=0, atol=5e-5, err_msg=key)


@pytest.mark.parametrize("case", ["perceiver_pv", "nwp_sat_gsp"])
def test_perceiver_pytorch_export_loads_strict(case, tmp_path):
    """The JAX package's export in perceiver_pytorch's layout loads into the
    port with ``strict=True`` (the tied block at every index), and so does a
    Lightning ``.ckpt`` of the port's ``state_dict`` through ``build_model``."""
    jmodel, model, variables, apply = _case(case)
    exported = export_perceiver_model(variables, jmodel, layout="perceiver_pytorch")
    assert set(exported) == set(model.state_dict())
    assert f"perceiver.layers.{model.total_seq_length - 1}.2.0.0.fn.to_kv.weight" in exported
    fresh = CASES[case][1](**TINY, **CASES[case][2])
    fresh.match_configuration(_configuration())
    fresh.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}, strict=True)
    fields = _inputs(jmodel, seed=4)
    expected = np.asarray(apply(variables, _jax_batch(fields)))
    np.testing.assert_allclose(_forward(fresh.eval(), fields), expected, rtol=1e-4, atol=1e-4)

    ckpt = str(tmp_path / "model.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in fresh.state_dict().items()}}, ckpt)
    name = {PerceiverModel: "perceiver", NwpSat: "perceiver_nwp_sat"}[CASES[case][1]]
    loaded = build_model(name, {**TINY, **CASES[case][2]}, checkpoint=ckpt, configuration=_configuration())
    np.testing.assert_array_equal(_forward(loaded, fields), _forward(fresh.eval(), fields))


def test_match_configuration_widths():
    """The reference's widths until the data's are known: 11 satellite and
    10 NWP channels at 64 px."""
    def to_kv(model):
        return model.perceiver.layers[0][0].fn.to_kv.in_features

    perceiver = PerceiverModel(**GSP)
    assert to_kv(perceiver) == 11 + 26
    assert (perceiver.encoder_rnn.input_size, perceiver.decoder_rnn.input_size) == (40969, 40968)
    nwp_sat, conv3d = NwpSat(**GSP), Conv3dNwpSat(**GSP, conv3d_channels=8)
    assert to_kv(nwp_sat) == 11 + 10 + 26 and to_kv(conv3d) == 2 * 8 + 26
    assert (conv3d.sat_conv3d_maxpool.conv.in_channels, conv3d.nwp_conv3d_maxpool.conv.in_channels) == (11, 10)
    assert (nwp_sat.encoder_rnn.input_size, nwp_sat.decoder_rnn.input_size) == (9, 8)

    configuration = _configuration()
    for model in (perceiver, nwp_sat, conv3d):
        model.match_configuration(configuration)
        geometry = model_configuration(model).input_data
        assert (len(geometry.satellite.satellite_channels), len(geometry.nwp.nwp_channels),
                geometry.satellite.satellite_image_size_pixels, geometry.nwp.nwp_image_size_pixels) == (
            C_SAT, C_NWP, PX, PX)
    assert to_kv(perceiver) == C_SAT + 26
    assert (perceiver.encoder_rnn.input_size, perceiver.decoder_rnn.input_size) == (8 + C_NWP * PX * PX + 1,
                                                                                    8 + C_NWP * PX * PX)
    assert to_kv(nwp_sat) == C_SAT + C_NWP + 26 and to_kv(conv3d) == 2 * 8 + 26
    assert (conv3d.sat_conv3d_maxpool.conv.in_channels, conv3d.nwp_conv3d_maxpool.conv.in_channels) == (C_SAT,
                                                                                                        C_NWP)
    layers = perceiver.perceiver.layers
    assert layers[1] is layers[-1] and layers[0] is not layers[1] and len(layers) == perceiver.total_seq_length


def test_seeded_init_draws_every_parameter():
    a, b = (_port_model("conv3d_gsp_past", seed=7).state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    model = _port_model("conv3d_gsp_past", seed=7)
    torch.manual_seed(123)  # the draws follow the generator, not the global RNG
    init_parameters(model, torch.Generator().manual_seed(7))
    assert all(torch.equal(a[k], v) for k, v in model.state_dict().items())
    # the GRUs as flax's cell: orthogonal recurrent blocks, zero biases,
    # LeCun-normal input weights truncated at two deviations
    for gate in range(3):
        block = a["encoder_rnn.weight_hh_l1"][16 * gate : 16 * (gate + 1)]
        torch.testing.assert_close(block @ block.T, torch.eye(16), rtol=0, atol=1e-5)
    assert not a["decoder_rnn.bias_ih_l0"].any() and not a["decoder_rnn.bias_hh_l1"].any()
    w_ih = a["encoder_rnn.weight_ih_l0"]
    assert float(w_ih.abs().max()) <= 2 / np.sqrt(w_ih.shape[1]) / 0.87962566103423978
    assert torch.equal(a["perceiver.to_logits.1.weight"], torch.ones(16))
    assert float(a["perceiver.latents"].std()) > 0.5  # standard normal, not a small init


@pytest.mark.parametrize("cls", [PerceiverModel, NwpSat, Conv3dNwpSat])
def test_models_pass_partition_attention_on(cls):
    """Each perceiver model hands ``partition_attention`` to its encoder, as
    the JAX models do; the encoder stays unpartitioned until a trainer (or
    a caller) partitions it."""
    model = cls(**TINY, **PV, partition_attention=True)
    assert model.perceiver.partition_attention and isinstance(model.perceiver.layers[0][1].fn, FeedForward)
    assert not cls(**TINY, **PV).perceiver.partition_attention


def test_registry_and_experiments(tmp_cwd):
    for name, cls in (("perceiver", PerceiverModel), ("perceiver_nwp_sat", NwpSat),
                      ("perceiver_conv3d_nwp_sat", Conv3dNwpSat)):
        assert MODEL_REGISTRY[name] is cls
    for experiment, cls in (("perceiver", PerceiverModel), ("perceiver_sat_nwp", NwpSat),
                            ("perceiver_conv3d_sat_nwp", Conv3dNwpSat)):
        config = compose("config", [f"experiment={experiment}"])
        assert type(instantiate(config["model"])) is cls is get_model(config["model"]["_target_"])
    assert get_model("predict_pv_yield.models.perceiver.perceiver.PerceiverModel") is PerceiverModel
    # experiment 003 (perceiver.yaml at precision 16) trains, in bf16
    metric = train(compose("config", [
        "experiment=003_perceiver_rnn", "datamodule.fake_data=true",
        f"datamodule.data_path={REPO / 'tests/configs/dataset_perceiver'}", "datamodule.n_train_data=2",
        "datamodule.n_val_data=1", "datamodule.num_workers=0", "trainer.max_epochs=1", "model.batch_size=2",
        "model.num_latents=4", "model.latent_dim=8", "+trainer.device=cpu", "+optimized_metric=MSE/Validation_epoch"]))
    assert metric is not None and np.isfinite(metric)
    # model_parallel 2 does not fit one process (tests/test_torch_tensor_parallel.py trains it on two)
    with pytest.raises(ValueError, match="does not fit"):
        train(compose("config", ["experiment=perceiver_tp", "datamodule.fake_data=true", "+trainer.device=cpu"]))


@pytest.mark.parametrize("experiment", ["perceiver", "perceiver_sat_nwp", "perceiver_conv3d_sat_nwp"])
def test_run_trains_the_experiment_on_the_cpu(experiment, tmp_cwd):
    """The port's train CLI on fake data shaped by the perceiver test
    dataset (sat and NWP on one 16-px grid, 60 + 30 minutes): one epoch of
    2 train and 1 validation batches, checkpoint written."""
    from predict_pv_yield_tpu_torch import run

    overrides = [
        f"experiment={experiment}", "datamodule.fake_data=true",
        f"datamodule.data_path={REPO / 'tests/configs/dataset_perceiver'}", "datamodule.n_train_data=2",
        "datamodule.n_val_data=1", "datamodule.num_workers=0", "trainer.max_epochs=1", "model.batch_size=2",
        "model.num_latents=4", "model.latent_dim=8", "+trainer.device=cpu", "+optimized_metric=MSE/Validation_epoch",
    ]
    if experiment == "perceiver_conv3d_sat_nwp":
        overrides.append("model.conv3d_channels=2")
    metric = run.main(overrides)
    assert metric is not None and np.isfinite(metric)
    assert list(tmp_cwd.glob("logs/runs/*/*/checkpoints/last/state.pt"))


def test_chip_smoke_perceiver_literals_are_the_yamls():
    """``chip_smoke.py`` runs without PyYAML: its literal model YAMLs and
    its ``experiment=perceiver`` config equal the files and the composed
    config."""
    import importlib.util

    from predict_pv_yield_tpu_torch.predict import load_model_config

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    files = {"perceiver": "perceiver", "perceiver_nwp_sat": "perceiver_sat_nwp",
             "perceiver_conv3d_nwp_sat": "perceiver_conv3d_sat_nwp"}
    for name, stem in files.items():
        assert chip_smoke.PERCEIVERS[name] == load_model_config(str(REPO / "configs" / "model" / f"{stem}.yaml"))
        assert get_model(chip_smoke.PERCEIVERS[name]["_target_"]) is get_model(name)
    composed = compose("config", chip_smoke.PERCEIVER_TRAIN_OVERRIDES)
    for key in ("hydra", "work_dir", "data_dir"):  # the clock and the cwd; only the CLI reads them
        composed.pop(key)
    assert chip_smoke.PERCEIVER_TRAIN_CONFIG == composed


def test_profile_perceiver_names_the_yamls():
    """The backend profile reads each perceiver model YAML under its zoo
    name, and asks for a card."""
    from predict_pv_yield_tpu_torch import profile_perceiver
    from predict_pv_yield_tpu_torch.predict import load_model_config

    assert set(profile_perceiver.MODELS) == {"perceiver", "perceiver_nwp_sat", "perceiver_conv3d_nwp_sat"}
    for name, stem in profile_perceiver.MODELS.items():
        config = load_model_config(str(profile_perceiver.CONFIGS / f"{stem}.yaml"))
        assert get_model(config["_target_"]) is get_model(name)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA card"):
            profile_perceiver.main()


def test_unequal_grids_raise():
    """perceiver_nwp_sat and the conv3d variant join the two streams as
    channels: their grids must agree, as the reference asserts."""
    model = _port_model("nwp_sat_pv")
    fields = _inputs(model)
    fields["nwp"]["data"] = fields["nwp"]["data"][..., :-1]
    with pytest.raises(ValueError, match="widths should be the same"), torch.no_grad():
        model(_port_batch(fields))
