"""The port's tooling against the JAX package's: each tool's JSON keys at
small widths on the CPU (``serve_bench``, ``pipeline_bench``,
``mfu_probe``; ``--mode flags`` raises), ``learn_probe``'s runs,
``fake_batch_on_device`` against the JAX function's fields, shapes, dtypes
and ranges (its bits are ``torch.Generator``'s, not ``jax.random``'s, so
only determinism per seed is held), the MAC counts that moved into
``flops.py``, and the helpers ``models.register_model``,
``utils.load_config``/``get_logger``/``timed_device_compute`` and
``data/preprocess.stack_timesteps_as_channels``."""

import json
import logging

import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.config.dataset as jds
import predict_pv_yield_tpu_torch.config.dataset as tds


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _json_line(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_serve_bench_keys(capsys):
    from predict_pv_yield_tpu_torch import serve_bench

    result = serve_bench.main(["--device", "cpu", "--smoke"])
    assert _json_line(capsys) == result
    keys = {f"{name}_b{b}" for b in (1, 32, 128) for name in ("p50_ms", "p99_ms", "throughput_ex_s", "batch_mb")}
    assert set(result) == keys | {"metric", "device"}  # tools/serve_bench.py's keys on one chip
    assert result["device"] == "cpu"
    assert all(result[k] > 0 for k in keys) and result["p99_ms_b1"] >= result["p50_ms_b1"]


@pytest.mark.parametrize("argv,keys", [
    (["--host-only", "--wire", "int16"], {"metric", "value", "unit", "wire_mb_per_batch", "host_mb_per_s"}),
    (["--host-only", "--wire", "f32", "--device-ceiling", "30"],
     {"metric", "value", "unit", "wire_mb_per_batch", "host_mb_per_s", "fraction_of_compute_ceiling",
      "device_ceiling_source"}),
    ([], {"metric", "value", "unit", "vs_baseline"}),
], ids=["host_int16", "host_f32_ceiling", "end_to_end"])
def test_pipeline_bench_keys(argv, keys, capsys):
    from predict_pv_yield_tpu_torch import pipeline_bench

    result = pipeline_bench.main(["--device", "cpu", "--smoke", "--shards", "3", "--steps", "4", "--workers", "2",
                                  *argv])
    assert _json_line(capsys) == result and set(result) == keys | {"device"} and result["value"] > 0
    assert result["device"] == ("host" if "--host-only" in argv else "cpu")


def test_mfu_probe_modes(capsys):
    from predict_pv_yield_tpu_torch import mfu_probe

    towers = mfu_probe.main(["--device", "cpu", "--smoke", "--mode", "towers"])
    assert set(towers) == {"mode", "batch", "sat_tower", "nwp_tower", "device"} and towers["device"] == "cpu"
    assert set(towers["sat_tower"]) == {"ms", "tflops_per_s", "mfu"}
    assert towers["sat_tower"]["mfu"] is None  # no peak on the CPU: not measured
    step = mfu_probe.main(["--device", "cpu", "--smoke", "--mode", "step"])
    assert {"mode", "label", "step_time_ms", "device"} <= set(step) and step["step_time_ms"] > 0
    perceiver = mfu_probe.main(["--device", "cpu", "--smoke", "--mode", "perceiver", "--widths", "24x24x32"])
    assert set(perceiver) == {"mode", "latents_24x24_b32", "device"}
    assert set(perceiver["latents_24x24_b32"]) == {"step_time_ms", "examples_per_s", "step_tflops", "mfu"}
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert out == [towers, step, perceiver]
    with pytest.raises(NotImplementedError, match="XLA"):
        mfu_probe.main(["--mode", "flags"])
    with pytest.raises(SystemExit):
        mfu_probe.main(["--device", "cpu", "--mode", "perceiver", "--widths", "1x2x3"])


def test_tower_flops_equal_the_jax_tools_formula():
    from tools.mfu_probe import conv_tower_flops

    from predict_pv_yield_tpu_torch.flops import layer_macs
    from predict_pv_yield_tpu_torch.mfu_probe import TOWERS, _tower

    for spec in TOWERS.values():
        x = torch.zeros(2, spec["c_in"], spec["t"], spec["h"], spec["w"])
        macs = layer_macs(_tower(spec["c_in"]), x)
        assert 3 * 2 * macs == conv_tower_flops(2, spec["t"], spec["h"], spec["w"], spec["c_in"], 32, 6)


def test_learn_probe_runs(capsys):
    from predict_pv_yield_tpu_torch import learn_probe

    result = learn_probe.main_small("cpu", runs=((2e-3, 1),), extra=("datamodule.n_train_data=2",
                                                                      "datamodule.n_val_data=1"))
    assert result["baseline"] > 0 and len(result["runs"]) == 1 and len(result["runs"][0]["val"]) == 1
    out = capsys.readouterr().out
    assert "baseline(16px,b4) NMAE:" in out and "SMALL lr=0.002" in out


def _configuration(module):
    configuration = module.Configuration()
    configuration.process.batch_size = 3
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    configuration.input_data.nwp.nwp_image_size_pixels = 4
    return configuration


def test_fake_batch_on_device_matches_the_jax_fields():
    import jax

    from predict_pv_yield_tpu.data.fake import fake_batch_on_device as jax_fake
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device

    want = {name: np.asarray(v) for name, v in jax.tree_util.tree_leaves_with_path(jax_fake(_configuration(jds)))
            for name in [jax.tree_util.keystr(name)]}
    batch = fake_batch_on_device(_configuration(tds), seed=0, device="cpu")
    got = {}
    for group in ("satellite", "nwp", "pv", "gsp", "sun", "topographic", "hrvsatellite", "datetime"):
        for name, value in vars(getattr(batch, group)).items():
            if isinstance(value, torch.Tensor):
                got[f".{group}.{name}"] = value
    assert sorted(got) == sorted(want)
    ranges = {"pv_yield": (0, 1), "gsp_yield": (0, 1), "gsp_capacity": (10, 500), "sun_elevation_angle": (-10, 60),
              "sun_azimuth_angle": (0, 360), "topo_data": (0, 600), "x": (0, 650_000), "y": (0, 1_000_000),
              }
    for key, value in got.items():
        name = key.rsplit(".", 1)[1]
        assert tuple(value.shape) == want[key].shape and value.device.type == "cpu", key
        assert str(value.dtype).replace("torch.", "") == str(want[key].dtype), key
        low, high = ranges.get(name, (-1, 1) if name.endswith(("_sin", "_cos")) else (None, None))
        if value.dtype == torch.int32:  # ids sized to the smallest embedding table that takes them
            low, high = 0, 940 if name == "pv_system_row_number" else 340
        if low is not None:
            assert value.min() >= low and value.max() < high, key
            assert want[key].min() >= low and want[key].max() < high, key
        else:  # unit-normal imagery
            assert abs(float(value.float().mean())) < 0.2 and 0.8 < float(value.float().std()) < 1.2, key
    again = fake_batch_on_device(_configuration(tds), seed=0, device="cpu")
    other = fake_batch_on_device(_configuration(tds), seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(batch.leaves(), again.leaves()))
    assert not torch.equal(batch.satellite.data, other.satellite.data)


def test_fake_batch_on_device_needs_a_card_by_default(monkeypatch):
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fake_batch_on_device(_configuration(tds))


def test_helpers_match_jax(tmp_path):
    import jax.numpy as jnp

    from predict_pv_yield_tpu.data.preprocess import stack_timesteps_as_channels as jax_stack
    from predict_pv_yield_tpu.utils import load_config as jax_load_config
    from predict_pv_yield_tpu_torch import models, utils
    from predict_pv_yield_tpu_torch.data.preprocess import stack_timesteps_as_channels

    video = np.random.default_rng(0).standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(stack_timesteps_as_channels(torch.from_numpy(video)).numpy(),
                                  np.asarray(jax_stack(jnp.asarray(video))))
    for path in ("configs/model/conv3d_sat_nwp.yaml", "tests/configs/model/conv3d_tiny.yaml"):
        assert utils.load_config(path) == jax_load_config(path) and "_target_" not in utils.load_config(path)

    class Dummy(torch.nn.Module):
        pass

    models.register_model("dummy_for_test", Dummy)
    try:
        assert models.get_model("dummy_for_test") is Dummy
    finally:
        del models.MODEL_REGISTRY["dummy_for_test"]
    logger = utils.get_logger("predict_pv_yield_tpu_torch.test_tools", logging.DEBUG)
    assert logger.level == logging.DEBUG and logger.filter(logging.makeLogRecord({"msg": "x"}))
    calls = []
    seconds, info = utils.timed_device_compute(lambda: calls.append(1), 5, device="cpu")
    assert len(calls) == 5 and seconds >= 0 and info["transfer_dominated"] is False


def test_macs_moved_into_flops_count_the_flagship():
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device
    from predict_pv_yield_tpu_torch.flagship import flagship_configuration, flagship_model
    from predict_pv_yield_tpu_torch.flops import layer_macs, peaks

    model = flagship_model(2, smoke=True)
    batch = fake_batch_on_device(flagship_configuration(2, smoke=True), device="cpu")
    macs = layer_macs(model, batch)
    convs = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Conv3d))
    assert macs > convs > 0
    assert peaks("NVIDIA H100 80GB HBM3")[0] == "H100" and peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    with pytest.raises(RuntimeError):
        peaks("a CPU")
