"""The optical-flow nowcast slice end to end, JAX package against the port.

One numpy int16 archive with −1 holes (64², 5-minute cadence) goes through
both ``SatelliteFlowLoader``s with the same seed: the same window, flows and
predictions to the flow bounds (mean 1e-4, max 1e-3 at a 2 px margin), the
same crops, then the forecaster (flax parameters converted) and the three
SSIM scores to 1e-4. Also: the port imports nothing of JAX, and its entry
points raise rather than fall back to the CPU when CUDA is absent.
"""

import ast
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.data.flow_dataset as jfd
import predict_pv_yield_tpu.models.flow_forecaster as jff
import predict_pv_yield_tpu.ops.ssim as jssim
import predict_pv_yield_tpu_torch.data.flow_dataset as tfd
import predict_pv_yield_tpu_torch.models.flow_forecaster as tff
from predict_pv_yield_tpu_torch import flow_bench, flow_nowcast, train_flow_forecaster
from predict_pv_yield_tpu_torch.convert import flow_forecaster_from_flax
from predict_pv_yield_tpu_torch.ops.ssim import ssim

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE, CROP_LARGE, CROP_SMALL = 64, 32, 16
TEST_RANGE = (np.datetime64("2019-05-21"), np.datetime64("2019-05-22"))
FIELDS = (jff.TARGET_SAT_IMAGE, jff.FORECAST_HORIZON, jff.HISTORICAL_SAT_IMAGES, jff.OPTICAL_FLOW_PREDICTIONS)


def _archive():
    """Two days of one smooth cloud field drifting ~1 px/frame, int16, with
    −1 outages (missing data) in every 7th frame."""
    return flow_nowcast.drifting_archive(n_days=2, size=SIZE, seed=0)


def _loader_kwargs(num_forecast_timesteps):
    frames, datetimes = _archive()
    return dict(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=num_forecast_timesteps,
        testing_date_range=TEST_RANGE,
        rng_seed=3,
    )


@pytest.fixture(scope="module")
def super_batches():
    kwargs = _loader_kwargs(6)
    jsb = jfd.SatelliteFlowLoader(**kwargs).load_super_batch("training")
    tsb = tfd.SatelliteFlowLoader(**kwargs, device="cpu").load_super_batch("training")
    return jsb, tsb


def _assert_flow_close(actual, expected):
    diff = np.abs(actual - expected)[..., 2:-2, 2:-2, :]
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1e-3, diff.max()


def test_same_window_and_decode(super_batches):
    jsb, tsb = super_batches
    np.testing.assert_array_equal(tsb.datetimes, jsb.datetimes)
    assert tsb.sat_images.shape == (7, SIZE, SIZE)
    assert np.isnan(jsb.sat_images).any()  # the outage is in the window
    np.testing.assert_array_equal(tsb.sat_images.numpy(), jsb.sat_images)


def test_flows_and_predictions_agree(super_batches):
    jsb, tsb = super_batches
    flows = tsb.flows.numpy()
    assert flows.shape == (6, SIZE, SIZE, 2) and np.isfinite(flows).all()
    _assert_flow_close(flows, jsb.flows)

    preds, jpreds = tsb.predictions.numpy(), np.asarray(jsb.predictions)
    assert preds.shape == (6, 6, SIZE, SIZE)
    both = ~np.isnan(preds) & ~np.isnan(jpreds)
    assert (np.isnan(preds) != np.isnan(jpreds)).mean() <= 1e-4
    diff = np.abs(preds - jpreds)[both]
    assert diff.mean() <= 1e-4 and diff.max() <= 1e-3, (diff.mean(), diff.max())


def test_lazy_prediction_matches_dense(super_batches):
    _, tsb = super_batches
    lazy = tfd.SuperBatch(tsb.sat_images, tsb.flows, None, tsb.datetimes)
    for t0_idx, step in ((0, 1), (2, 3), (5, 1)):
        torch.testing.assert_close(
            lazy.prediction(t0_idx, step), tsb.prediction(t0_idx, step), equal_nan=True
        )


def _examples(module, super_batch, n=6):
    rng = np.random.default_rng(11)
    return [
        module.super_batch_to_example(
            super_batch, rng, history_stride=1,
            n_pixels_per_side_large=CROP_LARGE, n_pixels_per_side_small=CROP_SMALL,
        )
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def example_batches(super_batches):
    jsb, tsb = super_batches
    jex, tex = _examples(jfd, jsb), _examples(tfd, tsb)
    jbatch = {k: np.stack([np.asarray(e[k]) for e in jex]).astype(np.float32) for k in FIELDS}
    tbatch = {k: torch.stack([torch.as_tensor(e[k]) for e in tex]).float() for k in FIELDS}
    return jbatch, tbatch


def test_same_crops(example_batches):
    jbatch, tbatch = example_batches
    assert tbatch[jff.HISTORICAL_SAT_IMAGES].shape == (6, 4, CROP_LARGE, CROP_LARGE)
    # history, target and horizon are slices of identical frames: equal
    # values mean the same windows, horizons and crop offsets were drawn
    for key in (jff.TARGET_SAT_IMAGE, jff.FORECAST_HORIZON, jff.HISTORICAL_SAT_IMAGES):
        np.testing.assert_array_equal(tbatch[key].numpy(), jbatch[key])
    pred = tbatch[jff.OPTICAL_FLOW_PREDICTIONS].numpy()
    assert not np.isnan(pred).any()
    np.testing.assert_allclose(pred, jbatch[jff.OPTICAL_FLOW_PREDICTIONS], atol=1e-3, rtol=0)


def test_forecaster_and_ssim_agree(example_batches):
    jbatch, tbatch = example_batches
    jmodel = jff.FlowForecaster(channels=8)
    variables = jax.device_get(jmodel.init(jax.random.key(0), jbatch))
    tmodel = tff.FlowForecaster(channels=8)
    tmodel.load_state_dict(flow_forecaster_from_flax(variables, "conv3d"))
    jout = np.asarray(jmodel.apply(variables, jbatch))
    with torch.no_grad():
        tout = tmodel(tbatch)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-4, atol=1e-4)

    border = (CROP_LARGE - CROP_SMALL) // 2
    centre = (slice(None), slice(border, -border), slice(border, -border))
    target = tbatch[jff.TARGET_SAT_IMAGE]
    span = target.amax(dim=(-2, -1)) - target.amin(dim=(-2, -1))
    methods = {
        "model": (tout, jout),
        "flow": (tbatch[jff.OPTICAL_FLOW_PREDICTIONS][centre], jbatch[jff.OPTICAL_FLOW_PREDICTIONS][centre]),
        "persistence": (tbatch[jff.HISTORICAL_SAT_IMAGES][:, -1][centre],
                        jbatch[jff.HISTORICAL_SAT_IMAGES][:, -1][centre]),
    }
    jtarget = jbatch[jff.TARGET_SAT_IMAGE]
    for name, (tpred, jpred) in methods.items():
        scores = ssim(tpred, target, data_range=span).numpy()
        expected = [
            float(jssim.ssim(jpred[i], jtarget[i], data_range=float(np.ptp(jtarget[i]))))
            for i in range(len(jtarget))
        ]
        np.testing.assert_allclose(scores, expected, atol=1e-4, rtol=0, err_msg=name)


def test_evaluate_matches_jax_tool_loop():
    """``flow_nowcast.evaluate`` against the scoring loop of the JAX
    package's tools/train_flow_forecaster.py (:148-191), same archive,
    weights and seeds (stride-3 history needs 13 frames)."""
    kwargs = _loader_kwargs(12)
    batch_size, n_batches = 3, 2
    jmodel = jff.FlowForecaster(channels=8)
    jloader = jfd.SatelliteFlowLoader(**kwargs)
    jdataset = jfd.FlowInMemDataset(
        jloader, n_super_batches=1, n_examples_per_epoch=n_batches * batch_size,
        batch_size=batch_size, batch_type="testing", crop_large=CROP_LARGE,
        crop_small=CROP_SMALL, background_refresh=False, seed=1,
    )
    border = (CROP_LARGE - CROP_SMALL) // 2
    centre = (slice(None), slice(border, -border), slice(border, -border))
    variables = None
    expected = {"model": [], "flow": [], "persistence": []}
    for _ in range(n_batches):
        batch = next(iter(jdataset))
        if variables is None:
            variables = jax.device_get(jmodel.init(jax.random.key(0), batch))
        prediction = np.asarray(jmodel.apply(variables, batch))
        target = batch[jff.TARGET_SAT_IMAGE]
        flow_pred = batch[jff.OPTICAL_FLOW_PREDICTIONS][centre]
        persistence = batch[jff.HISTORICAL_SAT_IMAGES][:, -1][centre]
        for i in range(len(target)):
            span = float(np.nanmax(target[i]) - np.nanmin(target[i])) or 1.0
            for name, method in (("model", prediction), ("flow", flow_pred), ("persistence", persistence)):
                expected[name].append(float(jssim.ssim(method[i], target[i], data_range=span)))

    tmodel = tff.FlowForecaster(channels=8)
    tmodel.load_state_dict(flow_forecaster_from_flax(variables, "conv3d"))
    scores = flow_nowcast.evaluate(
        tmodel, tfd.SatelliteFlowLoader(**kwargs, device="cpu"),
        batch_size=batch_size, n_batches=n_batches, crop_large=CROP_LARGE, crop_small=CROP_SMALL,
    )
    for name, values in expected.items():
        assert abs(scores[name] - np.mean(values)) <= 1e-4, (name, scores[name], np.mean(values))


def test_synthetic_archive_matches_jax_tool():
    """The numpy ``synthetic_archive`` against the JAX tool's (which
    resizes with ``jax.image.resize``): same datetimes, counts within 1 (the
    two resizes round differently before the int16 cast)."""
    spec = importlib.util.spec_from_file_location("train_flow_forecaster", REPO / "tools" / "train_flow_forecaster.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jframes, jtimes = tool.synthetic_archive(n_days=1, size=48, seed=2)
    frames, times = flow_nowcast.synthetic_archive(n_days=1, size=48, seed=2)
    np.testing.assert_array_equal(times, jtimes)
    assert frames.dtype == np.int16 and frames.shape == jframes.shape
    diff = np.abs(frames.astype(np.int32) - jframes)
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())


def test_main_runs_on_cpu(capsys):
    scores = flow_nowcast.main([
        "--synthetic", "--device", "cpu", "--size", "160", "--forecast-timesteps", "12",
        "--batch-size", "2", "--n-batches", "1", "--channels", "4",
    ])
    assert set(scores) == {"model", "flow", "persistence"}
    assert all(np.isfinite(v) for v in scores.values())
    assert "SSIM flow" in capsys.readouterr().out


def test_host_helpers_match_jax():
    values = np.array([[np.nan, -1, 0, 2, 6, 10, 511, 1023, 1500]], np.float32)
    expected = jfd.convert_10bpp_to_uint8(values)
    actual = tfd.convert_10bpp_to_uint8(torch.from_numpy(values))
    assert actual.dtype == torch.uint8
    np.testing.assert_array_equal(actual.numpy(), expected)  # rounds half to even
    for seconds in (300, 3600, 14400):
        assert tfd.normalise_forecast_horizon(seconds) == jfd.normalise_forecast_horizon(seconds)
    frames, datetimes = _archive()
    for steps in (6, 48):
        expected = jfd.compute_valid_start_times(datetimes, steps, TEST_RANGE)
        actual = tfd.compute_valid_start_times(datetimes, steps, TEST_RANGE)
        for split in ("training", "testing"):
            np.testing.assert_array_equal(actual[split], expected[split])


def test_sample_squares_rejects_nans():
    example = {
        jff.OPTICAL_FLOW_PREDICTIONS: torch.full((130, 130), torch.nan),
        jff.HISTORICAL_SAT_IMAGES: torch.zeros((4, 130, 130)),
        jff.TARGET_SAT_IMAGE: torch.zeros((130, 130)),
        jff.FORECAST_HORIZON: np.float32(0),
    }
    with pytest.raises(tfd.ImageHasNansError):
        tfd.sample_squares(example, np.random.default_rng(0))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            func = node.func
            name = getattr(func, "attr", getattr(func, "id", ""))
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "predict_pv_yield_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    # the multi-process package too
    parallel = {path.name for path in files if path.parent.name == "parallel"}
    assert {"__init__.py", "mesh.py", "distributed.py", "tensor_parallel.py"} <= parallel
    # the new modules of the checkpoint reader and the tooling too
    names = {str(path.relative_to(REPO)) for path in files}
    assert {"predict_pv_yield_tpu_torch/training/orbax.py", "predict_pv_yield_tpu_torch/sweep.py",
            "predict_pv_yield_tpu_torch/flops.py", "predict_pv_yield_tpu_torch/mfu_probe.py"} <= names
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "predict_pv_yield_tpu"}
    offenders = [
        (str(path.relative_to(REPO)), scope, module)
        for path in files
        for scope, module in _imports_by_scope(path)
        if module.split(".")[0] in forbidden
        and (str(path.relative_to(REPO)), scope, module) not in ZSTANDARD_BLOSC_CODEC
    ]
    assert not offenders, offenders
    assert not [m for path in files for m in _imported_modules(path)
                if m.split(".")[0] in forbidden - {"zstandard"}]


#: the one use of the zstandard package: writing blosc frames with the zstd
#: inner codec, as the JAX package's blosc writes them (the port has a zstd
#: decoder, csrc/zstd.cpp, and no zstd encoder); every zstd frame the port
#: reads, blosc's and the orbax checkpoints', goes through its own decoder
ZSTANDARD_BLOSC_CODEC = {
    ("predict_pv_yield_tpu_torch/data/blosc.py", "_compress_stream", "zstandard"),
}


#: packages no port module imports at module level (the card's machine need
#: not have them); pandas only inside these functions, where the JAX package
#: uses it to pivot CSVs
OPTIONAL_PACKAGES = {"pandas", "yaml", "h5py", "fsspec", "zstandard"}
PANDAS_FUNCTIONS = {
    ("predict_pv_yield_tpu_torch/data/sources.py", "from_passiv_csv"),
    ("predict_pv_yield_tpu_torch/data/sources.py", "from_pvlive_csv"),
    ("predict_pv_yield_tpu_torch/data/synthetic.py", "make_learnable_archive"),
}


def _imports_by_scope(path):
    """(enclosing function name or None, module) for every import."""
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                found.extend((scope, alias.name) for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                found.append((scope, child.module))
            visit(child, scope)

    visit(ast.parse(path.read_text(), filename=str(path)), None)
    return found


def test_port_imports_optional_packages_only_inside_functions():
    files = sorted((REPO / "predict_pv_yield_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    module_level, pandas_users = [], set()
    for path in files:
        name = str(path.relative_to(REPO))
        for scope, module in _imports_by_scope(path):
            root = module.split(".")[0]
            if root in OPTIONAL_PACKAGES and scope is None:
                module_level.append((name, module))
            if root == "pandas":
                pandas_users.add((name, scope))
    assert not module_level, module_level
    assert pandas_users == PANDAS_FUNCTIONS, pandas_users


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames, datetimes = _archive()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfd.SatelliteFlowLoader(data=frames, datetimes=datetimes)
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_nowcast.main(["--synthetic", "--size", "32"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_flow_forecaster.main(["--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_bench.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_bench.sweep()
