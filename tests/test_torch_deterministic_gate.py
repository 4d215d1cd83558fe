"""The perceiver learning gate under deterministic algorithms: the
port's deterministic max-pool gradient (``models/layers.py``:
``DeterministicMaxPool3d`` against ``F.max_pool3d``'s own backward, and
``Conv3dMaxPool``'s choice between them), ``utils.deterministic_algorithms``
and the gate's command line (``data/synthetic.py``). CPU only: on the card
the gate runs in ``chip_smoke.py`` phase 9 (d)."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch.data import synthetic
from predict_pv_yield_tpu_torch.models.layers import Conv3dMaxPool, DeterministicMaxPool3d
from predict_pv_yield_tpu_torch.utils import deterministic_algorithms

SHAPES = [(2, 3, 4, 9, 8), (1, 1, 1, 5, 5), (3, 2, 6, 12, 11)]


def _pool(x):
    return F.max_pool3d(x, 3, stride=(1, 2, 2), padding=1)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_gradient_equals_max_pool3d(shape, ties):
    """Forward and gradient bit-equal to ``F.max_pool3d``'s, also where
    windows overlap on a tied maximum (values rounded to halves)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if ties:
        x = torch.round(x * 2) / 2
    upstream = torch.from_numpy(rng.standard_normal(_pool(x).shape).astype(np.float32))
    plain, ours = x.clone().requires_grad_(), x.clone().requires_grad_()
    expected = _pool(plain)
    (expected * upstream).sum().backward()
    out = DeterministicMaxPool3d.apply(ours)
    (out * upstream).sum().backward()
    assert torch.equal(out, expected)
    assert torch.equal(ours.grad, plain.grad)


@pytest.mark.parametrize("deterministic", [False, True], ids=["default", "deterministic"])
def test_layer_on_the_cpu_keeps_the_plain_pool(deterministic):
    """On the CPU, whatever the algorithms flag, ``Conv3dMaxPool`` pools with
    ``F.max_pool3d`` (whose CPU backward is deterministic already)."""
    torch.manual_seed(0)
    layer = Conv3dMaxPool(2, 3)
    x = torch.randn(2, 2, 3, 10, 10)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        out = layer(x)
    finally:
        torch.use_deterministic_algorithms(before)
    assert out.grad_fn.name() != "DeterministicMaxPool3dBackward"
    assert torch.equal(out, _pool(layer.conv(x)))


@pytest.mark.parametrize("enabled", [False, True], ids=["off", "on"])
def test_deterministic_algorithms_restores_the_flags(enabled):
    """Inside the block every flag is set; after it, even after a raise,
    each is as it was."""
    cudnn = torch.backends.cudnn
    before = torch.are_deterministic_algorithms_enabled(), cudnn.deterministic, cudnn.benchmark
    torch.use_deterministic_algorithms(enabled)
    try:
        with pytest.raises(RuntimeError, match="inside"), deterministic_algorithms():
            assert torch.are_deterministic_algorithms_enabled() and cudnn.deterministic and not cudnn.benchmark
            raise RuntimeError("inside")
        assert torch.are_deterministic_algorithms_enabled() == enabled
        assert (cudnn.deterministic, cudnn.benchmark) == before[1:]
    finally:
        torch.use_deterministic_algorithms(before[0])


def test_gate_command_line_raises_without_a_card():
    """The gate's entry point defaults to the card and raises without one,
    before it writes an archive."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        synthetic.main(["--epochs", "1"])


def test_gate_command_line_line(monkeypatch, capsys, tmp_path):
    """The JSON line: the trainer's scores (stubbed here; phase 9 (d) trains
    them on the card), the best, its epoch and its ratio to the baseline,
    with the flags passed through."""
    calls = {}

    def scores(arch, workdir, epochs, learning_rate, deterministic, device):
        calls.update(epochs=epochs, learning_rate=learning_rate, deterministic=deterministic, device=device)
        return [0.18, 0.09, 0.12]

    monkeypatch.setattr(synthetic, "make_learnable_archive", lambda *args, **kwargs: None)
    monkeypatch.setattr(synthetic, "perceiver_gate_scores", scores)
    monkeypatch.setattr(synthetic, "run_learnable", lambda arch, overrides, workdir: 0.12)
    result = synthetic.main(["--device", "cpu", "--epochs", "3", "--learning-rate", "0.002", "--deterministic"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert calls == {"epochs": 3, "learning_rate": 0.002, "deterministic": True, "device": "cpu"}
    assert (line["best"], line["best_epoch"], line["baseline"]) == (0.09, 1, 0.12)
    assert line["ratio"] == 0.09 / 0.12 and line["device"] == "cpu" and line["scores"] == [0.18, 0.09, 0.12]
