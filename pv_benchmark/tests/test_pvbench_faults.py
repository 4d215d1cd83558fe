"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of the run is driven on
the CPU at a tiny size, once for each fault a cell can have. (The cells run
on one card, so there is no exchange between cards to leave out.)"""

import pytest
import torch

from predict_pv_yield_tpu_torch import predict
from predict_pv_yield_tpu_torch.training import engine
from pv_benchmark import run
from pv_benchmark.spec import load_cell
from pv_benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("tiny"))


def execute(root, name, seed=31):
    return run.execute(load_cell(name, root), seed, 0.3, False, [torch.device("cpu")], 0.0)


def test_sound_runs_are_correct(root):
    result = execute(root, "tiny_conv3d.train")
    assert result["correct"] is True
    assert result["checks"]["late_loss_gap"]["value"] <= 1e-6


def test_state_left_unchanged(root, monkeypatch):
    monkeypatch.setattr(engine.Trainer, "apply_gradients", lambda self, grads: None)
    result = execute(root, "tiny_conv3d.train")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch(root, monkeypatch):
    forward = engine.forward_and_metrics

    def half(model, batch, *args):
        return forward(model, batch.map(lambda name, x: x[: x.shape[0] // 2]), *args)

    monkeypatch.setattr(engine, "forward_and_metrics", half)
    result = execute(root, "tiny_conv3d.train")
    assert result["correct"] is False
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


def test_stale_batches_late_in_the_window(root, monkeypatch):
    """After the checked steps every step trains on the batch of step 4:
    the checked steps read sound, the late steps do not."""
    iterate = engine.iter_batches

    def stale(*args, **kwargs):
        first = None
        for i, (host, device_batch) in enumerate(iterate(*args, **kwargs)):
            if i == 3:
                first = device_batch
            yield host, (device_batch if first is None else first)

    monkeypatch.setattr(engine, "iter_batches", stale)
    result = execute(root, "tiny_conv3d.train")
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
    assert checks["late_loss_gap"]["value"] > checks["late_loss_gap"]["limit"]


def test_answer_altered(root, monkeypatch):
    step = predict.eval_step

    def altered(*args, **kwargs):
        metrics, h_mse, h_mae, y_hat = step(*args, **kwargs)
        return metrics, h_mse, h_mae, y_hat + torch.nn.functional.one_hot(
            torch.tensor(0), y_hat.numel()).view_as(y_hat) * 1e-3 * y_hat.abs().max()

    monkeypatch.setattr(predict, "eval_step", altered)
    result = execute(root, "tiny_conv3d.serve")
    assert result["correct"] is False


def test_answers_dropped(root, monkeypatch):
    step = predict.eval_step

    def dropped(model, batch, *args, **kwargs):
        return step(model, batch.map(lambda name, x: x[: x.shape[0] // 2]), *args, **kwargs)

    monkeypatch.setattr(predict, "eval_step", dropped)
    result = execute(root, "tiny_conv3d.serve")
    assert result["correct"] is False
    assert result["checks"]["missing"]["value"] > 0
