"""Batch inference with a forecast model — the serve path of the JAX
package's ``tools/predict.py`` and ``Trainer.predict``.

Weights (a seed, a reference Lightning ``.ckpt`` or a port ``state_dict``
``.pt``), then batches (fake data shaped to the model's geometry), then the
satellite decode and the forward on the device, then a forecast CSV with the
columns ``batch_index, example_index, forecast_horizon, forecast`` and,
with ``--nmae``, the mean absolute error against the batches' targets:

    python -m predict_pv_yield_tpu_torch.predict --model conv3d_sat_nwp \\
        --model-config configs/model/conv3d_sat_nwp.yaml --n-batches 10 \\
        --out forecasts.csv --nmae

Host batches go to the card through pinned buffers on a copy stream, the
next batch's copy issued before the current forward (``iter_batches``).
Forwards run in full fp32 (no TF32) under ``torch.inference_mode()``.
"""

from __future__ import annotations

import argparse
import csv
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from predict_pv_yield_tpu_torch.convert import load_lightning_checkpoint
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.data.preprocess import preprocess_batch
from predict_pv_yield_tpu_torch.losses import WeightedLosses, mse_loss, nmae_loss
from predict_pv_yield_tpu_torch.metrics import mae_each_forecast_horizon, mse_each_forecast_horizon
from predict_pv_yield_tpu_torch.models import get_model
from predict_pv_yield_tpu_torch.utils import full_fp32, resolve_device


def forward_and_metrics(model, batch: Batch, channel_names=None, weighted: Optional[WeightedLosses] = None):
    """Decode, forward, target and the four batch metrics →
    ``(y_hat, y, metrics)``. ``channel_names`` picks the satellite channel
    statistics of the decode (inferred from the count without it)."""
    batch = preprocess_batch(batch, channel_names=channel_names)
    if weighted is None:
        weighted = WeightedLosses(forecast_length=model.forecast_len, device=batch.satellite.data.device)
    y_hat = model(batch).float()
    y = model.target(batch).float()
    metrics = {
        "MSE": mse_loss(y_hat, y),
        "NMAE": nmae_loss(y_hat, y),
        "MSE_EXP": weighted.get_mse_exp(y_hat, y),
        "MAE_EXP": weighted.get_mae_exp(y_hat, y),
    }
    return y_hat, y, metrics


def eval_step(model, batch: Batch, channel_names=None, weighted: Optional[WeightedLosses] = None):
    """One evaluation step → ``(metrics, horizon_mse, horizon_mae, y_hat)``."""
    y_hat, y, metrics = forward_and_metrics(model, batch, channel_names, weighted)
    return metrics, mse_each_forecast_horizon(y_hat, y), mae_each_forecast_horizon(y_hat, y), y_hat


def channel_names_of(source) -> Optional[Tuple[str, ...]]:
    """The satellite channels of the dataset configuration that ``source``
    (a dataset or loader) carries, else None."""
    configuration = getattr(source, "configuration", None)
    if configuration is None:
        return None
    return tuple(configuration.input_data.satellite.satellite_channels)


#: batches in flight between the host and the card, as the JAX package's
#: ``Trainer.predict`` runs its prefetch
_PREFETCH_DEPTH = 2


def iter_batches(loader: Iterable, device: torch.device, depth: int = _PREFETCH_DEPTH) -> Iterator[Tuple[Batch, Batch]]:
    """Host batches → ``(host, device)`` pairs, with ``depth`` batches in
    flight (the trainer passes its ``prefetch_depth``).

    On the card each batch's numeric fields are copied into pinned host
    memory and sent with ``non_blocking`` copies on a stream of their own,
    so the next batch's copy overlaps the current batch's step; the compute
    stream waits for a batch's copy only when the batch is yielded.
    """
    depth = max(1, int(depth))
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: deque = deque()
    iterator: Optional[Iterator] = iter(loader)
    while True:
        while iterator is not None and len(queue) < depth:
            try:
                host = Batch.from_host(next(iterator))
            except StopIteration:
                iterator = None
                break
            numeric = host.numeric()
            if stream is None:
                queue.append((host, numeric.to(device), None))
                continue
            with torch.cuda.stream(stream):
                moved = numeric.pin_memory().to(device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            queue.append((host, moved, ready))
        if not queue:
            return
        host, moved, ready = queue.popleft()
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for leaf in moved.leaves():
                # allocated on the copy stream, used on the compute stream
                leaf.record_stream(current)
        yield host, moved


def predict(model, loader: Iterable, device="cuda") -> List[np.ndarray]:
    """The model's forecasts for every batch of ``loader``: one host numpy
    ``y_hat`` (batch_size, forecast_len) per batch. The model is moved to
    ``device``; the forecasts come back to the host after the last batch."""
    device = resolve_device(device)
    model = model.to(device).eval()
    channel_names = channel_names_of(loader)
    weighted = WeightedLosses(forecast_length=model.forecast_len, device=device)
    outputs = []
    with torch.inference_mode(), full_fp32():
        for _, batch in iter_batches(loader, device):
            _, _, _, y_hat = eval_step(model, batch, channel_names, weighted)
            outputs.append(y_hat)
    return [y_hat.cpu().numpy() for y_hat in outputs]


def fake_loader(model, n_batches: int) -> FakeDataset:
    """Fake batches (seed 0) shaped to the model's own geometry: its history
    and forecast windows, image sizes and channel counts, at batch
    ``min(model.batch_size, 32)``."""
    configuration = model_configuration(model, batch_size=min(model.batch_size, 32))
    return FakeDataset(configuration=configuration, length=n_batches, seed=0)


def load_model_config(path: str) -> Dict:
    """A model hyperparameter YAML as a dict (``_target_`` kept)."""
    import yaml

    with open(path, "r") as fh:
        return yaml.safe_load(fh)


def build_model(model_name: str, model_config: Dict, checkpoint: Optional[str] = None, seed: int = 0):
    """The model ``model_name`` with the hyperparameters ``model_config``
    (a model YAML as a dict; its ``_target_``, if any, must name the same
    model), on the CPU in ``eval()`` mode. Its weights come from
    ``checkpoint`` (loaded with ``strict=True``), else from ``seed``."""
    config = dict(model_config)
    model_cls = get_model(model_name)
    target = config.pop("_target_", None)
    if target is not None and get_model(target) is not model_cls:
        raise ValueError(f"the config's _target_ {target!r} is not the model {model_name!r}")
    model = model_cls(**config, generator=torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        model.load_state_dict(load_lightning_checkpoint(checkpoint), strict=True)
    return model.eval()


def write_forecasts(predictions: List[np.ndarray], path: str) -> int:
    """The forecast CSV of the JAX package's tool; returns its row count."""
    rows = 0
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["batch_index", "example_index", "forecast_horizon", "forecast"])
        for batch_idx, y_hat in enumerate(predictions):
            for example_idx, forecast in enumerate(y_hat):
                for horizon, value in enumerate(forecast, start=1):
                    writer.writerow([batch_idx, example_idx, horizon, float(value)])
                    rows += 1
    return rows


def nmae(model, predictions: List[np.ndarray], loader: Iterable) -> float:
    """Plain mean |error| of the forecasts against the target slice
    ``y[0:batch_size, -forecast_len:, 0]`` of each batch (the reference's
    "NMAE")."""
    errors = []
    for y_hat, batch in zip(predictions, loader):
        target = model.target(Batch.from_host(batch)).numpy()
        errors.append(np.abs(y_hat - target).reshape(-1))
    return float(np.mean(np.concatenate(errors)))


def run(
    model_config: Dict,
    model_name: str = "conv3d_sat_nwp",
    checkpoint: Optional[str] = None,
    n_batches: int = 10,
    out: str = "forecasts.csv",
    with_nmae: bool = False,
    device="cuda",
) -> Dict:
    """The CLI's work for a model config given as a dict → ``{"predictions",
    "rows", "nmae"}`` (``nmae`` None unless asked for). Without a
    checkpoint the weights come from seed 0."""
    device = resolve_device(device)
    model = build_model(model_name, model_config, checkpoint)
    loader = fake_loader(model, n_batches)
    predictions = predict(model, loader, device)
    rows = write_forecasts(predictions, out)
    print(f"wrote {rows} forecasts to {out}")
    score = None
    if with_nmae:
        score = nmae(model, predictions, loader)
        print(f"NMAE: {score:.6f}")
    return {"predictions": predictions, "rows": rows, "nmae": score}


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True, help="model-zoo name (conv3d_sat_nwp)")
    parser.add_argument("--model-config", required=True, help="model hyperparameter YAML")
    parser.add_argument("--checkpoint", help="reference Lightning .ckpt or port state_dict .pt")
    parser.add_argument("--n-batches", type=int, default=10)
    parser.add_argument("--out", default="forecasts.csv")
    parser.add_argument("--nmae", action="store_true",
                        help="also print NMAE (plain mean |error|) against the batches' targets")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return run(
        load_model_config(args.model_config),
        model_name=args.model,
        checkpoint=args.checkpoint,
        n_batches=args.n_batches,
        out=args.out,
        with_nmae=args.nmae,
        device=args.device,
    )


if __name__ == "__main__":
    main()
