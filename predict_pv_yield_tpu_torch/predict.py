"""Batch inference with a forecast model — the serve path of the JAX
package's ``tools/predict.py`` and ``Trainer.predict``.

Weights (a seed, a reference Lightning ``.ckpt``, a port ``state_dict``
``.pt``, a checkpoint the port's trainer wrote: its directory or its
``state.pt``, served through ``Trainer.predict`` as the JAX tool serves its
trainer's checkpoints, or a checkpoint directory the JAX package's trainer
wrote, orbax or msgpack, read natively), then batches (the test split of a prepared dataset with
``--data``, NetCDF files or shards; else fake data shaped to the model's
geometry), then the satellite decode and the forward on the device, then a
forecast CSV with the columns ``batch_index, example_index,
forecast_horizon, forecast`` and, with ``--nmae``, the mean absolute error
against the batches' targets:

    python -m predict_pv_yield_tpu_torch.predict --model conv3d_sat_nwp \\
        --model-config configs/model/conv3d_sat_nwp.yaml --n-batches 10 \\
        --out forecasts.csv --nmae [--data /path/to/prepared]

With ``--data`` the model's data-dependent input widths follow the
dataset's ``configuration.yaml`` (``match_configuration``).

Host batches go to the card through pinned buffers on a copy stream, the
next batch's copy issued before the current forward (``iter_batches``).
Forwards run in full fp32 (no TF32) under ``torch.inference_mode()``.
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from predict_pv_yield_tpu_torch import tracing
from predict_pv_yield_tpu_torch.convert import load_lightning_checkpoint
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
from predict_pv_yield_tpu_torch.data.preprocess import preprocess_batch
from predict_pv_yield_tpu_torch.losses import WeightedLosses, mse_loss, nmae_loss
from predict_pv_yield_tpu_torch.metrics import mae_each_forecast_horizon, mse_each_forecast_horizon
from predict_pv_yield_tpu_torch.models import get_model
from predict_pv_yield_tpu_torch.models.layers import init_parameters
from predict_pv_yield_tpu_torch.training.callbacks import STATE_FILE, is_jax_checkpoint, load_state
from predict_pv_yield_tpu_torch.utils import full_fp32, resolve_device


def forward_and_metrics(model, batch: Batch, channel_names=None, weighted: Optional[WeightedLosses] = None):
    """Decode, forward, target and the four batch metrics →
    ``(y_hat, y, metrics)``. ``channel_names`` picks the satellite channel
    statistics of the decode (inferred from the count without it). The
    forward runs in the model's compute precision; the forecasts come out
    as fp32, and the targets are fp32 as they come."""
    batch = preprocess_batch(batch, channel_names=channel_names)
    if weighted is None:
        weighted = WeightedLosses(forecast_length=model.forecast_len, device=batch.satellite.data.device)
    with model.compute_precision(batch.satellite.data.device):
        y_hat = model(batch)
    y_hat = y_hat.float()
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


def iter_batches(loader: Iterable, device: torch.device, depth: int = _PREFETCH_DEPTH,
                 cast=None) -> Iterator[Tuple[Any, Batch]]:
    """Host batches → ``(host, device)`` pairs, with ``depth`` items in
    flight (the trainer passes its ``prefetch_depth``). ``cast`` maps the
    numeric host batch before it is sent (the trainer's ``wire_float16``);
    the host batch is yielded as it came. An item that is a list of host
    batches (the trainer's group of k steps) is sent as one batch stacked
    (k, B, …) and yielded with the list of host batches.

    On the card each batch's numeric fields are copied into pinned host
    memory and sent with ``non_blocking`` copies on a stream of their own,
    so the next batch's copy overlaps the current batch's step; the compute
    stream waits for a batch's copy only when the batch is yielded.

    Spans (``tracing``): ``loader.next``, ``h2d.pin``, ``h2d.copy`` with the
    counter ``h2d.bytes``, and the compute stream's ``h2d.wait``.
    """
    depth = max(1, int(depth))
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: deque = deque()
    iterator: Optional[Iterator] = iter(loader)

    def numeric(host: Batch) -> Batch:
        return host.numeric() if cast is None else cast(host.numeric())

    while True:
        while iterator is not None and len(queue) < depth:
            try:
                with tracing.span("loader.next", device=False):
                    item = next(iterator)
            except StopIteration:
                iterator = None
                break
            group = isinstance(item, list)
            host = [Batch.from_host(x) for x in item] if group else Batch.from_host(item)
            if stream is None:
                sent = Batch.stack([numeric(h) for h in host]) if group else numeric(host)
                with tracing.span("h2d.copy"):
                    moved = sent.to(device)
                tracing.count("h2d.bytes", sum(leaf.nbytes for leaf in sent.leaves()))
                queue.append((host, moved, None))
                continue
            with torch.cuda.stream(stream):
                with tracing.span("h2d.pin", device=False):
                    if group:
                        pinned = Batch.stack([numeric(h) for h in host], pin_memory=True)
                    else:
                        pinned = numeric(host).pin_memory()
                # allocated before the copy span, so that its device time is
                # the transfer's and not the allocator's
                moved = pinned.map(lambda name, x: torch.empty_like(x, device=device))
                with tracing.span("h2d.copy", stream):
                    for target, leaf in zip(moved.leaves(), pinned.leaves()):
                        target.copy_(leaf, non_blocking=True)
                tracing.count("h2d.bytes", sum(leaf.nbytes for leaf in pinned.leaves()))
                # a timing event, so that the compute stream's wait for it
                # can be timed (``h2d.wait``)
                ready = torch.cuda.Event(enable_timing=True)
                ready.record(stream)
            queue.append((host, moved, ready))
        if not queue:
            return
        host, moved, ready = queue.popleft()
        if ready is not None:
            current = torch.cuda.current_stream(device)
            tracing.wait("h2d.wait", ready, current)
            current.wait_event(ready)
            for leaf in moved.leaves():
                # allocated on the copy stream, used on the compute stream
                leaf.record_stream(current)
        yield host, moved


def predict(model, loader: Iterable, device="cuda") -> List[np.ndarray]:
    """The model's forecasts for every batch of ``loader``: one host numpy
    ``y_hat`` (batch_size, forecast_len) per batch. The model is moved to
    ``device``; the forecasts come back to the host after the last batch."""
    with tracing.span("predict.round", device=False):
        device = resolve_device(device)
        model = model.to(device).eval()
        channel_names = channel_names_of(loader)
        weighted = WeightedLosses(forecast_length=model.forecast_len, device=device)
        outputs = []
        with torch.inference_mode(), full_fp32():
            for _, batch in iter_batches(loader, device):
                with tracing.span("predict.forward"):
                    _, _, _, y_hat = eval_step(model, batch, channel_names, weighted)
                outputs.append(y_hat)
        with tracing.span("predict.to_host", device=False):
            return [y_hat.cpu().numpy() for y_hat in outputs]


def fake_loader(model, n_batches: int) -> FakeDataset:
    """Fake batches (seed 0) shaped to the model's own geometry: its history
    and forecast windows, image sizes and channel counts, at batch
    ``min(model.batch_size, 32)``."""
    configuration = model_configuration(model, batch_size=min(model.batch_size, 32))
    return FakeDataset(configuration=configuration, length=n_batches, seed=0)


def data_loader(data_path: str, n_batches: int):
    """The test loader of a prepared dataset under ``data_path`` (NetCDF
    files or shards, local or remote) over ``n_batches`` batches, and the
    dataset's configuration, as ``tools/predict.py --data`` reads them."""
    datamodule = NetCDFDataModule(data_path=data_path, n_val_data=n_batches, num_workers=4)
    return datamodule.test_dataloader(), datamodule.configuration


def load_model_config(path: str) -> Dict:
    """A model hyperparameter YAML as a dict (``_target_`` kept)."""
    import yaml

    with open(path, "r") as fh:
        return yaml.safe_load(fh)


def trainer_checkpoint(path: str) -> Optional[str]:
    """The checkpoint directory of a path that names one: a directory the
    port's trainer wrote (or its ``state.pt``), or one the JAX package's
    trainer wrote (orbax, or ``state.msgpack``); else None."""
    if os.path.isdir(path):
        return path
    if os.path.basename(path) == STATE_FILE:
        return os.path.dirname(path)
    return None


def build_model(model_name: str, model_config: Dict, checkpoint: Optional[str] = None, seed: int = 0,
                configuration=None):
    """The model ``model_name`` with the hyperparameters ``model_config``
    (a model YAML as a dict; its ``_target_``, if any, must name the same
    model), on the CPU in ``eval()`` mode. Its data-dependent input widths
    follow the dataset ``configuration`` where one is given
    (``match_configuration``; the fake data of :func:`fake_loader` follows
    the model). Its weights come from ``checkpoint`` (loaded with
    ``strict=True``: a trainer checkpoint's ``model`` state, else a
    Lightning or ``state_dict`` file), else from ``seed``."""
    config = dict(model_config)
    model_cls = get_model(model_name)
    target = config.pop("_target_", None)
    if target is not None and get_model(target) is not model_cls:
        raise ValueError(f"the config's _target_ {target!r} is not the model {model_name!r}")
    model = model_cls(**config)
    if configuration is not None and hasattr(model, "match_configuration"):
        model.match_configuration(configuration)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        directory = trainer_checkpoint(checkpoint)
        state = load_state(directory, model=model)["model"] if directory else load_lightning_checkpoint(checkpoint)
        model.load_state_dict(state, strict=True)
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
    data: Optional[str] = None,
) -> Dict:
    """The CLI's work for a model config given as a dict → ``{"predictions",
    "rows", "nmae"}`` (``nmae`` None unless asked for). Without a
    checkpoint the weights come from seed 0; a trainer checkpoint is served
    through ``Trainer.predict`` with it as ``resume_from_checkpoint``; a
    JAX package checkpoint gives its parameters to the model, whatever
    optimiser chain it was trained with; without ``data`` the batches are
    fake."""
    device = resolve_device(device)
    directory = trainer_checkpoint(checkpoint) if checkpoint else None
    if directory and is_jax_checkpoint(directory):
        directory = None
    weights = None if directory else checkpoint
    if data:
        loader, configuration = data_loader(data, n_batches)
        model = build_model(model_name, model_config, weights, configuration=configuration)
    else:
        model = build_model(model_name, model_config, weights)
        loader = fake_loader(model, n_batches)
    if directory:
        from predict_pv_yield_tpu_torch.training.engine import Trainer

        trainer = Trainer(max_epochs=1, profiler=None, weights_summary=None, device=device,
                          resume_from_checkpoint=directory)
        predictions = trainer.predict(model, dataloaders=loader)
    else:
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
    parser.add_argument("--model", required=True,
                        help="model-zoo name (conv3d_sat_nwp, conv3d, conv3d_nwp, cnn_concat_timesteps, cnn_rnn, "
                        "perceiver, perceiver_nwp_sat, perceiver_conv3d_nwp_sat)")
    parser.add_argument("--model-config", required=True, help="model hyperparameter YAML")
    parser.add_argument("--checkpoint", help="reference Lightning .ckpt, port state_dict .pt, a checkpoint "
                        "directory of the port's trainer (or its state.pt), or one of the JAX package's trainer "
                        "(orbax or state.msgpack)")
    parser.add_argument("--data", help="prepared dataset dir: NetCDF files or shards (omit for fake data)")
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
        data=args.data,
    )


if __name__ == "__main__":
    main()
