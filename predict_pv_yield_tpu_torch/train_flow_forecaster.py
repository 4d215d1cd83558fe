"""Train the optical-flow residual forecaster — the port of the JAX
package's ``tools/train_flow_forecaster.py`` (notebook 13 as a script).

A ``SatelliteFlowLoader`` builds super batches on the device (flows and the
dense prediction matrix), a ``FlowInMemDataset`` samples 128→64 px crop
examples from them while a background thread builds fresh ones, and one of
the four forecasters trains with MSE against the true future frame (Adam,
lr 1e-4); ``flow_nowcast.evaluate`` then scores the model, the flow-only
prediction and persistence by SSIM on the held-out testing range. The
model's weights are drawn from seed 0.

    python -m predict_pv_yield_tpu_torch.train_flow_forecaster --zarr /path/to/hrv.zarr --steps 500
    python -m predict_pv_yield_tpu_torch.train_flow_forecaster --synthetic --steps 50
    python -m predict_pv_yield_tpu_torch.train_flow_forecaster --synthetic --device cpu --steps 20 \\
        --batch-size 2 --n-super-batches 1 --forecast-timesteps 12 --crop-large 32 --crop-small 16 --channels 4
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable

import torch

from predict_pv_yield_tpu_torch.data.flow_dataset import FlowInMemDataset, SatelliteFlowLoader
from predict_pv_yield_tpu_torch.flow_nowcast import add_archive_arguments, archive, evaluate
from predict_pv_yield_tpu_torch.models.flow_forecaster import FORECASTER_ARCHITECTURES, TARGET_SAT_IMAGE
from predict_pv_yield_tpu_torch.utils import resolve_device

#: steps between progress lines (the loss reaches the host only there)
LOG_EVERY = 20


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One optimiser step on the MSE of ``model(batch)`` against the target
    frame → the loss, left on the device."""
    prediction = model(batch)
    # each architecture's stride/padding pyramid emits its own output size;
    # crop_target aligns the label to it
    loss = torch.mean((prediction - model.crop_target(batch[TARGET_SAT_IMAGE])) ** 2)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train(model: torch.nn.Module, dataset: Iterable[Dict[str, torch.Tensor]], steps: int, lr: float = 1e-4) -> torch.Tensor:
    """``steps`` Adam steps (``torch.optim.Adam(lr)``, optax's ``adam`` at
    its defaults) on the batches of ``dataset`` → the per-step losses, (steps,)
    on the CPU. Prints ``step N: mse=… (… ex/s)`` every ``LOG_EVERY`` steps."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    start = time.perf_counter()
    for batch in dataset:
        losses.append(train_step(model, optimizer, batch))
        step = len(losses)
        if step % LOG_EVERY == 0:
            examples = step * len(batch[TARGET_SAT_IMAGE])
            print(f"step {step}: mse={float(losses[-1]):.5f} "
                  f"({examples / (time.perf_counter() - start):.1f} ex/s)", flush=True)
        if step >= steps:
            break
    return torch.stack(losses).cpu()


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__)
    add_archive_arguments(parser)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument(
        "--arch", default="conv3d",
        help="forecaster architecture: notebook 13 Conv3d (default), notebook 14 2-D conv AE "
        "(conv2d_ae), notebook 16 max-pool AE (maxpool_ae), or the notebook 12 pre-flow "
        "pure-3D-conv control (pure_conv3d)",
    )
    parser.add_argument("--channels", type=int, default=None,
                        help="conv width (default: the source notebook's value)")
    parser.add_argument("--n-super-batches", type=int, default=4)
    parser.add_argument("--forecast-timesteps", type=int, default=48)
    parser.add_argument("--crop-large", type=int, default=128)
    parser.add_argument("--crop-small", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.arch not in FORECASTER_ARCHITECTURES:
        parser.error(f"--arch {args.arch!r}: choose from {sorted(FORECASTER_ARCHITECTURES)}")

    device = resolve_device(args.device)
    frames, datetimes, testing = archive(None if args.synthetic else args.zarr, args.zarr_member)
    loader = SatelliteFlowLoader(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=args.forecast_timesteps,
        testing_date_range=testing,
        device=device,
    )
    dataset = FlowInMemDataset(
        loader,
        n_super_batches=args.n_super_batches,
        n_examples_per_epoch=args.steps * args.batch_size,
        batch_size=args.batch_size,
        crop_large=args.crop_large,
        crop_small=args.crop_small,
    )
    kwargs = {} if args.channels is None else {"channels": args.channels}
    model = FORECASTER_ARCHITECTURES[args.arch](generator=torch.Generator().manual_seed(0), **kwargs).to(device)
    train(model, dataset, args.steps, args.lr)

    # SSIM of model vs flow-only vs persistence on the held-out testing range
    scores = evaluate(model, loader, batch_size=args.batch_size, n_batches=8,
                      crop_large=args.crop_large, crop_small=args.crop_small)
    for name, value in scores.items():
        print(f"SSIM {name}: {value:.4f}")
    return scores


if __name__ == "__main__":
    main()
