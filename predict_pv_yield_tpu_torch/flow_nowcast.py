"""Optical-flow nowcast: super batches → flows → forecaster → SSIM.

The evaluation half of the JAX package's ``tools/train_flow_forecaster.py``:
a ``SatelliteFlowLoader`` builds super batches on the device (flows and the
prediction matrix), a ``FlowInMemDataset`` samples 128→64 px crop examples
from the held-out testing range, and the residual forecaster answers them;
each answer is scored by SSIM beside the flow-only prediction and
persistence. Training the forecaster is not part of this module yet: the
CLI draws the model's weights from a seed, and ``evaluate`` takes any model
(``convert.flow_forecaster_from_flax`` loads trained flax weights).

    python -m predict_pv_yield_tpu_torch.flow_nowcast --synthetic
    python -m predict_pv_yield_tpu_torch.flow_nowcast --synthetic --device cpu --size 160 \
        --forecast-timesteps 12 --batch-size 4 --n-batches 2
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from predict_pv_yield_tpu_torch.data.flow_dataset import FlowInMemDataset, SatelliteFlowLoader
from predict_pv_yield_tpu_torch.models.flow_forecaster import (
    FORECASTER_ARCHITECTURES,
    HISTORICAL_SAT_IMAGES,
    OPTICAL_FLOW_PREDICTIONS,
    TARGET_SAT_IMAGE,
)
from predict_pv_yield_tpu_torch.ops.ssim import ssim
from predict_pv_yield_tpu_torch.utils import resolve_device


def _resize_bilinear(image: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsample of a square (n, n) image to (size, size), half-pixel
    centres, edges clamped (what ``jax.image.resize(..., "bilinear")`` does
    when upsampling)."""
    n = image.shape[0]
    coords = (np.arange(size, dtype=np.float32) + 0.5) * np.float32(n / size) - 0.5
    coords = np.clip(coords, 0.0, n - 1.0)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    w = (coords - lo).astype(np.float32)
    rows = image[lo] * (1 - w)[:, None] + image[hi] * w[:, None]
    return rows[:, lo] * (1 - w)[None, :] + rows[:, hi] * w[None, :]


def synthetic_archive(n_days: int = 2, size: int = 192, seed: int = 0):
    """Cloud-like int16 frames at a 5-minute cadence → (frames, datetimes):
    16 smooth random fields cycled, each shifted sideways by (i % 11) − 5."""
    rng = np.random.default_rng(seed)
    n = n_days * 24 * 12
    datetimes = np.datetime64("2019-05-20T00:00") + np.arange(n) * np.timedelta64(5, "m")
    coarse = rng.integers(0, 900, size=(16, size // 16, size // 16)).astype(np.float32)
    smooth = [_resize_bilinear(c, size).astype(np.int16) for c in coarse]
    frames = np.empty((n, size, size), dtype=np.int16)
    for i in range(n):
        frames[i] = np.roll(smooth[i % 16], shift=(i % 11) - 5, axis=1)
    return frames, datetimes


def drifting_archive(n_days: int = 2, size: int = 256, seed: int = 0):
    """Temporally coherent int16 frames at a 5-minute cadence →
    (frames, datetimes): one smooth cloud field drifting 1 px right and
    0.5 px down per frame, as real HRV imagery moves, with missing-data (−1)
    holes in a corner of every 7th frame (crops can avoid them)."""
    rng = np.random.default_rng(seed)
    n = n_days * 24 * 12
    datetimes = np.datetime64("2019-05-20T00:00") + np.arange(n) * np.timedelta64(5, "m")
    coarse = rng.integers(0, 900, size=(size // 16, size // 16)).astype(np.float32)
    field = _resize_bilinear(coarse, size).astype(np.int16)
    frames = np.stack([np.roll(field, shift=(i // 2, i), axis=(0, 1)) for i in range(n)])
    frames[::7, :8, :16] = -1
    return frames, datetimes


@torch.no_grad()
def evaluate(
    model: torch.nn.Module,
    loader: SatelliteFlowLoader,
    batch_size: int = 32,
    n_batches: int = 8,
    crop_large: int = 128,
    crop_small: int = 64,
) -> Dict[str, float]:
    """Mean SSIM of the model, the flow-only prediction and persistence over
    ``n_batches`` batches of the loader's testing range.

    All three are scored on the model's own output footprint
    (``crop_target``), with one ``data_range`` per example taken from its
    target and shared by the three methods.
    """
    dataset = FlowInMemDataset(
        loader,
        n_super_batches=1,
        n_examples_per_epoch=n_batches * batch_size,
        batch_size=batch_size,
        batch_type="testing",
        crop_large=crop_large,
        crop_small=crop_small,
        background_refresh=False,
        seed=1,
    )
    border = (crop_large - crop_small) // 2
    centre = (slice(None), slice(border, -border), slice(border, -border))
    scores = {"model": [], "flow": [], "persistence": []}
    for _ in range(n_batches):
        batch = next(iter(dataset))
        prediction = model(batch)
        target = model.crop_target(batch[TARGET_SAT_IMAGE])
        flow_pred = model.crop_target(batch[OPTICAL_FLOW_PREDICTIONS][centre])
        persistence = model.crop_target(batch[HISTORICAL_SAT_IMAGES][:, -1][centre])
        span = target.amax(dim=(-2, -1)) - target.amin(dim=(-2, -1))
        span = torch.where(span == 0, 1.0, span)
        for name, method in (("model", prediction), ("flow", flow_pred), ("persistence", persistence)):
            scores[name].append(ssim(method, target, data_range=span).cpu())
    return {name: float(torch.cat(values).mean()) for name, values in scores.items()}


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic archive (the only source so far)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=192, help="synthetic frame size")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--n-batches", type=int, default=8)
    parser.add_argument("--arch", default="conv3d", choices=sorted(FORECASTER_ARCHITECTURES))
    parser.add_argument("--channels", type=int, default=None,
                        help="conv width (default: the source notebook's value)")
    parser.add_argument("--forecast-timesteps", type=int, default=48)
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only --synthetic is supported: the zarr reader is not ported yet")

    device = resolve_device(args.device)
    frames, datetimes = synthetic_archive(size=args.size)
    loader = SatelliteFlowLoader(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=args.forecast_timesteps,
        testing_date_range=(np.datetime64("2019-05-21"), np.datetime64("2019-05-22")),
        device=device,
    )
    model_cls = FORECASTER_ARCHITECTURES[args.arch]
    generator = torch.Generator().manual_seed(0)
    kwargs = {} if args.channels is None else {"channels": args.channels}
    model = model_cls(generator=generator, **kwargs).to(device).eval()
    scores = evaluate(model, loader, batch_size=args.batch_size, n_batches=args.n_batches)
    for name, value in scores.items():
        print(f"SSIM {name}: {value:.4f}")
    return scores


if __name__ == "__main__":
    main()
