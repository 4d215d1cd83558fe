"""Optical-flow nowcast: super batches → flows → forecaster → SSIM.

The evaluation half of the JAX package's ``tools/train_flow_forecaster.py``:
a ``SatelliteFlowLoader`` builds super batches on the device (flows and the
prediction matrix), a ``FlowInMemDataset`` samples 128→64 px crop examples
from the held-out testing range, and the residual forecaster answers them;
each answer is scored by SSIM beside the flow-only prediction and
persistence. The CLI draws the model's weights from a seed; ``evaluate``
takes any model (``train_flow_forecaster.train`` trains one,
``convert.flow_forecaster_from_flax`` loads trained flax weights). The
archive is an HRV zarr array (``--zarr``, ``--zarr-member``) or, without
one, the synthetic archive (``archive``).

    python -m predict_pv_yield_tpu_torch.flow_nowcast --zarr /path/to/hrv.zarr
    python -m predict_pv_yield_tpu_torch.flow_nowcast --synthetic --device cpu --size 160 \
        --forecast-timesteps 12 --batch-size 4 --n-batches 2
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from predict_pv_yield_tpu_torch.data.flow_dataset import FlowInMemDataset, SatelliteFlowLoader
from predict_pv_yield_tpu_torch.data.zarr_reader import open_zarr
from predict_pv_yield_tpu_torch.models.flow_forecaster import (
    FORECASTER_ARCHITECTURES,
    HISTORICAL_SAT_IMAGES,
    OPTICAL_FLOW_PREDICTIONS,
    TARGET_SAT_IMAGE,
)
from predict_pv_yield_tpu_torch.ops.ssim import ssim
from predict_pv_yield_tpu_torch.utils import resolve_device


def _linear_taps(n: int, size: int):
    coords = (np.arange(size, dtype=np.float32) + 0.5) * np.float32(n / size) - 0.5
    coords = np.clip(coords, 0.0, n - 1.0)
    lo = np.floor(coords).astype(np.int64)
    return lo, np.minimum(lo + 1, n - 1), (coords - lo).astype(np.float32)


def _resize_bilinear(image: np.ndarray, size) -> np.ndarray:
    """Bilinear upsample of the last two axes of ``image`` to ``size``, an
    (h, w) pair or an int for a square, half-pixel centres, edges clamped
    (what ``jax.image.resize(..., "bilinear")`` does when upsampling)."""
    height, width = size if isinstance(size, tuple) else (size, size)
    lo, hi, w = _linear_taps(image.shape[-2], height)
    rows = image[..., lo, :] * (1 - w)[:, None] + image[..., hi, :] * w[:, None]
    lo, hi, w = _linear_taps(image.shape[-1], width)
    return rows[..., lo] * (1 - w) + rows[..., hi] * w


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


def drifting_archive(n_days: int = 2, size=256, seed: int = 0):
    """Temporally coherent int16 frames at a 5-minute cadence →
    (frames, datetimes): one smooth cloud field of ``size`` ((h, w), or an
    int for a square) drifting 1 px right and 0.5 px down per frame, as real
    HRV imagery moves, with missing-data (−1) holes in a corner of every 7th
    frame (crops can avoid them)."""
    height, width = size if isinstance(size, tuple) else (size, size)
    rng = np.random.default_rng(seed)
    n = n_days * 24 * 12
    datetimes = np.datetime64("2019-05-20T00:00") + np.arange(n) * np.timedelta64(5, "m")
    coarse = rng.integers(0, 900, size=(height // 16, width // 16)).astype(np.float32)
    field = _resize_bilinear(coarse, (height, width)).astype(np.int16)
    frames = np.stack([np.roll(field, shift=(i // 2, i), axis=(0, 1)) for i in range(n)])
    frames[::7, :8, :16] = -1
    return frames, datetimes


def archive(zarr: Optional[str] = None, zarr_member: Optional[str] = None, size: int = 192):
    """(frames, datetimes, testing_date_range) of the flow CLIs' archive, as
    the JAX package's ``tools/train_flow_forecaster.py`` chooses it.

    With ``zarr``, the lazy HRV array at that path (``zarr_member`` picks
    an array of a group) read by ``open_zarr``; its frames are taken to start
    at 2019-01-01T00:00 at a 5-minute cadence, and 1–14 June 2019 is held
    out for testing (an archive shorter than that has no testing window, and
    evaluation raises ``no valid start times for testing``). Without it, the
    synthetic archive of ``size`` px, testing on 21 May 2019.
    """
    if zarr is None:
        frames, datetimes = synthetic_archive(size=size)
        return frames, datetimes, (np.datetime64("2019-05-21"), np.datetime64("2019-05-22"))
    frames = open_zarr(zarr, zarr_member)
    datetimes = np.datetime64("2019-01-01T00:00") + np.arange(frames.shape[0]) * np.timedelta64(5, "m")
    return frames, datetimes, (np.datetime64("2019-06-01"), np.datetime64("2019-06-14"))


def add_archive_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX tool's archive flags: ``--zarr``, ``--zarr-member``,
    ``--synthetic`` (the synthetic archive is also taken without ``--zarr``)."""
    parser.add_argument("--zarr", help="HRV satellite zarr array path")
    parser.add_argument("--zarr-member", default=None, help="array within a zarr group")
    parser.add_argument("--synthetic", action="store_true")


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
    add_archive_arguments(parser)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=192, help="synthetic frame size")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--n-batches", type=int, default=8)
    parser.add_argument("--arch", default="conv3d", choices=sorted(FORECASTER_ARCHITECTURES))
    parser.add_argument("--channels", type=int, default=None,
                        help="conv width (default: the source notebook's value)")
    parser.add_argument("--forecast-timesteps", type=int, default=48)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    frames, datetimes, testing = archive(None if args.synthetic else args.zarr, args.zarr_member, args.size)
    loader = SatelliteFlowLoader(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=args.forecast_timesteps,
        testing_date_range=testing,
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
