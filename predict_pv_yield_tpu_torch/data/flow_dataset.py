"""Super-batch pipeline of the optical-flow nowcast — the port of
``predict_pv_yield_tpu/data/flow_dataset.py``.

* valid daytime start windows with a held-out testing date range;
* a super batch = ``num_forecast_timesteps + 1`` consecutive HRV frames:
  the int16 window moves to the device once, and the −1→NaN decode, the
  8-bit conversion, the flows of every consecutive pair, the normalisation
  and the dense prediction matrix all run there;
* example sampling: strided history, a random forecast horizon and aligned
  128→64 px crops with NaN-rejection retries;
* an in-memory dataset of N super batches with round-robin replacement from
  a background producer thread.

Host-side sampling makes the same numpy RNG calls in the same order as the
JAX module, so the same seed picks the same windows and crops.
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from predict_pv_yield_tpu_torch.consts import SAT_IMAGE_MEAN, SAT_IMAGE_STD
from predict_pv_yield_tpu_torch.models.flow_forecaster import (
    FORECAST_HORIZON,
    HISTORICAL_SAT_IMAGES,
    OPTICAL_FLOW_PREDICTIONS,
    TARGET_SAT_IMAGE,
)
from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence
from predict_pv_yield_tpu_torch.ops.remap import flow_predictions, remap_image
from predict_pv_yield_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)

TIMESTEPS_PER_HOUR = 12
MINUTES_PER_TIMESTEP = 5
SECONDS_PER_TIMESTEP = MINUTES_PER_TIMESTEP * 60
NUM_RETRIES = 5
MAX_RETRIES = 128

#: Forecast-horizon normalisation constants (notebook 13 cell 20).
_HORIZON_SEQ = np.arange(1, 24, dtype=np.float32) * SECONDS_PER_TIMESTEP
FCST_HORIZON_MEAN = _HORIZON_SEQ.mean()
FCST_HORIZON_STD = _HORIZON_SEQ.std()


def normalise_forecast_horizon(forecast_horizon_seconds: float) -> np.float32:
    value = np.float32(forecast_horizon_seconds)
    return (value - FCST_HORIZON_MEAN) / FCST_HORIZON_STD


def convert_10bpp_to_uint8(array: torch.Tensor) -> torch.Tensor:
    """10-bit counts → uint8 for flow estimation; missing data (NaN) → 0.
    Rounds half to even, as numpy does."""
    array = torch.nan_to_num(array.float(), nan=0.0)
    array = array.clamp(0.0, 1023.0) / 4.0
    return array.round().clamp(0, 255).to(torch.uint8)


class ImageHasNansError(Exception):
    pass


def compute_valid_start_times(
    datetimes: np.ndarray,
    num_forecast_timesteps: int,
    testing_date_range: Tuple[np.datetime64, np.datetime64],
) -> Dict[str, np.ndarray]:
    """{'training': dates, 'testing': dates} of valid super-batch starts:
    start hour in (9, 16 − forecast_hours), the testing range held out."""
    datetimes = np.asarray(datetimes, dtype="datetime64[ns]")
    hours = datetimes.astype("datetime64[h]").astype(np.int64) % 24
    forecast_hours = num_forecast_timesteps / TIMESTEPS_PER_HOUR
    mask = (hours > 9) & (hours < 16 - forecast_hours)
    masked = datetimes[mask]
    start, end = testing_date_range
    testing_mask = (np.datetime64(start) < masked) & (np.datetime64(end) > masked)
    return {"training": masked[~testing_mask], "testing": masked[testing_mask]}


@dataclass
class SuperBatch:
    sat_images: torch.Tensor  # (T, H, W) normalised float32 (NaNs preserved)
    flows: torch.Tensor  # (T-1, H, W, 2)
    #: (T-1, T-1, H, W) dense prediction matrix, or None when the loader runs
    #: with precompute_predictions=False (O(T²·H·W) memory at real frame
    #: sizes); predictions are then warped lazily per sampled example.
    predictions: Optional[torch.Tensor]
    datetimes: np.ndarray  # (T,)

    def prediction(self, t0_idx: int, step: int) -> torch.Tensor:
        """Prediction for timestep ``t0_idx + step`` from source ``t0_idx``."""
        if self.predictions is not None:
            return self.predictions[t0_idx, step - 1]
        return remap_image(self.sat_images[t0_idx], self.flows[t0_idx] * float(step))


@dataclass
class SatelliteFlowLoader:
    """Builds super batches from an int16 satellite archive on ``device``.

    ``data`` is any (T, H, W) int16-like array (−1 encodes missing) with a
    matching (T,) datetime index. ``device`` defaults to ``"cuda"`` and
    raises without a card; pass ``device="cpu"`` to run on the CPU.
    """

    data: np.ndarray
    datetimes: np.ndarray
    num_forecast_timesteps: int = 48
    testing_date_range: Tuple[np.datetime64, np.datetime64] = (
        np.datetime64("2019-06-01"),
        np.datetime64("2019-06-14"),
    )
    rng_seed: Optional[int] = 42
    precompute_predictions: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.rng = np.random.default_rng(self.rng_seed)
        self.valid_start_times = compute_valid_start_times(
            self.datetimes, self.num_forecast_timesteps, self.testing_date_range
        )
        self._time_index = {
            t: i for i, t in enumerate(np.asarray(self.datetimes, dtype="datetime64[ns]"))
        }

    def load_satellite_window(self, batch_type: str = "training") -> Tuple[np.ndarray, np.ndarray]:
        """A (num_forecast_timesteps+1)-frame contiguous window from a valid
        start (NUM_RETRIES tries on ragged coverage), on the host."""
        starts = self.valid_start_times[batch_type]
        if len(starts) == 0:
            raise ValueError(f"no valid start times for {batch_type}")
        window = self.num_forecast_timesteps + 1
        for _ in range(NUM_RETRIES):
            start = self.rng.choice(starts)
            i = self._time_index[start]
            if i + window > len(self.data):
                continue
            times = np.asarray(self.datetimes[i : i + window], dtype="datetime64[ns]")
            # positional slicing must not span archive gaps
            if not np.all(np.diff(times) == np.timedelta64(MINUTES_PER_TIMESTEP, "m")):
                continue
            frames = np.asarray(self.data[i : i + window])
            return frames, times
        raise ValueError(f"Failed to find valid data after {NUM_RETRIES} retries!")

    def load_super_batch(self, batch_type: str = "training") -> SuperBatch:
        raw, times = self.load_satellite_window(batch_type)
        # the int16 window crosses to the device once; all else runs there
        raw = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.int16)).to(self.device)

        # int16 archive: −1 encodes NaN
        decoded = torch.where(raw == -1, torch.nan, raw.float())
        # flow on 8-bit imagery, all pairs in one batch
        flows = flow_sequence(convert_10bpp_to_uint8(decoded).float())
        # warp the NaN-preserving normalised frames: missing pixels and the
        # warp's out-of-bounds border both surface as NaN for the sampler
        normalised = (decoded - float(SAT_IMAGE_MEAN)) / float(SAT_IMAGE_STD)
        preds = flow_predictions(normalised, flows) if self.precompute_predictions else None
        return SuperBatch(sat_images=normalised, flows=flows, predictions=preds, datetimes=times)


def sample_squares(
    example: Dict[str, torch.Tensor],
    rng: np.random.Generator,
    n_pixels_per_side_large: int = 128,
    n_pixels_per_side_small: int = 64,
) -> Dict[str, torch.Tensor]:
    """Aligned random crops: 128 px context (history + flow prediction),
    64 px centred target; NaNs anywhere → ImageHasNansError."""
    large_names = (OPTICAL_FLOW_PREDICTIONS, HISTORICAL_SAT_IMAGES)
    small_names = (TARGET_SAT_IMAGE,)
    height, width = example[large_names[0]].shape[-2:]
    if height < n_pixels_per_side_large or width < n_pixels_per_side_large:
        raise ValueError("super batch smaller than the large crop size")

    out = dict(example)
    top = rng.integers(0, height - n_pixels_per_side_large + 1)
    left = rng.integers(0, width - n_pixels_per_side_large + 1)
    border = (n_pixels_per_side_large - n_pixels_per_side_small) // 2

    def crop(names, t, l, size):
        for name in names:
            image = out[name][..., t : t + size, l : l + size]
            if bool(torch.isnan(image).any()):
                raise ImageHasNansError(f"{name} has NaNs!")
            out[name] = image

    crop(large_names, top, left, n_pixels_per_side_large)
    crop(small_names, top + border, left + border, n_pixels_per_side_small)
    return out


def super_batch_to_example(
    super_batch: SuperBatch,
    rng: np.random.Generator,
    n_historical_images: int = 4,
    history_stride: int = 3,
    n_pixels_per_side_large: int = 128,
    n_pixels_per_side_small: int = 64,
) -> Dict[str, torch.Tensor]:
    """One example: strided history up to t0, a random valid forecast
    horizon, the matching flow prediction, aligned crops."""
    n_frames = len(super_batch.sat_images)
    total_hist = n_historical_images * history_stride
    max_hist_start = n_frames - total_hist - 1
    if max_hist_start < 0:
        raise ValueError(
            f"super batch of {n_frames} frames too short for "
            f"{n_historical_images}x{history_stride} history + 1 forecast frame"
        )

    for _ in range(MAX_RETRIES):
        hist_start = int(rng.integers(0, max_hist_start + 1))
        hist_end = hist_start + total_hist
        t0_idx = hist_end - 1

        max_step = n_frames - 1 - t0_idx  # triangle validity
        step = int(rng.integers(1, max_step + 1))

        example = {
            TARGET_SAT_IMAGE: super_batch.sat_images[t0_idx + step],
            FORECAST_HORIZON: normalise_forecast_horizon(step * SECONDS_PER_TIMESTEP),
            HISTORICAL_SAT_IMAGES: super_batch.sat_images[hist_start:hist_end:history_stride],
            OPTICAL_FLOW_PREDICTIONS: super_batch.prediction(t0_idx, step),
        }
        for _ in range(MAX_RETRIES):
            try:
                return sample_squares(
                    example,
                    rng=rng,
                    n_pixels_per_side_large=n_pixels_per_side_large,
                    n_pixels_per_side_small=n_pixels_per_side_small,
                )
            except ImageHasNansError:
                continue
    raise ImageHasNansError(
        f"Cropped images still have NaNs, even after {MAX_RETRIES**2} retries!"
    )


class FlowInMemDataset:
    """N resident super batches → stream of example batches on the loader's
    device.

    A background thread produces fresh super batches into a bounded queue;
    after each epoch slice one resident super batch is replaced round-robin.
    The thread runs for the life of the process, as the JAX package's does;
    at interpreter exit it is let finish the super batch it is building and
    end, since a thread killed inside a PyTorch call aborts the process.
    """

    def __init__(
        self,
        loader: SatelliteFlowLoader,
        n_super_batches: int = 8,
        n_examples_per_epoch: int = 4096,
        batch_size: int = 64,
        batch_type: str = "training",
        crop_large: int = 128,
        crop_small: int = 64,
        background_refresh: bool = True,
        seed: int = 42,
    ):
        self.loader = loader
        self.n_super_batches = n_super_batches
        self.n_examples_per_epoch = n_examples_per_epoch
        self.batch_size = batch_size
        self.batch_type = batch_type
        self.crop_large = crop_large
        self.crop_small = crop_small
        self.rng = np.random.default_rng(seed)
        self._replace_next = 0

        self.super_batches = [
            loader.load_super_batch(batch_type) for _ in range(n_super_batches)
        ]

        self._queue: Optional[queue.Queue] = None
        if background_refresh:
            self._queue = queue.Queue(maxsize=2)
            self._exiting = threading.Event()
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
            atexit.register(self._end_producer)

    def _producer(self):
        while not self._exiting.is_set():
            try:
                batch = self.loader.load_super_batch(self.batch_type)
            except Exception as exc:
                # a transient load failure (gappy archive window, retry
                # exhaustion) must not kill the refresh thread for good
                log.warning("super-batch producer failed (%s); retrying", exc)
                time.sleep(1.0)
                continue
            self._queue.put(batch)

    def _end_producer(self):
        self._exiting.set()
        with contextlib.suppress(queue.Empty):
            self._queue.get_nowait()  # frees a put blocked on a full queue
        self._thread.join()

    def _refresh_one(self):
        if self._queue is None:
            return
        try:
            fresh = self._queue.get_nowait()
        except queue.Empty:
            return
        self.super_batches[self._replace_next] = fresh
        self._replace_next = (self._replace_next + 1) % self.n_super_batches

    def _example(self) -> Dict[str, torch.Tensor]:
        super_batch = self.super_batches[int(self.rng.integers(0, self.n_super_batches))]
        return super_batch_to_example(
            super_batch,
            rng=self.rng,
            n_pixels_per_side_large=self.crop_large,
            n_pixels_per_side_small=self.crop_small,
        )

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        n_batches = self.n_examples_per_epoch // self.batch_size
        for _ in range(n_batches):
            examples = [self._example() for _ in range(self.batch_size)]
            yield {key: self._collate([e[key] for e in examples]) for key in examples[0]}
        self._refresh_one()

    def _collate(self, values) -> torch.Tensor:
        """Stack one field of a batch: crops are already on the device; host
        scalars (the horizon) cross in one copy."""
        if isinstance(values[0], torch.Tensor):
            return torch.stack(values).float()
        return torch.as_tensor(np.stack(values), dtype=torch.float32, device=self.loader.device)
