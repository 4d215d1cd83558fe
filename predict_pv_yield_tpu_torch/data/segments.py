"""Contiguous-timeseries segmentation — the notebook-28 loader lineage (a
copy of the JAX package's ``data/segments.py``; pure numpy, so the windows
drawn here equal the JAX package's under the same rng).

The reference's data-pipeline research (SURVEY §2.5.2 family 3,
``notebooks/28.0_manual_processes.ipynb`` cells 75–92 — the notebook that
evolved into ``nowcasting_dataset``) builds training windows in three steps:
chunk a satellite datetime index into gap-free segments
(``get_contiguous_segments``, cell 75), expand each segment into fixed-length
runs of whole zarr chunks for efficient disk loads
(``get_zarr_chunk_sequences``, cell 79), and sample example windows with
probability proportional to segment duration (``get_random_segments``,
cell 92). These are host-side index computations — pure numpy, no device
work — used by archive-preparation tooling and the flow super-batch loader.

Datetimes are ``np.datetime64`` throughout (a ``pd.DatetimeIndex`` is
accepted anywhere an index is expected — it converts cleanly).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class Segment(NamedTuple):
    """Start and end datetimes of a contiguous run of samples.

    The segment covers the inclusive range ``[start, end]`` (notebook 28
    cell 75).
    """

    start: np.datetime64
    end: np.datetime64

    def duration(self) -> np.timedelta64:
        return self.end - self.start


def _as_datetime64(index) -> np.ndarray:
    arr = np.asarray(index)
    if not np.issubdtype(arr.dtype, np.datetime64):
        arr = arr.astype("datetime64[ns]")
    return arr


def get_contiguous_segments(
    dt_index, min_timesteps: int, max_gap: np.timedelta64
) -> List[Segment]:
    """Chunk a datetime index into contiguous segments ≥ ``min_timesteps``.

    ``max_gap`` is the threshold between consecutive timesteps beyond which a
    new segment starts; runs shorter than ``min_timesteps`` are discarded
    (notebook 28 cell 75 semantics, including the inclusive segment ends).
    """
    dt_index = _as_datetime64(dt_index)
    if len(dt_index) == 0:
        return []
    max_gap = np.timedelta64(max_gap)

    gap_mask = np.diff(dt_index) > max_gap
    # index of the timestep immediately before each gap, +1 = segment starts
    segment_boundaries = np.argwhere(gap_mask)[:, 0] + 1
    segment_boundaries = np.concatenate((segment_boundaries, [len(dt_index)]))

    segments = []
    start_i = 0
    for end_i in segment_boundaries:
        if end_i - start_i >= min_timesteps:
            segments.append(Segment(start=dt_index[start_i], end=dt_index[end_i - 1]))
        start_i = end_i
    return segments


def get_zarr_chunk_sequences(
    n_chunks_per_disk_load: int,
    zarr_chunk_boundaries,
    contiguous_segments: List[Segment],
) -> List[Segment]:
    """Sliding sequences of whole zarr chunks covering each contiguous segment.

    For every contiguous segment, emit overlapping ``Segment``s spanning
    ``n_chunks_per_disk_load`` chunks each, advanced one chunk at a time and
    clipped to the segment's ends, so every example window of up to
    ``n_chunks_per_disk_load - 1`` chunks' length lies wholly inside at least
    one sequence (notebook 28 cell 79 — see its ASCII diagram). At least one
    side of each sequence lies on a natural chunk boundary.

    ``zarr_chunk_boundaries`` must bracket every segment (first boundary ≤
    segment start, last boundary ≥ segment end — i.e. include the archive's
    END boundary, not just chunk starts). The notebook assumes this silently
    and crashes or wraps around when violated; raising is the native
    behaviour.
    """
    if n_chunks_per_disk_load <= 0:
        raise ValueError("n_chunks_per_disk_load must be positive")
    zarr_chunk_boundaries = _as_datetime64(zarr_chunk_boundaries)
    if len(zarr_chunk_boundaries) == 0:
        raise ValueError("zarr_chunk_boundaries must be non-empty")

    sequences: List[Segment] = []
    for segment in contiguous_segments:
        if (
            segment.start < zarr_chunk_boundaries[0]
            or segment.end > zarr_chunk_boundaries[-1]
        ):
            raise ValueError(
                f"{segment} is not bracketed by zarr_chunk_boundaries "
                f"[{zarr_chunk_boundaries[0]} .. {zarr_chunk_boundaries[-1]}]"
            )
        # chunk boundary at or before the segment start
        i = int(np.searchsorted(zarr_chunk_boundaries, segment.start))
        if i == len(zarr_chunk_boundaries) or zarr_chunk_boundaries[i] > segment.start:
            i -= 1
        start = segment.start
        while True:
            j = min(i + n_chunks_per_disk_load, len(zarr_chunk_boundaries) - 1)
            end = min(zarr_chunk_boundaries[j], segment.end)
            sequences.append(Segment(start=start, end=end))
            if end == segment.end:
                break
            i += 1
            start = zarr_chunk_boundaries[i]
    return sequences


def _floor_hour(t: np.datetime64) -> np.datetime64:
    return t.astype("datetime64[h]").astype(t.dtype)


def _ceil_hour(t: np.datetime64) -> np.datetime64:
    floored = _floor_hour(t)
    if floored == t:
        return t
    return floored + np.timedelta64(1, "h")


def select_nwp_init_times(
    init_times, start, end, t0
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Freshest-run NWP selection for one example window — notebook 28 cell 85.

    Returns ``(target_times_hourly, chosen_init_times, steps)`` where
    ``target_times_hourly`` is the hourly grid from ``floor(start)`` to
    ``ceil(end)`` inclusive, and for each target time:

    * recent history (target ≤ ``ceil(t0)``): the prediction produced by the
      freshest NWP run initialised at or before that target (pandas
      ``sel(method='ffill')`` semantics);
    * future (target > ``ceil(t0)``): every target uses the single init time
      chosen for ``ceil(t0)``.

    Note the notebook's quirk, replicated faithfully: the freeze point is
    ``ceil(t0)``, not ``t0``, so with sub-hourly init cadence the "future"
    can use a run initialised up to 59 minutes AFTER now (e.g. hourly runs,
    t0 04:20 → future frozen on the 05:00 run). The same applies to history
    targets in ``(t0, ceil(t0)]``. Pinned by a regression test; don't "fix"
    without breaking parity with nowcasting_dataset's ancestor.

    ``steps`` is the per-target lead time ``target − init``. ``init_times``
    must be sorted ascending and cover ``floor(start)`` (the notebook's
    ``ffill`` would produce NaT there; raising is the native behaviour).
    """
    init_times = _as_datetime64(init_times)
    if len(init_times) == 0:
        raise ValueError("init_times must be non-empty")
    start, end, t0 = (np.datetime64(x) for x in (start, end, t0))
    if not (start <= t0 <= end):
        raise ValueError(f"need start <= t0 <= end, got {start} {t0} {end}")

    start_hourly = _floor_hour(start)
    t0_hourly = _ceil_hour(t0)
    end_hourly = _ceil_hour(end)
    hour = np.timedelta64(1, "h")
    n = int((end_hourly - start_hourly) / hour) + 1
    target_times = start_hourly + np.arange(n) * hour

    # ffill: index of the latest init_time <= each target
    idx = np.searchsorted(init_times, target_times, side="right") - 1
    if idx[0] < 0:
        raise ValueError(
            f"no NWP run initialised at or before {target_times[0]}"
        )
    chosen = init_times[idx]
    future = target_times > t0_hourly
    if future.any():
        t0_init = chosen[target_times == t0_hourly]
        chosen = np.where(future, t0_init[0], chosen)
    steps = target_times - chosen
    return target_times, chosen, steps


def get_random_segments(
    source_segments: List[Segment],
    duration: np.timedelta64,
    n_segments: int,
    rng: Optional[np.random.Generator] = None,
    freq: np.timedelta64 = np.timedelta64(5, "m"),
) -> List[Segment]:
    """``n_segments`` windows of ``duration``, sampled ∝ segment duration.

    Each returned segment starts on the ``freq`` grid of its source segment
    and lies wholly inside it (notebook 28 cell 92). Source segments shorter
    than ``duration`` get zero sampling probability here — the notebook gives
    them positive probability and crashes if one is drawn; masking them is
    the deliberate divergence.
    """
    if not source_segments:
        raise ValueError("source_segments must be non-empty")
    if rng is None:
        rng = np.random.default_rng()
    duration = np.timedelta64(duration)
    freq = np.timedelta64(freq)

    durations = np.array(
        [segment.duration() / freq for segment in source_segments], dtype=np.float64
    )
    eligible = durations >= duration / freq
    if not eligible.any():
        raise ValueError(f"no source segment is at least {duration} long")
    probs = np.where(eligible, durations, 0.0)
    probs /= probs.sum()

    out: List[Segment] = []
    for _ in range(n_segments):
        k = int(rng.choice(len(source_segments), p=probs))
        seg_start, seg_end = source_segments[k]
        # inclusive of the latest grid-aligned start (the notebook's
        # ``rng.choice(n_poss_start_timesteps)`` excludes it and crashes on a
        # segment exactly ``duration`` long — a latent off-by-one, not
        # replicated)
        n_possible_starts = int((seg_end - duration - seg_start) / freq) + 1
        start = seg_start + int(rng.integers(n_possible_starts)) * freq
        end = start + duration
        assert start >= seg_start and end <= seg_end
        out.append(Segment(start, end))
    return out
