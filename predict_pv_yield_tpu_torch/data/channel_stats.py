"""Per-channel satellite archive statistics — the mean/std notebook lineage
(a copy of the JAX package's ``data/channel_stats.py``).

The reference derives its normalisation constants (``SAT_MEAN`` / ``SAT_STD``,
``consts.py``) by scanning the whole int16 satellite zarr archive with the
−1 → NaN decode and reducing over ``(time, x, y)`` per channel
(``notebooks/mean_and_std_of_satellite_imagery.ipynb`` cells 6–11: mean, std,
max, min via dask/xarray). This module is the native equivalent: a streaming
single-pass moment accumulator over chunk-aligned time slabs, so archives far
larger than memory reduce in O(channels) state. Host-side numpy — the work is
IO-bound archive scanning, not device math.

Semantics matched to the notebook:

* decode: ``astype(float32).where(x != -1, NaN)`` (cell 7) — exactly the
  value −1 is missing data, everything else (including 0) is signal;
* ``std`` is population std (xarray's default ``ddof=0``, cell 9);
* NaNs are skipped by every reduction (xarray skipna default).

Accumulation runs in float64 (the float32 archive values are exactly
representable, so sums lose nothing and cancellation in
``E[x²] − E[x]²`` stays benign at archive scale).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class ChannelStatsAccumulator:
    """Single-pass nan-aware per-channel count/sum/sumsq/min/max."""

    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.count = np.zeros(n_channels, dtype=np.int64)
        self.sum = np.zeros(n_channels, dtype=np.float64)
        self.sumsq = np.zeros(n_channels, dtype=np.float64)
        self.min = np.full(n_channels, np.inf, dtype=np.float64)
        self.max = np.full(n_channels, -np.inf, dtype=np.float64)

    def update(self, slab: np.ndarray, channel_axis: int = -1) -> None:
        """Fold one archive slab in. ``slab`` is raw int16 (or any numeric)
        with the −1 missing-data convention; any axis layout, one channel
        axis."""
        slab = np.moveaxis(slab, channel_axis, -1)
        flat = slab.reshape(-1, slab.shape[-1])
        if flat.shape[0] == 0:  # empty slab: nothing to fold in
            return
        # the notebook's decode: exactly -1 is missing (cell 7); NaNs in an
        # already-float archive are also missing (skipna)
        valid = flat != -1
        if flat.dtype.kind == "f":
            valid &= ~np.isnan(flat)
        # masked float64-ACCUMULATED reductions over the raw slab — no
        # widened copy of the data: a full float64 + where-zeroed twin of a
        # hundreds-of-MB int16 slab was several GB of transient allocations
        # for an O(channels) accumulator
        self.count += valid.sum(axis=0)
        self.sum += np.sum(flat, axis=0, dtype=np.float64, where=valid)
        # one widened temp (the squares must be float64 — int16² overflows);
        # masked lanes are excluded by `where`, so no zeroed copy is needed
        squares = np.square(flat, dtype=np.float64)
        self.sumsq += np.sum(squares, axis=0, where=valid)
        if flat.dtype.kind == "f":
            lo_init, hi_init = np.inf, -np.inf
        else:  # `initial` must be representable in the slab's dtype
            info = np.iinfo(flat.dtype)
            lo_init, hi_init = info.max, info.min
        lo = np.min(flat, axis=0, initial=lo_init, where=valid).astype(np.float64)
        hi = np.max(flat, axis=0, initial=hi_init, where=valid).astype(np.float64)
        # all-invalid columns: the initial leaks through — neutralise it so
        # only truly observed values move the running extrema
        none_valid = ~valid.any(axis=0)
        lo = np.where(none_valid, np.inf, lo)
        hi = np.where(none_valid, -np.inf, hi)
        self.min = np.minimum(self.min, lo)
        self.max = np.maximum(self.max, hi)

    def result(
        self, channel_names: Optional[Sequence[str]] = None
    ) -> Dict[str, Dict[str, float]]:
        """Per-channel ``{name: {mean, std, min, max, count}}``.

        Channels with zero valid samples report NaN statistics (what
        xarray's reductions produce on an all-NaN slice)."""
        if channel_names is None:
            channel_names = [str(i) for i in range(self.n_channels)]
        if len(channel_names) != self.n_channels:
            raise ValueError(
                f"{len(channel_names)} names for {self.n_channels} channels"
            )
        out: Dict[str, Dict[str, float]] = {}
        for i, name in enumerate(channel_names):
            n = int(self.count[i])
            if n == 0:
                mean = std = lo = hi = float("nan")
            else:
                mean = self.sum[i] / n
                var = max(self.sumsq[i] / n - mean * mean, 0.0)
                std = float(np.sqrt(var))  # ddof=0, the notebook's xr default
                lo, hi = float(self.min[i]), float(self.max[i])
            out[name] = {
                "mean": float(mean), "std": std, "min": lo, "max": hi,
                "count": n,
            }
        return out


def iter_time_slabs(
    array, slab_timesteps: Optional[int] = None
) -> Iterable[np.ndarray]:
    """Yield chunk-aligned slabs of ``array`` along axis 0.

    ``slab_timesteps`` defaults to the zarr time-chunk length so every slab
    read decompresses each chunk exactly once (the dask behaviour the
    notebook gets for free)."""
    if slab_timesteps is None:
        chunks = getattr(array, "chunks", None)
        slab_timesteps = chunks[0] if chunks else max(1, min(len(array), 64))
    for start in range(0, array.shape[0], slab_timesteps):
        yield np.asarray(array[start : start + slab_timesteps])


def compute_channel_stats(
    array,
    channel_axis: int = -1,
    channel_names: Optional[Sequence[str]] = None,
    slab_timesteps: Optional[int] = None,
) -> Dict[str, Dict[str, float]]:
    """Scan a (time, ..., channel) archive array and reduce per channel.

    ``array`` is anything sliceable along axis 0 with ``.shape`` (a
    ``ZarrArray``, an ``np.ndarray``, a memmap)."""
    n_channels = array.shape[channel_axis % len(array.shape)]
    acc = ChannelStatsAccumulator(n_channels)
    for slab in iter_time_slabs(array, slab_timesteps):
        acc.update(slab, channel_axis=channel_axis)
    return acc.result(channel_names)
