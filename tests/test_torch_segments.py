"""The port's ``data/segments.py`` against the JAX package's: contiguous
segments, zarr chunk sequences, random windows under the same rng, and the
freshest-run NWP selection with its ceil(t0) freeze. Exact: both are numpy.
"""

import numpy as np
import pytest

from predict_pv_yield_tpu.data import segments as jsegments

from predict_pv_yield_tpu_torch.data import segments

FIVE = np.timedelta64(5, "m")
START = np.datetime64("2020-06-01T04:00", "ns")


def _index(seed=0, n=400):
    """A 5-minute index with random gaps of 1-12 missing steps."""
    rng = np.random.default_rng(seed)
    steps = np.cumsum(np.where(rng.random(n) < 0.05, rng.integers(2, 13, n), 1))
    return START + steps * FIVE


def _same_segments(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert isinstance(a, segments.Segment)
        assert (a.start, a.end) == (b.start, b.end) and a.start.dtype == b.start.dtype


@pytest.mark.parametrize("seed,min_timesteps", [(0, 1), (1, 13), (2, 40)])
def test_contiguous_segments(seed, min_timesteps):
    index = _index(seed)
    _same_segments(segments.get_contiguous_segments(index, min_timesteps, FIVE),
                   jsegments.get_contiguous_segments(index, min_timesteps, FIVE))
    assert segments.get_contiguous_segments(index[:0], 1, FIVE) == []


@pytest.mark.parametrize("seed,n_segments", [(0, 1), (3, 25)])
def test_random_segments_same_rng(seed, n_segments):
    source = jsegments.get_contiguous_segments(_index(seed), 10, FIVE)
    duration = np.timedelta64(90, "m")
    rngs = [np.random.default_rng(seed), np.random.default_rng(seed)]
    ours = segments.get_random_segments(source, duration, n_segments, rng=rngs[0])
    theirs = jsegments.get_random_segments(source, duration, n_segments, rng=rngs[1])
    _same_segments(ours, theirs)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state
    with pytest.raises(ValueError, match="at least"):
        segments.get_random_segments(source, np.timedelta64(100, "D"), 1, rng=rngs[0])


def test_zarr_chunk_sequences():
    contiguous = jsegments.get_contiguous_segments(_index(4), 5, FIVE)
    boundaries = START + np.arange(0, 40 * 16 + 1, 16) * FIVE
    for n_chunks in (1, 2, 5):
        _same_segments(segments.get_zarr_chunk_sequences(n_chunks, boundaries, contiguous),
                       jsegments.get_zarr_chunk_sequences(n_chunks, boundaries, contiguous))
    with pytest.raises(ValueError, match="bracketed"):
        segments.get_zarr_chunk_sequences(2, boundaries[:3], contiguous)


@pytest.mark.parametrize("start,t0,end", [
    ("10:00", "11:00", "12:00"),  # aligned on the hour
    ("10:05", "11:20", "12:35"),  # misaligned: the freeze is ceil(t0) = 12:00
    ("10:40", "10:40", "11:10"),  # t0 at the start
    ("09:55", "12:00", "12:00"),  # t0 at the end
])
@pytest.mark.parametrize("cadence_minutes", [60, 180])
def test_select_nwp_init_times(start, t0, end, cadence_minutes):
    inits = np.datetime64("2020-06-01T06:00", "ns") + np.arange(12) * np.timedelta64(cadence_minutes, "m")
    day = "2020-06-01T"
    args = [np.datetime64(day + s, "ns") for s in (start, end, t0)]
    ours = segments.select_nwp_init_times(inits, start=args[0], end=args[1], t0=args[2])
    theirs = jsegments.select_nwp_init_times(inits, start=args[0], end=args[1], t0=args[2])
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no NWP run"):
        segments.select_nwp_init_times(inits[3:], start=args[0] - np.timedelta64(1, "D"), end=args[1], t0=args[2])
