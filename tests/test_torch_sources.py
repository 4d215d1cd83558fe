"""The port's data sources (``data/sources.py``, ``sun.py``, ``geo.py``)
against the JAX package's: every source's ``get_sample`` under the same
rng, the CSV constructors, the window sampler with its ``BadData`` retries,
``collate_samples`` and ``merge_real_groups``. Both sides are numpy, so
every comparison is exact (values, dtypes and shapes; NaN equals NaN).
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu import geo as jgeo
from predict_pv_yield_tpu import sun as jsun
from predict_pv_yield_tpu.data import fake as jfake
from predict_pv_yield_tpu.data import sources as jsources
from predict_pv_yield_tpu.data.zarr_reader import write_zarr

from predict_pv_yield_tpu_torch import geo, sun
from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.data import fake
from predict_pv_yield_tpu_torch.data import sources as tsources
from predict_pv_yield_tpu_torch.data.batch import Batch

MODULES = (jsources, tsources)
START = np.datetime64("2020-06-01T10:00", "ns")
FIVE = np.timedelta64(5, "m")


def assert_same_value(ours, theirs, what=""):
    """Exact equality of two sample values: arrays (dtype, shape, values;
    NaN equal), scalars (type and value) or tuples of them."""
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(theirs), what
        for a, b in zip(ours, theirs):
            assert_same_value(a, b, what)
        return
    if isinstance(theirs, (np.ndarray, np.generic)):
        ours = np.asarray(ours)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (what, ours.dtype, theirs.dtype)
        np.testing.assert_array_equal(ours, theirs, err_msg=what)
        return
    assert type(ours) is type(theirs) and ours == theirs, (what, ours, theirs)


def assert_same_sample(ours, theirs):
    assert list(ours) == list(theirs)
    for key in theirs:
        assert_same_value(ours[key], theirs[key], key)


def assert_same_batch(batch: Batch, theirs) -> None:
    """The port's Batch of CPU tensors equals a JAX package Batch of numpy
    arrays field for field: the same fields set, dtypes, shapes, values."""
    assert isinstance(batch, Batch)
    for group in dataclasses.fields(batch):
        ours_group, their_group = getattr(batch, group.name), getattr(theirs, group.name)
        for f in dataclasses.fields(ours_group):
            a, b = getattr(ours_group, f.name), getattr(their_group, f.name)
            what = f"{group.name}.{f.name}"
            if f.name == "channel_last":
                assert a is bool(b), what
                continue
            assert (a is None) == (b is None), what
            if a is None:
                continue
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu", what
            assert_same_value(a.numpy(), np.asarray(b), what)


def _frames(n=40, channels=2, size=20, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, size, size) if channels is None else (n, channels, size, size)
    data = rng.integers(-1, 1024, size=shape).astype(np.int16)
    return data, START + np.arange(n) * FIVE


def _coords(size):
    return np.arange(size) * 2000.0 + 100_000.0, 700_000.0 - np.arange(size) * 2000.0


@pytest.mark.parametrize("case", ["archive_centre", "centre", "corner_no_coords", "hrv", "no_crop"])
def test_satellite_sample(case):
    data, times = _frames(channels=None if case == "hrv" else 2)
    x, y = _coords(20)
    kwargs = dict(image_size_pixels=8)
    centre = None
    if case == "centre":
        centre = (float(x[5]) + 400.0, float(y[14]))
    elif case == "corner_no_coords":
        x = y = None
    elif case == "hrv":
        kwargs["key_prefix"] = "hrv"
    elif case == "no_crop":
        kwargs = {}
    start, end = START + 3 * FIVE, START + 15 * FIVE
    samples = [
        mod.SatelliteDataSource(data, times, x=x, y=y, **kwargs).get_sample(start, end, end, centre=centre)
        for mod in MODULES
    ]
    assert_same_sample(samples[1], samples[0])


def test_satellite_bad_windows():
    data, times = _frames()
    times = np.delete(times, 10)  # a gap
    data = data[:-1]
    x, y = _coords(20)
    for mod in MODULES:
        source = mod.SatelliteDataSource(data, times, x=x, y=y, image_size_pixels=8)
        with pytest.raises(mod.BadData, match="gap-free"):
            source.get_sample(START, START + 14 * FIVE, START)
        with pytest.raises(mod.BadData, match="outside the archive"):
            source.get_sample(START + 12 * FIVE, START + 20 * FIVE, START, centre=(x[1], y[1]))


def _nwp_canonical(n_init=8, n_step=7, channels=3, size=12, seed=1):
    data = np.random.default_rng(seed).standard_normal((n_init, n_step, channels, size, size)).astype(np.float32)
    inits = np.datetime64("2020-06-01T08:00", "ns") + np.arange(n_init) * np.timedelta64(1, "h")
    return data, inits


@pytest.mark.parametrize("dims", [("init_time", "variable", "step", "y", "x"),
                                  ("step", "x", "init_time", "y", "variable")])
def test_nwp_axis_view_and_sample(tmp_path, dims):
    canonical, inits = _nwp_canonical()
    canonical_dims = ("init_time", "step", "variable", "y", "x")
    stored = np.transpose(canonical, [canonical_dims.index(d) for d in dims])
    store = str(tmp_path / "nwp.zarr")
    write_zarr(os.path.join(store, "data"), stored, chunks=tuple(max(1, s // 2) for s in stored.shape))
    write_zarr(os.path.join(store, "init_time"), inits.astype("datetime64[m]").astype(np.int64),
               chunks=(len(inits),), attrs={"units": "minutes since 1970-01-01T00:00"})
    write_zarr(os.path.join(store, "step"), np.arange(canonical.shape[1]) * 30, chunks=(canonical.shape[1],),
               attrs={"units": "minutes"})
    x, y = _coords(12)
    write_zarr(os.path.join(store, "x"), x, chunks=(12,))
    write_zarr(os.path.join(store, "y"), y, chunks=(12,))

    views = [mod.NWPAxisView(stored, dims) for mod in MODULES]
    for key in [(2,), (slice(1, 5), 3), (0, slice(None), 1, slice(2, 9)), (slice(None), 2, slice(0, 2), 4, 5)]:
        assert_same_value(views[1][key], views[0][key], str(key))
    np.testing.assert_array_equal(views[1][:], canonical)

    start = np.datetime64("2020-06-01T10:20", "ns")
    for centre, size in ((None, 8), ((float(x[6]), float(y[5])), 6), (None, None)):
        samples = [
            mod.open_zarr_nwp(store, dims=dims, image_size_pixels=size, n_targets=4).get_sample(
                start, start + np.timedelta64(90, "m"), start + np.timedelta64(30, "m"), centre=centre)
            for mod in MODULES
        ]
        assert_same_sample(samples[1], samples[0])


@pytest.mark.parametrize("t0_minutes", [0, 20, 60])
def test_nwp_static_targets_and_bad_steps(t0_minutes):
    canonical, inits = _nwp_canonical(n_step=3)
    start = np.datetime64("2020-06-01T09:40", "ns")
    t0 = start + np.timedelta64(t0_minutes, "m")
    end = start + np.timedelta64(60, "m")
    kwargs = dict(step_duration=np.timedelta64(30, "m"))
    samples = [mod.NWPDataSource(canonical, inits, **kwargs).get_sample(start, end, t0) for mod in MODULES]
    assert_same_sample(samples[1], samples[0])
    for mod in MODULES:  # lead times past the archive's 3 steps
        with pytest.raises(mod.BadData, match="exceeds"):
            mod.NWPDataSource(canonical, inits, **kwargs).get_sample(start, start + np.timedelta64(4, "h"), t0)


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(header)
        writer.writerows(rows)
    return str(path)


@pytest.fixture
def pvlive_csv(tmp_path):
    """Half-hourly PVLive rows for 3 GSPs with a duplicate row (pivot_table
    averages it), a missing cell, a NaN and the installedcapacity_mwp name."""
    rows = []
    times = np.datetime64("2020-06-01T09:00") + np.arange(10) * np.timedelta64(30, "m")
    rng = np.random.default_rng(3)
    for t in times:
        for gsp, capacity in ((12, 100.0), (7, 250.0), (31, 80.0)):
            rows.append([str(t), gsp, round(float(rng.uniform(0, capacity)), 3), capacity])
    rows.append([str(times[2]), 7, 111.5, 250.0])  # duplicate (time, gsp)
    rows[3 * 7 + 1][2] = "nan"  # gsp 7 at times[7] NaN
    del rows[3 * 5 + 2]  # gsp 31 at times[5] missing
    return _write_csv(tmp_path / "pvlive.csv", ["datetime_gmt", "gsp_id", "generation_mw", "installedcapacity_mwp"],
                      rows)


def test_gsp_from_pvlive_csv(pvlive_csv):
    sources = [mod.GSPSource.from_pvlive_csv(pvlive_csv, n_gsp_per_example=2) for mod in MODULES]
    for name in ("power", "capacity", "datetimes", "gsp_ids"):
        assert_same_value(getattr(sources[1], name), getattr(sources[0], name), name)
    start = np.datetime64("2020-06-01T09:10", "ns")
    for end_minutes in (60, 120, 200):
        end = start + np.timedelta64(end_minutes, "m")
        if end_minutes == 200:  # the window holds the NaN and the missing cell
            for mod, s in zip(MODULES, sources):
                with pytest.raises(mod.BadData, match="only 1 NaN-free"):
                    s.get_sample(start, end, start, rng=np.random.default_rng(5))
            continue
        samples = [s.get_sample(start, end, start, rng=np.random.default_rng(5)) for s in sources]
        assert_same_sample(samples[1], samples[0])


@pytest.mark.parametrize("variant", ["latlon_generation_wh", "xy_pv_yield"])
def test_pv_from_passiv_csv(tmp_path, variant):
    times = START + np.arange(24) * FIVE
    rng = np.random.default_rng(4)
    ids = [1001, 1002, 1003, 1004]
    power_rows = []
    for t in times:
        for i in ids:
            value = float(rng.uniform(0, 300)) if variant == "latlon_generation_wh" else float(rng.uniform(0, 1))
            power_rows.append([str(t), i, value])
    power_rows[5][2] = "nan"
    value_col = "generation_wh" if variant == "latlon_generation_wh" else "pv_yield"
    power = _write_csv(tmp_path / "power.csv", ["timestamp", "ss_id", value_col], power_rows)
    if variant == "latlon_generation_wh":
        meta = _write_csv(tmp_path / "meta.csv", ["ss_id", "kwp", "latitude", "longitude"],
                          [[1003, 3.5, 51.5, -0.1], [1001, 4.0, 52.1, -1.2], [1002, 2.2, 53.0, -2.5],
                           [9999, 1.0, 50.0, -4.0]])
    else:
        meta = _write_csv(tmp_path / "meta.csv", ["ss_id", "x", "y"],
                          [[1002, 300_000.0, 400_000.0], [1004, 350_000.0, 420_000.0]])
    sources = [mod.PVDataSource.from_passiv_csv(power, meta) for mod in MODULES]
    for name in ("power", "datetimes", "system_ids", "x", "y"):
        assert_same_value(getattr(sources[1], name), getattr(sources[0], name), name)
    start, end = START + 2 * FIVE, START + 14 * FIVE
    for centre in (None, (320_000.0, 410_000.0)):
        samples = [s.get_sample(start, end, start, centre=centre, rng=np.random.default_rng(6)) for s in sources]
        assert_same_sample(samples[1], samples[0])


def test_osgb_and_sun_angles():
    lat, lon = np.array([49.9, 51.5, 54.2, 58.6]), np.array([-6.3, -0.1, -3.0, -3.1])
    for ours, theirs in zip(geo.osgb_from_latlon(lat, lon), jgeo.osgb_from_latlon(lat, lon)):
        assert_same_value(ours, theirs)
    easting, northing = geo.osgb_from_latlon(lat, lon)
    for ours, theirs in zip(geo.latlon_from_osgb(easting, northing), jgeo.latlon_from_osgb(easting, northing)):
        assert_same_value(ours, theirs)
    times = np.datetime64("2020-03-20T00:00", "ns") + np.arange(288) * FIVE
    for refraction in (False, True):
        for ours, theirs in zip(sun.sun_angles_osgb(times, 400_000.0, 300_000.0, refraction=refraction),
                                jsun.sun_angles_osgb(times, 400_000.0, 300_000.0, refraction=refraction)):
            assert_same_value(ours, theirs)
    samples = [mod.SunSource(420_000.0, 350_000.0).get_sample(START, START + 30 * FIVE, START,
                                                              centre=(300_000.0, 500_000.0))
               for mod in MODULES]
    assert_same_sample(samples[1], samples[0])


def test_datetime_features():
    times = np.datetime64("2020-12-31T22:00", "ns") + np.arange(40) * np.timedelta64(7, "m")
    ours, theirs = tsources.datetime_features(times), jsources.datetime_features(times)
    assert_same_sample(ours, theirs)


@pytest.mark.parametrize("size", [None, 6])
def test_topographic(tmp_path, size):
    store = str(tmp_path / "topo.zarr")
    x, y = _coords(16)
    write_zarr(os.path.join(store, "data"), np.random.default_rng(7).uniform(0, 600, (16, 16)), chunks=(8, 8))
    write_zarr(os.path.join(store, "x"), x, chunks=(16,))
    write_zarr(os.path.join(store, "y"), y, chunks=(16,))
    for centre in (None, (float(x[4]), float(y[9]))):
        if size is None and centre is not None:
            continue
        samples = [mod.open_zarr_topographic(store, image_size_pixels=size).get_sample(None, None, None, centre=centre)
                   for mod in MODULES]
        assert_same_sample(samples[1], samples[0])


def _generator(mod, locations=None, all_nan=False):
    """Satellite + PV (with NaN holes that force BadData retries) + sun."""
    data, times = _frames(n=60, channels=2, size=20, seed=8)
    x, y = _coords(20)
    power = np.random.default_rng(9).uniform(0, 1, (60, 3))
    power[10:30, :] = np.nan  # every system missing: windows through here are BadData
    if all_nan:
        power[:] = np.nan
    sources = [
        mod.SatelliteDataSource(data, times, x=x, y=y, image_size_pixels=8),
        mod.PVDataSource(power, times, system_ids=np.array([5, 6, 7]), x=x[[4, 10, 15]], y=y[[4, 10, 15]]),
        mod.SunSource(float(np.median(x)), float(np.median(y))),
    ]
    return mod.SampleGenerator(sources, times, history_minutes=30, forecast_minutes=30, locations=locations)


@pytest.mark.parametrize("located", [False, True])
def test_sample_generator_retries_and_collate(located):
    locations = None
    if located:
        x, y = _coords(20)
        locations = np.stack([x[[6, 10, 13]], y[[6, 10, 13]]], axis=1)
    rngs = [np.random.default_rng(11) for _ in MODULES]
    samples = [_generator(mod, locations).sample(12, rng=rng) for mod, rng in zip(MODULES, rngs)]
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state  # the same draws, retries included
    for ours, theirs in zip(samples[1], samples[0]):
        assert_same_sample(ours, theirs)
    assert_same_batch(tsources.collate_samples(samples[1]), jsources.collate_samples(samples[0]))
    for mod in MODULES:  # no clean PV window at all: the sampler gives up after its retries
        generator = _generator(mod, all_nan=True)
        with pytest.raises(mod.BadData, match="gave up after 21 bad windows"):
            generator.sample(2, rng=np.random.default_rng(12))


def test_merge_real_groups_over_the_filler():
    configuration = Configuration()
    configuration.process.batch_size = 4
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    configuration.input_data.satellite.satellite_channels = configuration.input_data.satellite.satellite_channels[:2]
    from predict_pv_yield_tpu.config.dataset import Configuration as JaxConfiguration

    jconfiguration = JaxConfiguration()
    jconfiguration.process.batch_size = 4
    jconfiguration.input_data = jconfiguration.input_data.set_all_to_defaults()
    jconfiguration.input_data.satellite.satellite_image_size_pixels = 8
    jconfiguration.input_data.satellite.satellite_channels = jconfiguration.input_data.satellite.satellite_channels[:2]

    samples = [_generator(mod).sample(4, rng=np.random.default_rng(13)) for mod in MODULES]
    ours = tsources.merge_real_groups(fake.fake_batch(configuration, np.random.default_rng(14)),
                                      tsources.collate_samples(samples[1]))
    theirs = jsources.merge_real_groups(jfake.fake_batch(jconfiguration, np.random.default_rng(14)),
                                        jsources.collate_samples(samples[0]))
    assert_same_batch(ours, theirs)
    assert ours.pv.pv_system_id.dtype == torch.int32 and ours.nwp.data is not None  # real pv, filler nwp
