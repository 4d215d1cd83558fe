"""The port's ``ZarrStreamDataModule`` against the JAX package's on the
learnable synthetic archive (satellite zarr, PVLive CSV, NWP zarr): the
archive files byte for byte, then the train and validation batches field
for field at ``num_workers`` 0 and 2 over two epochs (shuffle order
included), with and without a GSP source (the filler-target redraw), with
pandas importable only inside the CSV constructors and h5py, fsspec and
zstandard not at all. ``datamodule=zarr_stream`` composes and instantiates
through the port's config stack.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.data import synthetic as jsynthetic
from predict_pv_yield_tpu.data.loader import ZarrStreamDataModule as JaxZarrStreamDataModule

from predict_pv_yield_tpu_torch.config.composer import compose
from predict_pv_yield_tpu_torch.config.instantiate import instantiate
from predict_pv_yield_tpu_torch.data import synthetic
from predict_pv_yield_tpu_torch.data.loader import ZarrStreamDataModule
from tests.test_torch_sources import assert_same_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
#: packages the data path must not need
ABSENT = ("h5py", "fsspec", "zstandard")


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same learnable archive written by each package (small: 160 frames
    of 16 px, 3 GSPs, with NWP)."""
    kwargs = dict(n_frames=160, px=16, n_gsp=3, seed=2, with_nwp=True)
    ours = synthetic.make_learnable_archive(str(tmp_path_factory.mktemp("port")), **kwargs)
    theirs = jsynthetic.make_learnable_archive(str(tmp_path_factory.mktemp("jax")), **kwargs)
    return ours, theirs


def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_archive_files_byte_equal(archives):
    ours, theirs = archives
    for a, b in ((ours.satellite_zarr, theirs.satellite_zarr), (ours.nwp_zarr, theirs.nwp_zarr)):
        assert _files(a) == _files(b)
    assert pathlib.Path(ours.gsp_csv).read_bytes() == pathlib.Path(theirs.gsp_csv).read_bytes()
    assert (ours.start, ours.n_frames, ours.cadence_minutes) == (theirs.start, theirs.n_frames, theirs.cadence_minutes)
    minutes = np.linspace(0, 700, 57)
    np.testing.assert_array_equal(ours.signal(minutes), jsynthetic.brightness_signal(minutes))


def _kwargs(archive, with_gsp=True, **extra):
    kwargs = dict(zarr_path=archive.satellite_zarr, nwp_zarr_path=archive.nwp_zarr, nwp_image_size_pixels=12,
                  batch_size=4, history_minutes=30, forecast_minutes=60, satellite_image_size_pixels=12,
                  n_train_data=5, n_val_data=2, seed=3)
    if with_gsp:
        kwargs.update(gsp_csv=archive.gsp_csv, n_gsp=2)
    kwargs.update(extra)
    return kwargs


def _assert_same_epochs(ours, theirs, epochs=2):
    train, jtrain = ours.train_dataloader(), theirs.train_dataloader()
    assert train.shuffle and len(train) == len(jtrain)
    for _ in range(epochs):
        for batch, jbatch in zip(list(train), list(jtrain), strict=True):
            assert_same_batch(batch, jbatch)
    for batch, jbatch in zip(list(ours.val_dataloader()), list(theirs.val_dataloader()), strict=True):
        assert_same_batch(batch, jbatch)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_batches_match_jax(archives, monkeypatch, num_workers):
    ours_archive, theirs_archive = archives
    ours = ZarrStreamDataModule(**_kwargs(ours_archive, num_workers=num_workers))
    theirs = JaxZarrStreamDataModule(**_kwargs(theirs_archive, num_workers=num_workers))
    assert ours.configuration.input_data.nwp.nwp_channels == ["t"]
    assert ours.configuration.input_data.gsp.n_gsp_per_example == 2
    # pandas only inside the CSV constructors (above); sampling needs none
    for name in ("pandas", *ABSENT):
        monkeypatch.setitem(sys.modules, name, None)
    _assert_same_epochs(ours, theirs)
    batch = next(iter(ours.val_dataloader()))
    assert batch.satellite.data.dtype == torch.float32 and batch.gsp.gsp_yield.shape == (4, 4, 2)
    assert batch.nwp.data.shape == (4, 1, 3, 12, 12) and batch.sun.sun_elevation_angle.shape == (4, 19)


def test_filler_targets_redrawn_without_a_gsp_source(archives, monkeypatch):
    ours_archive, theirs_archive = archives
    theirs = JaxZarrStreamDataModule(**_kwargs(theirs_archive, with_gsp=False, num_workers=2))
    for name in ("pandas", *ABSENT):  # no CSV: pandas is never needed
        monkeypatch.setitem(sys.modules, name, None)
    ours = ZarrStreamDataModule(**_kwargs(ours_archive, with_gsp=False, num_workers=2))
    _assert_same_epochs(ours, theirs, epochs=1)
    batches = list(ours.train_dataloader())
    assert not torch.equal(batches[0].gsp.gsp_yield, batches[1].gsp.gsp_yield)  # not the cached filler
    assert torch.equal(batches[0].gsp.gsp_id, batches[1].gsp.gsp_id)  # the rest of the group is


def test_test_fraction_and_split_errors(archives):
    ours_archive, _ = archives
    whole = ZarrStreamDataModule(**_kwargs(ours_archive, test_fraction=0.0, num_workers=0))
    assert len(list(whole.train_dataloader())) == 5
    with pytest.raises(ValueError, match="the test split of the archive cannot seed"):
        whole.val_dataloader()


def test_compose_and_instantiate(archives, tmp_cwd):
    ours_archive, _ = archives
    config = compose(config_name="config", overrides=[
        "datamodule=zarr_stream", f"datamodule.zarr_path={ours_archive.satellite_zarr}",
        f"datamodule.gsp_csv={ours_archive.gsp_csv}", "datamodule.satellite_image_size_pixels=12",
        "datamodule.n_train_data=2", "datamodule.batch_size=2"], config_dir=str(REPO / "configs"))
    datamodule = instantiate(config["datamodule"])
    assert isinstance(datamodule, ZarrStreamDataModule)
    batch = next(iter(datamodule.train_dataloader()))
    assert batch.satellite.data.shape == (2, 1, 19, 12, 12)


def test_data_path_imports_without_optional_packages(archives):
    """A fresh interpreter with pandas, PyYAML, h5py, fsspec and zstandard
    unimportable imports the data path and streams a batch."""
    ours_archive, _ = archives
    script = (
        "import sys\n"
        "for name in ('pandas', 'yaml', 'h5py', 'fsspec', 'zstandard'): sys.modules[name] = None\n"
        "from predict_pv_yield_tpu_torch.data import loader, shards, sources, synthetic, zarr_reader\n"
        f"dm = loader.ZarrStreamDataModule(zarr_path={ours_archive.satellite_zarr!r}, batch_size=2, "
        "satellite_image_size_pixels=12, n_train_data=1, num_workers=0)\n"
        "print(tuple(next(iter(dm.train_dataloader())).satellite.data.shape))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "(2, 1, 19, 12, 12)"


def test_cli_pins_the_archive_paths():
    """The CLI changes into the run directory, so relative archive and CSV
    paths resolve against the launch directory first (as the repo's run.py)."""
    from predict_pv_yield_tpu_torch.run import _pin_data_paths

    config = {"datamodule": {"zarr_path": "data/sat.zarr", "nwp_zarr_path": "/abs/nwp.zarr",
                             "gsp_csv": "gsp.csv", "pv_csv": None, "hrv_zarr_path": "gs://bucket/hrv.zarr"}}
    _pin_data_paths(config, "/launch")
    assert config["datamodule"] == {"zarr_path": "/launch/data/sat.zarr", "nwp_zarr_path": "/abs/nwp.zarr",
                                    "gsp_csv": "/launch/gsp.csv", "pv_csv": None,
                                    "hrv_zarr_path": "gs://bucket/hrv.zarr"}
