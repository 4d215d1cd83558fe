"""Data modules: whole-batch datasets → host prefetch (a port of the JAX
package's ``data/loader.py``: ``PrefetchingLoader``, ``NetCDFDataModule``
over fake data, prepared shards or the reference's NetCDF batch files,
local or remote through fsspec, ``ZarrStreamDataModule`` and
``get_dataloaders``).

The dataset yields whole batches of CPU tensors, as the reference's
``DataLoader(batch_size=None)`` does. The host → device copy is the
trainer's (``predict.iter_batches``: pinned buffers, a copy stream).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from predict_pv_yield_tpu_torch.config.dataset import Configuration, load_yaml_configuration
from predict_pv_yield_tpu_torch.data.fake import FakeDataset
from predict_pv_yield_tpu_torch.data.netcdf_reader import _V15_SOURCES, NetCDFBatchDataset
from predict_pv_yield_tpu_torch.data.shards import ShardDataset
from predict_pv_yield_tpu_torch.data.sources import (
    GSPSource,
    PVDataSource,
    SampledBatchDataset,
    SampleGenerator,
    SunSource,
    open_zarr_nwp,
    open_zarr_satellite,
    open_zarr_topographic,
)
from predict_pv_yield_tpu_torch.seqlen import SeqLens

_LOG = logging.getLogger(__name__)


class PrefetchingLoader:
    """Wrap a map-style dataset in a background-thread prefetcher.

    ``num_workers`` reader threads pull indices from a shared queue and put
    batches into a bounded window (``prefetch_factor`` ahead), in order.
    With ``shuffle`` the order of an epoch is the permutation that
    ``np.random.default_rng((seed, epoch)).shuffle`` gives, the JAX
    package's, so both engines see the same batches.
    """

    def __init__(self, dataset, num_workers: int = 4, prefetch_factor: int = 4,
                 shuffle: bool = False, seed: int = 0, transform=None):
        self.dataset = dataset
        self.num_workers = max(0, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.shuffle = shuffle
        self.seed = seed
        #: optional per-batch callable applied in the worker threads
        self.transform = transform
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle rng of the next iteration to a global epoch
        number, so a resumed run (a fresh loader) draws the permutation of
        the epoch it re-enters."""
        self._epoch = int(epoch)

    def _order(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator:
        indices = self._order()
        self._epoch += 1
        transform = self.transform
        if self.num_workers == 0:
            for i in indices:
                item = self.dataset[i]
                yield transform(item) if transform is not None else item
            return

        results: dict = {}
        results_lock = threading.Condition()
        work: queue.Queue = queue.Queue()
        for pos, i in enumerate(indices):
            work.put((pos, i))
        stop = threading.Event()
        next_pos = [0]

        def worker():
            while not stop.is_set():
                try:
                    pos, i = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.dataset[i]
                    if transform is not None:
                        batch = transform(batch)
                except Exception as exc:  # handed to the consumer
                    with results_lock:
                        results[pos] = exc
                        results_lock.notify_all()
                    return
                with results_lock:
                    # bounded prefetch: do not run ahead of the consumer
                    while not stop.is_set() and pos - next_pos[0] >= self.prefetch_factor + self.num_workers:
                        results_lock.wait(0.1)
                    results[pos] = batch
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(len(indices)):
                with results_lock:
                    while pos not in results:
                        results_lock.wait(0.1)
                    batch = results.pop(pos)
                    next_pos[0] = pos + 1
                    results_lock.notify_all()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


class NetCDFDataModule:
    """Train/val/test loaders over the splits ``train/`` and ``test/`` under
    ``data_path``: the reference's per-batch NetCDF files (v15 per-source
    trees or legacy flat files, ``data/netcdf_reader.py``), prepared batch
    shards (``data/shards.py``), or fake batches shaped by the dataset's
    ``configuration.yaml``. Constructor-compatible with the JAX package's
    datamodule. A remote ``data_path`` (``gs://``, ``file://``, … through
    fsspec) reads its ``configuration.yaml`` remotely and fetches each batch
    file into ``temp_path/<split>``. Without ``configuration.yaml`` fake
    data takes the default Configuration and real data raises.
    ``configuration`` may be replaced before the first loader is built.
    """

    def __init__(
        self,
        temp_path: str = ".",
        n_train_data: int = 24900,
        n_val_data: int = 1000,
        cloud: str = "local",
        num_workers: int = 8,
        pin_memory: bool = True,
        data_path: str = "prepared_ML_training_data/v4/",
        fake_data: bool = False,
        shuffle_train: bool = True,
    ):
        self.temp_path = temp_path
        self.data_path = data_path
        self.cloud = cloud
        self.n_train_data = n_train_data
        self.n_val_data = n_val_data
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.fake_data = fake_data
        self.shuffle_train = shuffle_train

        # remote stores use URL joins + fsspec (the reference's
        # load_yaml_configuration opened gs:// URLs directly)
        remote = "://" in data_path
        if remote:
            filename = data_path.rstrip("/") + "/configuration.yaml"
            import fsspec

            try:
                with fsspec.open(filename, "rb") as fh:
                    payload = fh.read()
            except (FileNotFoundError, OSError) as exc:
                if not fake_data:
                    raise FileNotFoundError(filename) from exc
                _LOG.warning("%s not readable (%s); using default Configuration for fake data", filename, exc)
                payload = None
        else:
            filename = os.path.join(data_path, "configuration.yaml")
            payload = filename if os.path.exists(filename) else None
            if payload is None and not fake_data:
                raise FileNotFoundError(filename)
            if payload is None:
                _LOG.warning("%s not found; using default Configuration for fake data", filename)
        if payload is not None:
            self.configuration = load_yaml_configuration(payload)
        else:
            self.configuration = Configuration()
            self.configuration.input_data = self.configuration.input_data.set_all_to_defaults()

    def _dataset(self, n_batches: int, split: str):
        if self.fake_data:
            return FakeDataset(configuration=self.configuration, length=n_batches)
        src_path = os.path.join(self.data_path, split)
        tmp_path = os.path.join(self.temp_path, split)
        if self._is_netcdf(src_path):
            # the reference's published datasets unmodified: per-batch
            # NetCDF files (v15 per-source tree or legacy flat files)
            return NetCDFBatchDataset(
                n_batches=n_batches, src_path=src_path, tmp_path=tmp_path, configuration=self.configuration
            )
        return ShardDataset(n_batches=n_batches, src_path=src_path, configuration=self.configuration,
                            tmp_path=tmp_path)

    @staticmethod
    def _is_netcdf(src_path: str) -> bool:
        """Whether ``src_path`` holds one of the reference's NetCDF layouts:
        v15 per-source directories or flat ``.nc`` files. A remote store is
        probed once, with one fsspec listing per split."""
        if "://" in src_path:
            import fsspec

            try:
                fs, root = fsspec.core.url_to_fs(src_path)
                # names only: some filesystems (memory://) list dicts by default
                names = [os.path.basename(str(p).rstrip("/")) for p in fs.ls(root, detail=False)]
            except (FileNotFoundError, OSError):
                return False
            return any(s in names for s in _V15_SOURCES) or any(n.endswith(".nc") for n in names)
        if not os.path.isdir(src_path):
            return False
        if any(os.path.isdir(os.path.join(src_path, s)) for s in _V15_SOURCES):
            return True
        try:
            return any(name.endswith(".nc") for name in os.listdir(src_path))
        except OSError:
            return False

    def _loader(self, dataset, shuffle: bool) -> PrefetchingLoader:
        return PrefetchingLoader(
            dataset,
            num_workers=0 if self.fake_data else self.num_workers,
            prefetch_factor=8,
            shuffle=shuffle,
        )

    def train_dataloader(self) -> PrefetchingLoader:
        return self._loader(self._dataset(self.n_train_data, "train"), self.shuffle_train)

    def val_dataloader(self) -> PrefetchingLoader:
        return self._loader(self._dataset(self.n_val_data, "test"), False)

    def test_dataloader(self) -> PrefetchingLoader:
        return self._loader(self._dataset(self.n_val_data, "test"), False)


class ZarrStreamDataModule:
    """Train/val/test loaders sampling LIVE from a zarr satellite archive.

    No prepare step: each batch draws random example windows straight from
    the archive through the nb28 DataSource pipeline (``data/sources.py``) —
    the native analog of experiment 001's ``NowcastingDataModule`` streaming
    from zarr (reference ``experiments/001…py:66-89``). Satellite windows,
    computed solar angles, (with ``gsp_csv``) real 30-minute GSP targets and
    (with ``nwp_zarr_path``) real NWP grids — freshest-run-per-target
    selection, centre-cropped — are real; groups no source covers keep
    deterministic synthetic filler so every model's input contract holds.
    The archive's time-axis tail (``test_fraction``) is held out for
    val/test — train and test windows never overlap. Batch ``i`` of a split
    is the JAX package's batch ``i``, value for value.
    """

    def __init__(
        self,
        zarr_path: str,
        zarr_array: str = "data",
        zarr_time: str = "time",
        nwp_zarr_path: Optional[str] = None,
        nwp_zarr_array: str = "data",
        nwp_init_time: str = "init_time",
        nwp_step: str = "step",
        nwp_dims: str = "init_time,variable,step,y,x",
        nwp_image_size_pixels: int = 16,
        hrv_zarr_path: Optional[str] = None,
        hrv_zarr_array: str = "data",
        hrv_zarr_time: str = "time",
        hrv_image_size_pixels: int = 64,
        topo_zarr_path: Optional[str] = None,
        topo_image_size_pixels: int = 64,
        pv_csv: Optional[str] = None,
        pv_metadata_csv: Optional[str] = None,
        gsp_csv: Optional[str] = None,
        n_gsp: int = 1,
        batch_size: int = 32,
        history_minutes: int = 30,
        forecast_minutes: int = 60,
        satellite_image_size_pixels: int = 24,
        n_train_data: int = 64,
        n_val_data: int = 8,
        test_fraction: float = 0.2,
        num_workers: int = 2,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.n_train_data = n_train_data
        self.n_val_data = n_val_data
        self.num_workers = num_workers
        self.seed = seed

        sat = open_zarr_satellite(
            zarr_path, zarr_array, zarr_time,
            image_size_pixels=satellite_image_size_pixels,
        )
        sources = [sat]
        nwp_source = None
        if nwp_zarr_path:
            nwp_source = open_zarr_nwp(
                nwp_zarr_path,
                array=nwp_zarr_array,
                init_time=nwp_init_time,
                step=nwp_step,
                dims=tuple(nwp_dims.split(",")),
                image_size_pixels=nwp_image_size_pixels,
                n_targets=SeqLens(history_minutes, forecast_minutes).seq_len_60,
            )
            sources.append(nwp_source)
        if hrv_zarr_path:
            sources.append(
                open_zarr_satellite(
                    hrv_zarr_path, hrv_zarr_array, hrv_zarr_time,
                    image_size_pixels=hrv_image_size_pixels, key_prefix="hrv",
                )
            )
        if topo_zarr_path:
            sources.append(open_zarr_topographic(topo_zarr_path, image_size_pixels=topo_image_size_pixels))
        locations = None
        if pv_csv:
            if not pv_metadata_csv:
                raise ValueError("pv_csv requires pv_metadata_csv")
            pv_source = PVDataSource.from_passiv_csv(pv_csv, pv_metadata_csv)
            sources.append(pv_source)
            if pv_source.x is not None and pv_source.y is not None:
                # location-driven extraction: one PV system's OSGB location
                # per example drives every modality's crop
                locations = np.stack([pv_source.x, pv_source.y], axis=1)
        if sat.x is not None and sat.y is not None:
            sources.append(SunSource(float(np.median(sat.x)), float(np.median(sat.y))))
        if gsp_csv:
            sources.append(GSPSource.from_pvlive_csv(gsp_csv, n_gsp_per_example=n_gsp))
        self._locations = locations

        configuration = Configuration()
        configuration.process.batch_size = batch_size
        configuration.input_data.default_history_minutes = history_minutes
        configuration.input_data.default_forecast_minutes = forecast_minutes
        configuration.input_data = configuration.input_data.set_all_to_defaults()
        configuration.input_data.satellite.satellite_image_size_pixels = satellite_image_size_pixels
        n_ch = 1 if len(sat.data.shape) == 3 else sat.data.shape[1]
        channels = list(configuration.input_data.satellite.satellite_channels)
        if n_ch > len(channels):
            raise ValueError(f"archive has {n_ch} channels > the {len(channels)} named satellite channels")
        configuration.input_data.satellite.satellite_channels = channels[:n_ch]
        if hrv_zarr_path:
            configuration.input_data.hrvsatellite.hrvsatellite_image_size_pixels = hrv_image_size_pixels
        if topo_zarr_path:
            configuration.input_data.topographic.topographic_image_size_pixels = topo_image_size_pixels
        if pv_csv:
            configuration.input_data.pv.n_pv_systems_per_example = 1
        if nwp_zarr_path:
            configuration.input_data.nwp.nwp_image_size_pixels = nwp_image_size_pixels
            n_nwp_ch = nwp_source.data.shape[2]  # canonical axis 2 = channel
            nwp_channels = list(configuration.input_data.nwp.nwp_channels)
            if n_nwp_ch > len(nwp_channels):
                raise ValueError(
                    f"NWP archive has {n_nwp_ch} channels > the {len(nwp_channels)} named NWP channels"
                )
            configuration.input_data.nwp.nwp_channels = nwp_channels[:n_nwp_ch]
        if gsp_csv:
            configuration.input_data.gsp.n_gsp_per_example = n_gsp
        self.configuration = configuration

        cut = int(len(sat.datetimes) * (1.0 - test_fraction))
        # built lazily per split: test_fraction=0 (train on the whole
        # archive) must not fail at construction for want of a test split
        self._split_times = {"train": sat.datetimes[:cut], "test": sat.datetimes[cut:]}
        self._sources = sources
        self._history_minutes = history_minutes
        self._forecast_minutes = forecast_minutes
        self._generators: dict = {}

    def _generator(self, split: str) -> SampleGenerator:
        if split not in self._generators:
            try:
                self._generators[split] = SampleGenerator(
                    self._sources,
                    datetimes=self._split_times[split],
                    history_minutes=self._history_minutes,
                    forecast_minutes=self._forecast_minutes,
                    locations=self._locations,
                )
            except ValueError as exc:
                raise ValueError(
                    f"the {split} split of the archive cannot seed a sample generator ({exc}); "
                    "adjust test_fraction"
                ) from exc
        return self._generators[split]

    def _loader(self, split: str, n_batches: int, shuffle: bool) -> PrefetchingLoader:
        dataset = SampledBatchDataset(
            self._generator(split),
            batch_size=self.batch_size,
            length=n_batches,
            configuration=self.configuration,
            seed=2 * self.seed + (split == "test"),
        )
        return PrefetchingLoader(dataset, num_workers=self.num_workers, prefetch_factor=4, shuffle=shuffle)

    def train_dataloader(self) -> PrefetchingLoader:
        return self._loader("train", self.n_train_data, True)

    def val_dataloader(self) -> PrefetchingLoader:
        return self._loader("test", self.n_val_data, False)

    def test_dataloader(self) -> PrefetchingLoader:
        return self._loader("test", self.n_val_data, False)


def get_dataloaders(
    n_train_data: int = 24900,
    n_validation_data: int = 900,
    cloud: str = "gcp",
    temp_path: str = ".",
    data_path: str = "prepared_ML_training_data/v4/",
) -> Tuple[PrefetchingLoader, PrefetchingLoader]:
    """The train and validation loaders of a :class:`NetCDFDataModule` over
    the prepared dataset (NetCDF files or shards) under ``data_path``."""
    data_module = NetCDFDataModule(
        temp_path=temp_path,
        data_path=data_path,
        cloud=cloud,
        n_train_data=n_train_data,
        n_val_data=n_validation_data,
    )
    return data_module.train_dataloader(), data_module.val_dataloader()
