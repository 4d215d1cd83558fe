"""Data module: whole-batch datasets → host prefetch (a port of the JAX
package's ``data/loader.py``: ``PrefetchingLoader``, the fake-data branch of
``NetCDFDataModule`` and ``get_dataloaders``).

The dataset yields whole batches, as the reference's
``DataLoader(batch_size=None)`` does. The host → device copy is the
trainer's (``predict.iter_batches``: pinned buffers, a copy stream). The
prepared-shard and NetCDF readers are not ported yet (ROADMAP M9/M16), nor
is the zarr-stream datamodule (M8/M9).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator, Tuple

import numpy as np

from predict_pv_yield_tpu_torch.config.dataset import Configuration, load_yaml_configuration
from predict_pv_yield_tpu_torch.data.fake import FakeDataset

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
    """Train/val/test loaders over fake batches shaped by the dataset's
    ``configuration.yaml`` (the default Configuration when ``data_path``
    has none). Constructor-compatible with the JAX package's datamodule;
    ``fake_data=False`` (prepared shards or NetCDF files) is ROADMAP M9/M16.
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
        if not fake_data:
            raise NotImplementedError(
                "NetCDFDataModule(fake_data=False): the prepared-shard and NetCDF readers are not "
                "ported yet (ROADMAP M9 loader, M16 readers); set datamodule.fake_data=true"
            )
        if "://" in data_path:
            raise NotImplementedError(f"remote data_path {data_path!r} (fsspec) is not ported yet (ROADMAP M9)")
        self.temp_path = temp_path
        self.data_path = data_path
        self.cloud = cloud
        self.n_train_data = n_train_data
        self.n_val_data = n_val_data
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.fake_data = fake_data
        self.shuffle_train = shuffle_train

        filename = os.path.join(data_path, "configuration.yaml")
        if os.path.exists(filename):
            self.configuration = load_yaml_configuration(filename)
        else:
            _LOG.warning("%s not found; using default Configuration for fake data", filename)
            self.configuration = Configuration()
            self.configuration.input_data = self.configuration.input_data.set_all_to_defaults()

    def _loader(self, n_batches: int, shuffle: bool) -> PrefetchingLoader:
        dataset = FakeDataset(configuration=self.configuration, length=n_batches)
        return PrefetchingLoader(dataset, num_workers=0, prefetch_factor=8, shuffle=shuffle)

    def train_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.n_train_data, self.shuffle_train)

    def val_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.n_val_data, False)

    def test_dataloader(self) -> PrefetchingLoader:
        return self._loader(self.n_val_data, False)


def get_dataloaders(
    n_train_data: int = 24900,
    n_validation_data: int = 900,
    cloud: str = "gcp",
    temp_path: str = ".",
    data_path: str = "prepared_ML_training_data/v4/",
) -> Tuple[PrefetchingLoader, PrefetchingLoader]:
    """The train and validation loaders of a :class:`NetCDFDataModule` over
    prepared data (ROADMAP M9/M16: raises until those land)."""
    data_module = NetCDFDataModule(
        temp_path=temp_path,
        data_path=data_path,
        cloud=cloud,
        n_train_data=n_train_data,
        n_val_data=n_validation_data,
    )
    return data_module.train_dataloader(), data_module.val_dataloader()
