"""End-to-end input-pipeline benchmark (the port of the JAX package's
``tools/pipeline_bench.py``, raw shards): can the host pipeline keep the
card fed? It writes a shard dataset (int16 satellite counts, the native
wire format), then times real train steps fed through the trainer's own
batch path: threaded shard reads (``PrefetchingLoader``), the float16 wire,
pinned side-stream copies, the on-card int16 decode and the bf16 train step
of the flagship conv3d_sat_nwp.

    python -m predict_pv_yield_tpu_torch.pipeline_bench --shards 64 --steps 60
    python -m predict_pv_yield_tpu_torch.pipeline_bench --host-only --wire int16|f32

``--host-only`` times the host pipeline alone up to the copy (shard read,
an optional host f32 decode as the reference's loader workers did, the
wire cast). Prints one JSON line with the JAX tool's keys (``metric``,
``value``, ``unit``, and ``wire_mb_per_batch``/``host_mb_per_s`` or
``vs_baseline``; ``fraction_of_compute_ceiling`` with
``--device-ceiling``), and ``device``, the device it ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

#: the reference Lightning trainer's rate, 4.2 batches of 32 per second (BASELINE.md)
BASELINE_EXAMPLES_PER_S = 4.2 * 32


def _write_shards(directory: str, n: int, batch_size: int, smoke: bool) -> None:
    from predict_pv_yield_tpu_torch.data.fake import fake_batch
    from predict_pv_yield_tpu_torch.data.shards import write_shard
    from predict_pv_yield_tpu_torch.flagship import flagship_configuration

    configuration = flagship_configuration(batch_size, smoke)
    for i in range(n):
        rng = np.random.default_rng(i)
        batch = fake_batch(configuration, rng)
        raw = torch.from_numpy(rng.integers(-1, 1023, size=tuple(batch.satellite.data.shape), dtype=np.int16))
        batch = batch.replace(satellite=dataclasses.replace(batch.satellite, data=raw))
        write_shard(directory, i, batch, fmt="raw")


def _host_decode_f32(batch):
    """The reference's host-side decode and normalisation of int16 counts."""
    from predict_pv_yield_tpu_torch.consts import SAT_MEAN, SAT_STD

    sat = batch.satellite.data.float()
    n = sat.shape[1]
    mean = torch.as_tensor(np.asarray(SAT_MEAN[1:1 + n], np.float32))[:, None, None, None]
    std = torch.as_tensor(np.asarray(SAT_STD[1:1 + n], np.float32))[:, None, None, None]
    return batch.replace(satellite=dataclasses.replace(batch.satellite, data=(sat - mean) / std))


def _batch_bytes(batch) -> int:
    """Wire bytes, touching one byte per 4 KiB page (mmap-backed shards
    defer the reads to their consumer)."""
    total = 0
    for leaf in batch.numeric().leaves():
        flat = leaf.reshape(-1).view(-1).contiguous()
        total += flat.numel() * flat.element_size()
        if flat.numel():
            int(flat.view(-1)[:: max(1, 4096 // flat.element_size())].float().sum())
    return total


def run(shards=64, steps=60, batch_size=32, workers=8, directory=None, device_ceiling=None, host_only=False,
        wire="int16", device="cuda", smoke=False) -> Dict:
    from predict_pv_yield_tpu_torch.data.loader import PrefetchingLoader
    from predict_pv_yield_tpu_torch.data.shards import ShardDataset
    from predict_pv_yield_tpu_torch.flagship import flagship_model
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.utils import device_name, resolve_device

    cleanup = directory is None
    if cleanup:
        directory = tempfile.mkdtemp(prefix="shards_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        _write_shards(directory, shards, batch_size, smoke)
        dataset = ShardDataset(n_batches=shards, src_path=directory)
        loader = PrefetchingLoader(dataset, num_workers=workers, prefetch_factor=8, shuffle=True)
        if host_only:
            from predict_pv_yield_tpu_torch.training.engine import wire_cast

            count, nbytes = 0, 0
            next(iter(loader))  # warm the page cache and the threads
            start = time.perf_counter()
            while count < steps:
                for batch in loader:
                    if wire == "f32":
                        batch = _host_decode_f32(batch)
                    nbytes += _batch_bytes(wire_cast(batch.numeric()))
                    count += 1
                    if count >= steps:
                        break
            seconds = time.perf_counter() - start
            value = count / seconds
            payload = {
                "metric": f"host pipeline batches/sec (raw format, {wire} wire, b{batch_size}, {workers} threads)",
                "value": value,
                "unit": "batches/s",
                "wire_mb_per_batch": nbytes / count / 1e6,
                "host_mb_per_s": nbytes / seconds / 1e6,
            }
        else:
            device = resolve_device(device)
            trainer = Trainer(max_epochs=1, profiler=None, precision=16, wire_float16=True, device=device,
                              weights_summary=None)
            trainer._adopt_configuration(loader)
            trainer.setup(flagship_model(batch_size, smoke))
            metrics = None
            for _, device_batch in trainer._iter_batches(loader, limit=4):  # warm
                metrics = trainer.train_step(device_batch)
            float(metrics["NMAE"])
            count = 0
            start = time.perf_counter()
            while count < steps:
                for _, device_batch in trainer._iter_batches(loader, limit=None):
                    metrics = trainer.train_step(device_batch)
                    count += 1
                    if count >= steps:
                        break
            float(metrics["NMAE"])  # waits for the last step
            value = count / (time.perf_counter() - start)
            payload = {
                "metric": f"conv3d_sat_nwp end-to-end batches/sec/chip (host shards, b{batch_size}, bf16)",
                "value": value,
                "unit": "batches/s/chip",
                "vs_baseline": value * batch_size / BASELINE_EXAMPLES_PER_S,
            }
        payload["device"] = "host" if host_only else device_name(device)
        if device_ceiling:
            payload["fraction_of_compute_ceiling"] = value / device_ceiling
            payload["device_ceiling_source"] = "--device-ceiling (measured)"
        return payload
    finally:
        if cleanup:
            shutil.rmtree(directory, ignore_errors=True)


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--shards", type=int, default=64)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--dir", default=None, help="shard dir (default: a temporary one, on /dev/shm if present)")
    parser.add_argument("--device-ceiling", type=float, default=None,
                        help="the device's train-step rate (batches/s) to set the measured rate against")
    parser.add_argument("--host-only", action="store_true", help="the host pipeline alone, no device")
    parser.add_argument("--wire", choices=("int16", "f32"), default="int16",
                        help="int16 = raw counts, decoded on the device; f32 = decoded on the host")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true", help="the narrow flagship")
    args = parser.parse_args(argv)
    payload = run(args.shards, args.steps, args.batch_size, args.workers, args.dir, args.device_ceiling,
                  args.host_only, args.wire, args.device, args.smoke)
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
