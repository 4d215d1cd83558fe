"""Drive the PyTorch / CUDA port on one GPU: the optical-flow nowcast, the
conv3d_sat_nwp serve and train paths, the data path that feeds them, the
perceiver family, the rest of the single-device zoo with bf16, the on-disk
formats (NetCDF, blosc/LZ4, remote stores, the prepare step), the
Trainer's knobs (CUDA graphs of k steps, lr_find, the float16 wire,
overfit/reload, loggers, plots, debug_nans, the device trace), the flow
forecaster's training with the flow bench, and several ranks (data and
tensor parallelism, the sharded flow), and the JAX package's orbax
checkpoints read natively, resumed and served, with the rest of the tooling.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``predict_pv_yield_tpu_torch/csrc``; print
     the instantiations' registers and spills from ``ptxas -v``, and fail
     if a weight- or data-gradient kernel or a radius that phase 2 times
     spills;
  2. hold each kernel to its plain PyTorch version on the card, at the shapes
     the flow path gives it and at edge shapes, and time kernel, plain
     version and the cuDNN yardstick against the card's bound. Times are the
     device's own record (``torch.profiler`` kernel durations); ``call_ms``
     is the wall time of one wrapper call, host cost included;
  3. nowcast at the headline: one 49-frame 256² super batch through
     ``SatelliteFlowLoader.load_super_batch`` (flows of all 48 pairs, dense
     predictions), flows checked against the port's CPU run, pairs/s;
  4. requests: 4 batches of 32 examples answered by a seeded
     ``FlowForecaster(32)``, scored by SSIM against flow-only and
     persistence;
  5. production geometry: ``flow_sequence`` on 49×704×548 frames;
  6. serve: the conv3d_sat_nwp flagship at the full width of
     ``configs/model/conv3d_sat_nwp.yaml`` (a literal copy below) through
     ``predict.run`` on 8 fake batches of 32 (CSV rows, finite forecasts,
     NMAE line); card forward vs the port's CPU forward (≤ 1e-4, TF32 off);
     the satellite decode of int16 counts with −1 holes, card bit-equal to
     CPU in both layouts, timed against its bound; a Lightning ``.ckpt``
     round trip; an invalid GSP id giving a NaN row; forward device time
     with its top kernels, ``predict`` wall time per batch, examples/s, the
     device's busy share, and the steady rate of 24 more batches;
  7. train: the same model through the port's ``Trainer`` (TF32 off):
     (w) the towers' weight-gradient kernel (``csrc/conv3d_wgrad.cu``) at
     the twelve tower shapes of a batch-32 step and their data-gradient
     kernel (``csrc/conv3d_dgrad.cu``) at the ten that need an input
     gradient, each at edge shapes too, against its plain version (im2col
     + matmul) and cuDNN's weight or data gradient (``library_ms``), two
     launches bit-equal, device ms against the fp32 bound; (a) one step at batch 4 on the card against the same step on the CPU
     from the same seed-0 weights (NMAE ≤ 2e-6; every gradient within 3 ×
     the spread of the CPU's two fp32 implementations, at least 1e-4, of
     its largest entry; parameters after the Adam step ≤ 1e-3);
     (b) ``Trainer.fit`` over 24 train and 4 validation batches of 32,
     generated before timing, with ``ModelCheckpoint``, ``EarlyStopping``
     and ``CSVLogger``: the train step's device ms and top kernels, its
     bound from the layer shapes, the median steady examples/s of the last
     16 steps, the busy share of a traced fit, the CSVs checked, and the
     weight- and data-gradient kernels' launches in the fit (> 0; 12 and
     10 a step); (c)
     ``last`` loaded into a fresh trainer: parameters, Adam moments and
     step and the loop counters bit-equal, the next step's NMAE within
     1e-6; (d) ``train(config)`` on a literal of the composed
     ``experiment=conv3d_sat_nwp`` config (``TRAIN_OVERRIDES``);
  8. data: the same model fed by the port's real loaders. (a) Zarr
     archives written from a seed at the flagship's widths
     (``STREAM_*``) streamed by ``ZarrStreamDataModule`` (batch 32,
     ``num_workers`` 2): the loader alone at 2 and 8 workers, a timed
     ``Trainer.fit`` of 24 + 4 batches (steady examples/s of the last 16
     steps) and the busy share of a traced 8-step fit; (b) raw int16 shards
     (5 % −1 holes) through ``NetCDFDataModule(fake_data=False)``: the
     train step with the decode inside it (the decode's kernels and share),
     the fit's steady examples/s and busy share, the bytes sent per batch;
     (c) the learning gate on the card (``run_learnable``: trained conv3d
     NMAE < 0.85 × the persistence baseline's); (d) whether h5py,
     zstandard and fsspec import (information only);
  9. perceiver: each of ``configs/model/perceiver.yaml``,
     ``perceiver_sat_nwp.yaml`` and ``perceiver_conv3d_sat_nwp.yaml`` (literal
     copies below) at its widths on fake data of the default geometry (11
     satellite and 10 NWP channels at 64 px): (a) serve — card forward vs
     the CPU's on the same seeded weights (≤ 1e-4 · max |y|), forward device
     ms and top kernels against the fp32 bound reckoned from the layer
     shapes, ``predict`` examples/s and busy share, a perceiver_pytorch-layout
     ``.ckpt`` round trip with ``strict=True``; (b) train — one Adam step card
     vs CPU (as 7 (a)), a timed ``Trainer.fit`` of 24 + 4 batches: step
     device ms and its bound, steady examples/s, busy share of a traced
     8-step fit, peak device memory; then (c) ``train(config)`` on a literal
     of the composed ``experiment=perceiver`` config and (d) the JAX
     package's perceiver learning gate on the card (16 epochs, lr 1e-3, the
     best validation epoch < 0.85 × phase 8's persistence baseline on the
     same archive), under deterministic algorithms, so that each run trains
     the same trajectory; it trains in a process of its own while phase 1
     builds the kernels;
 10. the zoo and bf16: (a) each of ``configs/model/conv3d.yaml``,
     ``conv3d_nwp.yaml``, ``cnn_concat_timesteps.yaml`` and ``cnn_rnn.yaml``
     (literal copies below) at batch 32 in fp32 on fake data of its
     geometry: card vs CPU at one example on the forecasts and on fc1's
     input (≤ 1e-4 · max |y|), forward and step device ms against the fp32
     bound from the layer shapes, ``predict`` and train examples/s, busy
     shares, peak memory, one step at batch 1 card vs CPU (as 7 (a));
     (b) the PRED-189 runbook's command (``weights/conv3d/readme.md``)
     through the port's ``predict.main`` on a synthesized reference
     ``.ckpt``; (c) conv3d_sat_nwp, perceiver.yaml and cnn_rnn at precision
     16 beside their fp32 numbers (phases 7, 9, 10 (a)): card bf16 vs CPU
     bf16 within 3 × the CPU's own bf16-vs-fp32 spread, forward and step
     device ms against the dense bf16 bound, top kernels, examples/s, busy
     share, peak memory, and what ``nn.GRU`` does under bf16 autocast;
     (d) phase 8 (c)'s learning gate at ``trainer.precision=16``; (e)
     ``train(config)`` on literals of the composed ``experiment=conv3d``,
     ``conv3d_nwp``, ``001_cnn_concat``, ``002_cnn_rnn`` and
     ``003_perceiver_rnn`` configs, each ``last`` checkpoint loaded back
     bit for bit with fp32 parameters;
 11. formats, at the flagship's geometry (``FORMAT_*``): (a) ``csrc/lz4.cpp``
     built with the host compiler (build seconds), the loaded library the
     native one, native LZ4 equal to the plain Python codec on seeded
     structured and random payloads of a satellite chunk's size, both
     codecs' MB/s; (b) a v15 per-source tree of netCDF3 classic files
     (this script's own CDF-2 writer: int16 channel-last satellite, CF
     minutes, raw MW beside capacities), 24 train (8 unique) and 4 test
     batches of 32, read back by ``NetCDFDataModule`` field for field as
     written, the loader alone at 2 and 8 threads, ``train(config)`` with
     the datamodule of ``netcdf_datamodule.yaml`` on the tree (steady
     examples/s beside phase 7's cached batches) and the busy share of a
     traced 8-step fit; (c) the same tree through ``file://`` (the remote
     branch and its fetch into ``temp_path``), equal to (b); (d) a legacy
     flat file, equal to what was written; (e) ``predict --data`` on the
     tree, the CSV's rows, card vs CPU forecasts ≤ 1e-4 · max |y|; (f)
     ``prepare`` from the learnable archive at 1 and 4 workers, byte-equal,
     and ``compute_channel_stats`` against float64 numpy; (g) phase 8 (a)'s
     archive with blosc-lz4 + shuffle satellite imagery: the loader alone
     at 2 and 8 threads and one thread's share in decompression beside 8
     (a)'s zlib numbers, and its channel statistics; (h) without h5py an
     HDF5 file raises naming the package, a blosc-zstd frame decodes
     natively and without zstandard writing one raises naming it (with
     them: an HDF5 and a zstd round trip);
 12. the Trainer's knobs at full width: (a) ``steps_per_execution`` 8 as one
     CUDA graph of 8 train steps for conv3d_sat_nwp.yaml at batch 32 on
     phase 7's batches in fp32 and bf16 and perceiver.yaml at batch 8 in
     bf16, each group of 8 batches rotated against the one before: 24 steps
     (the first group eager, then 16 replayed) against 24 eager steps under
     deterministic algorithms (flash attention's deterministic backward
     included), parameters, Adam's moments and step counts and every step's
     NMAE bit-equal (else within phase 7's one-step tolerances), and the
     same with ``accumulate_grad_batches=2``; for the perceiver, two planted
     faults (every replay skipped; every replay on the first group's
     inputs) that the same check must catch; fits of 48 steps at k = 1 and
     8: steady train examples/s (the last 16 step gaps, the last 4 group
     gaps), and a traced 8-step fit's busy share and host kernel launches
     per optimiser step; (b) ``lr_find(num_training=32)``
     on conv3d_sat_nwp.yaml: its suggestion and seconds; (c)
     ``wire_float16`` on phase 11's NetCDF tree: bytes per batch float32
     against float16, the fit's steady rate on each wire, the ``"auto"``
     probe's interleaved timings and decision, and the forecasts on the
     float16 wire within 16 float16 roundings of max |y| of the float32
     wire's; (d) ``overfit_batches=2`` for 3 epochs, and
     ``reload_dataloaders_every_epoch`` for 2 from the tree with each
     reloaded loader carrying the float16 cast; (e) a fit with the
     composed ``logger=many_loggers`` (its tfevents file read back record
     by record, CRCs checked), the four SaaS loggers with their clients
     hidden (each warns and writes JSONL), the validation plots as HTML (or
     that matplotlib is missing); (f) ``profiler="jax"``'s trace holding
     CUDA kernel events, and ``debug_nans`` raising ``FloatingPointError``
     naming ``fc1.weight`` set to NaN at k = 1 and 8;
 13. flow training: (a) one ``train_flow_forecaster.train_step`` of each of
     the four forecasters at its default width (``FlowForecaster(32)``,
     ``Conv2dAEForecaster(32)``, ``MaxPoolAEForecaster(32)``,
     ``PureConv3dForecaster(128)``) at batch 4, card against CPU from the
     same seed-0 weights on one seeded batch, under phase 7's one-step rules
     (ReLU ties included, and max-pool choices: the CPU step takes the
     card's argmax of each window, which may differ from its own only in a
     tied window) but with the parameters after Adam within 5e-5
     (bar the elements whose gradient the measured card-vs-CPU gap could
     carry across zero, counted),
     and the step lowering the loss; (b) the JAX
     tool's run at full width: a one-day drifting-cloud HRV zarr archive at
     704×548 read through ``flow_nowcast.archive`` (``open_zarr``), a
     testing range inside it, ``train`` of ``FlowForecaster(32)`` for 200
     steps of 32 on 4 resident super batches with background refresh, then
     ``evaluate`` over 8 testing batches: the super batches' build time, the
     steady train examples/s (the median of the last 100 step gaps), the
     busy share of a traced 20-step window, the step's device time (traced
     again until the records sum to 90 % of the CUDA-event time), the same
     run without background
     refresh, peak device memory, ``sep_blur`` launches (a multiple of 9, at
     least 36, the producer thread's included), the mean MSE of the first
     and last 20 steps (the last below the first), the SSIM triple in
     [−1, 1]; (c) 20 steps of each other forecaster on that dataset, finite
     losses; (d) ``flow_bench.main()`` three times (the best headline
     within 20 % of the best of phase 3's rate, measured again in turns with
     it; a positive host single-core rate) and ``flow_bench.sweep()``;
 14. parallel: (a) a ``ModelCheckpoint`` directory written by a short fit at
     phase 7's geometry, served by ``predict.main --checkpoint`` and by
     ``Trainer.predict``, each within 1e-4 · max |y| of ``predict.predict``
     on the trained model, and the seed-0 model's forecasts differing; the
     partitioned perceiver.yaml (``partition_attention=True``) one step card
     vs CPU under phase 9's rules; then a NCCL group of one rank on a free
     port: (b) conv3d_sat_nwp.yaml fp32, batch 32, 24 steps at k = 1 and 8
     bit-equal to the same fits without a process group and the k = 8
     replays bit-equal to the eager steps (deterministic algorithms), the
     48-step rates beside phase 12's, the NCCL kernels' device time a step
     from a trace held to ``TRACE_COVERAGE``; (c) perceiver.yaml partitioned
     by the trainer over its model group of one: its feed-forward shards
     what ``split_geglu_params`` makes of the fused weights, the forward
     within 1e-4 · max |y| of the fused model from the same seed, the bf16
     rate at k = 8 beside phase 12's, ``model_parallel=2`` raising
     ``ValueError``; ``flow_sequence_sharded`` at world size 1 against
     ``flow_sequence``; (d) two processes on ``cuda:0`` over gloo at small
     widths and k = 1: the data-parallel step against the one-rank step on
     the same global batch (phase 7's one-step tolerances), the
     tensor-parallel fit (model 2) against the unpartitioned fit (the JAX
     package's TP tolerances), ``flow_sequence_sharded`` within 1e-5 px of
     ``flow_sequence`` with ``sep_blur`` launching on both ranks. World size
     1 and two ranks sharing one card measure no scaling;
 15. the JAX package's checkpoints and the tooling: (a) every zstd frame
     of the two committed orbax fixtures (``testdata/orbax``) through the
     native decoder, each leaf's hash against ``expected.json``, the
     decoder's MB/s; (b) fixture (a) (conv3d_sat_nwp, accumulation and clip,
     mid-epoch) resumed by the port's ``Trainer`` for 2 steps on the card
     against the CPU (phase 7's one-step limits), and resume bit-exact on
     the card under deterministic algorithms: a 4-step fit against 2 steps,
     ``last``, resume and 2 steps, and fixture (a) resumed twice; (c)
     ``predict.main --checkpoint`` on fixture (a), card vs CPU ≤ 1e-4 ·
     max |y|; (d) ``serve_bench``, a short ``pipeline_bench`` (end to end
     and host alone) and ``mfu_probe`` (towers, step, the perceiver at
     24×24, batch 32) at full width, their JSON lines; (e) ``run.py -m``
     with 2 trials at a small width; (f) ``fake_batch_on_device`` at the
     flagship's configuration;
 16. the ``kernels`` line, then the result line.

The kernel launch counters are zeroed just before each drive of the main
path (phases 3, 4, 13 (b), 14's world-1 flow and each of 14 (d)'s ranks)
and read just after; the serve, train, data,
perceiver, zoo, formats, Trainer and checkpoint paths run no hand kernel (the JAX
package computes them with XLA, outside any Pallas kernel; attention is
PyTorch's ``scaled_dot_product_attention``; the LZ4 codec is host code; a
CUDA graph replays the kernels it captured), and their phases check that
``sep_blur`` launched 0 times.
Every busy share of a traced fit (7 (b), 8 (a) and (b), 10, 11 (b), 12
(a), 13 (b)) is taken after a warm-up fit in the profiler session's
warm-up step and held to ``TRACE_COVERAGE`` against a second trace of the
same work: a session opened after others loses its first records of
kernels loaded since, which would read as idle time.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from predict_pv_yield_tpu_torch.flops import layer_macs as _layer_macs, peaks
from predict_pv_yield_tpu_torch.flops import perceiver_macs as _perceiver_macs

FRAMES, SIDE = 49, 256  # the headline super batch (tools/flow_bench.py:30-37)
PRODUCTION = (704, 548)  # the full-extent nb13 HRV window (tools/flow_bench.py:101-119)
FLOW_MEAN_TOL, FLOW_MAX_TOL, FLOW_MARGIN = 1e-4, 1e-3, 2  # tests/test_opencv_parity.py
BLUR_REL_TOL = 2e-5  # max |kernel − plain| ≤ BLUR_REL_TOL · max |plain|

#: configs/model/conv3d_sat_nwp.yaml as a literal (tests/test_torch_predict.py
#: holds the two equal); the model defaults it leaves unset give 10 NWP
#: channels at 64 px, embedding_dem 16 and batch 32
CONV3D_SAT_NWP = {
    "_target_": "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model",
    "include_pv_or_gsp_yield_history": True,
    "include_nwp": True,
    "forecast_minutes": 120,
    "history_minutes": 30,
    "number_of_conv3d_layers": 6,
    "image_size_pixels": 24,
    "number_sat_channels": 11,
    "conv3d_channels": 32,
    "fc1_output_features": 128,
    "fc2_output_features": 128,
    "fc3_output_features": 64,
    "output_variable": "gsp_yield",
    "include_pv_yield_history": False,
    "include_future_satellite": True,
}
CONV3D_SAT_NWP_YAML = "configs/model/conv3d_sat_nwp.yaml"
#: the satellite channels of the predict tool's fake data for that YAML
CONV3D_SAT_NWP_CHANNELS = ("IR_016", "IR_039", "IR_087", "IR_097", "IR_108", "IR_120",
                           "IR_134", "VIS006", "VIS008", "WV_062", "WV_073")
SERVE_BATCHES = 8
STEADY_REPEATS = 4  # the steady serve rate runs the 8 batches 4 times over
SERVE_TOL = 1e-4  # card vs CPU forward, tests/test_convert.py:427

#: the weight-gradient kernel against its plain version (im2col + one
#: matmul a chunk): max |kernel − plain| ≤ WGRAD_REL_TOL · max |plain|, or
#: WGRAD_SPREAD_FACTOR × cuDNN's own distance from the plain version where
#: that is larger (both sum ~10^5–10^6 fp32 products per entry, in other orders)
WGRAD_REL_TOL, WGRAD_SPREAD_FACTOR = 1e-5, 3
#: the data-gradient kernel against its plain version, the same way (each
#: entry sums 864 fp32 products of a 32-channel layer, in other orders)
DGRAD_REL_TOL, DGRAD_SPREAD_FACTOR = 1e-5, 3
PARITY_BATCH = 4  # (a): the CPU side of the one-step parity stays cheap
STEP_LOSS_TOL, GRAD_REL_TOL, STEP_PARAM_TOL = 2e-6, 1e-4, 1e-3  # 1e-3 = 2·lr: Adam moves ~0 gradients by ±lr
GRAD_SPREAD_FACTOR = 3  # card gradients vs CPU: ≤ 3 × the CPU's own fp32 spread (see _train_parity)
#: a ReLU input within this fraction of its call's largest |input| of zero
#: is a tie that fp32 rounding may decide either way (_relu_decisions)
RELU_TIE = 1e-6
TRAIN_BATCHES, TRAIN_UNIQUE, VAL_BATCHES, STEADY_STEPS = 24, 8, 4, 16
ROUND_TRIP_TOL = 1e-6

#: phase 8 (a): the zarr archives, at the flagship's widths: 7 days of
#: 5-minute satellite frames, 11 channels at 64 px (~182 MB of int16, more
#: than the reader's 64 MiB chunk cache), hourly NWP runs of 10 channels at
#: 64 px with 30-minute steps to 3 h, a PVLive CSV of 8 GSPs
STREAM_FRAMES, STREAM_PX, STREAM_CHUNK, STREAM_GSPS = 7 * 288, 64, 12, 8
STREAM_NWP_STEPS = 7  # 0, 30, ..., 180 minutes
STREAM_WORKERS = (2, 8)  # the YAML's num_workers, and one per core of the card's host
LOADER_BATCHES = 16
#: phase 8 (b): raw int16 shards at the model's geometry
SHARD_TRAIN, SHARD_VAL, SHARD_EPOCHS, SHARD_WORKERS = 8, 2, 3, 8
#: phase 8 (c): tests/test_learning_gate.py's margin
GATE_MARGIN = 0.85

#: the port's ``compose`` of these overrides, as a literal (the card's
#: machine need not have PyYAML; tests/test_torch_composer.py holds the two
#: equal). The run dirs, ``work_dir`` and ``data_dir`` are left out: they
#: hold the clock and the cwd, and only the CLI reads them.
TRAIN_OVERRIDES = [
    "experiment=conv3d_sat_nwp", "datamodule.fake_data=true", "datamodule.n_train_data=2",
    "datamodule.n_val_data=1", "trainer.max_epochs=1", "+optimized_metric=MSE/Validation_epoch",
]
TRAIN_CONFIG = {
    "trainer": {"_target_": "predict_pv_yield_tpu.training.engine.Trainer", "min_epochs": 1, "max_epochs": 1,
                "resume_from_checkpoint": None, "fast_dev_run": False, "profiler": "simple"},
    "model": CONV3D_SAT_NWP,
    "datamodule": {"_target_": "predict_pv_yield_tpu.data.loader.NetCDFDataModule", "temp_path": ".",
                   "n_train_data": 2, "n_val_data": 1, "num_workers": 8, "pin_memory": True,
                   "data_path": "data/prepared_ML_training_data/v15/", "fake_data": True, "shuffle_train": True},
    "callbacks": {
        "model_checkpoint": {"_target_": "predict_pv_yield_tpu.training.callbacks.ModelCheckpoint",
                             "monitor": "MSE/Validation_epoch", "mode": "min", "save_top_k": 1, "save_last": True,
                             "verbose": False, "dirpath": "checkpoints/", "filename": "epoch_{epoch:03d}",
                             "auto_insert_metric_name": False},
        "early_stopping": {"_target_": "predict_pv_yield_tpu.training.callbacks.EarlyStopping",
                           "monitor": "MSE/Validation_epoch", "mode": "min", "patience": 5, "min_delta": 0},
    },
    "logger": {"csv": {"_target_": "predict_pv_yield_tpu.training.loggers.CSVLogger", "save_dir": ".",
                       "name": "csv/", "version": None, "prefix": ""}},
    "debug": False,
    "print_config": True,
    "ignore_warnings": True,
    "test_after_training": True,
    "seed": 518,
    "optimized_metric": "MSE/Validation_epoch",
}


#: phase 9: the perceiver family's model YAMLs as literals
#: (tests/test_torch_perceiver.py holds them equal to the files), by zoo name
PERCEIVERS = {
    "perceiver": {
        "_target_": "predict_pv_yield_tpu.models.perceiver.PerceiverModel",
        "forecast_minutes": 30, "history_minutes": 60, "batch_size": 8, "num_latents": 128, "latent_dim": 64,
        "embedding_dem": 16, "output_variable": "gsp_yield",
    },
    "perceiver_nwp_sat": {
        "_target_": "predict_pv_yield_tpu.models.perceiver_nwp_sat.Model",
        "forecast_minutes": 30, "history_minutes": 60, "batch_size": 8, "num_latents": 128, "latent_dim": 64,
        "embedding_dem": 0, "output_variable": "gsp_yield",
    },
    "perceiver_conv3d_nwp_sat": {
        "_target_": "predict_pv_yield_tpu.models.perceiver_conv3d_nwp_sat.Model",
        "forecast_minutes": 30, "history_minutes": 60, "batch_size": 32, "num_latents": 24, "latent_dim": 24,
        "embedding_dem": 0, "output_variable": "gsp_yield", "conv3d_channels": 8, "use_future_satellite_images": 0,
    },
}
#: (a) and (b): examples of the card-vs-CPU comparisons, so that the CPU's
#: side stays cheap (a CPU forward of a batch of 8 at perceiver.yaml's width
#: takes ~20 s); one example still runs every frame through the encoder
PERCEIVER_PARITY_BATCH = 1
PERCEIVER_TRAIN_OVERRIDES = ["experiment=perceiver"] + TRAIN_OVERRIDES[1:]
PERCEIVER_TRAIN_CONFIG = {**TRAIN_CONFIG, "model": PERCEIVERS["perceiver"]}
# the same sums of at most 12 fp32 upstream gradients in another order,
# relative to the largest gradient
POOL_GRAD_TOL = 1e-5
PERCEIVER_TRACED_CALLS = 3  # forwards and train steps per profiler trace

#: phase 10: the rest of the zoo's model YAMLs as literals
#: (tests/test_torch_experimental.py holds them equal to the files), by zoo name
ZOO = {
    "conv3d": {
        "_target_": "predict_pv_yield_tpu.models.conv3d.Model", "include_pv_yield": True, "include_nwp": True,
        "forecast_minutes": 120, "history_minutes": 30, "number_of_conv3d_layers": 6, "image_size_pixels": 24,
        "number_sat_channels": 11, "conv3d_channels": 32, "fc1_output_features": 128, "fc2_output_features": 128,
        "fc3_output_features": 64, "output_variable": "gsp_yield",
    },
    "conv3d_nwp": {
        "_target_": "predict_pv_yield_tpu.models.conv3d_nwp.Model", "include_pv_or_gsp_yield_history": True,
        "forecast_minutes": 120, "history_minutes": 30, "number_of_conv3d_layers": 6, "conv3d_channels": 32,
        "fc1_output_features": 128, "fc2_output_features": 128, "fc3_output_features": 64, "number_nwp_channels": 1,
    },
    "cnn_concat_timesteps": {
        "_target_": "predict_pv_yield_tpu.models.experimental.CNNConcatTimesteps", "history_minutes": 30,
        "forecast_minutes": 60, "channels": 144, "embedding_dim": 16, "include_nwp": True,
        "output_variable": "pv_yield",
    },
    "cnn_rnn": {
        "_target_": "predict_pv_yield_tpu.models.experimental.CNNRNN", "history_minutes": 30, "forecast_minutes": 60,
        "channels": 128, "last_conv_channels": 32, "embedding_dim": 16, "include_nwp": True,
        "output_variable": "pv_yield",
    },
}
#: (a): per model 4 unique train batches (each 6 times) and 2 validation
#: batches; the first 4 serve, twice over
ZOO_TRAIN_UNIQUE, ZOO_VAL = 4, 2
#: (c): the cells run in bf16 beside their fp32 numbers (phases 7, 9, 10 (a))
BF16_CELLS = {"conv3d_sat_nwp": CONV3D_SAT_NWP, "perceiver": PERCEIVERS["perceiver"], "cnn_rnn": ZOO["cnn_rnn"]}
#: (c): card bf16 vs CPU bf16 within this many times the CPU's own
#: bf16-vs-fp32 spread, as GRAD_SPREAD_FACTOR holds the fp32 gradients
BF16_SPREAD_FACTOR = 3
#: (e): the composed ``experiment=<name>`` + ``TRAIN_OVERRIDES[1:]`` configs
#: as literals (tests/test_torch_experimental.py holds them equal)
ZOO_TRAIN_CONFIGS = {
    "conv3d": {**TRAIN_CONFIG, "model": ZOO["conv3d"]},
    "conv3d_nwp": {**TRAIN_CONFIG, "model": ZOO["conv3d_nwp"]},
    "001_cnn_concat": {**TRAIN_CONFIG, "model": ZOO["cnn_concat_timesteps"], "seed": 42},
    "002_cnn_rnn": {**TRAIN_CONFIG, "model": ZOO["cnn_rnn"], "seed": 42},
    "003_perceiver_rnn": {**TRAIN_CONFIG, "model": PERCEIVERS["perceiver"], "seed": 42,
                          "trainer": {**TRAIN_CONFIG["trainer"], "precision": 16}},
}


#: phase 11: the on-disk formats at the flagship's geometry (phase 7's
#: batches: ~51 MB each, ~1.4 GB for the tree): a v15 per-source tree of
#: netCDF3 classic files, 24 train batches (8 unique) and 4 test batches,
#: read by the datamodule of configs/datamodule/netcdf_datamodule.yaml (a
#: literal; tests/test_torch_netcdf.py holds the two equal)
FORMAT_TRAIN, FORMAT_UNIQUE, FORMAT_TEST = 24, 8, 4
FORMAT_WORKERS = (2, 8)
FORMAT_PREDICT_BATCHES = 2  # (e): the CPU side of predict --data stays cheap
NETCDF_DATAMODULE = {"_target_": "predict_pv_yield_tpu.data.loader.NetCDFDataModule", "temp_path": ".",
                     "n_train_data": 4000, "n_val_data": 400, "num_workers": 8, "pin_memory": True,
                     "data_path": "data/prepared_ML_training_data/v15/", "fake_data": False, "shuffle_train": True}


#: phase 12: the Trainer's knobs at full width
GRAPH_K = 8
GRAPH_TRAIN = 48  # the rate fits: 6 groups of 8, the first eager (then captured), 5 replayed
STEADY_GROUPS = 4  # a graphed fit's steady rate: the last 4 group gaps, all between replays
GRAPH_EQUAL_TRAIN = 24  # the equality fits: 3 groups, 16 steps replayed
LR_FIND_STEPS = 32
U16 = 2.0 ** -11  # float16's unit roundoff
WIRE_TOL = 16 * U16  # f16-wire forecasts within 16 float16 roundings of max |y| of the f32 wire's
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cuGraphLaunch")
SAAS = {
    "wandb": {"_target_": "predict_pv_yield_tpu.training.loggers.WandbLogger", "project": "predict_pv_yield_tpu"},
    "neptune": {"_target_": "predict_pv_yield_tpu.training.loggers.NeptuneLogger", "api_key": "",
                "project": "OpenClimateFix/predict-pv-yield", "prefix": ""},
    "mlflow": {"_target_": "predict_pv_yield_tpu.training.loggers.MLFlowLogger", "experiment_name": "default",
               "tracking_uri": None, "save_dir": "./mlruns"},
    "comet": {"_target_": "predict_pv_yield_tpu.training.loggers.CometLogger", "api_key": "",
              "project_name": "predict_pv_yield_tpu"},
}
#: configs/logger/many_loggers.yaml composed (csv.yaml + tensorboard.yaml), as a literal
MANY_LOGGERS = {
    "csv": {"_target_": "predict_pv_yield_tpu.training.loggers.CSVLogger", "save_dir": ".", "name": "csv/",
            "version": None, "prefix": ""},
    "tensorboard": {"_target_": "predict_pv_yield_tpu.training.loggers.TensorBoardLogger", "save_dir": "tensorboard/",
                    "name": "default", "version": None, "prefix": ""},
}


#: phase 13: flow training at full width, at the JAX tool's defaults
#: (tools/train_flow_forecaster.py): batch 32, 4 resident super batches,
#: 48 forecast timesteps, 128→64 px crops, Adam 1e-4, 200 steps. The HRV
#: zarr archive is one day of drifting-cloud frames at the production
#: extent (cut from months: past four resident super batches the cost per
#: step does not depend on the archive's length); under the tool's dates
#: (from 2019-01-01T00:00) the day has 24 valid 4-hour windows, and the
#: testing range below holds the last 13 of them
FLOW_DAYS, FLOW_CHUNK = 1, 12
FLOW_TESTING = (np.datetime64("2019-01-01T10:50"), np.datetime64("2019-01-01T12:00"))
FLOW_STEPS, FLOW_BATCH, FLOW_SUPER_BATCHES, FLOW_LR = 200, 32, 4, 1e-4
FLOW_STEADY = 100  # the steady rate: the median of the last 100 step gaps
FLOW_EDGE = 20  # the first and last 20 losses are averaged to show learning
FLOW_SMOKE_STEPS = FLOW_TRACED_STEPS = 20
FLOW_EVAL_BATCHES = 8
TRACE_COVERAGE = 0.9  # a traced busy step: kernel records sum to ≥ 90 % of the CUDA-event time
FLOW_PARITY_BATCH = 4
FLOW_PARAM_TOL = 5e-5  # parameters after one Adam step, card vs CPU (ROADMAP §1)
BENCH_AGREEMENT = 0.2  # the bench's headline within 20 % of phase 3's rate
BENCH_READINGS = 3  # bench headlines, each between two readings of phase 3's rate


def log(message: str) -> None:
    print(message, flush=True)


def _warm_session():
    """A ``torch.profiler`` session of one warm-up step, which is not
    recorded, then one recorded step; the caller ends each with
    ``prof.step()``. A session opened after earlier sessions loses its first
    few records of kernels loaded since those sessions, whether or not the
    host syncs (on an H100, a third of the flow forecaster's cuDNN step in
    phase 13, after phase 12's sessions); the warm-up step takes that loss."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))


def _device_events(fn, calls: int, kernel: str | None = None, attempts: int = 3):
    """``torch.profiler``'s per-name device records (kernels and copies) of
    ``calls`` calls after a warm-up call in the session's warm-up step
    (:func:`_warm_session`); with ``kernel``, only the names that hold it.
    A trace that comes back without device records (CUPTI now and then
    delivers none) is taken again, up to ``attempts`` times."""
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with _warm_session() as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        # user annotations (``Optimizer.step#Adam.step``) span kernels already counted
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and (kernel is None or kernel in e.key)]
        if any(e.self_device_time_total > 0 for e in events) or attempt == attempts:
            return events
        log(f"[profiler] no device records in trace {attempt}; tracing again")


def device_ms(fn, kernel: str | None = None, calls: int = 50) -> float:
    """Mean device milliseconds per call: the durations ``torch.profiler``
    records on the card for ``calls`` calls after a warm-up call. With
    ``kernel``, only the kernels whose name holds it (one launch per call is
    checked); else every kernel and copy of the call. Host dispatch between
    launches is not counted."""
    for attempt in range(1, 4):
        events = _device_events(fn, calls, kernel)
        count = calls if kernel is None else sum(e.count for e in events)
        if count == calls:
            break
        # CUPTI now and then drops a record: trace again
        log(f"[profiler] trace {attempt} saw {count} launches of {kernel}, expected {calls}; tracing again")
    check(count == calls, f"profiler saw {count} launches of {kernel}, expected {calls}")
    total_us = sum(e.self_device_time_total for e in events)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / calls / 1e3


def call_ms(fn, calls: int = 50) -> float:
    """Mean wall milliseconds per call of a run of calls (CUDA events around
    the run, warm-up first): device time plus whatever the host adds."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def _build_checked(name, expected):
    """Build ``csrc/<name>.cu``; print each kernel's registers and spills
    (``ptxas -v``, named ``main<template argument>`` or ``reduce``) and fail
    if one spills or the kernels are not ``expected``."""
    import importlib

    from predict_pv_yield_tpu_torch import _build

    start = time.perf_counter()
    importlib.import_module(f"predict_pv_yield_tpu_torch.ops.{name}")._library()
    seconds = time.perf_counter() - start
    info = _build.build_info[name]
    log(f"[build] {name}.cu: {seconds:.2f} s (nvcc {info['seconds']:.2f} s)")
    if info["log"]:  # built, not reused: ptxas -v for each kernel
        kernels = {}
        for line in info["log"].splitlines():
            found = re.search(rf"Compiling entry function '(\S*{name}\w*)'", line)
            if found:
                width = re.search(r"ILi(\d+)E", found.group(1))
                kernel = f"main<{width.group(1)}>" if width else "reduce"
                kernels[kernel] = {"registers": 0, "spill_bytes": 0}
            elif kernels and "spill" in line:
                kernels[kernel]["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
            elif kernels and "Used" in line:
                kernels[kernel]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        log(f"[build]   {name} kernels (ptxas): {kernels}")
        check(sorted(kernels) == sorted(expected), f"ptxas reported {sorted(kernels)}, expected {sorted(expected)}")
        check(not any(v["spill_bytes"] for v in kernels.values()), f"a {name} kernel spills")


def phase_build():
    from predict_pv_yield_tpu_torch import _build
    from predict_pv_yield_tpu_torch.ops import sep_blur

    _build_checked("conv3d_wgrad", ["main<16>", "main<32>", "reduce"])
    _build_checked("conv3d_dgrad", [f"main<{width}>" for width in range(4, 9)])
    start = time.perf_counter()
    sep_blur._library()
    seconds = time.perf_counter() - start
    info = _build.build_info["sep_blur"]
    log(f"[build] sep_blur.cu: {seconds:.2f} s (nvcc {info['seconds']:.2f} s)")
    if not info["log"]:  # the library was reused
        return
    # ptxas -v: one instantiation per radius; registers, spills, static smem
    radius, per_radius = None, {}
    for line in info["log"].splitlines():
        found = re.search(r"Compiling entry function '.*sep_blur_kernelILi(\d+)E", line)
        if found:
            radius = int(found.group(1))
            per_radius[radius] = {"registers": 0, "spill_bytes": 0, "smem": 0}
        elif radius is not None and "spill" in line:
            per_radius[radius]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif radius is not None and "registers" in line:
            per_radius[radius]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            per_radius[radius]["smem"] = int(smem.group(1)) if smem else 0
    radii = (sep_blur.MAX_TAPS + 1) // 2
    check(len(per_radius) == radii, f"ptxas reported {len(per_radius)} instantiations, expected {radii}")
    for key in ("registers", "smem"):
        values = sorted({v[key] for v in per_radius.values()})
        log(f"[build]   {key} per instantiation (r = 0..{radii - 1}): {values}")
    spills = {r: v["spill_bytes"] for r, v in sorted(per_radius.items()) if v["spill_bytes"]}
    log(f"[build]   spill bytes by radius: {spills or 'none'}")
    timed = {len(t) // 2 for _, _, t in _kernel_cases()}
    check(not timed & spills.keys(), f"a radius the cases time spills: {spills}")


def _pyramid(height: int, width: int):
    """The three level sizes of the flow pyramid (levels=2, pyr_scale 0.5)."""
    return [(round(height * 0.5**k), round(width * 0.5**k)) for k in range(3)]


def _kernel_cases():
    """(label, shape, taps) of the timed kernel cases: every level of the
    headline and production pyramids (winsize 40: 41 Gaussian taps), a box
    window, and edge shapes: planes smaller than the window, a plane shorter
    than one band of rows and 200 wide, and a radius off the flow path."""
    from predict_pv_yield_tpu_torch.ops.optical_flow import _window_taps

    gaussian, box = _window_taps(40, True), _window_taps(15, False)
    pairs = FRAMES - 1
    return [
        *((f"headline L{k}", (pairs, 5, *hw), gaussian) for k, hw in enumerate(_pyramid(SIDE, SIDE))),
        *((f"production L{k}", (pairs, 5, *hw), gaussian) for k, hw in enumerate(_pyramid(*PRODUCTION))),
        ("box r=7", (pairs, 5, SIDE // 2, SIDE // 2), box),
        ("edge 32x32", (pairs, 5, 32, 32), gaussian),
        ("edge 17x200", (2, 5, 17, 200), gaussian),
        ("31 taps", (pairs, 5, SIDE // 2, SIDE // 2), _window_taps(30, True)),
    ]


def phase_kernels(device, bandwidth, flops_peak):
    """Kernel vs plain version at the flow path's shapes → per-case rows."""
    import torch.nn.functional as F

    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import _window_taps

    generator = torch.Generator(device=device).manual_seed(0)

    def held_to_plain(label, fields, taps):
        out = blur.sep_blur(fields, taps)
        plain = blur.sep_blur_reference(fields, taps)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        check(
            err <= BLUR_REL_TOL * scale,
            f"sep_blur {label} {tuple(fields.shape)}: max|kernel-plain| {err:.3e} > "
            f"{BLUR_REL_TOL}*{scale:.3e}",
        )
        return err

    # every tap count the kernel takes, on a ragged plane, and a plane count
    # over the 65,535 that one launch takes
    worst = 0.0
    for n_taps in range(1, blur.MAX_TAPS + 1, 2):
        fields = torch.randn((3, 5, 45, 70), generator=generator, device=device)
        taps = torch.rand(n_taps, generator=generator, device=device).cpu().numpy()
        worst = max(worst, held_to_plain(f"{n_taps} taps", fields, taps))
    held_to_plain("65,540 planes", torch.randn((13108, 5, 6, 7), generator=generator, device=device),
                  _window_taps(4, True))
    log(f"[kernel] tap counts 1..{blur.MAX_TAPS} at (3,5,45,70) and (13108,5,6,7): "
        f"within {BLUR_REL_TOL} of max |plain|; max abs err {worst:.3e}")

    rows = []
    for label, shape, taps in _kernel_cases():
        fields = torch.randn(shape, generator=generator, device=device)
        err = held_to_plain(label, fields, taps)
        radius = len(taps) // 2
        k = torch.as_tensor(taps, device=device)
        wx = k.view(1, 1, 1, -1).repeat(5, 1, 1, 1)
        wy = k.view(1, 1, -1, 1).repeat(5, 1, 1, 1)

        def library():
            padded = F.pad(fields, (radius,) * 4, mode="replicate")
            return F.conv2d(F.conv2d(padded, wx, groups=5), wy, groups=5)

        numel = fields.numel()
        bytes_moved = 2 * 4 * numel
        flops = 4 * len(taps) * numel  # 2·taps FMAs per element
        bound_bytes, bound_ops = bytes_moved / bandwidth * 1e3, flops / flops_peak * 1e3
        row = {
            "case": label,
            "shape": list(shape),
            "taps": len(taps),
            "max_abs_err": err,
            "ms": device_ms(lambda: blur.sep_blur(fields, taps), kernel="sep_blur_kernel"),
            "plain_ms": device_ms(lambda: blur.sep_blur_reference(fields, taps)),
            "library_ms": device_ms(library),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "call_ms": call_ms(lambda: blur.sep_blur(fields, taps)),
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("[kernel] " + json.dumps(row))
        del fields
    return rows


def _flow_pairs_per_s(frames: torch.Tensor, runs: int) -> float:
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence

    flow_sequence(frames)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(runs):
        flow_sequence(frames)
    torch.cuda.synchronize()
    return runs * (frames.shape[0] - 1) / (time.perf_counter() - start)


def phase_nowcast(device):
    """One headline super batch on the card; flows against the CPU run."""
    from predict_pv_yield_tpu_torch.data.flow_dataset import (
        SatelliteFlowLoader,
        convert_10bpp_to_uint8,
    )
    from predict_pv_yield_tpu_torch.flow_nowcast import drifting_archive
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import farneback_flow_batched

    timesteps, size = FRAMES - 1, SIDE
    frames, datetimes = drifting_archive(size=size)
    loader = SatelliteFlowLoader(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=timesteps,
        testing_date_range=(np.datetime64("2019-05-21"), np.datetime64("2019-05-22")),
        device=device,
    )

    blur.launches = 0
    start = time.perf_counter()
    super_batch = loader.load_super_batch("training")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - start
    launches = blur.launches
    check(launches == 9, f"load_super_batch launched sep_blur {launches} times, expected 9")
    flows = super_batch.flows
    check(tuple(flows.shape) == (timesteps, size, size, 2), f"flows shape {tuple(flows.shape)}")
    check(bool(torch.isfinite(flows).all()), "non-finite flows")
    check(tuple(super_batch.predictions.shape) == (timesteps, timesteps, size, size),
          "predictions shape")
    log(f"[nowcast] load_super_batch {timesteps + 1}x{size}x{size} (first call): "
        f"{load_seconds:.3f} s, "
        f"sep_blur launches {launches}")

    # the same window through the port on the CPU (plain versions)
    first = int(np.searchsorted(datetimes, super_batch.datetimes[0]))
    raw = torch.from_numpy(frames[first : first + timesteps + 1])
    decoded = torch.where(raw == -1, torch.nan, raw.float())
    uint8 = convert_10bpp_to_uint8(decoded).float()
    pairs = [0, timesteps // 3 - 1, 2 * timesteps // 3 - 1, timesteps - 1]
    cpu_flows = farneback_flow_batched(uint8[pairs], uint8[[p + 1 for p in pairs]])
    m = FLOW_MARGIN
    diff = (flows[pairs].cpu() - cpu_flows).abs()[:, m:-m, m:-m]
    mean_err, max_err = float(diff.mean()), float(diff.max())
    log(f"[nowcast] card vs CPU flows, pairs {pairs}: mean {mean_err:.3e} px, max {max_err:.3e} px")
    check(mean_err <= FLOW_MEAN_TOL and max_err <= FLOW_MAX_TOL, "card flows disagree with the CPU run")

    on_card = uint8.to(device)
    rate = _flow_pairs_per_s(on_card, runs=10)
    log(f"[nowcast] flow_sequence {timesteps + 1}x{size}x{size}: {rate:.2f} pairs/s")
    return loader, launches, rate, on_card


def phase_requests(device, loader):
    """4 batches of 32 examples through a seeded FlowForecaster(32)."""
    from predict_pv_yield_tpu_torch.flow_nowcast import evaluate
    from predict_pv_yield_tpu_torch.models.flow_forecaster import FlowForecaster
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    model = FlowForecaster(32, generator=torch.Generator().manual_seed(0)).to(device).eval()
    blur.launches = 0
    start = time.perf_counter()
    scores = evaluate(model, loader, batch_size=32, n_batches=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = blur.launches
    check(launches == 9, f"requests launched sep_blur {launches} times, expected 9")
    check(all(np.isfinite(v) and -1 <= v <= 1 for v in scores.values()), f"SSIM {scores}")
    log(f"[requests] 4x32 examples (incl. one testing super batch): {seconds:.3f} s; "
        + ", ".join(f"SSIM {k} {v:.4f}" for k, v in scores.items()))

    # the forecaster on the card against the same weights on the CPU
    batch = {k: torch.randn(v, generator=torch.Generator().manual_seed(1))
             for k, v in (("historical_sat_images", (4, 4, 128, 128)),
                          ("optical_flow_predictions", (4, 128, 128)),
                          ("forecast_horizon", (4,)))}
    with torch.no_grad():
        card = model({k: v.to(device) for k, v in batch.items()}).cpu()
        host = model.cpu()(batch)
    err = float((card - host).abs().max())
    log(f"[requests] FlowForecaster card vs CPU: max abs diff {err:.3e}")
    check(tuple(card.shape) == (4, 64, 64) and err <= 1e-4, "forecaster disagrees with the CPU run")
    return launches, scores


def phase_production(device):
    """flow_sequence on the full-extent 49×704×548 HRV window."""
    import torch.nn.functional as F

    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence

    generator = torch.Generator(device=device).manual_seed(0)
    t, (h, w) = FRAMES, PRODUCTION
    coarse = torch.randn((t, 1, h // 16, w // 16), generator=generator, device=device)
    frames = F.interpolate(coarse, size=(h, w), mode="bilinear")[:, 0] * 60 + 120
    blur.launches = 0
    flows = flow_sequence(frames)
    torch.cuda.synchronize()
    check(blur.launches == 9, f"flow_sequence launched sep_blur {blur.launches} times, expected 9")
    check(tuple(flows.shape) == (t - 1, h, w, 2) and bool(torch.isfinite(flows).all()),
          "production flows")
    rate = _flow_pairs_per_s(frames, runs=3)
    log(f"[production] flow_sequence {t}x{h}x{w}: {rate:.2f} pairs/s")
    return rate


def _session_spans(fn, warm, attempts: int = 3):
    """One traced call of ``fn`` after an unrecorded call of ``warm`` in the
    session's warm-up step (:func:`_warm_session`) → (the card's kernel and
    copy intervals, wall seconds of the call, the session's events). A
    trace without device records is taken again, up to ``attempts`` times."""
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with _warm_session() as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            prof.step()
        events = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        if spans:
            return spans, wall, events
        log(f"[profiler] no device records in trace {attempt}; tracing again")
    raise AssertionError("the profiler recorded no device activity")


def _union_us(spans) -> float:
    busy, (lo, hi) = 0.0, spans[0]
    for start_us, end_us in spans[1:]:
        if start_us > hi:
            busy += hi - lo
            lo, hi = start_us, end_us
        else:
            hi = max(hi, end_us)
    return busy + hi - lo


def _hold_to_coverage(spans, replica, warm, what):
    """A traced call that cannot be timed by CUDA events alone (a fit, idle
    between its steps) is held to ``TRACE_COVERAGE`` against ``replica``,
    the same work traced in a second session after the same warm-up: the
    device time the first trace recorded must reach 90 % of the second's,
    else the first lost records."""
    again, _, _ = _session_spans(replica, warm)
    recorded, reference = sum(e - s for s, e in spans), sum(e - s for s, e in again)
    log(f"[profiler] {what}: the trace recorded {recorded / 1e3:.3f} ms of device time, a second trace of the same "
        f"work {reference / 1e3:.3f} ms ({recorded / reference:.1%}, limit {TRACE_COVERAGE:.0%})")
    check(recorded >= TRACE_COVERAGE * reference, f"{what}: the busy share's trace lost records")


def _busy_share(fn, warm=True, replica=None, what="traced call"):
    """(share of the wall time the device is busy, wall seconds) of one
    traced call after a warm-up call in the session's warm-up step
    (:func:`_warm_session`): ``fn`` itself, or the callable ``warm`` (a fit,
    which runs once, warms with a short fit of another trainer on the same
    data, so that every kernel the fit loads takes the session's record
    loss before the traced call). The busy share is the union of the kernel
    and copy intervals the profiler records on the card over the host clock
    around the call. With ``replica`` (the same work again, e.g. the same
    fit on a fresh trainer) the trace is held to ``TRACE_COVERAGE``
    (:func:`_hold_to_coverage`)."""
    warm = fn if warm is True else warm
    spans, wall, _ = _session_spans(fn, warm)
    if replica is not None:
        _hold_to_coverage(spans, replica, warm, what)
    return _union_us(spans) / (wall * 1e6), wall


def _serve_cli(device, tmp):
    """(a, b) ``predict.run`` on a literal copy of the model YAML: 8 fake
    batches of 32, the forecast CSV and the NMAE line."""
    import contextlib
    import csv
    import io
    import math
    import os

    from predict_pv_yield_tpu_torch import predict as serve

    out = os.path.join(tmp, "forecasts.csv")
    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = serve.run(CONV3D_SAT_NWP, n_batches=SERVE_BATCHES, out=out, with_nmae=True, device=device)
    seconds = time.perf_counter() - start
    with open(out, newline="") as fh:
        rows = list(csv.reader(fh))
    expected = SERVE_BATCHES * 32 * 4
    check(rows[0] == ["batch_index", "example_index", "forecast_horizon", "forecast"], f"CSV header {rows[0]}")
    check(len(rows) - 1 == result["rows"] == expected, f"{len(rows) - 1} CSV rows, expected {expected}")
    check(all(math.isfinite(float(row[3])) for row in rows[1:]), "a non-finite forecast")
    check("NMAE: " in printed.getvalue() and math.isfinite(result["nmae"]), "no NMAE line")
    for line in printed.getvalue().splitlines():
        log(f"[serve] {line}")
    log(f"[serve] predict.run, {SERVE_BATCHES}x32 fake examples (model build, fake data and the NMAE "
        f"pass included, first call): {seconds:.3f} s")


def _serve_decode(device, batch, bandwidth):
    """(d) The satellite decode of int16 counts with −1 holes on the card,
    bit-equal to the CPU decode in both layouts; device ms vs its bound."""
    from predict_pv_yield_tpu_torch.data.batch import Batch, SatelliteBatch
    from predict_pv_yield_tpu_torch.data.preprocess import channel_stats, decode_satellite, preprocess_batch

    names = CONV3D_SAT_NWP_CHANNELS
    mean, std = channel_stats(names)
    shape = (1, -1, 1, 1, 1)
    counts = torch.round(batch.satellite.data * std.view(shape) + mean.view(shape)).clamp(0, 1023).to(torch.int16)
    holes = torch.rand(counts.shape, generator=torch.Generator().manual_seed(2)) < 0.05
    counts[holes] = -1
    rows = []
    for channel_last in (False, True):
        raw = counts.permute(0, 2, 3, 4, 1).contiguous() if channel_last else counts
        host = preprocess_batch(Batch(satellite=SatelliteBatch(data=raw, channel_last=channel_last)), names)
        card_raw = raw.to(device)
        card = preprocess_batch(Batch(satellite=SatelliteBatch(data=card_raw, channel_last=channel_last)), names)
        equal = torch.equal(card.satellite.data.cpu(), host.satellite.data)
        check(equal, f"card decode differs from the CPU decode (channel_last={channel_last})")
        mean_d, std_d = channel_stats(names, device)
        ms = device_ms(lambda: decode_satellite(card_raw, mean_d, std_d, channel_last=channel_last))
        bound = raw.numel() * (2 + 4) / bandwidth * 1e3
        row = {"layout": "channel_last" if channel_last else "canonical", "shape": list(raw.shape),
               "holes": int(holes.sum()), "bit_equal": equal, "ms": ms, "bound_ms": bound,
               "share_of_bound": bound / ms}
        log("[serve] decode " + json.dumps(row))
        rows.append(row)
    return rows


def phase_serve(device, bandwidth, flops_peak):
    """The conv3d_sat_nwp serve path at the full width of its YAML."""
    import dataclasses
    import tempfile

    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.utils import full_fp32

    blur.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        _serve_cli(device, tmp)

        # (a) the model, seeded, eval mode; the predict tool's fake batches
        model = serve.build_model("conv3d_sat_nwp", CONV3D_SAT_NWP, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        loader = serve.fake_loader(model, SERVE_BATCHES)
        check(serve.channel_names_of(loader) == CONV3D_SAT_NWP_CHANNELS, "satellite channels")
        batches = list(loader)
        host = batches[0].numeric()
        log(f"[serve] conv3d_sat_nwp: {n_params:,} parameters; satellite "
            f"{tuple(host.satellite.data.shape)}, NWP {tuple(host.nwp.data.shape)}")

        # (c) card against CPU, same weights, TF32 off
        with torch.inference_mode(), full_fp32():
            on_cpu = model(host)
        model.to(device)
        card_batch = host.to(device)
        with torch.inference_mode(), full_fp32():
            on_card = model(card_batch)
        err = float((on_card.cpu() - on_cpu).abs().max())
        log(f"[serve] card vs CPU forward {tuple(on_card.shape)}: max abs diff {err:.3e} (limit {SERVE_TOL})")
        check(tuple(on_card.shape) == (32, 4) and bool(torch.isfinite(on_card).all()), "forward shape or NaN")
        check(err <= SERVE_TOL, "card forward disagrees with the CPU forward")

        decode_rows = _serve_decode(device, batches[0], bandwidth)

        # (e) Lightning checkpoint round trip through the CLI's loader
        ckpt = f"{tmp}/conv3d_sat_nwp.ckpt"
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        loaded = serve.build_model("conv3d_sat_nwp", CONV3D_SAT_NWP, checkpoint=ckpt, seed=1).to(device)
        with torch.inference_mode(), full_fp32():
            again = loaded(card_batch)
        check(torch.equal(again, on_card), "the .ckpt round trip changed the forecasts")
        log("[serve] .ckpt round trip (strict=True): forecasts equal")
        del loaded

    # (f) an invalid GSP id gives a NaN row, and no device-side assert
    gsp_id = card_batch.gsp.gsp_id.clone()
    gsp_id[0, 0], gsp_id[1, 0] = 5000, -1
    bad = card_batch.replace(gsp=dataclasses.replace(card_batch.gsp, gsp_id=gsp_id))
    with torch.inference_mode(), full_fp32():
        out = model(bad)
    torch.cuda.synchronize()
    check(bool(torch.isnan(out[:2]).all()) and bool(torch.isfinite(out[2:]).all()),
          "invalid ids did not give NaN rows (only those)")
    log("[serve] invalid GSP ids 5000 and -1: NaN rows 0 and 1, the other rows finite")

    # (g) timing: warm forward on the card, then predict with the copies
    def forward():
        with torch.inference_mode(), full_fp32():
            model(card_batch)

    events = _device_events(forward, calls=10)
    forward_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    flops = 2 * _conv3d_sat_nwp_macs(model) * 32
    bound_ms = flops / flops_peak * 1e3
    log(f"[serve] forward device time per batch of 32: {forward_ms:.4f} ms; fp32 bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP), {bound_ms / forward_ms:.1%} of it")
    for e in top:
        log(f"[serve]   {e.self_device_time_total / 10 / 1e3:8.4f} ms  x{e.count // 10:<3d} {e.key[:110]}")

    def serve_batches(repeats: int = 1):
        serve.predict(model, batches * repeats, device)

    def seconds_per_call(repeats: int, runs: int = 5) -> float:
        """Median host seconds of ``runs`` warm calls: the host is shared,
        and a mean takes in whatever else ran on it."""
        serve_batches(repeats)
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            serve_batches(repeats)
            times.append(time.perf_counter() - start)
        return float(np.median(times))

    seconds = seconds_per_call(1)
    wall_ms = seconds / SERVE_BATCHES * 1e3
    rate = SERVE_BATCHES * 32 / seconds
    busy, traced = _busy_share(serve_batches)
    log(f"[serve] predict over {SERVE_BATCHES} host batches of 32 (pinned copies included): "
        f"{wall_ms:.4f} ms per batch, {rate:.2f} examples/s; device busy {busy:.1%} of a traced "
        f"call ({traced * 1e3:.3f} ms)")
    # the steady rate: the batches a longer call adds, so that the fill of
    # the copy pipeline and the last forecasts' copy back drop out
    long_batches = SERVE_BATCHES * STEADY_REPEATS
    long_seconds = seconds_per_call(STEADY_REPEATS)
    steady_rate = (long_batches - SERVE_BATCHES) * 32 / (long_seconds - seconds)
    log(f"[serve] predict over {long_batches} host batches of 32: {long_seconds / long_batches * 1e3:.4f} ms "
        f"per batch, {long_batches * 32 / long_seconds:.2f} examples/s; steady rate of the "
        f"{long_batches - SERVE_BATCHES} batches it adds: {steady_rate:.2f} examples/s")
    check(blur.launches == 0, "the serve path launched sep_blur")
    return {"serve_examples_per_s": rate, "serve_steady_examples_per_s": steady_rate,
            "serve_forward_ms": forward_ms, "serve_wall_ms_per_batch": wall_ms,
            "serve_busy_share": busy, "decode_ms": decode_rows[0]["ms"],
            "decode_bound_ms": decode_rows[0]["bound_ms"]}


def _conv3d_sat_nwp_macs(model) -> int:
    """Multiply-accumulates of one example's forward, from the layer
    shapes: each conv's output elements × its kernel volume × input
    channels, plus every linear layer's weights."""
    import torch.nn as nn

    macs = 0
    towers = (("sat_conv", model.sat_time_steps, model.image_size_pixels),
              ("nwp_conv", model.seq_lens.seq_len_60, model.nwp_image_size_pixels))
    for prefix, time_steps, size in towers:
        for i in range(model.number_of_conv3d_layers):
            conv = getattr(model, f"{prefix}{i}")
            size -= 2
            macs += conv.weight.numel() * time_steps * size * size
    macs += sum(m.weight.numel() for m in model.modules() if isinstance(m, nn.Linear))
    return macs


def _timed_fit(trainer, batch_size=32, **fit_kwargs):
    """``trainer.fit`` of its set-up model, with a CUDA event recorded after
    every train step → (wall seconds, train steps, ms between the last
    ``STEADY_STEPS`` step ends, the median train examples/s of those gaps at
    ``batch_size``): the device's pace, step by step."""
    marks = []
    step = trainer.train_step

    def marked_step(batch):
        metrics = step(batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return metrics

    trainer.train_step = marked_step
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.fit(trainer._model, **fit_kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    gaps = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])][-STEADY_STEPS:]
    return seconds, len(marks), gaps, float(np.median([batch_size * 1e3 / gap for gap in gaps]))


def _rel_errs(grads, reference):
    """Per tensor: max |grad − reference| over max |reference|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(grads, reference)]


@contextlib.contextmanager
def _recorded_relus(namespace, decide=None):
    """Inside the block, each ``namespace.relu`` call (``F.relu`` or
    ``torch.relu``) records its decisions (input > 0) and ties on the host
    into the yielded ``(decisions, ties)`` lists: a tie is an input within
    ``RELU_TIE`` × the call's largest |input| of zero, recorded as that
    fraction (−1 elsewhere). With ``decide`` (another run's decisions, call
    by call) the ReLUs keep those inputs instead of their own positive ones."""
    relu, decisions, ties = namespace.relu, [], []

    def recording_relu(x, inplace=False):
        positive = x > 0
        keep = positive if decide is None else decide[len(decisions)].to(x.device)
        decisions.append(positive.cpu())
        fraction = x.abs() / x.abs().max().clamp_min(torch.finfo(x.dtype).tiny)
        ties.append(torch.where(fraction <= RELU_TIE, fraction, -1.0).cpu())
        return relu(x) if decide is None else x * keep

    namespace.relu = recording_relu
    try:
        yield decisions, ties
    finally:
        namespace.relu = relu


def _relu_decisions(trainer, host, decide=None):
    """``trainer.loss_and_grads(host)`` with each ``F.relu`` call's decisions
    and ties recorded (:func:`_recorded_relus`) → (metrics, grads,
    decisions, ties)."""
    import torch.nn.functional as F

    with _recorded_relus(F, decide) as (decisions, ties):
        metrics, grads = trainer.loss_and_grads(host)
    return metrics, grads, decisions, ties


def _train_parity(device, make_model=None, tag="train"):
    """(a) One train step on the card and on the CPU, both from the seed-0
    weights, in full fp32; ``make_model`` builds the model (by default the
    flagship at batch ``PARITY_BATCH``), whose own geometry the fake batch
    takes.

    The early conv layers' fp32 gradients are fixed only to ~1e-3 of their
    largest entry at this width: the CPU's two fp32 implementations (oneDNN
    and PyTorch's own kernels) differ that much on the same inputs
    (PERF.md, section 6). So the card's gradients are held to the CPU's within
    the larger of ``GRAD_REL_TOL`` and ``GRAD_SPREAD_FACTOR`` times that
    spread, measured in the same run.

    A ReLU input within fp32 rounding of zero (a tie) may round to either
    side on the card and on the CPU, and the gradients of every layer below
    it then differ by its contribution (PERF.md, PR 7). So the CPU's
    gradients the card is held to are taken on the card's ReLU decisions
    (:func:`_relu_decisions`), and every decision the two disagree on must
    be a tie."""
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    if make_model is None:
        config = {k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"}
        config["batch_size"] = PARITY_BATCH

        def make_model():
            return Model(**config)

    geometry = make_model()
    host = FakeDataset(model_configuration(geometry), length=1)[0].numeric()
    results = []
    for on_card, where in ((True, device), (False, "cpu")):
        trainer = Trainer(device=where, profiler=None)
        trainer.setup(make_model())
        if not on_card:
            metrics, grads, decisions, ties = _relu_decisions(trainer, host)
            torch.backends.mkldnn.enabled = False
            try:
                _, native = trainer.loss_and_grads(host)
            finally:
                torch.backends.mkldnn.enabled = True
            # the reference: the CPU's gradients on the card's ReLU decisions, and its Adam step from them
            own, grads = grads, _relu_decisions(trainer, host, decide=card_decisions)[1]
        else:
            metrics, grads, card_decisions, _ = _relu_decisions(trainer, host.to(where))
        trainer.apply_gradients(grads)
        results.append((float(metrics["NMAE"]), [g.cpu() for g in grads],
                        {k: v.cpu() for k, v in trainer._model.state_dict().items()}))
        del trainer, grads
    (card_loss, card_grads, card_params), (cpu_loss, cpu_grads, cpu_params) = results
    flips = [a != b for a, b in zip(decisions, card_decisions)]
    n_flips = sum(int(f.sum()) for f in flips)
    n_ties = sum(int((t >= 0).sum()) for t in ties)
    check(all(not (f & (t < 0)).any() for f, t in zip(flips, ties)),
          "the card and the CPU decide a ReLU input that is not a tie differently")
    flip_size = max((float(t[f].max()) for f, t in zip(flips, ties) if f.any()), default=0.0)
    unaligned = max(_rel_errs(card_grads, own))
    loss_err = abs(card_loss - cpu_loss)
    grad_errs, spread = _rel_errs(card_grads, cpu_grads), _rel_errs(native, own)
    grad_tol = max(GRAD_REL_TOL, GRAD_SPREAD_FACTOR * max(spread))
    param_err = max(float((card_params[k] - cpu_params[k]).abs().max()) for k in cpu_params)
    over = sum(int(((card_params[k] - cpu_params[k]).abs() > 5e-5).sum()) for k in cpu_params)
    n_params = sum(v.numel() for v in cpu_params.values())
    above = sum(err > GRAD_REL_TOL for err in grad_errs)
    log(f"[{tag}] (a) one step at batch {geometry.batch_size}, card vs CPU: NMAE {card_loss:.7f} vs {cpu_loss:.7f} "
        f"(|Δ| {loss_err:.3e}, limit {STEP_LOSS_TOL}); gradients max |Δ| / max |g| {max(grad_errs):.3e} "
        f"({above} of {len(grad_errs)} tensors above {GRAD_REL_TOL}) against the CPU's on the card's ReLU "
        f"decisions ({n_flips} of the CPU's {n_ties} ties decided the other way, the largest at {flip_size:.2e} of "
        f"its call's largest input; on its own decisions {unaligned:.3e}); the CPU's two fp32 implementations "
        f"differ by {max(spread):.3e} ({sum(e > GRAD_REL_TOL for e in spread)} tensors above {GRAD_REL_TOL}), "
        f"limit {grad_tol:.3e}; parameters after Adam max |Δ| {param_err:.3e} (limit {STEP_PARAM_TOL}), "
        f"{over} of {n_params:,} differ by more than 5e-5")
    check(loss_err <= STEP_LOSS_TOL, "the card's NMAE disagrees with the CPU's")
    check(max(grad_errs) <= grad_tol, "a card gradient disagrees with the CPU's")
    check(param_err <= STEP_PARAM_TOL, "the card's Adam step disagrees with the CPU's")
    return {"step_nmae_err": loss_err, "step_grad_rel_err": max(grad_errs), "cpu_grad_spread": max(spread),
            "relu_flips": n_flips, "relu_flip_size": flip_size, "step_grad_rel_err_own_decisions": unaligned,
            "step_param_err": param_err}


def _train_bound_ms(model, batch_size, bandwidth, flops_peak):
    """The least device time of one train step: forward, data-gradient and
    weight-gradient products (3 × the forward's FLOPs) at the fp32 rate,
    plus Adam's 7 × 4 B per parameter (read p, g, m, v; write p, m, v) at
    the memory rate."""
    flops = 3 * 2 * _conv3d_sat_nwp_macs(model) * batch_size
    adam_bytes = 7 * 4 * sum(p.numel() for p in model.parameters())
    return flops / flops_peak * 1e3 + adam_bytes / bandwidth * 1e3, flops, adam_bytes


def _check_train_csvs(log_dir, results_csv, train_steps, val_batches):
    """metrics.csv: finite per-step train rows and ``*_epoch`` rows; the
    validation results: val_batches × 32 × 4 rows."""
    import csv
    import math

    with open(f"{log_dir}/metrics.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    steps = [r for r in rows if r.get("NMAE/Train")]
    check(len(steps) == train_steps, f"{len(steps)} per-step train rows, expected {train_steps}")
    check(all(math.isfinite(float(r["NMAE/Train"])) for r in steps), "a non-finite train row")
    for key in ("NMAE/Train_epoch", "MSE/Validation_epoch"):
        values = [float(r[key]) for r in rows if r.get(key)]
        check(len(values) == 1 and math.isfinite(values[0]), f"{key}: {values}")
    with open(results_csv, newline="") as fh:
        results = list(csv.reader(fh))
    check(len(results) - 1 == val_batches * 32 * 4, f"{len(results) - 1} validation result rows")
    return len(rows), len(results) - 1


def _wgrad_cases(model, batch_size=32):
    """(label, x shape, padding) of the twelve tower convolutions of one
    train step of ``model`` at ``batch_size``."""
    towers = (("sat_conv", model.sat_time_steps, model.image_size_pixels),
              ("nwp_conv", model.seq_lens.seq_len_60, model.nwp_image_size_pixels))
    cases = []
    for prefix, time_steps, size in towers:
        for i in range(model.number_of_conv3d_layers):
            conv = getattr(model, f"{prefix}{i}")
            cases.append((f"{prefix}{i}", (batch_size, conv.in_channels, time_steps, size, size), conv.padding))
            size -= 2
    return cases


def _wgrad_kernel(device, flops_peak):
    """7 (w): the weight-gradient kernel at the twelve tower shapes of the
    train step (batch 32) and at edge shapes, against its plain version and
    cuDNN's weight gradient; two launches bit-equal; device times against
    the fp32 bound → per-shape rows."""
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.ops import conv3d_wgrad as wgrad
    from predict_pv_yield_tpu_torch.utils import full_fp32

    generator = torch.Generator(device=device).manual_seed(0)

    def inputs(shape, co, padding):
        x = torch.randn(shape, generator=generator, device=device)
        out = [shape[0], co, *(size + 2 * p - 2 for size, p in zip(shape[2:], padding))]
        grad = torch.randn(out, generator=generator, device=device)
        weight = torch.randn((co, shape[1], 3, 3, 3), generator=generator, device=device)
        return x, grad, weight

    def library(x, grad, weight, padding):
        """cuDNN's weight and bias gradients (the parent's path), TF32 off."""
        with full_fp32():
            return torch.ops.aten.convolution_backward(grad, x, weight, [weight.shape[0]], (1, 1, 1), padding,
                                                       (1, 1, 1), False, (0, 0, 0), 1, (False, True, True))[1:]

    def held(label, x, grad, weight, padding):
        kernel = wgrad.conv3d_wgrad(x, grad, padding=padding)
        again = wgrad.conv3d_wgrad(x, grad, padding=padding)
        plain = wgrad.conv3d_wgrad_reference(x, grad, padding)
        cudnn = library(x, grad, weight, padding)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(kernel, again)), f"conv3d_wgrad {label}: two launches differ")
        errs, spreads = [], []
        for mine, ref, lib in zip(kernel, plain, cudnn):
            scale = float(ref.abs().max())
            errs.append(float((mine - ref).abs().max()) / scale)
            spreads.append(float((lib - ref).abs().max()) / scale)
        tol = max(WGRAD_REL_TOL, WGRAD_SPREAD_FACTOR * max(spreads))
        check(max(errs) <= tol, f"conv3d_wgrad {label} {tuple(x.shape)}: max|kernel-plain| / max|plain| "
                                f"(dW, db) {errs} > {tol:.3e} (cuDNN's: {spreads})")
        return errs, spreads

    # edge shapes: full padding, one input channel, two chunks of input and
    # of output channels, a row wider than one tile, a single row
    for label, shape, co, padding in [("pad 1,1,1", (2, 32, 3, 7, 9), 32, (1, 1, 1)),
                                      ("c_in 1", (3, 1, 4, 9, 9), 32, (1, 0, 0)),
                                      ("c_in 40, c_out 40", (2, 40, 3, 6, 70), 40, (0, 1, 1)),
                                      ("c_out 8, wide", (2, 11, 3, 5, 150), 8, (1, 0, 0)),
                                      ("one row", (2, 16, 3, 3, 5), 32, (0, 0, 0))]:
        errs, spreads = held(label, *inputs(shape, co, padding), padding)
        log(f"[train] (w) {label} {shape} -> c_out {co}, padding {padding}: max err (dW, db) "
            f"{errs[0]:.3e}, {errs[1]:.3e} of max |plain|; cuDNN {spreads[0]:.3e}, {spreads[1]:.3e}")

    model = Model(**{k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"})
    rows = []
    for label, shape, padding in _wgrad_cases(model):
        x, grad, weight = inputs(shape, model.conv3d_channels, padding)
        errs, spreads = held(label, x, grad, weight, padding)
        flops = 2 * weight.numel() * grad[:, 0].numel()
        row = {
            "case": label, "shape": list(shape), "padding": list(padding), "gflop": flops / 1e9,
            "max_err_dw": errs[0], "max_err_db": errs[1], "cudnn_err_dw": spreads[0],
            "ms": device_ms(lambda: wgrad.conv3d_wgrad(x, grad, padding=padding), kernel="conv3d_wgrad_kernel",
                            calls=20),
            "call_device_ms": device_ms(lambda: wgrad.conv3d_wgrad(x, grad, padding=padding), calls=20),
            "plain_ms": device_ms(lambda: wgrad.conv3d_wgrad_reference(x, grad, padding), calls=5),
            "library_ms": device_ms(lambda: library(x, grad, weight, padding), calls=10),
            "bound_ms": flops / flops_peak * 1e3,
        }
        row["share_of_bound"] = row["bound_ms"] / row["call_device_ms"]
        rows.append(row)
        log("[train] (w) " + json.dumps(row))
        del x, grad, weight
    total = {key: sum(r[key] for r in rows) for key in ("gflop", "ms", "call_device_ms", "plain_ms",
                                                           "library_ms", "bound_ms")}
    total["share_of_bound"] = total["bound_ms"] / total["call_device_ms"]
    total["library_share_of_bound"] = total["bound_ms"] / total["library_ms"]
    log(f"[train] (w) the twelve tower shapes: {json.dumps(total)}")
    return rows, total


def _dgrad_kernel(device, flops_peak):
    """7 (w): the data-gradient kernel at the ten tower shapes of the train
    step (batch 32; the first layers' inputs need no gradient) and at edge
    shapes, against its plain version and cuDNN's data gradient; two
    launches bit-equal; device times against the fp32 bound → per-shape
    rows."""
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.ops import conv3d_dgrad as dgrad
    from predict_pv_yield_tpu_torch.utils import full_fp32

    generator = torch.Generator(device=device).manual_seed(1)

    def inputs(shape, co, padding):
        out = [shape[0], co, *(size + 2 * p - 2 for size, p in zip(shape[2:], padding))]
        grad = torch.randn(out, generator=generator, device=device)
        weight = torch.randn((co, shape[1], 3, 3, 3), generator=generator, device=device)
        return grad, weight

    def library(grad, weight, shape, padding):
        """cuDNN's data gradient (the parent's path), TF32 off."""
        x = torch.empty(shape, device=device)
        with full_fp32():
            return torch.ops.aten.convolution_backward(grad, x, weight, None, (1, 1, 1), padding, (1, 1, 1), False,
                                                       (0, 0, 0), 1, (True, False, False))[0]

    def held(label, grad, weight, shape, padding):
        kernel = dgrad.conv3d_dgrad(grad, weight, shape, padding=padding)
        again = dgrad.conv3d_dgrad(grad, weight, shape, padding=padding)
        plain = dgrad.conv3d_dgrad_reference(grad, weight, shape, padding)
        cudnn = library(grad, weight, shape, padding)
        torch.cuda.synchronize()
        check(torch.equal(kernel, again), f"conv3d_dgrad {label}: two launches differ")
        scale = float(plain.abs().max())
        err, spread = float((kernel - plain).abs().max()) / scale, float((cudnn - plain).abs().max()) / scale
        tol = max(DGRAD_REL_TOL, DGRAD_SPREAD_FACTOR * spread)
        check(err <= tol, f"conv3d_dgrad {label} {tuple(shape)}: max|kernel-plain| / max|plain| {err:.3e} > "
                          f"{tol:.3e} (cuDNN's: {spread:.3e})")
        return err, spread

    # edge shapes: full padding, no padding (conv3d.py's towers), uneven
    # channels, two chunks of input and of output channels, a row wider than
    # 64, a single row, a width under the narrowest tile
    for label, shape, co, padding in [("pad 1,1,1", (2, 32, 3, 7, 9), 32, (1, 1, 1)),
                                      ("pad 0", (2, 32, 5, 9, 10), 32, (0, 0, 0)),
                                      ("c_in 10, c_out 24", (3, 10, 4, 9, 13), 24, (1, 0, 0)),
                                      ("c_in 40, c_out 40", (2, 40, 3, 6, 70), 40, (0, 1, 1)),
                                      ("c_out 8, wide", (2, 11, 3, 5, 150), 8, (1, 0, 0)),
                                      ("one row", (2, 16, 3, 3, 5), 32, (0, 0, 0)),
                                      ("width 3", (2, 32, 4, 6, 3), 32, (1, 0, 1))]:
        err, spread = held(label, *inputs(shape, co, padding), shape, padding)
        log(f"[train] (w) dgrad {label} {shape} <- c_out {co}, padding {padding}: max err {err:.3e} of max |plain|; "
            f"cuDNN {spread:.3e}")

    model = Model(**{k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"})
    rows = []
    for label, shape, padding in _wgrad_cases(model):
        if label.endswith("conv0"):  # the imagery: no input gradient
            continue
        grad, weight = inputs(shape, model.conv3d_channels, padding)
        err, spread = held(label, grad, weight, shape, padding)
        flops = 2 * weight.numel() * grad[:, 0].numel()
        row = {
            "case": label, "shape": list(shape), "padding": list(padding), "gflop": flops / 1e9,
            "max_err": err, "cudnn_err": spread,
            "call_device_ms": device_ms(lambda: dgrad.conv3d_dgrad(grad, weight, shape, padding=padding),
                                        kernel="conv3d_dgrad_kernel", calls=20),
            "plain_ms": device_ms(lambda: dgrad.conv3d_dgrad_reference(grad, weight, shape, padding), calls=5),
            "library_ms": device_ms(lambda: library(grad, weight, shape, padding), calls=10),
            "bound_ms": flops / flops_peak * 1e3,
        }
        row["share_of_bound"] = row["bound_ms"] / row["call_device_ms"]
        rows.append(row)
        log("[train] (w) dgrad " + json.dumps(row))
        del grad, weight
    total = {key: sum(r[key] for r in rows) for key in ("gflop", "call_device_ms", "plain_ms", "library_ms",
                                                           "bound_ms")}
    total["share_of_bound"] = total["bound_ms"] / total["call_device_ms"]
    total["library_share_of_bound"] = total["bound_ms"] / total["library_ms"]
    log(f"[train] (w) dgrad, the ten tower shapes: {json.dumps(total)}")
    return rows, total


def phase_train(device, bandwidth, flops_peak):
    """The conv3d_sat_nwp training path at the full width of its YAML."""
    import copy
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.config.instantiate import instantiate
    from predict_pv_yield_tpu_torch.data.batch import Batch
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.ops import conv3d_dgrad as dgrad
    from predict_pv_yield_tpu_torch.ops import conv3d_wgrad as wgrad
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint, load_state
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.loggers import CSVLogger
    from predict_pv_yield_tpu_torch.training.pipeline import train

    blur.launches = 0
    wgrad_rows, wgrad_total = _wgrad_kernel(device, flops_peak)
    dgrad_rows, dgrad_total = _dgrad_kernel(device, flops_peak)
    _train_parity(device)

    config = {k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"}
    geometry = Model(**config)
    start = time.perf_counter()
    dataset = FakeDataset(model_configuration(geometry), length=TRAIN_UNIQUE + VAL_BATCHES)
    unique = [dataset[i] for i in range(TRAIN_UNIQUE + VAL_BATCHES)]
    train_batches = unique[:TRAIN_UNIQUE] * (TRAIN_BATCHES // TRAIN_UNIQUE)
    val_batches = unique[TRAIN_UNIQUE:]
    log(f"[train] (b) {TRAIN_UNIQUE + VAL_BATCHES} host batches of 32 generated before timing in "
        f"{time.perf_counter() - start:.2f} s; {TRAIN_BATCHES} train (the {TRAIN_UNIQUE} first, "
        f"{TRAIN_BATCHES // TRAIN_UNIQUE} times), {VAL_BATCHES} validation")

    # the train step alone: device time and its top kernels
    profiled = Trainer(device=device, profiler=None)
    profiled.setup(Model(**config))
    card_batch = unique[0].numeric().to(device)
    events = _device_events(lambda: profiled.train_step(card_batch), calls=10)
    step_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    bound_ms, flops, adam_bytes = _train_bound_ms(profiled._model, 32, bandwidth, flops_peak)
    log(f"[train] train step device time per batch of 32: {step_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP at fp32 + Adam {adam_bytes / 1e9:.3f} GB), "
        f"{bound_ms / step_ms:.1%} of it")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[train]   {e.self_device_time_total / 10 / 1e3:8.4f} ms  x{e.count // 10:<3d} {e.key[:110]}")
    # not on the path: the same step with cuDNN held to deterministic
    # algorithms, what bit-exact resume on the card would cost (ROADMAP M7)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        events = _device_events(lambda: profiled.train_step(card_batch), calls=10)
    deterministic_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    log(f"[train] the same step with cudnn.deterministic (not the path): {deterministic_ms:.4f} ms; top: "
        + "; ".join(f"{e.self_device_time_total / 10 / 1e3:.4f} ms x{e.count // 10} {e.key[:60]}"
                    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:3]))
    del profiled, card_batch

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (b) the timed fit; a CUDA event after each train step gives the
            # device's pace, step by step
            stopper = EarlyStopping()
            logger = CSVLogger(save_dir=tmp)
            trainer = Trainer(max_epochs=1, device=device, logger=logger,
                              callbacks=[ModelCheckpoint(dirpath=f"{tmp}/ck"), stopper])
            trainer.setup(Model(**config))
            torch.cuda.reset_peak_memory_stats(device)
            wgrad.launches = dgrad.launches = 0
            fit_seconds, steps, gaps, rate = _timed_fit(trainer, train_dataloaders=train_batches,
                                                        val_dataloaders=val_batches)
            fit_launches, dgrad_fit_launches = wgrad.launches, dgrad.launches
            check(fit_launches > 0, "the fit's backward did not go through conv3d_wgrad")
            check(dgrad_fit_launches > 0, "the fit's backward did not go through conv3d_dgrad")
            peak = torch.cuda.max_memory_allocated(device)
            check(trainer.global_step == TRAIN_BATCHES and steps == TRAIN_BATCHES, "train steps")
            log(f"[train] fit over {TRAIN_BATCHES}x32 train + {VAL_BATCHES}x32 validation batches (copies, "
                f"checkpoints and CSVs included): {fit_seconds:.3f} s; steady pace of the last {STEADY_STEPS} steps "
                f"{np.median(gaps):.4f} ms per step (median), {rate:.2f} train examples/s; peak device memory "
                f"{peak / 2**30:.3f} GiB")
            rows, results = _check_train_csvs(logger.log_dir, f"{tmp}/results_epoch_0.csv", TRAIN_BATCHES, VAL_BATCHES)
            step_span = trainer.profiler.spans["train.step"]
            check(step_span.count == TRAIN_BATCHES, f"{step_span.count} train.step spans, expected {TRAIN_BATCHES}")
            log(f"[train] metrics.csv {rows} rows (finite per-step and *_epoch rows); results_epoch_0.csv "
                f"{results} rows; train.step span: {step_span.count} steps, {step_span.host_s:.3f} s on the host; "
                f"conv3d_wgrad launched {fit_launches} times ({fit_launches / steps:.2f} a step; 12 tower layers), "
                f"conv3d_dgrad {dgrad_fit_launches} ({dgrad_fit_launches / steps:.2f} a step; 10 with an input "
                f"gradient)")

            # (c) round trip of `last` into a fresh trainer
            last = f"{tmp}/ck/last"
            saved = load_state(last)
            resumed = Trainer(max_epochs=1, device=device, profiler=None, resume_from_checkpoint=last,
                              callbacks=[ModelCheckpoint(dirpath=f"{tmp}/ck2"), EarlyStopping()])
            resumed.setup(Model(**config))
            live, loaded = trainer.state, resumed.state
            check(all(torch.equal(live["model"][k], loaded["model"][k]) for k in live["model"]), "parameters differ")
            moments = [(a[key], b[key]) for a, b in zip(live["optimizer"]["state"].values(),
                                                        loaded["optimizer"]["state"].values())
                       for key in ("exp_avg", "exp_avg_sq", "step")]
            check(len(moments) == 3 * len(live["model"]) and all(torch.equal(a, b) for a, b in moments),
                  "Adam moments or step differ")
            check(all(torch.equal(saved["model"][k], live["model"][k].cpu()) for k in live["model"]), "state.pt")
            check((resumed.global_step, resumed.current_epoch) == (trainer.global_step, trainer.current_epoch)
                  and resumed.callbacks[0].state_dict() == stopper.state_dict(), "loop.json counters")
            adam_step = int(moments[2][0])
            batch = Batch.from_host(val_batches[0]).numeric().to(device)
            losses = [float(t.train_step(batch)["NMAE"]) for t in (trainer, resumed)]
            check(abs(losses[0] - losses[1]) <= ROUND_TRIP_TOL, f"next-step NMAE {losses}")
            log(f"[train] (c) `last` round trip: parameters, Adam moments and step ({adam_step}), "
                f"global_step {resumed.global_step} bit-equal; next step NMAE {losses[0]:.7f} / {losses[1]:.7f}")
            del trainer, resumed, live, loaded, saved, moments

            # busy share of a traced fit of 8 steps (set-up outside the trace)
            traced, warmup, replica = (Trainer(max_epochs=1, device=device, profiler=None) for _ in range(3))
            for t in (traced, warmup, replica):
                t.setup(Model(**config))
            busy, wall = _busy_share(lambda: traced.fit(traced._model, train_dataloaders=train_batches[:8]),
                                     warm=lambda: warmup.fit(warmup._model, train_dataloaders=train_batches[:2]),
                                     replica=lambda: replica.fit(replica._model, train_dataloaders=train_batches[:8]),
                                     what="[train] the 8-step fit")
            log(f"[train] device busy {busy:.1%} of a traced 8-step fit ({wall * 1e3:.3f} ms)")
            del traced, warmup, replica

            # (d) the pipeline on the literal composed config
            os.makedirs(f"{tmp}/pipeline")
            os.chdir(f"{tmp}/pipeline")
            run_config = copy.deepcopy(TRAIN_CONFIG)
            datamodule = instantiate(run_config["datamodule"])
            datamodule.configuration = model_configuration(geometry)  # the model's geometry, set in code
            start = time.perf_counter()
            metric = train(run_config, datamodule=datamodule)
            seconds = time.perf_counter() - start
            check(metric is not None and np.isfinite(metric), f"optimized_metric {metric}")
            check(os.path.exists("checkpoints/epoch_000/state.pt") and os.path.exists("checkpoints/last/state.pt"),
                  "the pipeline wrote no best checkpoint")
            log(f"[train] (d) train(config) of {' '.join(TRAIN_OVERRIDES)}: {TRAIN_CONFIG['optimized_metric']} "
                f"{metric:.6f}, best checkpoint checkpoints/epoch_000 written, {seconds:.2f} s")
        finally:
            os.chdir(cwd)
    check(blur.launches == 0, "the train path launched sep_blur")
    return {"train_step_ms": step_ms, "train_step_deterministic_ms": deterministic_ms,
            "train_bound_ms": bound_ms, "train_examples_per_s": rate,
            "train_busy_share": busy, "train_fit_seconds": fit_seconds, "train_peak_bytes": peak,
            "wgrad_rows": wgrad_rows, "wgrad_total": wgrad_total, "wgrad_fit_launches": fit_launches,
            "dgrad_rows": dgrad_rows, "dgrad_total": dgrad_total, "dgrad_fit_launches": dgrad_fit_launches}


def _stream_archive(root, seed=0, compressor="zlib"):
    """Phase 8 (a)'s archives under ``root``, from ``seed``: the satellite
    and NWP zarr stores (the port's writer; the satellite imagery with
    ``compressor``, the rest zlib) and the PVLive CSV; every value follows
    the learnable brightness signal (``data/synthetic.py``). Returns
    (satellite store, NWP store, CSV, bytes before compression)."""
    import csv
    import os

    from predict_pv_yield_tpu_torch.consts import SAT_MEAN, SAT_STD, SAT_VARIABLE_NAMES
    from predict_pv_yield_tpu_torch.data.synthetic import brightness_signal
    from predict_pv_yield_tpu_torch.data.zarr_reader import write_zarr

    rng = np.random.default_rng(seed)
    px, n = STREAM_PX, STREAM_FRAMES
    start = np.datetime64("2020-06-01T04:00", "ns")
    times = start + np.arange(n) * np.timedelta64(5, "m")
    yy, xx = np.meshgrid(np.linspace(0, np.pi, px), np.linspace(0, np.pi, px), indexing="ij")
    gain = (1.0 + 0.2 * np.sin(yy) * np.cos(xx)).astype(np.float32)
    x, y = np.arange(px) * 2000.0 + 100_000.0, np.arange(px) * 2000.0 + 500_000.0

    channels = [SAT_VARIABLE_NAMES.index(c) for c in CONV3D_SAT_NWP_CHANNELS]
    level = (2.0 * brightness_signal(np.arange(n) * 5.0) - 1.0).astype(np.float32)
    counts = np.empty((n, len(channels), px, px), np.int16)
    for i, c in enumerate(channels):
        normed = level[:, None, None] * gain + 0.02 * rng.standard_normal((n, px, px), dtype=np.float32)
        counts[:, i] = np.clip(SAT_MEAN[c] + SAT_STD[c] * normed, 0, 1023).astype(np.int16)
    sat = os.path.join(root, "satellite.zarr")
    write_zarr(os.path.join(sat, "time"), times.astype("datetime64[m]").astype(np.int64), chunks=(n,),
               attrs={"units": "minutes since 1970-01-01T00:00"})
    write_zarr(os.path.join(sat, "x"), x, chunks=(px,))
    write_zarr(os.path.join(sat, "y"), y, chunks=(px,))

    hour = np.timedelta64(60, "m")
    n_init = int((times[-1] + hour - (start - hour)) / hour) + 1
    inits = start - hour + np.arange(n_init) * hour
    steps = np.arange(STREAM_NWP_STEPS) * 30
    valid = (inits[:, None] - start) / np.timedelta64(1, "m") + steps[None, :]
    scale = 1.0 + 0.1 * np.arange(10, dtype=np.float32)  # one level per channel
    values = brightness_signal(valid).astype(np.float32)[:, None, :, None, None] * scale[None, :, None, None, None]
    values = np.round(values * gain * 16) / 16  # (init, variable, step, y, x) on a 1/16 grid
    nwp = os.path.join(root, "nwp.zarr")
    write_zarr(os.path.join(sat, "data"), counts, chunks=(STREAM_CHUNK, len(channels), px, px),
               compressor=compressor)
    write_zarr(os.path.join(nwp, "data"), values.astype(np.float32), chunks=(1, 10, STREAM_NWP_STEPS, px, px))
    write_zarr(os.path.join(nwp, "init_time"), inits.astype("datetime64[m]").astype(np.int64), chunks=(n_init,),
               attrs={"units": "minutes since 1970-01-01T00:00"})
    write_zarr(os.path.join(nwp, "step"), steps.astype(np.int64), chunks=(len(steps),), attrs={"units": "minutes"})
    write_zarr(os.path.join(nwp, "x"), x, chunks=(px,))
    write_zarr(os.path.join(nwp, "y"), y, chunks=(px,))

    half = np.timedelta64(30, "m")
    gsp_times = start - half + np.arange(int((times[-1] + 2 * hour - start) / half) + 1) * half
    level = brightness_signal((gsp_times - start) / np.timedelta64(1, "m"))
    path = os.path.join(root, "pvlive.csv")
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["datetime_gmt", "gsp_id", "generation_mw", "capacity_mwp"])
        for t, v in zip(gsp_times, level):
            for g in range(STREAM_GSPS):
                capacity = 100.0 + 40.0 * g
                writer.writerow([str(t), 101 + g, capacity * v, capacity])
    return sat, nwp, path, counts.nbytes + values.nbytes


def _data_model(device, configuration):
    """The flagship at full width, ``fc3`` sized for ``configuration``'s
    yield history, set up on a fresh trainer (outside any timing)."""
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    model = Model(**{k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"})
    model.match_configuration(configuration)
    trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None)
    trainer.setup(model)
    return trainer


def _loader_profile(dataset, top: int = 8, tag: str = "[data] (a)"):
    """Where one thread's time goes building the batches of ``dataset``:
    ``cProfile`` over all of them, the functions with the most own time.
    Returns the shares of that thread's time in decompression: zlib's own
    time, and the cumulative time of the blosc frame decode (the native LZ4
    calls included)."""
    import cProfile
    import pstats

    profiler = cProfile.Profile()
    profiler.enable()
    for i in range(len(dataset)):
        dataset[i]
    profiler.disable()
    stats = pstats.Stats(profiler)
    examples = len(dataset) * dataset.batch_size
    log(f"{tag} host profile of {len(dataset)} batches on one thread: {stats.total_tt:.3f} s, "
        f"{stats.total_tt / examples * 1e3:.3f} ms per example; most own time:")
    rows = sorted(stats.stats.items(), key=lambda item: -item[1][2])[:top]
    phase = tag.split(" ")[0]
    for (filename, line, name), (_, calls, own, cumulative, _) in rows:
        where = f"{filename.rsplit('/', 1)[-1]}:{line}" if line else filename
        log(f"{phase}   {own / examples * 1e3:8.3f} ms/example own, {cumulative / examples * 1e3:8.3f} cumulative, "
            f"{calls:6d} calls  {name} ({where})")
    zlib_s = sum(own for (_, _, name), (_, _, own, _, _) in stats.stats.items() if "zlib.decompress" in name)
    blosc_s = sum(cumulative for (filename, _, name), (_, _, _, cumulative, _) in stats.stats.items()
                  if filename.endswith("blosc.py") and name == "decompress")
    return {"zlib_share": zlib_s / stats.total_tt, "blosc_share": blosc_s / stats.total_tt,
            "ms_per_example": stats.total_tt / examples * 1e3}


def _stream_datamodule(sat, nwp, csv_path, workers, n_train=TRAIN_BATCHES, n_val=VAL_BATCHES):
    """The zarr-stream datamodule over :func:`_stream_archive`'s archives at
    the flagship's widths (batch 32, one GSP per example)."""
    from predict_pv_yield_tpu_torch.data.loader import ZarrStreamDataModule

    return ZarrStreamDataModule(
        zarr_path=sat, nwp_zarr_path=nwp, nwp_image_size_pixels=CONV3D_SAT_NWP.get("nwp_image_size_pixels", 64),
        gsp_csv=csv_path, n_gsp=1, batch_size=32, history_minutes=CONV3D_SAT_NWP["history_minutes"],
        forecast_minutes=CONV3D_SAT_NWP["forecast_minutes"],
        satellite_image_size_pixels=CONV3D_SAT_NWP["image_size_pixels"],
        n_train_data=n_train, n_val_data=n_val, num_workers=workers)


def _data_stream(device, tmp, cached):
    """(a) The zarr stream at the flagship's widths."""
    start = time.perf_counter()
    sat, nwp, csv_path, nbytes = _stream_archive(tmp)
    log(f"[data] (a) wrote the zarr archives ({STREAM_FRAMES} frames x {len(CONV3D_SAT_NWP_CHANNELS)} channels "
        f"at {STREAM_PX} px, hourly NWP runs of 10 channels x {STREAM_NWP_STEPS} steps at {STREAM_PX} px; "
        f"{nbytes / 1e6:.1f} MB before zlib) and the CSV of {STREAM_GSPS} GSPs: "
        f"{time.perf_counter() - start:.2f} s")

    def datamodule(workers, n_train=TRAIN_BATCHES, n_val=VAL_BATCHES):
        return _stream_datamodule(sat, nwp, csv_path, workers, n_train, n_val)

    loader_rates = {}
    for workers in STREAM_WORKERS:
        loader = datamodule(workers, n_train=LOADER_BATCHES).train_dataloader()
        start = time.perf_counter()
        batches = list(loader)
        seconds = time.perf_counter() - start
        loader_rates[workers] = LOADER_BATCHES * 32 / seconds
        log(f"[data] (a) loader alone, num_workers {workers}: {LOADER_BATCHES} batches of 32 in {seconds:.3f} s, "
            f"{LOADER_BATCHES / seconds:.2f} batches/s, {loader_rates[workers]:.2f} examples/s")
    batch = batches[0]
    profile = _loader_profile(datamodule(0, n_train=2).train_dataloader().dataset)
    log(f"[data] (a) one loader thread's time in zlib: {profile['zlib_share']:.1%}")
    check(tuple(batch.satellite.data.shape) == (32, 11, 31, 24, 24) and tuple(batch.nwp.data.shape) ==
          (32, 10, 4, 64, 64) and tuple(batch.gsp.gsp_yield.shape) == (32, 6, 1), "zarr-stream batch shapes")
    check(all(bool(torch.isfinite(leaf.float()).all()) for leaf in batch.leaves()), "a non-finite streamed field")

    dm = datamodule(STREAM_WORKERS[0])
    trainer = _data_model(device, dm.configuration)
    seconds, steps, gaps, rate = _timed_fit(trainer, datamodule=dm)
    check(steps == TRAIN_BATCHES and trainer.global_step == TRAIN_BATCHES, "zarr-stream fit steps")
    nmae = trainer.callback_metrics.get("NMAE/Validation_epoch")
    check(nmae is not None and np.isfinite(nmae), f"zarr-stream validation NMAE {nmae}")
    log(f"[data] (a) fit from the zarr stream, {TRAIN_BATCHES}x32 train + {VAL_BATCHES}x32 validation batches "
        f"(num_workers {STREAM_WORKERS[0]}): {seconds:.3f} s; steady pace of the last {STEADY_STEPS} steps "
        f"{np.median(gaps):.4f} ms per step (median), {rate:.2f} train examples/s (cached batches, phase 7: "
        f"{cached['train_step_ms']:.4f} ms of device time per step, {cached['train_examples_per_s']:.2f} examples/s); "
        f"validation NMAE {nmae:.6f}")
    del trainer

    traced, warmup, replica = (_data_model(device, dm.configuration) for _ in range(3))
    short = datamodule(STREAM_WORKERS[0], n_train=8, n_val=1)
    busy, wall = _busy_share(lambda: traced.fit(traced._model, datamodule=short), warm=lambda: warmup.fit(
        warmup._model, datamodule=datamodule(STREAM_WORKERS[0], n_train=2, n_val=1)),
        replica=lambda: replica.fit(replica._model, datamodule=datamodule(STREAM_WORKERS[0], n_train=8, n_val=1)),
        what="[data] (a) the zarr-stream fit")
    log(f"[data] (a) device busy {busy:.1%} of a traced 8-step fit from the zarr stream ({wall * 1e3:.3f} ms; "
        f"cached batches, phase 7: {cached['train_busy_share']:.1%})")
    return {"stream_loader_examples_per_s_2": loader_rates[2], "stream_loader_examples_per_s_8": loader_rates[8],
            "stream_train_examples_per_s": rate, "stream_busy_share": busy,
            "stream_zlib_share": profile["zlib_share"], "stream_ms_per_example": profile["ms_per_example"]}


def _shard_batches(n, seed):
    """``n`` fake batches at the model's geometry with int16 satellite
    counts and 5 % −1 holes (the decode's inputs in the serve phase)."""
    import dataclasses

    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.data.preprocess import channel_stats
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model

    configuration = model_configuration(Model(**{k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"}))
    mean, std = channel_stats(CONV3D_SAT_NWP_CHANNELS)
    shape = (1, -1, 1, 1, 1)
    generator = torch.Generator().manual_seed(seed)
    for batch in FakeDataset(configuration, length=n, seed=seed):
        sat = batch.satellite.data
        counts = torch.round(sat * std.view(shape) + mean.view(shape)).clamp(0, 1023).to(torch.int16)
        counts[torch.rand(counts.shape, generator=generator) < 0.05] = -1
        yield configuration, batch, batch.replace(satellite=dataclasses.replace(batch.satellite, data=counts))


def _yaml_configuration(configuration) -> str:
    """A dataset configuration as ``configuration.yaml`` text (JSON is YAML)."""
    input_data = configuration.input_data
    return json.dumps({
        "general": {"name": "chip_smoke", "description": "raw int16 shards at the flagship's geometry"},
        "process": {"batch_size": configuration.process.batch_size},
        "input_data": {
            "default_history_minutes": input_data.default_history_minutes,
            "default_forecast_minutes": input_data.default_forecast_minutes,
            "satellite": {"satellite_channels": list(input_data.satellite.satellite_channels),
                          "satellite_image_size_pixels": input_data.satellite.satellite_image_size_pixels},
            "nwp": {"nwp_channels": list(input_data.nwp.nwp_channels),
                    "nwp_image_size_pixels": input_data.nwp.nwp_image_size_pixels},
        },
    }, indent=1)


def _data_shards(device, tmp, cached):
    """(b) Raw int16 shards at the model's geometry: the decode inside the
    step, the fit from the shard datamodule, the bytes sent per batch."""
    import os

    from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
    from predict_pv_yield_tpu_torch.data.preprocess import preprocess_batch
    from predict_pv_yield_tpu_torch.data.shards import write_shard

    root = os.path.join(tmp, "prepared")
    start = time.perf_counter()
    for i, (configuration, float_batch, raw_batch) in enumerate(_shard_batches(SHARD_TRAIN + SHARD_VAL, seed=5)):
        split, index = ("train", i) if i < SHARD_TRAIN else ("test", i - SHARD_TRAIN)
        write_shard(os.path.join(root, split), index, raw_batch, fmt="raw")
    with open(os.path.join(root, "configuration.yaml"), "w") as fh:
        fh.write(_yaml_configuration(configuration))
    shard_mb = os.path.getsize(os.path.join(root, "train", "000000.shard")) / 1e6
    log(f"[data] (b) wrote {SHARD_TRAIN} + {SHARD_VAL} raw shards ({shard_mb:.1f} MB each): "
        f"{time.perf_counter() - start:.2f} s")
    sent = [sum(leaf.numel() * leaf.element_size() for leaf in b.numeric().leaves()) for b in (raw_batch, float_batch)]
    log(f"[data] (b) host->device bytes per batch: {sent[0] / 1e6:.3f} MB with int16 satellite counts, "
        f"{sent[1] / 1e6:.3f} MB with float32 (phase 7), {1 - sent[0] / sent[1]:.1%} less")

    dm = NetCDFDataModule(data_path=root, fake_data=False, num_workers=SHARD_WORKERS,
                          n_train_data=SHARD_TRAIN, n_val_data=SHARD_VAL)
    check(tuple(dm.configuration.input_data.satellite.satellite_channels) == CONV3D_SAT_NWP_CHANNELS,
          "the shards' configuration.yaml")
    first = next(iter(dm.val_dataloader()))
    check(first.satellite.data.dtype == torch.int16 and int((first.satellite.data == -1).sum()) > 0, "int16 shards")

    # the train step on an int16 batch: the decode runs inside it
    trainer = _data_model(device, dm.configuration)
    card = first.numeric().to(device)
    events = _device_events(lambda: trainer.train_step(card), calls=10)
    step_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    decode = _device_events(lambda: preprocess_batch(card, CONV3D_SAT_NWP_CHANNELS), calls=10)
    # each decode kernel launches once per call; the mean launch counts even
    # where CUPTI dropped a record
    decode_ms = sum(e.self_device_time_total / e.count for e in decode if e.count) / 1e3
    check(not preprocess_batch(card, CONV3D_SAT_NWP_CHANNELS).satellite.data.isnan().any(), "decode NaN")
    log(f"[data] (b) train step on an int16 batch of 32 (decode inside): {step_ms:.4f} ms of device time "
        f"(float32 batches, phase 7: {cached['train_step_ms']:.4f} ms); the decode alone {decode_ms:.4f} ms, "
        f"{decode_ms / step_ms:.2%} of the step:")
    for e in sorted(decode, key=lambda e: -e.self_device_time_total):
        log(f"[data]   {e.self_device_time_total / max(e.count, 1) / 1e3:8.4f} ms per launch, {e.count} launches "
            f"in 10 calls  {e.key[:100]}")
    del trainer, card

    trainer = _data_model(device, dm.configuration)
    trainer.max_epochs = SHARD_EPOCHS
    seconds, steps, gaps, rate = _timed_fit(trainer, datamodule=dm)
    check(steps == SHARD_TRAIN * SHARD_EPOCHS, "shard fit steps")
    log(f"[data] (b) fit from raw shards, {SHARD_EPOCHS} epochs of {SHARD_TRAIN}x32 train + {SHARD_VAL}x32 "
        f"validation batches (num_workers {SHARD_WORKERS}): {seconds:.3f} s; steady pace of the last {STEADY_STEPS} "
        f"steps {np.median(gaps):.4f} ms per step (median), {rate:.2f} train examples/s (phase 7: "
        f"{cached['train_examples_per_s']:.2f})")
    del trainer
    traced, warmup, replica = (_data_model(device, dm.configuration) for _ in range(3))
    warmup.max_steps = 2
    busy, wall = _busy_share(lambda: traced.fit(traced._model, datamodule=dm),
                             warm=lambda: warmup.fit(warmup._model, datamodule=dm),
                             replica=lambda: replica.fit(replica._model, datamodule=dm),
                             what="[data] (b) the shard fit")
    log(f"[data] (b) device busy {busy:.1%} of a traced {SHARD_TRAIN}-step fit from raw shards "
        f"({wall * 1e3:.3f} ms; phase 7: {cached['train_busy_share']:.1%})")
    return {"shard_train_step_ms": step_ms, "shard_decode_ms": decode_ms, "shard_decode_share": decode_ms / step_ms,
            "shard_train_examples_per_s": rate, "shard_busy_share": busy, "shard_bytes_per_batch": sent[0],
            "float_bytes_per_batch": sent[1]}


def _data_gate(tmp):
    """(c) The learning gate on the card: conv3d_sat_nwp trained through
    ``compose`` → ``train`` beats the persistence baseline."""
    import contextlib
    import io
    import os

    from predict_pv_yield_tpu_torch.data import synthetic

    start = time.perf_counter()
    archive = synthetic.make_learnable_archive(os.path.join(tmp, "learnable"), n_frames=288, px=24, n_gsp=4,
                                               seed=0, with_nwp=True)
    results = {}
    for name, overrides in (("trained", synthetic.CONV3D_GATE_OVERRIDES + ["trainer.max_epochs=4"]),
                            ("baseline", synthetic.BASELINE_GATE_OVERRIDES)):
        workdir = os.path.join(tmp, f"gate_{name}")
        os.makedirs(workdir)
        with contextlib.redirect_stdout(io.StringIO()):  # the config tree and the profiler summary
            results[name] = synthetic.run_learnable(archive, overrides, workdir=workdir)
    trained, baseline = results["trained"], results["baseline"]
    log(f"[data] (c) learning gate on the card: trained conv3d_sat_nwp {synthetic.GATE_METRIC} {trained:.6f}, "
        f"persistence baseline {baseline:.6f}, ratio {trained / baseline:.4f} (limit {GATE_MARGIN}); "
        f"{time.perf_counter() - start:.2f} s")
    check(trained < GATE_MARGIN * baseline, "the trained model does not beat persistence")
    return {"trained_nmae": trained, "baseline_nmae": baseline}


def phase_data(device, cached):
    """Phase 8: the flagship fed by the port's zarr-stream and shard
    loaders, the learning gate, and a package probe."""
    import importlib.util
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    blur.launches = 0
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = {**_data_stream(device, tmp, cached), **_data_shards(device, tmp, cached), **_data_gate(tmp)}
    probe = {name: importlib.util.find_spec(name) is not None for name in ("h5py", "zstandard", "fsspec")}
    log("[data] (d) packages on this machine: " + ", ".join(
        f"{name} {'imports' if found else 'missing'}" for name, found in probe.items()))
    log(f"[data] (d) host cores: os.cpu_count() {os.cpu_count()}, usable by this process "
        f"{len(os.sched_getaffinity(0))}")
    check(blur.launches == 0, "the data path launched sep_blur")
    log(f"[data] phase 8: {time.perf_counter() - start:.2f} s")
    return results


def _attention_precision(device):
    """Phase 9 (a): whether the memory-efficient SDPA kernel, the serve
    path's, computes fp32 attention in fp32 or in TF32. One call at
    perceiver.yaml's cross-attention shape (8 frames, 1 head: 128 latent
    queries over 4096 input tokens of 64 channels; seeded normal inputs, the
    queries ×3 for a sharp softmax) against the plain product in float64,
    beside the plain product in fp32 and with TF32 matmuls allowed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    generator = torch.Generator(device=device).manual_seed(0)
    q = 3 * torch.randn((8, 1, 128, 64), generator=generator, device=device)
    k, v = (torch.randn((8, 1, 4096, 64), generator=generator, device=device) for _ in range(2))

    def attend(backend, dtype=torch.float32):
        with torch.inference_mode(), sdpa_kernel(backend):
            return F.scaled_dot_product_attention(q.to(dtype), k.to(dtype), v.to(dtype)).double()

    reference = attend(SDPBackend.MATH, torch.float64)
    outputs = {"efficient": attend(SDPBackend.EFFICIENT_ATTENTION), "plain fp32": attend(SDPBackend.MATH)}
    matmul = torch.backends.cuda.matmul
    previous, matmul.allow_tf32 = matmul.allow_tf32, True
    try:
        outputs["plain TF32"] = attend(SDPBackend.MATH)
    finally:
        matmul.allow_tf32 = previous
    scale = float(reference.abs().max())
    errors = {name: float((out - reference).abs().max()) / scale for name, out in outputs.items()}
    log("[perceiver] (a) fp32 attention at (8,1,128,64) x (8,1,4096,64) against float64, max |Δ| / max |y|: "
        + ", ".join(f"{name} {err:.3e}" for name, err in errors.items()))
    return {f"attention_err_{name.replace(' ', '_')}": err for name, err in errors.items()}


def _perceiver_serve(device, name, config, batches, flops_peak):
    """Phase 9 (a) for one model on the host ``batches``: card vs CPU
    forward, the ``.ckpt`` round trip, forward device time against the
    bound, ``predict``'s rate and the busy share."""
    import os
    import tempfile

    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models import perceiver_core
    from predict_pv_yield_tpu_torch.utils import full_fp32

    model = serve.build_model(name, config, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    host = batches[0].numeric()
    batch_size = host.satellite.data.shape[0]
    few = host.map(lambda _, leaf: leaf[:PERCEIVER_PARITY_BATCH])  # the examples the CPU compares
    # the forecasts and the encoder's output (fc1's input): the head's ReLUs
    # can hide an encoder fault from the forecasts
    start = time.perf_counter()
    readings = _cpu_parity(model, few, device)
    readings["encoder"] = readings.pop("body")
    parity_seconds = time.perf_counter() - start
    card_batch = host.to(device)
    with torch.inference_mode(), full_fp32():
        on_card = model(card_batch)
    backend = perceiver_core.sdpa_backend(device).name  # the serve path's: no autograd
    log(f"[perceiver] {name}: {n_params:,} parameters, depth {model.perceiver.depth}; satellite "
        f"{tuple(host.satellite.data.shape)}, NWP {tuple(host.nwp.data.shape)}; card "
        f"({backend} attention) vs CPU at {PERCEIVER_PARITY_BATCH} example(s): "
        + "; ".join(f"{label} max abs diff {err:.3e}, limit {SERVE_TOL} x max |y| {scale:.4f}"
                    for label, (err, scale) in readings.items())
        + f" ({parity_seconds:.2f} s)")
    check(tuple(on_card.shape) == (batch_size, model.forecast_len) and bool(torch.isfinite(on_card).all()),
          "forward shape or NaN")
    for label, (err, scale) in readings.items():
        check(err <= SERVE_TOL * scale, f"card {label} disagree with the CPU's")

    # a perceiver_pytorch-layout Lightning checkpoint, loaded with strict=True
    state = model.state_dict()
    check(f"perceiver.layers.{model.perceiver.depth - 1}.2.0.0.fn.to_kv.weight" in state
          and model.perceiver.layers[1] is model.perceiver.layers[-1], "perceiver_pytorch layout or tying")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, f"{name}.ckpt")
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in state.items()}}, ckpt)
        loaded = serve.build_model(name, config, checkpoint=ckpt, seed=1).to(device)
    with torch.inference_mode(), full_fp32():
        again = loaded(card_batch)
    check(torch.equal(again, on_card), "the .ckpt round trip changed the forecasts")
    del loaded

    def forward():
        with torch.inference_mode(), full_fp32():
            model(card_batch)

    events = _device_events(forward, calls=PERCEIVER_TRACED_CALLS)
    forward_ms = sum(e.self_device_time_total for e in events) / PERCEIVER_TRACED_CALLS / 1e3
    flops = 2 * _perceiver_macs(model) * batch_size
    bound_ms = flops / flops_peak * 1e3
    attention = [e.key for e in events if "fmha" in e.key.lower() or "attention" in e.key.lower()]
    log(f"[perceiver] {name} .ckpt round trip (strict=True, {len(state)} keys): forecasts equal; forward device "
        f"time per batch of {batch_size}: {forward_ms:.4f} ms; fp32 bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP), {bound_ms / forward_ms:.1%} of it; attention kernels: "
        + ("; ".join(sorted(set(k[:90] for k in attention))) or "none named"))
    _top(events, "perceiver", n=8)
    rate, busy, seconds, traced = _serve_numbers(model, batches, device)
    log(f"[perceiver] {name} predict over {len(batches)} host batches of {batch_size}: "
        f"{seconds / len(batches) * 1e3:.4f} ms per batch, {rate:.2f} examples/s; device busy {busy:.1%} "
        f"of a traced call ({traced * 1e3:.3f} ms)")
    return {"serve_err": readings["forecasts"][0], "serve_err_limit": SERVE_TOL * readings["forecasts"][1],
            "encoder_err": readings["encoder"][0], "encoder_err_limit": SERVE_TOL * readings["encoder"][1],
            "forward_ms": forward_ms, "forward_bound_ms": bound_ms, "serve_examples_per_s": rate,
            "serve_busy_share": busy}


def _perceiver_train(device, name, config, unique, bandwidth, flops_peak):
    """Phase 9 (b) for one model on the ``unique`` host batches (train,
    then validation): one step card vs CPU, the step's device time against
    its bound, a timed fit, its busy share and peak memory."""
    from predict_pv_yield_tpu_torch.models import get_model

    cls = get_model(name)
    kwargs = {k: v for k, v in config.items() if k != "_target_"}
    start = time.perf_counter()
    parity = _train_parity(device, lambda: cls(**{**kwargs, "batch_size": PERCEIVER_PARITY_BATCH}), "perceiver")
    parity_seconds = time.perf_counter() - start

    batch_size = config["batch_size"]
    train_batches = unique[:TRAIN_UNIQUE] * (TRAIN_BATCHES // TRAIN_UNIQUE)

    events, step_ms, trained = _step_events(device, lambda: cls(**kwargs), unique[0].numeric().to(device))
    flops = 3 * 2 * _perceiver_macs(trained) * batch_size
    adam_bytes = 7 * 4 * sum(p.numel() for p in trained.parameters())
    bound_ms = flops / flops_peak * 1e3 + adam_bytes / bandwidth * 1e3
    del trained
    log(f"[perceiver] {name} train step device time per batch of {batch_size}: {step_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP at fp32 + Adam {adam_bytes / 1e9:.4f} GB), "
        f"{bound_ms / step_ms:.1%} of it")
    _top(events, "perceiver", n=8)
    traced_seconds = time.perf_counter() - start - parity_seconds

    rate, gap, peak, busy = _fit_numbers(device, lambda: cls(**kwargs), train_batches, unique[TRAIN_UNIQUE:],
                                         batch_size)
    log(f"[perceiver] {name} fit over {TRAIN_BATCHES}x{batch_size} train + {VAL_BATCHES}x{batch_size} validation "
        f"batches: steady pace of the last {STEADY_STEPS} steps {gap:.4f} ms per step (median), {rate:.2f} train "
        f"examples/s; peak device memory {peak / 2**30:.3f} GiB; device busy {busy:.1%} of a traced 8-step fit; "
        f"the one-step parity took {parity_seconds:.2f} s, the step's trace {traced_seconds:.2f} s")
    return {**parity, "train_step_ms": step_ms, "train_bound_ms": bound_ms, "train_examples_per_s": rate,
            "train_busy_share": busy, "train_peak_bytes": peak}


def _perceiver_pipeline(device):
    """Phase 9 (c): ``train(config)`` on the literal composed
    ``experiment=perceiver`` config, 2 train and 1 validation batch."""
    import copy
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.config.instantiate import instantiate
    from predict_pv_yield_tpu_torch.data.fake import model_configuration
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
    from predict_pv_yield_tpu_torch.training.pipeline import train

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            run_config = copy.deepcopy(PERCEIVER_TRAIN_CONFIG)
            datamodule = instantiate(run_config["datamodule"])
            model = PerceiverModel(**{k: v for k, v in run_config["model"].items() if k != "_target_"})
            datamodule.configuration = model_configuration(model)  # batches of the model's batch_size
            start = time.perf_counter()
            metric = train(run_config, datamodule=datamodule)
            seconds = time.perf_counter() - start
            check(metric is not None and np.isfinite(metric), f"optimized_metric {metric}")
            check(os.path.exists("checkpoints/epoch_000/state.pt"), "the pipeline wrote no best checkpoint")
        finally:
            os.chdir(cwd)
    log(f"[perceiver] (c) train(config) of {' '.join(PERCEIVER_TRAIN_OVERRIDES)}: "
        f"{PERCEIVER_TRAIN_CONFIG['optimized_metric']} {metric:.6f}, best checkpoint written, {seconds:.2f} s")


def _deterministic_pool(device):
    """Phase 9 (d): the max-pool gradient that the gate trains with under
    deterministic algorithms (``layers.DeterministicMaxPool3d``) against
    ``F.max_pool3d``'s own backward on the card, at the shape of the gate's
    satellite convolution (batch 8, 4 channels, 13 frames of 24 × 24);
    two of its runs must be bit-equal."""
    import torch.nn.functional as F

    from predict_pv_yield_tpu_torch.models.layers import DeterministicMaxPool3d

    generator = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4, 13, 24, 24, generator=generator)
    x[..., ::3, :] = x[..., ::3, :].round()  # ties inside overlapping windows
    x = x.to(device)
    upstream = torch.randn(8, 4, 13, 12, 12, generator=generator).to(device)

    def gradient(pool):
        leaf = x.clone().requires_grad_()
        (pool(leaf) * upstream).sum().backward()
        return leaf.grad

    plain = gradient(lambda t: F.max_pool3d(t, 3, stride=(1, 2, 2), padding=1))
    with _deterministic():
        ours, again = gradient(DeterministicMaxPool3d.apply), gradient(DeterministicMaxPool3d.apply)
    err, scale = (ours - plain).abs().max().item(), plain.abs().max().item()
    log(f"[perceiver] (d) deterministic max-pool gradient vs max_pool3d's on the card: max |err| {err:.3e} "
        f"(tol {POOL_GRAD_TOL:g} × max |g| {scale:.3f}); two runs bit-equal: {torch.equal(ours, again)}")
    check(err <= POOL_GRAD_TOL * scale, f"deterministic max-pool gradient off by {err:.3e}")
    check(torch.equal(ours, again), "the deterministic max-pool gradient differs between two runs")


class _GateProcess:
    """Phase 9 (d)'s training in a process of its own, ``python -m
    predict_pv_yield_tpu_torch.data.synthetic --deterministic``, started
    before phase 1 so that it trains while nvcc builds (the card is idle
    then). Leaving the block stops the process, whatever happened."""

    def __init__(self, *args):
        self.stderr = tempfile.TemporaryFile(mode="w+")
        self.start = time.perf_counter()
        self.process = subprocess.Popen(
            [sys.executable, "-m", "predict_pv_yield_tpu_torch.data.synthetic", *args],
            cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=self.stderr, text=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.process.poll() is None:
            self.process.kill()
        self.process.wait()
        self.stderr.close()

    def result(self) -> dict:
        """Wait for the process → its JSON line, with ``seconds`` added."""
        out, _ = self.process.communicate()
        if self.process.returncode != 0:
            self.stderr.seek(0)
            check(False, f"the perceiver gate's process exited with {self.process.returncode}: "
                         f"{self.stderr.read()[-2000:]}")
        return {**json.loads(out.strip().splitlines()[-1]), "seconds": time.perf_counter() - self.start}


def _perceiver_gate(baseline, run):
    """Phase 9 (d): the JAX package's perceiver learning gate on the card:
    perceiver_conv3d_sat_nwp at gate scale, 16 epochs at lr 1e-3, judged on
    its best validation epoch against the persistence ``baseline`` of the
    same archive (phase 8 (c) wrote it from the same seed; the gate's
    process, whose ``run`` this is, computed its own, which must equal it).
    It trains under deterministic algorithms: the card's atomics otherwise
    move the epoch at which the model leaves its plateau from run to run,
    and some runs had not left it by the 16th epoch."""
    from predict_pv_yield_tpu_torch.data import synthetic

    scores = run["scores"]
    check(run["deterministic"] and run["epochs"] == synthetic.PERCEIVER_GATE_EPOCHS
          and run["learning_rate"] == synthetic.PERCEIVER_GATE_LEARNING_RATE, f"the gate ran as {run}")
    check(len(scores) == synthetic.PERCEIVER_GATE_EPOCHS, f"{len(scores)} validation epochs")
    check(abs(run["baseline"] - baseline) <= 1e-6 * baseline,
          f"the gate's persistence baseline {run['baseline']} against phase 8's {baseline}")
    best = min(scores)
    log(f"[perceiver] (d) learning gate on the card, deterministic algorithms: perceiver_conv3d_sat_nwp best of "
        f"{len(scores)} validation epochs {synthetic.GATE_METRIC} {best:.6f} (epoch {scores.index(best)}; last "
        f"{scores[-1]:.6f}), persistence baseline {baseline:.6f}, ratio {best / baseline:.4f} (limit {GATE_MARGIN}); "
        f"{run['seconds']:.2f} s in its own process during phase 1")
    check(best < GATE_MARGIN * baseline, "the trained perceiver does not beat persistence")
    return {"trained_nmae": best, "baseline_nmae": baseline}


def phase_perceiver(device, bandwidth, flops_peak, baseline_nmae, gate_run):
    """Phase 9: the perceiver family, serve and train at the widths of its
    YAMLs, the pipeline and the learning gate (``gate_run``, against
    ``baseline_nmae``, phase 8's persistence baseline on the same archive)."""
    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    blur.launches = 0
    start = time.perf_counter()
    results = {"attention": _attention_precision(device)}
    for name, config in PERCEIVERS.items():
        began = time.perf_counter()
        # fake batches of the model's geometry (seed 0), generated before timing:
        # the first SERVE_BATCHES serve, all but the last VAL_BATCHES train
        unique = list(serve.fake_loader(serve.build_model(name, config), TRAIN_UNIQUE + VAL_BATCHES))
        generated = time.perf_counter()
        results[name] = _perceiver_serve(device, name, config, unique[:SERVE_BATCHES], flops_peak)
        served = time.perf_counter()
        results[name].update(_perceiver_train(device, name, config, unique, bandwidth, flops_peak))
        log(f"[perceiver] {name}: {time.perf_counter() - began:.2f} s ({generated - began:.2f} s generating "
            f"{len(unique)} batches, serve {served - generated:.2f} s, train {time.perf_counter() - served:.2f} s)")
        del unique
        torch.cuda.empty_cache()
    _perceiver_pipeline(device)
    _deterministic_pool(device)
    results["gate"] = _perceiver_gate(baseline_nmae, gate_run)
    check(blur.launches == 0, "the perceiver path launched sep_blur")
    log(f"[perceiver] phase 9: {time.perf_counter() - start:.2f} s")
    return results


def _head_input(model):
    """The model's first dense layer after its body: the tensor it takes is
    the body's output (the CNN's, the tower's, the encoder's)."""
    return model.nwp_fc1 if hasattr(model, "nwp_fc1") else model.fc1


def _forward_with_body(model, batch, device, bf16=False):
    """(forecasts, the body's output), on the host as fp32, of one forward
    of ``model`` on ``device`` in full fp32 or bf16 autocast."""
    from predict_pv_yield_tpu_torch.utils import full_fp32

    caught = []
    hook = _head_input(model).register_forward_pre_hook(lambda module, args: caught.append(args[0].detach()))
    model.compute_dtype = torch.bfloat16 if bf16 else None
    try:
        with torch.inference_mode(), full_fp32(), model.compute_precision(device):
            out = model(batch.to(device))
    finally:
        hook.remove()
        model.compute_dtype = None
    return out.float().cpu(), caught[0].float().cpu()


def _cpu_parity(model, few, device):
    """(a) One example forward on the card against the CPU, forecasts and
    the body's output, in full fp32 → readings {label: (max |Δ|, max |y|)}."""
    on_cpu = _forward_with_body(model.cpu(), few, torch.device("cpu"))
    on_card = _forward_with_body(model.to(device), few, device)
    return {label: (float((card - cpu).abs().max()), float(cpu.abs().max()))
            for label, cpu, card in zip(("forecasts", "body"), on_cpu, on_card)}


def _fit_numbers(device, make_model, train_batches, val_batches, batch_size, precision=32):
    """A timed ``Trainer.fit`` of ``train_batches`` and ``val_batches`` and a
    traced fit of the first 8 train batches → (steady examples/s, the median
    ms between step ends, peak device memory, busy share)."""
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    trainer = Trainer(max_epochs=1, device=device, precision=precision, profiler=None)
    trainer.setup(make_model())
    torch.cuda.reset_peak_memory_stats(device)
    _, steps, gaps, rate = _timed_fit(trainer, batch_size=batch_size, train_dataloaders=train_batches,
                                      val_dataloaders=val_batches)
    peak = torch.cuda.max_memory_allocated(device)
    check(steps == len(train_batches) and np.isfinite(trainer.callback_metrics["NMAE/Train_epoch"])
          and np.isfinite(trainer.callback_metrics["NMAE/Validation_epoch"]), "fit steps or NaN")
    del trainer
    traced, warmup, replica = (Trainer(max_epochs=1, device=device, precision=precision, profiler=None)
                               for _ in range(3))
    for t in (traced, warmup, replica):
        t.setup(make_model())
    busy, _ = _busy_share(lambda: traced.fit(traced._model, train_dataloaders=train_batches[:8]),
                          warm=lambda: warmup.fit(warmup._model, train_dataloaders=train_batches[:2]),
                          replica=lambda: replica.fit(replica._model, train_dataloaders=train_batches[:8]),
                          what=f"the 8-step fit of {type(traced._model).__name__} at precision {precision}")
    del traced, warmup, replica
    return rate, float(np.median(gaps)), peak, busy


def _zoo_fit(device, make_model, unique, batch_size, precision=32):
    """:func:`_fit_numbers` of phase 10's 24 + 2 batches (the 4 unique train
    batches 6 times)."""
    train_batches = unique[:ZOO_TRAIN_UNIQUE] * (TRAIN_BATCHES // ZOO_TRAIN_UNIQUE)
    return _fit_numbers(device, make_model, train_batches, unique[ZOO_TRAIN_UNIQUE:], batch_size, precision)


def _serve_numbers(model, batches, device, runs=3):
    """``predict`` over ``batches``: (examples/s of the median of ``runs``
    warm calls, the busy share of a traced call, wall seconds per call)."""
    from predict_pv_yield_tpu_torch import predict as serve

    def serve_batches():
        serve.predict(model, batches, device)

    serve_batches()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        serve_batches()
        times.append(time.perf_counter() - start)
    seconds = float(np.median(times))
    busy, traced = _busy_share(serve_batches)
    batch_size = batches[0].satellite.data.shape[0]
    return len(batches) * batch_size / seconds, busy, seconds, traced


def _step_events(device, make_model, batch, precision=32):
    """The train step's per-kernel device records over
    ``PERCEIVER_TRACED_CALLS`` steps, its ms per step, and the model."""
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    profiled = Trainer(device=device, profiler=None, precision=precision)
    profiled.setup(make_model())
    events = _device_events(lambda: profiled.train_step(batch), calls=PERCEIVER_TRACED_CALLS)
    return events, sum(e.self_device_time_total for e in events) / PERCEIVER_TRACED_CALLS / 1e3, profiled._model


def _top(events, tag, n=6):
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:n]:
        log(f"[{tag}]   {e.self_device_time_total / PERCEIVER_TRACED_CALLS / 1e3:8.4f} ms  "
            f"x{e.count // PERCEIVER_TRACED_CALLS:<3d} {e.key[:110]}")


def _zoo_model(device, name, config, bandwidth, flops_peak):
    """Phase 10 (a) for one model at the full width of its YAML, batch 32,
    fp32: card vs CPU, forward and step device ms against the bound,
    ``predict`` and train examples/s, busy shares, peak memory."""
    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models import get_model
    from predict_pv_yield_tpu_torch.utils import full_fp32

    began = time.perf_counter()
    cls, kwargs = get_model(name), {k: v for k, v in config.items() if k != "_target_"}
    model = serve.build_model(name, config, seed=0)
    unique = list(serve.fake_loader(model, ZOO_TRAIN_UNIQUE + ZOO_VAL))
    host = unique[0].numeric()
    batch_size = host.satellite.data.shape[0]
    few = host.map(lambda _, leaf: leaf[:1])
    macs = _layer_macs(model, few)  # one example
    readings = _cpu_parity(model, few, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[zoo] {name}: {n_params:,} parameters; satellite {tuple(host.satellite.data.shape)}, NWP "
        f"{tuple(host.nwp.data.shape)}; card vs CPU at 1 example: "
        + "; ".join(f"{label} max abs diff {err:.3e}, limit {SERVE_TOL} x max |y| {scale:.4f}"
                    for label, (err, scale) in readings.items()))
    for label, (err, scale) in readings.items():
        check(err <= SERVE_TOL * scale, f"{name}: card {label} disagree with the CPU's")

    card_batch = host.to(device)

    def forward():
        with torch.inference_mode(), full_fp32():
            model(card_batch)

    events = _device_events(forward, calls=PERCEIVER_TRACED_CALLS)
    forward_ms = sum(e.self_device_time_total for e in events) / PERCEIVER_TRACED_CALLS / 1e3
    flops = 2 * macs * batch_size
    bound_ms = flops / flops_peak * 1e3
    log(f"[zoo] {name} forward device time per batch of {batch_size}: {forward_ms:.4f} ms; fp32 bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP), {bound_ms / forward_ms:.1%} of it")
    _top(events, "zoo", n=4)
    served = unique[:ZOO_TRAIN_UNIQUE] * 2
    serve_rate, serve_busy, _, _ = _serve_numbers(model, served, device)
    log(f"[zoo] {name} predict over {len(served)} host batches of {batch_size}: {serve_rate:.2f} examples/s; "
        f"device busy {serve_busy:.1%}")
    del model, card_batch

    parity = _train_parity(device, lambda: cls(**{**kwargs, "batch_size": 1}), "zoo")
    events, step_ms, trained = _step_events(device, lambda: cls(**kwargs), unique[0].numeric().to(device))
    adam_bytes = 7 * 4 * sum(p.numel() for p in trained.parameters())
    step_bound_ms = 3 * flops / flops_peak * 1e3 + adam_bytes / bandwidth * 1e3
    del trained
    log(f"[zoo] {name} train step device time per batch of {batch_size}: {step_ms:.4f} ms; bound "
        f"{step_bound_ms:.4f} ms ({3 * flops / 1e9:.1f} GFLOP at fp32 + Adam {adam_bytes / 1e9:.4f} GB), "
        f"{step_bound_ms / step_ms:.1%} of it")
    _top(events, "zoo", n=4)
    rate, gap, peak, busy = _zoo_fit(device, lambda: cls(**kwargs), unique, batch_size)
    log(f"[zoo] {name} fit over {TRAIN_BATCHES}x{batch_size} + {ZOO_VAL}x{batch_size} batches: steady "
        f"{gap:.4f} ms per step (median), {rate:.2f} train examples/s; peak device memory {peak / 2**30:.3f} GiB; "
        f"device busy {busy:.1%} of a traced 8-step fit; {time.perf_counter() - began:.2f} s")
    torch.cuda.empty_cache()
    return {**parity, "forward_err": readings["forecasts"][0], "body_err": readings["body"][0],
            "forward_ms": forward_ms, "forward_bound_ms": bound_ms, "serve_examples_per_s": serve_rate,
            "serve_busy_share": serve_busy, "train_step_ms": step_ms, "train_bound_ms": step_bound_ms,
            "train_examples_per_s": rate, "train_busy_share": busy, "train_peak_bytes": peak}


def _runbook_command():
    """The predict command of ``weights/conv3d/readme.md``, verbatim."""
    import os
    import shlex

    with open(os.path.join("weights", "conv3d", "readme.md")) as fh:
        found = re.search(r"```\n(python tools/predict\.py.*?)```", fh.read(), re.S)
    check(found is not None, "the runbook no longer documents the predict command")
    return shlex.split(found.group(1).replace("\\\n", " "))


def _runbook(device):
    """Phase 10 (b): the PRED-189 runbook's command through the port's
    predict entry point on the card, on a Lightning ``.ckpt`` in the
    reference's layout at the PRED-189 widths (seeded weights)."""
    import contextlib
    import csv
    import io
    import math
    import os
    import tempfile

    from predict_pv_yield_tpu_torch import predict as serve

    command = _runbook_command()
    check(command[:2] == ["python", "tools/predict.py"], f"runbook command {command[:2]}")
    model = serve.build_model("conv3d", ZOO["conv3d"], seed=189)
    check(list(model.state_dict())[:3] == ["sat_conv0.weight", "sat_conv0.bias", "conv3d_1.weight"],
          "the reference's names")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out = os.path.join(tmp, "PRED-189.ckpt"), os.path.join(tmp, "forecasts.csv")
        torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()},
                    "hyper_parameters": dict(ZOO["conv3d"]), "epoch": 10}, ckpt)
        argv = command[2:]
        argv[argv.index("path/to/PRED-189.ckpt")] = ckpt
        argv[argv.index("forecasts.csv")] = out
        printed = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = serve.main(argv + ["--device", str(device)])
        seconds = time.perf_counter() - start
        with open(out, newline="") as fh:
            rows = list(csv.reader(fh))
    n_batches = int(argv[argv.index("--n-batches") + 1])
    check(len(rows) - 1 == n_batches * 32 * 4 and all(math.isfinite(float(r[3])) for r in rows[1:]),
          f"{len(rows) - 1} forecast rows")
    check(result["nmae"] is not None and math.isfinite(result["nmae"]) and "NMAE: " in printed.getvalue(),
          "no NMAE")
    log(f"[zoo] (b) the PRED-189 runbook through the port on the card: python -m predict_pv_yield_tpu_torch.predict "
        f"{' '.join(command[2:])} --device {device} (checkpoint synthesized from seed 189): {len(rows) - 1} "
        f"forecasts, NMAE {result['nmae']:.6f}; {seconds:.2f} s")
    return {"runbook_nmae": result["nmae"]}


def _gru_under_autocast(device):
    """Whether cuDNN's GRU runs under bf16 autocast: what ``nn.GRU`` gives
    for fp32 and for bf16 inputs (the port casts to its fp32 weights)."""
    gru = torch.nn.GRU(8, 16, num_layers=2, batch_first=True).to(device)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 5, 8, device=device, dtype=dtype)
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                results[str(dtype)] = str(gru(x)[0].dtype)
        except RuntimeError as error:
            results[str(dtype)] = f"raises: {str(error).splitlines()[0][:80]}"
    log("[zoo] (c) nn.GRU under bf16 autocast: " + "; ".join(f"{k} input -> {v}" for k, v in results.items()))
    return results


def _bf16_cell(device, name, config, fp32, bandwidth, bf16_peak, flops_peak):
    """Phase 10 (c) for one cell: card bf16 vs CPU bf16 at one example
    (within ``BF16_SPREAD_FACTOR`` × the CPU's own bf16-vs-fp32 spread, on
    the forecasts and the body's output); bf16 forward and train step device
    ms against the bf16 bound, top kernels, train examples/s, busy share and
    peak memory, beside ``fp32``'s numbers."""
    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models import get_model

    began = time.perf_counter()
    cls, kwargs = get_model(name), {k: v for k, v in config.items() if k != "_target_"}
    model = serve.build_model(name, config, seed=0)
    unique = list(serve.fake_loader(model, ZOO_TRAIN_UNIQUE + ZOO_VAL))
    host = unique[0].numeric()
    batch_size = host.satellite.data.shape[0]
    few = host.map(lambda _, leaf: leaf[:1])
    macs = _perceiver_macs(model) if hasattr(model, "perceiver") else _layer_macs(model, few)
    cpu = torch.device("cpu")
    exact = _forward_with_body(model, few, cpu)
    narrow = _forward_with_body(model, few, cpu, bf16=True)
    card = _forward_with_body(model.to(device), few, device, bf16=True)
    readings = {}
    for label, a, b, c in zip(("forecasts", "body"), exact, narrow, card):
        spread, err = float((b - a).abs().max()), float((c - b).abs().max())
        readings[label] = (err, spread)
        check(spread > 0, f"{name}: the CPU's bf16 {label} equal its fp32 ones")
        check(err <= BF16_SPREAD_FACTOR * spread, f"{name}: card bf16 {label} disagree with the CPU's")
    log(f"[bf16] {name}: card bf16 vs CPU bf16 at 1 example: "
        + "; ".join(f"{label} max abs diff {err:.3e} (the CPU's bf16 vs fp32 {spread:.3e}, limit "
                    f"{BF16_SPREAD_FACTOR} x)" for label, (err, spread) in readings.items()))

    card_batch = host.to(device)
    model.compute_dtype = torch.bfloat16

    def forward():
        with torch.inference_mode(), model.compute_precision(device):
            model(card_batch)

    events = _device_events(forward, calls=PERCEIVER_TRACED_CALLS)
    forward_ms = sum(e.self_device_time_total for e in events) / PERCEIVER_TRACED_CALLS / 1e3
    flops = 2 * macs * batch_size
    bound_ms = flops / bf16_peak * 1e3
    log(f"[bf16] {name} forward device time per batch of {batch_size}: {forward_ms:.4f} ms (fp32 "
        f"{fp32['forward_ms']:.4f} ms); bf16 bound {bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP at "
        f"{bf16_peak / 1e12:.0f} TFLOP/s), {bound_ms / forward_ms:.1%} of it")
    _top(events, "bf16")
    del model, card_batch

    events, step_ms, trained = _step_events(device, lambda: cls(**kwargs), unique[0].numeric().to(device), 16)
    check(all(p.dtype == torch.float32 for p in trained.parameters()), "bf16 training changed a parameter's dtype")
    adam_bytes = 7 * 4 * sum(p.numel() for p in trained.parameters())
    step_bound_ms = 3 * flops / bf16_peak * 1e3 + adam_bytes / bandwidth * 1e3
    del trained
    log(f"[bf16] {name} train step device time per batch of {batch_size}: {step_ms:.4f} ms (fp32 "
        f"{fp32['train_step_ms']:.4f} ms, {fp32['train_step_ms'] / step_ms:.2f}x); bf16 bound {step_bound_ms:.4f} ms "
        f"(fp32 bound {3 * flops / flops_peak * 1e3 + adam_bytes / bandwidth * 1e3:.4f} ms), "
        f"{step_bound_ms / step_ms:.1%} of it")
    _top(events, "bf16")
    rate, gap, peak, busy = _zoo_fit(device, lambda: cls(**kwargs), unique, batch_size, precision=16)
    fp32_peak = fp32.get("train_peak_bytes")
    log(f"[bf16] {name} fit at precision 16: steady {gap:.4f} ms per step, {rate:.2f} train examples/s (fp32 "
        f"{fp32['train_examples_per_s']:.2f}); peak device memory {peak / 2**30:.3f} GiB (fp32 "
        + (f"{fp32_peak / 2**30:.3f} GiB" if fp32_peak else "not measured")
        + f"); device busy {busy:.1%} (fp32 {fp32['train_busy_share']:.1%}); {time.perf_counter() - began:.2f} s")
    torch.cuda.empty_cache()
    return {"forward_err": readings["forecasts"][0], "forward_spread": readings["forecasts"][1],
            "body_err": readings["body"][0], "body_spread": readings["body"][1], "forward_ms": forward_ms,
            "forward_bound_ms": bound_ms, "train_step_ms": step_ms, "train_bound_ms": step_bound_ms,
            "train_examples_per_s": rate, "train_busy_share": busy, "train_peak_bytes": peak}


def _bf16_gate(baseline):
    """Phase 10 (d): phase 8 (c)'s conv3d learning gate once more at
    ``trainer.precision=16``, against the same persistence ``baseline``."""
    import contextlib
    import io
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.data import synthetic

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        archive = synthetic.make_learnable_archive(os.path.join(tmp, "learnable"), n_frames=288, px=24, n_gsp=4,
                                                   seed=0, with_nwp=True)
        workdir = os.path.join(tmp, "gate_bf16")
        os.makedirs(workdir)
        overrides = synthetic.CONV3D_GATE_OVERRIDES + ["trainer.max_epochs=4", "+trainer.precision=16"]
        with contextlib.redirect_stdout(io.StringIO()):
            trained = synthetic.run_learnable(archive, overrides, workdir=workdir)
    log(f"[bf16] (d) conv3d learning gate at precision 16: trained {synthetic.GATE_METRIC} {trained:.6f}, "
        f"persistence baseline {baseline:.6f}, ratio {trained / baseline:.4f} (limit {GATE_MARGIN}); "
        f"{time.perf_counter() - start:.2f} s")
    check(trained < GATE_MARGIN * baseline, "the bf16-trained model does not beat persistence")
    return {"bf16_trained_nmae": trained}


def _zoo_pipelines(device):
    """Phase 10 (e): ``train(config)`` on each literal composed experiment
    config (fake data in the model's geometry, 2 train + 1 validation
    batches): a finite metric, and the ``last`` checkpoint loaded into a
    fresh trainer bit for bit, its parameters fp32."""
    import copy
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.config.instantiate import instantiate
    from predict_pv_yield_tpu_torch.data.fake import model_configuration
    from predict_pv_yield_tpu_torch.training.callbacks import load_state
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.pipeline import train

    cwd = os.getcwd()
    results = {}
    for experiment, config in ZOO_TRAIN_CONFIGS.items():
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                run_config = copy.deepcopy(config)
                datamodule = instantiate(run_config["datamodule"])
                model = instantiate(run_config["model"])
                datamodule.configuration = model_configuration(model)  # batches in the model's geometry
                start = time.perf_counter()
                metric = train(run_config, datamodule=datamodule)
                seconds = time.perf_counter() - start
                check(metric is not None and np.isfinite(metric), f"{experiment}: optimized_metric {metric}")
                saved = load_state("checkpoints/last")
                fresh = Trainer(device=device, profiler=None, resume_from_checkpoint="checkpoints/last",
                                precision=run_config["trainer"].get("precision", 32))
                fresh.setup(instantiate(run_config["model"]))
                loaded = fresh.state["model"]
                check(all(torch.equal(saved["model"][k], v.cpu()) for k, v in loaded.items()) and
                      saved["model"].keys() == loaded.keys(), f"{experiment}: the `last` round trip")
                check(all(v.dtype == torch.float32 for v in loaded.values()), f"{experiment}: a parameter not fp32")
                compute = fresh._model.compute_dtype
                del fresh
            finally:
                os.chdir(cwd)
        log(f"[zoo] (e) train(config) of experiment={experiment} {' '.join(TRAIN_OVERRIDES[1:])}: "
            f"{config['optimized_metric']} {metric:.6f}; `last` round trip bit-equal, {len(loaded)} tensors fp32, "
            f"compute {compute or 'fp32'}; {seconds:.2f} s")
        results[experiment] = metric
        torch.cuda.empty_cache()
    return results


def phase_zoo(device, bandwidth, flops_peak, bf16_peak, serve, trained, perceivers, baseline_nmae):
    """Phase 10: the rest of the single-device zoo at the widths of its
    YAMLs, the PRED-189 runbook, bf16 beside fp32, the bf16 learning gate
    and ``train(config)`` of the zoo's experiments."""
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    blur.launches = 0
    start = time.perf_counter()
    results = {name: _zoo_model(device, name, config, bandwidth, flops_peak) for name, config in ZOO.items()}
    results.update(_runbook(device))
    results["gru_under_autocast"] = _gru_under_autocast(device)
    fp32 = {"conv3d_sat_nwp": {**trained, "forward_ms": serve["serve_forward_ms"]},
            "perceiver": perceivers["perceiver"], "cnn_rnn": results["cnn_rnn"]}
    results["bf16"] = {name: _bf16_cell(device, name, config, fp32[name], bandwidth, bf16_peak, flops_peak)
                       for name, config in BF16_CELLS.items()}
    results.update(_bf16_gate(baseline_nmae))
    results["pipelines"] = _zoo_pipelines(device)
    check(blur.launches == 0, "the zoo launched sep_blur")
    log(f"[zoo] phase 10: {time.perf_counter() - start:.2f} s")
    return results


def _write_classic(path, variables):
    """``variables`` {name: (dims, values[, {attribute: text}])} as a netCDF3
    classic file in the 64-bit-offset format (CDF-2, the format xarray's
    scipy engine writes): fixed-size variables, big-endian, 4-byte padded
    (the same layout as ``tests/test_netcdf_reader.py``'s writer)."""
    import struct

    nc_type = {np.dtype("int16"): 3, np.dtype("int32"): 4, np.dtype("float32"): 5, np.dtype("float64"): 6}

    def name(text):
        raw = text.encode()
        return struct.pack(">I", len(raw)) + raw + b"\0" * (-len(raw) % 4)

    dims = {}
    specs = []
    for var, (dim_names, values, *attrs) in variables.items():
        values = np.ascontiguousarray(values)
        for dim, size in zip(dim_names, values.shape):
            check(dims.setdefault(dim, size) == size, f"{path}: dimension {dim} of {var} has two sizes")
        specs.append((var, dim_names, values, attrs[0] if attrs else {}))
    ids = {dim: i for i, dim in enumerate(dims)}

    def var_header(var, dim_names, values, attrs, begin):
        raw = name(var) + struct.pack(">I", len(dim_names)) + b"".join(struct.pack(">I", ids[d]) for d in dim_names)
        raw += struct.pack(">II", 0x0C if attrs else 0, len(attrs))
        for key, text in attrs.items():
            payload = text.encode()
            raw += name(key) + struct.pack(">II", 2, len(payload)) + payload + b"\0" * (-len(payload) % 4)
        return raw + struct.pack(">IIQ", nc_type[values.dtype], (values.nbytes + 3) & ~3, begin)

    header = b"CDF\x02" + struct.pack(">III", 0, 0x0A, len(dims))
    header += b"".join(name(dim) + struct.pack(">I", size) for dim, size in dims.items())
    header += struct.pack(">IIII", 0, 0, 0x0B, len(specs))  # no global attributes; the variable list
    begin = len(header) + sum(len(var_header(*spec, 0)) for spec in specs)
    begins = []
    for _, _, values, _ in specs:
        begins.append(begin)
        begin += (values.nbytes + 3) & ~3
    with open(path, "wb") as fh:
        fh.write(header + b"".join(var_header(*spec, at) for spec, at in zip(specs, begins)))
        for _, _, values, _ in specs:
            fh.write(values.astype(values.dtype.newbyteorder(">")).tobytes() + b"\0" * (-values.nbytes % 4))


def _cf_minutes(values_ns):
    """int64 ns since the epoch → (int32 minutes since the first value, CF
    attributes): classic files have no 64-bit integers."""
    values_ns = np.asarray(values_ns, np.int64)
    origin = int(values_ns.flat[0])
    minutes = (values_ns - origin) // 60_000_000_000
    check(bool(np.all(minutes * 60_000_000_000 == values_ns - origin)) and np.abs(minutes).max() < 2**31,
          "times that int32 minutes cannot hold")
    epoch = str(np.datetime64(origin, "ns").astype("datetime64[s]")).replace("T", " ")
    return minutes.astype(np.int32), {"units": f"minutes since {epoch}"}


def _v15_classic(root, index, batch):
    """``batch`` (CPU tensors, int16 satellite counts) as v15 per-source
    classic files ``<root>/<source>/{index:06d}.nc``, laid out as the JAX
    package's ``write_v15_batch`` lays out its HDF5 files (satellite and HRV
    channel-last, raw MW beside capacities, CF times) → the fields the
    reader must give back, by (group, field), in its own terms."""
    import os

    sat, nwp, pv, gsp = batch.satellite, batch.nwp, batch.pv, batch.gsp
    n = lambda x: x.numpy()  # noqa: E731
    sat_wire = n(sat.data).transpose(0, 2, 3, 4, 1)
    hrv_wire = n(batch.hrvsatellite.data).transpose(0, 2, 3, 4, 1)
    pv_capacity = np.full((pv.pv_yield.shape[0], pv.pv_yield.shape[2]), 10.0, np.float32)
    pv_power = n(pv.pv_yield) * np.float32(10.0)
    gsp_power = n(gsp.gsp_yield) * n(gsp.gsp_capacity)
    files = {
        "satellite": {"data": (("example", "time_index", "y_geostationary_index", "x_geostationary_index",
                                "channels_index"), sat_wire),
                      "x_osgb": (("example", "x_geostationary_index"), n(sat.x)),
                      "y_osgb": (("example", "y_geostationary_index"), n(sat.y)),
                      "time": (("example", "time_index"), *_cf_minutes(n(sat.datetime_index)))},
        "nwp": {"data": (("example", "channels_index", "time_index", "y_osgb_index", "x_osgb_index"), n(nwp.data)),
                "target_time": (("example", "time_index"), *_cf_minutes(n(nwp.target_time)))},
        "pv": {"power_mw": (("example", "time_index", "id_index"), pv_power),
               "capacity_mwp": (("example", "id_index"), pv_capacity),
               "pv_system_row_number": (("example", "id_index"), n(pv.pv_system_row_number)),
               "id": (("example", "id_index"), n(pv.pv_system_id))},
        "gsp": {"power_mw": (("example", "time_index", "id_index"), gsp_power),
                "capacity_mwp": (("example", "time_index", "id_index"), n(gsp.gsp_capacity)),
                "id": (("example", "id_index"), n(gsp.gsp_id)),
                "time": (("example", "time_index"), *_cf_minutes(n(gsp.gsp_datetime_index)))},
        "sun": {"elevation": (("example", "time_index"), n(batch.sun.sun_elevation_angle)),
                "azimuth": (("example", "time_index"), n(batch.sun.sun_azimuth_angle))},
        "topographic": {"data": (("example", "y_index", "x_index"), n(batch.topographic.topo_data))},
        "hrvsatellite": {"data": (("example", "time_index", "y_index", "x_index", "channels_index"), hrv_wire)},
        "metadata": {"t0_datetime_utc": (("example",), *_cf_minutes(n(batch.metadata.t0_datetime_utc)))},
    }
    for source, variables in files.items():
        os.makedirs(os.path.join(root, source), exist_ok=True)
        _write_classic(os.path.join(root, source, f"{index:06d}.nc"), variables)
    with np.errstate(divide="ignore", invalid="ignore"):  # the reader's normalisation of raw MW
        pv_yield = np.where(pv_capacity[:, None] > 0, pv_power / pv_capacity[:, None], 0.0).astype(np.float32)
        gsp_yield = np.where(n(gsp.gsp_capacity) > 0, gsp_power / n(gsp.gsp_capacity), 0.0).astype(np.float32)
    return {("satellite", "data"): sat_wire, ("satellite", "x"): n(sat.x), ("satellite", "y"): n(sat.y),
            ("satellite", "datetime_index"): n(sat.datetime_index), ("nwp", "data"): n(nwp.data),
            ("nwp", "target_time"): n(nwp.target_time), ("pv", "pv_yield"): pv_yield,
            ("pv", "pv_system_row_number"): n(pv.pv_system_row_number), ("pv", "pv_system_id"): n(pv.pv_system_id),
            ("gsp", "gsp_yield"): gsp_yield, ("gsp", "gsp_id"): n(gsp.gsp_id),
            ("gsp", "gsp_capacity"): n(gsp.gsp_capacity), ("gsp", "gsp_datetime_index"): n(gsp.gsp_datetime_index),
            ("sun", "sun_elevation_angle"): n(batch.sun.sun_elevation_angle),
            ("sun", "sun_azimuth_angle"): n(batch.sun.sun_azimuth_angle),
            ("topographic", "topo_data"): n(batch.topographic.topo_data), ("hrvsatellite", "data"): hrv_wire,
            ("metadata", "t0_datetime_utc"): n(batch.metadata.t0_datetime_utc)}


def _check_read(batch, expected, what):
    """``batch`` holds exactly the ``expected`` fields, each equal in dtype,
    shape and value, and the channel-last markers of the wire."""
    import dataclasses

    for group in dataclasses.fields(batch):
        for f in dataclasses.fields(getattr(batch, group.name)):
            value = getattr(getattr(batch, group.name), f.name)
            if f.name == "channel_last":
                check(value is ((group.name, "data") in expected and group.name in ("satellite", "hrvsatellite")),
                      f"{what}: {group.name}.channel_last {value}")
                continue
            want = expected.get((group.name, f.name))
            check((value is None) == (want is None), f"{what}: {group.name}.{f.name} set {value is not None}")
            if want is None:
                continue
            got = value.numpy()
            check(got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want),
                  f"{what}: {group.name}.{f.name} differs from what was written")


def _format_tree(tmp):
    """(b) The v15 classic tree at the flagship's geometry: 24 train batches
    (from 8 unique ones) and 4 test batches, and ``configuration.yaml`` →
    (tree, the fields each train and test batch must read back as, the
    dataset configuration)."""
    import os

    root = os.path.join(tmp, "v15")
    start = time.perf_counter()
    unique = list(_shard_batches(FORMAT_UNIQUE + FORMAT_TEST, seed=11))
    configuration = unique[0][0]
    expected = {"train": [], "test": []}
    for i in range(FORMAT_TRAIN):
        expected["train"].append(_v15_classic(os.path.join(root, "train"), i, unique[i % FORMAT_UNIQUE][2]))
    for i in range(FORMAT_TEST):
        expected["test"].append(_v15_classic(os.path.join(root, "test"), i, unique[FORMAT_UNIQUE + i][2]))
    with open(os.path.join(root, "configuration.yaml"), "w") as fh:
        fh.write(_yaml_configuration(configuration))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(os.path.join(root, "train"))
                 for f in files)
    log(f"[formats] (b) wrote the v15 classic tree: {FORMAT_TRAIN} train batches ({FORMAT_UNIQUE} unique) + "
        f"{FORMAT_TEST} test batches of 32 at the flagship's geometry, {nbytes / FORMAT_TRAIN / 1e6:.1f} MB a batch "
        f"in 8 files: {time.perf_counter() - start:.2f} s")
    return root, expected, configuration


def _format_loader(device, tmp, tree, expected, trained):
    """(b) The NetCDF datamodule over the tree: batches equal to the arrays
    written, the loader alone at 2 and 8 threads, ``train(config)`` with the
    datamodule of ``netcdf_datamodule.yaml`` (steady examples/s), the busy
    share of a traced 8-step fit."""
    import copy
    import os

    from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
    from predict_pv_yield_tpu_torch.data.netcdf_reader import NetCDFBatchDataset
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.pipeline import train

    def datamodule(workers, n_train=FORMAT_TRAIN, n_val=FORMAT_TEST, **kwargs):
        return NetCDFDataModule(data_path=tree, num_workers=workers, n_train_data=n_train, n_val_data=n_val, **kwargs)

    dm = datamodule(8)
    check(tuple(dm.configuration.input_data.satellite.satellite_channels) == CONV3D_SAT_NWP_CHANNELS,
          "the tree's configuration.yaml")
    start = time.perf_counter()
    for split, loader in (("train", dm.train_dataloader()), ("test", dm.val_dataloader())):
        check(isinstance(loader.dataset, NetCDFBatchDataset), f"the {split} split is not read as NetCDF")
        for i, want in enumerate(expected[split]):
            _check_read(loader.dataset[i], want, f"{split} batch {i}")
    log(f"[formats] (b) all {FORMAT_TRAIN} + {FORMAT_TEST} batches read back field for field as written "
        f"(int16 channel-last satellite, CF minutes to ns, MW to yields): {time.perf_counter() - start:.2f} s")

    rates = {}
    for workers in FORMAT_WORKERS:
        loader = datamodule(workers).train_dataloader()
        start = time.perf_counter()
        batches = list(loader)
        seconds = time.perf_counter() - start
        check(len(batches) == FORMAT_TRAIN and batches[0].satellite.channel_last, "the NetCDF loader's batches")
        rates[workers] = FORMAT_TRAIN * 32 / seconds
        log(f"[formats] (b) loader alone, num_workers {workers}: {FORMAT_TRAIN} batches of 32 in {seconds:.3f} s, "
            f"{rates[workers]:.2f} examples/s")
    del batches

    marks = []
    step = Trainer.train_step

    def marked_step(self, batch):
        metrics = step(self, batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return metrics

    cwd = os.getcwd()
    os.makedirs(os.path.join(tmp, "pipeline"))
    os.chdir(os.path.join(tmp, "pipeline"))
    config = copy.deepcopy(TRAIN_CONFIG)
    config["datamodule"] = {**NETCDF_DATAMODULE, "data_path": tree, "n_train_data": FORMAT_TRAIN,
                            "n_val_data": FORMAT_TEST}
    Trainer.train_step = marked_step
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        metric = train(config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        Trainer.train_step = step
        os.chdir(cwd)
    check(len(marks) == FORMAT_TRAIN, f"train(config) ran {len(marks)} train steps")
    check(metric is not None and np.isfinite(metric), f"optimized_metric {metric}")
    check(os.path.exists(os.path.join(tmp, "pipeline", "checkpoints", "last", "state.pt")), "no last checkpoint")
    gaps = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])][-STEADY_STEPS:]
    rate = float(np.median([32e3 / gap for gap in gaps]))
    log(f"[formats] (b) train(config) with the datamodule of netcdf_datamodule.yaml on the tree "
        f"({FORMAT_TRAIN}x32 train + {FORMAT_TEST}x32 validation batches, num_workers 8, checkpoints and the test "
        f"pass): {seconds:.3f} s, {config['optimized_metric']} {metric:.6f}; steady pace of the last {STEADY_STEPS} "
        f"steps {np.median(gaps):.4f} ms per step (median), {rate:.2f} train examples/s (cached batches, phase 7: "
        f"{trained['train_examples_per_s']:.2f})")

    traced, warmup, replica = (_data_model(device, dm.configuration) for _ in range(3))
    steps = min(8, FORMAT_TRAIN)
    short = datamodule(8, n_train=steps, n_val=1)
    busy, wall = _busy_share(lambda: traced.fit(traced._model, datamodule=short),
                             warm=lambda: warmup.fit(warmup._model, datamodule=datamodule(8, n_train=2, n_val=1)),
                             replica=lambda: replica.fit(replica._model, datamodule=datamodule(8, n_train=steps, n_val=1)),
                             what="[formats] (b) the NetCDF fit")
    log(f"[formats] (b) device busy {busy:.1%} of a traced {steps}-step fit from the NetCDF tree ({wall * 1e3:.3f} ms; "
        f"cached batches, phase 7: {trained['train_busy_share']:.1%})")
    return {"netcdf_loader_examples_per_s_2": rates[2], "netcdf_loader_examples_per_s_8": rates[8],
            "netcdf_train_examples_per_s": rate, "netcdf_busy_share": busy, "netcdf_train_seconds": seconds}


def _format_remote(tmp, tree, expected):
    """(c) The tree through ``file://``: the remote branch, its fetch of
    every file into ``temp_path``, and the same batches as (b)."""
    import os

    from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
    from predict_pv_yield_tpu_torch.data.netcdf_reader import NetCDFBatchDataset

    fetched = os.path.join(tmp, "fetched")
    start = time.perf_counter()
    dm = NetCDFDataModule(data_path=f"file://{tree}", temp_path=fetched, num_workers=8,
                          n_train_data=FORMAT_TRAIN, n_val_data=FORMAT_TEST)
    check(tuple(dm.configuration.input_data.satellite.satellite_channels) == CONV3D_SAT_NWP_CHANNELS,
          "configuration.yaml through fsspec")
    for split, loader in (("train", dm.train_dataloader()), ("test", dm.val_dataloader())):
        check(isinstance(loader.dataset, NetCDFBatchDataset) and "://" in loader.dataset.src_path,
              f"the remote {split} split")
        for i, want in enumerate(expected[split]):
            _check_read(loader.dataset[i], want, f"file:// {split} batch {i}")
    files = sum(len(names) for _, _, names in os.walk(fetched))
    seconds = time.perf_counter() - start
    log(f"[formats] (c) the same tree through file://: {files} files fetched into temp_path, all "
        f"{FORMAT_TRAIN} + {FORMAT_TEST} batches equal to (b)'s: {seconds:.2f} s")
    return {"remote_seconds": seconds}


def _format_legacy(tmp, expected):
    """(d) One legacy flat file (``sat_data``, ``nwp``, ``pv_yield``, …)."""
    import os

    from predict_pv_yield_tpu_torch.data.netcdf_reader import NetCDFBatchDataset

    want = expected["test"][0]
    rng = np.random.default_rng(12)
    b, t = want[("satellite", "datetime_index")].shape
    features = {name: rng.uniform(-1, 1, (b, t)).astype(np.float32)
                for name in ("hour_of_day_sin", "hour_of_day_cos", "day_of_year_sin", "day_of_year_cos")}
    variables = {
        "sat_data": (("example", "time", "y", "x", "channels"), want[("satellite", "data")]),
        "sat_x_coords": (("example", "x"), want[("satellite", "x")]),
        "sat_y_coords": (("example", "y"), want[("satellite", "y")]),
        "sat_datetime_index": (("example", "time"), *_cf_minutes(want[("satellite", "datetime_index")])),
        "nwp": (("example", "nwp_channels", "nwp_time", "y_osgb", "x_osgb"), want[("nwp", "data")]),
        "nwp_target_time": (("example", "nwp_time"), *_cf_minutes(want[("nwp", "target_time")])),
        "pv_yield": (("example", "time", "pv_system"), want[("pv", "pv_yield")]),
        "pv_system_id": (("example", "pv_system"), want[("pv", "pv_system_id")]),
        "pv_system_row_number": (("example", "pv_system"), want[("pv", "pv_system_row_number")]),
        **{name: (("example", "time"), values) for name, values in features.items()},
    }
    root = os.path.join(tmp, "legacy", "test")
    os.makedirs(root)
    _write_classic(os.path.join(root, "000000.nc"), variables)
    batch = NetCDFBatchDataset(1, root)[0]
    legacy = {key: want[key] for key in want if key[0] in ("satellite", "nwp", "pv")}
    legacy.update({("datetime", name): values for name, values in features.items()})
    _check_read(batch, legacy, "the legacy file")
    log(f"[formats] (d) a legacy flat file ({len(variables)} variables, {os.path.getsize(os.path.join(root, '000000.nc')) / 1e6:.1f} MB) "
        "read back field for field as written")


def _format_predict(device, tmp, tree):
    """(e) ``predict --data`` on the tree, on the card and on the CPU with
    the same seed-0 weights: the CSV's rows and the forecasts' agreement."""
    import contextlib
    import io
    import os

    from predict_pv_yield_tpu_torch import predict as serve

    config_path = os.path.join(tmp, "conv3d_sat_nwp.yaml")
    with open(config_path, "w") as fh:
        json.dump(CONV3D_SAT_NWP, fh)  # JSON is YAML
    forecasts = {}
    for where, label in ((device, "card"), ("cpu", "CPU")):
        out = os.path.join(tmp, f"forecasts_{label}.csv")
        printed = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = serve.main(["--model", "conv3d_sat_nwp", "--model-config", config_path, "--data", tree,
                                 "--n-batches", str(FORMAT_PREDICT_BATCHES), "--out", out, "--nmae",
                                 "--device", str(where)])
        seconds = time.perf_counter() - start
        rows = np.loadtxt(out, delimiter=",", skiprows=1)
        expected_rows = FORMAT_PREDICT_BATCHES * 32 * 4
        check(rows.shape == (expected_rows, 4) and result["rows"] == expected_rows,
              f"predict --data wrote {rows.shape[0]} rows, expected {expected_rows}")
        check(bool(np.isfinite(rows[:, 3]).all()) and np.isfinite(result["nmae"]), "a non-finite forecast")
        forecasts[label] = rows[:, 3]
        log(f"[formats] (e) predict --data on the tree, on the {label}: {expected_rows} rows, "
            f"NMAE {result['nmae']:.6f}, {seconds:.2f} s")
    err = float(np.abs(forecasts["card"] - forecasts["CPU"]).max())
    scale = float(np.abs(forecasts["CPU"]).max())
    log(f"[formats] (e) card vs CPU forecasts: max abs diff {err:.3e}, limit {SERVE_TOL} x max |y| {scale:.4f}")
    check(err <= SERVE_TOL * scale, "predict --data: the card's forecasts disagree with the CPU's")
    return {"predict_data_err": err, "predict_data_err_limit": SERVE_TOL * scale}


def _stats_reference(array, channel_axis):
    """Per-channel mean, std, min, max and count in float64 numpy (−1 is missing)."""
    values = np.moveaxis(np.asarray(array), channel_axis, -1)
    decoded = np.where(values == -1, np.nan, values.astype(np.float64))
    axes = tuple(range(decoded.ndim - 1))
    return (np.nanmean(decoded, axis=axes), np.nanstd(decoded, axis=axes), np.nanmin(decoded, axis=axes),
            np.nanmax(decoded, axis=axes), (~np.isnan(decoded)).sum(axis=axes))


def _check_stats(stats, array, channel_axis, what):
    """``compute_channel_stats``' table against :func:`_stats_reference` →
    the largest relative difference of a mean or std."""
    mean, std, lo, hi, count = _stats_reference(array, channel_axis)
    worst = 0.0
    for i, row in enumerate(stats.values()):
        check(row["count"] == count[i] and (row["min"], row["max"]) == (lo[i], hi[i]), f"{what}: channel {i}")
        for got, want in ((row["mean"], mean[i]), (row["std"], std[i])):
            worst = max(worst, abs(got - want) / max(abs(want), 1e-300))
    check(worst <= 1e-9, f"{what}: mean or std {worst:.2e} from the float64 numpy computation")
    return worst


def _format_prepare(tmp):
    """(f) ``prepare`` from the learnable zarr archive: raw shards at 1 and
    4 workers byte-equal; ``compute_channel_stats`` over its satellite
    archive against float64 numpy."""
    import contextlib
    import filecmp
    import io
    import os

    from predict_pv_yield_tpu_torch import compute_channel_stats, prepare
    from predict_pv_yield_tpu_torch.data import synthetic
    from predict_pv_yield_tpu_torch.data.zarr_reader import open_zarr

    archive = synthetic.make_learnable_archive(os.path.join(tmp, "learnable"), n_frames=288, px=24, n_gsp=4,
                                               seed=0, with_nwp=True)
    args = ["--satellite-zarr", archive.satellite_zarr, "--nwp-zarr", archive.nwp_zarr, "--gsp-csv",
            archive.gsp_csv, "--n-gsp", "4", "--nwp-pixels", "24", "--n-train", "8", "--n-test", "2",
            "--format", "raw", "--seed", "3"]
    seconds = {}
    for workers in (1, 4):
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            prepare.main(["--out", os.path.join(tmp, f"prepared_{workers}"), *args, "--workers", str(workers)])
        seconds[workers] = time.perf_counter() - start
    names = sorted(os.path.relpath(os.path.join(d, f), os.path.join(tmp, "prepared_1"))
                   for d, _, files in os.walk(os.path.join(tmp, "prepared_1")) for f in files)
    check(len(names) == 11, f"prepare wrote {len(names)} files")
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(tmp, "prepared_1"), os.path.join(tmp, "prepared_4"),
                                               names, shallow=False)
    check(not mismatch and not errors, f"prepare at 1 and 4 workers differs in {mismatch + errors}")
    log(f"[formats] (f) prepare from the learnable archive, 8 + 2 raw shards of 32: {seconds[1]:.2f} s at "
        f"--workers 1, {seconds[4]:.2f} s at --workers 4; the {len(match)} files byte-equal")
    with contextlib.redirect_stdout(io.StringIO()):
        stats = compute_channel_stats.main([archive.satellite_zarr, "--member", "data"])
    worst = _check_stats(stats, open_zarr(archive.satellite_zarr, "data")[:], -1, "the learnable archive")
    log(f"[formats] (f) compute_channel_stats over the learnable satellite archive ({len(stats)} channels on the "
        f"trailing axis): counts, min and max equal, mean and std within {worst:.1e} of float64 numpy")
    return {"prepare_seconds_1": seconds[1], "prepare_seconds_4": seconds[4]}


def _format_blosc(tmp, data):
    """(g) Phase 8 (a)'s flagship satellite archive in blosc-lz4 with byte
    shuffle, streamed as 8 (a) streams the zlib one: the loader alone at 2
    and 8 threads and the share of one thread's time in decompression."""
    import contextlib
    import io
    import os

    from predict_pv_yield_tpu_torch.compute_channel_stats import main as channel_stats_main
    from predict_pv_yield_tpu_torch.data.zarr_reader import open_zarr

    start = time.perf_counter()
    sat, nwp, csv_path, nbytes = _stream_archive(os.path.join(tmp, "blosc"), compressor="blosc")
    stored = sum(os.path.getsize(os.path.join(sat, "data", f)) for f in os.listdir(os.path.join(sat, "data")))
    log(f"[formats] (g) wrote phase 8 (a)'s archives with the satellite imagery in blosc-lz4 + shuffle "
        f"({STREAM_FRAMES} frames x {len(CONV3D_SAT_NWP_CHANNELS)} channels at {STREAM_PX} px, "
        f"{stored / 1e6:.1f} MB stored): {time.perf_counter() - start:.2f} s")

    rates = {}
    for workers in STREAM_WORKERS:
        loader = _stream_datamodule(sat, nwp, csv_path, workers, n_train=LOADER_BATCHES).train_dataloader()
        start = time.perf_counter()
        batches = list(loader)
        seconds = time.perf_counter() - start
        rates[workers] = LOADER_BATCHES * 32 / seconds
        log(f"[formats] (g) loader alone from the blosc archive, num_workers {workers}: {LOADER_BATCHES} batches of "
            f"32 in {seconds:.3f} s, {rates[workers]:.2f} examples/s (zlib, phase 8 (a): "
            f"{data[f'stream_loader_examples_per_s_{workers}']:.2f})")
    px = CONV3D_SAT_NWP["image_size_pixels"]
    check(tuple(batches[0].satellite.data.shape) == (32, 11, 31, px, px), "blosc-stream batch shapes")
    profile = _loader_profile(_stream_datamodule(sat, nwp, csv_path, 0, n_train=2).train_dataloader().dataset,
                              tag="[formats] (g)")
    log(f"[formats] (g) one loader thread's time in decompression: blosc-lz4 {profile['blosc_share']:.1%} "
        f"(satellite), zlib {profile['zlib_share']:.1%} (NWP); {profile['ms_per_example']:.3f} ms per example "
        f"(phase 8 (a), all zlib: {data['stream_zlib_share']:.1%} in zlib, {data['stream_ms_per_example']:.3f} ms "
        f"per example)")
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's JSON table
        stats = channel_stats_main([sat, "--member", "data", "--channel-axis", "1"])
    seconds = time.perf_counter() - start
    worst = _check_stats(stats, open_zarr(sat, "data")[:], 1, "the blosc archive")
    log(f"[formats] (g) compute_channel_stats over the blosc archive: {len(stats)} channels in {seconds:.2f} s, "
        f"mean and std within {worst:.1e} of float64 numpy")
    return {"blosc_loader_examples_per_s_2": rates[2], "blosc_loader_examples_per_s_8": rates[8],
            "blosc_share": profile["blosc_share"], "blosc_zlib_share": profile["zlib_share"],
            "blosc_ms_per_example": profile["ms_per_example"]}


def _format_lz4():
    """(a) The LZ4 codec: built from ``csrc/lz4.cpp``, the native library
    loaded, native equal to plain on seeded payloads of a satellite chunk's
    size, and both codecs' rates."""
    from predict_pv_yield_tpu_torch import _build, native

    start = time.perf_counter()
    lib = native.load_library()
    seconds = time.perf_counter() - start
    check(lib._name == str(_build.library_path("lz4")), f"the loaded LZ4 library is {lib._name}")
    log(f"[formats] (a) lz4.cpp: {seconds:.2f} s (c++ {_build.build_info['lz4']['seconds']:.2f} s), "
        f"loaded {lib._name}")
    rng = np.random.default_rng(8)
    chunk = (STREAM_CHUNK, len(CONV3D_SAT_NWP_CHANNELS), STREAM_PX, STREAM_PX)
    smooth = np.cumsum(rng.integers(-2, 3, chunk), axis=-1) + 500
    structured = native.byte_shuffle(np.clip(smooth, 0, 1023).astype(np.int16).tobytes(), 2)
    random = rng.integers(0, 256, len(structured), dtype=np.uint8).tobytes()
    rates = {}
    for label, payload in (("structured", structured), ("random", random)):
        packed = native.lz4_compress(payload)
        for block in (packed, native.lz4_compress_plain(payload)):
            check(native.lz4_decompress(block, len(payload)) == payload, f"native LZ4 round trip ({label})")
            check(native.lz4_decompress_plain(block, len(payload)) == payload, f"plain LZ4 decode ({label})")
        check(native.byte_unshuffle(payload, 2) == native.byte_unshuffle_plain(payload, 2), "the shuffle")
        reps = 20
        start = time.perf_counter()
        for _ in range(reps):
            native.lz4_decompress(packed, len(payload))
        native_rate = reps * len(payload) / (time.perf_counter() - start) / 1e6
        start = time.perf_counter()
        native.lz4_decompress_plain(packed, len(payload))
        plain_rate = len(payload) / (time.perf_counter() - start) / 1e6
        rates[label] = {"ratio": len(payload) / len(packed), "native_mb_s": native_rate, "plain_mb_s": plain_rate}
        log(f"[formats] (a) {label} payload of {len(payload) / 1e6:.2f} MB (a shuffled satellite chunk's size): "
            f"ratio {len(payload) / len(packed):.2f}, decode native {native_rate:.1f} MB/s, plain Python "
            f"{plain_rate:.2f} MB/s; native and plain agree")
    return {"lz4_build_seconds": _build.build_info["lz4"]["seconds"], "lz4": rates}


def _format_packages(tmp):
    """(h) The optional packages: without h5py an HDF5 file raises naming
    it, with h5py a v15 HDF5 batch round-trips; a blosc-zstd frame decodes
    through the native decoder, and without zstandard writing one raises
    naming it (with it a zstd frame round-trips)."""
    import importlib.util
    import os
    import struct

    from predict_pv_yield_tpu_torch.data import blosc
    from predict_pv_yield_tpu_torch.data.netcdf_reader import NetCDFBatchDataset, read_netcdf_variables
    from predict_pv_yield_tpu_torch.data.netcdf_writer import write_v15_batch

    found = {name: importlib.util.find_spec(name) is not None for name in ("h5py", "zstandard")}
    payload = np.arange(40_000, dtype=np.int16).tobytes()
    if found["h5py"]:
        configuration, _, batch = next(_shard_batches(1, seed=13))
        write_v15_batch(os.path.join(tmp, "hdf5"), 0, batch)
        read = NetCDFBatchDataset(1, os.path.join(tmp, "hdf5"))[0]
        check(torch.equal(read.satellite.data, batch.satellite.data.permute(0, 2, 3, 4, 1)), "HDF5 round trip")
        log("[formats] (h) h5py imports: a v15 HDF5 batch written by the port's writer reads back equal")
    else:
        path = os.path.join(tmp, "hdf5.nc")
        with open(path, "wb") as fh:
            fh.write(b"\x89HDF\r\n\x1a\n" + bytes(504))
        try:
            read_netcdf_variables(path)
            raised = None
        except ImportError as exc:
            raised = str(exc)
        check(raised is not None and "h5py" in raised, f"an HDF5 file without h5py: {raised}")
        log(f"[formats] (h) h5py missing: an HDF5 file raises ImportError: {raised}")
    if found["zstandard"]:
        frame = blosc.compress(payload, typesize=2, cname="zstd")
        check(blosc.decompress(frame) == payload, "zstd round trip")
        log("[formats] (h) zstandard imports: a blosc-zstd frame round-trips")
    else:
        # a zstd frame by hand (RFC 8878): single segment, 2-byte content
        # size, a raw block of 512 bytes and a last RLE block of 512
        raw = bytes(range(256)) * 2
        stream = b"\x28\xb5\x2f\xfd" + bytes([0x60]) + struct.pack("<H", 1024 - 256)
        stream += (512 << 3).to_bytes(3, "little") + raw + ((512 << 3) | (1 << 1) | 1).to_bytes(3, "little") + b"\x07"
        frame = bytes([2, 2, 4 << 5, 1]) + struct.pack("<III", 1024, 1024, 16 + 4 + 4 + len(stream))
        frame += struct.pack("<II", 20, len(stream)) + stream
        check(blosc.decompress(frame) == raw + b"\x07" * 512, "a blosc-zstd frame through the native decoder")
        try:
            blosc.compress(payload, typesize=2, cname="zstd")
            raised = None
        except ImportError as exc:
            raised = str(exc)
        check(raised is not None and "zstandard" in raised, f"writing a blosc-zstd frame without zstandard: {raised}")
        log(f"[formats] (h) zstandard missing: a blosc-zstd frame decodes natively; writing one raises "
            f"ImportError: {raised}")
    return {"packages": found}


def phase_formats(device, trained, data, tmp):
    """Phase 11: the on-disk formats at the flagship's widths — the LZ4
    codec, a v15 classic NetCDF tree through the loader, ``train(config)``
    and ``file://``, a legacy file, ``predict --data``, ``prepare`` and the
    channel statistics, a blosc archive streamed, the optional packages →
    (results, the tree, which phase 12 reads again)."""
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    blur.launches = 0
    start = time.perf_counter()
    results = _format_lz4()
    tree, expected, _ = _format_tree(tmp)
    results.update(_format_loader(device, tmp, tree, expected, trained))
    results.update(_format_remote(tmp, tree, expected))
    _format_legacy(tmp, expected)
    results.update(_format_predict(device, tmp, tree))
    del expected
    results.update(_format_prepare(tmp))
    results.update(_format_blosc(tmp, data))
    results.update(_format_packages(tmp))
    check(blur.launches == 0, "the formats phase launched sep_blur")
    results["seconds"] = time.perf_counter() - start
    log(f"[formats] phase 11: {results['seconds']:.2f} s")
    return results, tree


def _marked_fit(trainer, batch_size, **fit_kwargs):
    """``trainer.fit`` with a CUDA event after every train step, or after
    every group of k steps with ``steps_per_execution`` k → (wall seconds,
    steps, the median examples/s over the steady gaps between marks, the
    number of those gaps, every step's NMAE in order). The steady gaps are
    the last ``STEADY_STEPS`` at k = 1 and the last ``STEADY_GROUPS`` at
    k > 1."""
    marks, losses = [], []
    k = trainer.steps_per_execution
    name = "train_group" if k > 1 else "train_step"
    inner = getattr(trainer, name)

    def marked(batch):
        metrics = inner(batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        losses.append(metrics["NMAE"].reshape(-1))
        return metrics

    setattr(trainer, name, marked)
    torch.cuda.synchronize()
    start = time.perf_counter()
    try:
        trainer.fit(trainer._model, **fit_kwargs)
    finally:
        delattr(trainer, name)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    gaps = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])][-(STEADY_GROUPS if k > 1 else STEADY_STEPS):]
    rate = float(np.median([k * batch_size * 1e3 / gap for gap in gaps]))
    return seconds, len(marks) * k, rate, len(gaps), torch.cat(losses).float().cpu()


def _traced(fn, what):
    """One traced call of ``fn`` after an unrecorded warm-up call of it in
    the session's warm-up step (:func:`_warm_session`), held to
    ``TRACE_COVERAGE`` against a third call of it (:func:`_hold_to_coverage`)
    → (busy share, wall seconds, host kernel and graph launches, device
    kernel records): the union of the kernel and copy intervals on the card
    over the host clock around the call, and the runtime's launch calls on
    the host."""
    spans, wall, events = _session_spans(fn, fn)
    _hold_to_coverage(spans, fn, fn, what)
    launches = sum(1 for e in events if e.name in LAUNCH_NAMES)
    graphs = sum(1 for e in events if "GraphLaunch" in e.name)
    return _union_us(spans) / (wall * 1e6), wall, launches, graphs, len(spans)


def _state_diff(a, b):
    """(bit-equal, max |Δ| over parameters, max |Δ| over Adam's moments and
    step) of two trainers' states; a NaN anywhere gives NaN."""
    sa, sb = a.state, b.state
    pairs = list(zip(sa["optimizer"]["state"].values(), sb["optimizer"]["state"].values()))
    params = float(torch.stack([(sa["model"][k].float() - sb["model"][k].float()).abs().max()
                                for k in sa["model"]]).max())
    moments = float(torch.stack([(x[key].float() - y[key].float()).abs().max()
                                 for x, y in pairs for key in ("exp_avg", "exp_avg_sq", "step")]).max())
    equal = all(torch.equal(sa["model"][k], sb["model"][k]) for k in sa["model"]) and all(
        torch.equal(x[key], y[key]) for x, y in pairs for key in ("exp_avg", "exp_avg_sq", "step"))
    return equal, params, moments


def _adam_updates(trainer):
    """The distinct step counts of Adam's per-parameter states."""
    return sorted({int(state["step"]) for state in trainer.state["optimizer"]["state"].values()})


def _deterministic():
    """``utils.deterministic_algorithms()``: deterministic algorithms inside
    the block."""
    from predict_pv_yield_tpu_torch.utils import deterministic_algorithms

    return deterministic_algorithms()


def _rotated(unique, steps):
    """``steps`` batches of ``unique``, group g of ``GRAPH_K`` rotated by g,
    so that no two groups hold the same batch at the same step: a replay on
    a stale group trains on other data than the eager step."""
    return [unique[(i + i // GRAPH_K) % len(unique)] for i in range(steps)]


def _fit_k(device, make_model, batches, k, precision, accumulate, batch_size, checked=True):
    """A trainer set up from the seed and fitted on ``batches`` at
    ``steps_per_execution`` k → (trainer, wall seconds, steady examples/s,
    steady gaps, every step's NMAE). ``checked``: fail on a short or
    non-finite fit, or one at k > 1 that captured no CUDA graph."""
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    trainer = Trainer(max_epochs=1, device=device, precision=precision, profiler=None, weights_summary=None,
                      steps_per_execution=k, accumulate_grad_batches=accumulate)
    trainer.setup(make_model())
    seconds, steps, rate, gaps, losses = _marked_fit(trainer, batch_size, train_dataloaders=batches)
    if checked:
        check(trainer.global_step == len(batches) and steps == len(batches), f"k={k} ran {steps} steps")
        check(np.isfinite(trainer.callback_metrics["NMAE/Train_epoch"]), f"k={k}: a non-finite loss")
        check(k == 1 or len(trainer._graphs) >= 1, "no CUDA graph was captured")
    return trainer, seconds, rate, gaps, losses


def _graph_equality(eager, graphed):
    """A graphed fit against an eager fit of the same batches from the same
    seed, each ``(trainer, every step's NMAE)``, under deterministic
    algorithms → (agrees, numbers). Parameters, Adam's moments and step
    counts and every step's NMAE are expected bit-equal. A fit that is not
    agrees where Adam's step counts are equal, every step's NMAE is within
    phase 7's ``STEP_LOSS_TOL`` and the parameters within its one-step
    ``STEP_PARAM_TOL``."""
    (a, a_losses), (b, b_losses) = eager, graphed
    equal, params, moments = _state_diff(a, b)
    updates = _adam_updates(a), _adam_updates(b)
    loss = float((a_losses - b_losses).abs().max()) if a_losses.shape == b_losses.shape else float("nan")
    agrees = updates[0] == updates[1] and loss <= STEP_LOSS_TOL and params <= STEP_PARAM_TOL
    return agrees, {"bit_equal": equal and loss == 0.0, "param_diff": params, "adam_diff": moments,
                    "nmae_diff": loss, "adam_updates": updates[1]}


def _planted_faults():
    """(name, context) pairs that break graphed fits on purpose, for
    showing that :func:`_graph_equality` catches them: every replay
    skipped, and every replay run on the first group's inputs."""
    from unittest import mock

    from predict_pv_yield_tpu_torch.training.engine import Trainer

    graphed, first = Trainer._train_graphed, []

    def stale(self, group):
        first.append(group)
        return graphed(self, first[0])

    return [("every replay skipped", mock.patch.object(torch.cuda.CUDAGraph, "replay", lambda self: None)),
            ("every replay on the first group's inputs", mock.patch.object(Trainer, "_train_graphed", stale))]


def _graph_cell(device, label, make_model, unique, batch_size, precision=32, accumulate=1, rates=True,
                faults=False):
    """Phase 12 (a) for one cell, on ``unique`` batches in rotated groups.
    Under deterministic algorithms, fits of ``GRAPH_EQUAL_TRAIN`` batches at
    ``steps_per_execution`` 1 and 8 go to :func:`_graph_equality`; with
    ``faults``, so do graphed fits with each planted fault, which must fail
    it. With ``rates``, fits of ``GRAPH_TRAIN`` batches at k = 1 and 8 at
    the default algorithms: their steady train examples/s, their states'
    difference, and the busy share and host launches per optimiser step of
    a traced 8-step fit on each trainer (the k = 8 one replays the graph it
    captured)."""
    began = time.perf_counter()

    def fit(k, steps, checked=True):
        return _fit_k(device, make_model, _rotated(unique, steps), k, precision, accumulate, batch_size, checked)

    steps = GRAPH_EQUAL_TRAIN
    line = (f"[trainer] (a) {label}: {steps} steps at steps_per_execution {GRAPH_K} (the first group eager, "
            f"{steps - GRAPH_K} replayed) against {steps} eager steps, deterministic algorithms")
    with _deterministic():
        eager = fit(1, steps)
        graphed = fit(GRAPH_K, steps)
        agrees, result = _graph_equality((eager[0], eager[4]), (graphed[0], graphed[4]))
        numbers = (f"parameters max |Δ| {result['param_diff']:.3e} (limit {STEP_PARAM_TOL}), Adam state "
                   f"{result['adam_diff']:.3e}, step counts {result['adam_updates']}, every step's NMAE max |Δ| "
                   f"{result['nmae_diff']:.3e} (limit {STEP_LOSS_TOL})")
        log(f"{line} ({len(graphed[0]._graphs)} CUDA graph(s)): "
            + ("parameters, Adam moments and step counts, and every step's NMAE bit-equal" if result["bit_equal"]
               else f"not bit-equal: {numbers}"))
        check(agrees, f"{label}: graphed steps disagree with eager steps")
        for fault, planted in (_planted_faults() if faults else []):
            with planted:
                broken = fit(GRAPH_K, steps, checked=False)
            caught, numbers = _graph_equality((eager[0], eager[4]), (broken[0], broken[4]))
            log(f"{line}, planted fault ({fault}): parameters max |Δ| {numbers['param_diff']:.3e}, Adam step counts "
                f"{numbers['adam_updates']}, every step's NMAE max |Δ| {numbers['nmae_diff']:.3e}: "
                f"{'missed' if caught else 'caught'}")
            check(not caught, f"{label}: the equality check missed a planted fault ({fault})")
            result[f"fault_{fault}"] = numbers
            del broken
        del eager, graphed
    if rates:
        fits, numbers = {}, {}
        for k in (1, GRAPH_K):
            fits[k], seconds, rate, gaps, _ = fit(k, GRAPH_TRAIN)
            numbers[k] = {"seconds": seconds, "rate": rate, "gaps": gaps}
        _, params, moments = _state_diff(fits[1], fits[GRAPH_K])
        check(_adam_updates(fits[1]) == _adam_updates(fits[GRAPH_K]), f"{label}: Adam's step counts differ")
        for k, trainer in fits.items():
            busy, wall, launches, graphs, records = _traced(
                lambda: trainer.fit(trainer._model, train_dataloaders=unique[:GRAPH_K]), f"{label}, k={k} fit")
            numbers[k].update(busy=busy, launches=launches / GRAPH_K, graph_launches=graphs)
        log(f"[trainer] (a) {label}: {GRAPH_TRAIN} steps, default algorithms: steady train examples/s k=1 "
            f"{numbers[1]['rate']:.2f} (median of {numbers[1]['gaps']} step gaps), k={GRAPH_K} "
            f"{numbers[GRAPH_K]['rate']:.2f} (median of {numbers[GRAPH_K]['gaps']} group gaps, all replays) "
            f"({numbers[GRAPH_K]['rate'] / numbers[1]['rate']:.2f}x); states differ by {params:.3e} (parameters) / "
            f"{moments:.3e} (Adam); traced {GRAPH_K}-step fit: busy {numbers[1]['busy']:.1%} / "
            f"{numbers[GRAPH_K]['busy']:.1%}, host launches per optimiser step {numbers[1]['launches']:.1f} / "
            f"{numbers[GRAPH_K]['launches']:.1f} ({numbers[GRAPH_K]['graph_launches']} graph launch)")
        result.update({f"k{k}_{key}": value for k, values in numbers.items() for key, value in values.items()})
        result.update(default_param_diff=params, default_adam_diff=moments)
        del fits
    torch.cuda.empty_cache()
    log(f"[trainer] (a) {label}: {time.perf_counter() - began:.2f} s")
    return result


def _trainer_graphs(device, flagship, flagship_model):
    """Phase 12 (a): steps_per_execution as one CUDA graph of 8 steps."""
    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models import get_model

    unique = flagship[:TRAIN_UNIQUE]
    results = {
        "conv3d_sat_nwp_fp32": _graph_cell(device, "conv3d_sat_nwp.yaml fp32, batch 32", flagship_model, unique, 32),
        "conv3d_sat_nwp_bf16": _graph_cell(device, "conv3d_sat_nwp.yaml bf16, batch 32", flagship_model, unique, 32,
                                           precision=16),
        "conv3d_sat_nwp_accumulate2": _graph_cell(
            device, "conv3d_sat_nwp.yaml fp32, batch 32, accumulate_grad_batches 2", flagship_model, unique, 32,
            accumulate=2, rates=False),
    }
    config = PERCEIVERS["perceiver"]
    cls, kwargs = get_model("perceiver"), {k: v for k, v in config.items() if k != "_target_"}
    model = serve.build_model("perceiver", config, seed=0)
    unique = list(serve.fake_loader(model, TRAIN_UNIQUE))
    del model
    batch_size = unique[0].satellite.data.shape[0]
    results["perceiver_bf16"] = _graph_cell(device, f"perceiver.yaml bf16, batch {batch_size}", lambda: cls(**kwargs),
                                            unique, batch_size, precision=16, faults=True)
    return results


def _trainer_lr_find(device, flagship, flagship_model):
    """Phase 12 (b): ``lr_find(num_training=32)`` at full width."""
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None)
    torch.cuda.synchronize()
    start = time.perf_counter()
    suggestion = trainer.lr_find(flagship_model(), train_dataloaders=flagship[:TRAIN_UNIQUE],
                                 num_training=LR_FIND_STEPS)
    seconds = time.perf_counter() - start
    results = trainer.lr_find_results
    check(len(results["lr"]) == len(results["loss"]) <= LR_FIND_STEPS and trainer._model is None
          and np.isfinite(suggestion), "lr_find")
    log(f"[trainer] (b) lr_find(num_training={LR_FIND_STEPS}) on conv3d_sat_nwp.yaml, batch 32: {len(results['lr'])} "
        f"steps, lr {results['lr'][0]:.3e} → {results['lr'][-1]:.3e}, suggestion {suggestion:.4e}, {seconds:.2f} s")
    return {"lr_find_suggestion": suggestion, "lr_find_seconds": seconds, "lr_find_steps": len(results["lr"])}


def _trainer_wire(device, tree):
    """Phase 12 (c): ``wire_float16`` True and ``"auto"`` on the v15 NetCDF
    tree: bytes per batch, the fit's steady rate, the probe, and the
    forecasts against the f32 wire's."""
    from predict_pv_yield_tpu_torch.data.batch import Batch
    from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
    from predict_pv_yield_tpu_torch.training.engine import Trainer, wire_cast

    def datamodule(n_train=FORMAT_TRAIN):
        return NetCDFDataModule(data_path=tree, num_workers=8, n_train_data=n_train, n_val_data=1)

    dm = datamodule()
    host = Batch.from_host(dm.train_dataloader().dataset[0]).numeric()
    narrow = wire_cast(host)
    sizes = [sum(leaf.numel() * leaf.element_size() for leaf in b.leaves()) for b in (host, narrow)]
    log(f"[trainer] (c) bytes sent per batch from the NetCDF tree: {sizes[0] / 1e6:.3f} MB float32, "
        f"{sizes[1] / 1e6:.3f} MB on the float16 wire ({1 - sizes[1] / sizes[0]:.1%} less; the int16 satellite "
        f"counts and the OSGB coordinates keep their type)")

    def trainer_for(wire, **kwargs):
        trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None, wire_float16=wire,
                          **kwargs)
        trainer._adopt_configuration(dm)
        return trainer

    results = {"wire_bytes_f32": sizes[0], "wire_bytes_f16": sizes[1]}
    for wire in (False, True):
        trainer = trainer_for(wire)
        trainer.setup(_flagship(dm.configuration))
        seconds, steps, rate, _, _ = _marked_fit(trainer, 32, datamodule=datamodule())
        check(steps == FORMAT_TRAIN and trainer._wire_cast_loaders == [], "the wire fit")
        results[f"wire_{'f16' if wire else 'f32'}_examples_per_s"] = rate
        log(f"[trainer] (c) fit from the NetCDF tree, wire_float16={wire}: {seconds:.3f} s, steady {rate:.2f} train "
            f"examples/s")
        del trainer
    auto = trainer_for("auto")
    auto._resolve_wire(dm.train_dataloader())
    probe = auto.wire_probe
    check(isinstance(auto.wire_float16, bool), "wire_float16='auto' did not resolve")
    log(f"[trainer] (c) wire_float16='auto' probe (interleaved, after a warm-up of each): f32 ships "
        + ", ".join(f"{t:.3f}" for t in probe["f32_ms"]) + " ms; f16 cast+ships "
        + ", ".join(f"{t:.3f}" for t in probe["f16_ms"]) + f" ms → float16 wire {'ON' if auto.wire_float16 else 'OFF'}")
    results.update({"wire_probe_f32_ms": probe["f32_ms"], "wire_probe_f16_ms": probe["f16_ms"],
                    "wire_auto": auto.wire_float16})

    auto.setup(_flagship(dm.configuration))
    model = auto._model.eval()
    from predict_pv_yield_tpu_torch.predict import forward_and_metrics
    with torch.no_grad():
        wide = forward_and_metrics(model, host.to(device), auto._satellite_channels)[0]
        thin = forward_and_metrics(model, narrow.to(device), auto._satellite_channels)[0]
    err, scale = float((thin - wide).abs().max()), float(wide.abs().max())
    log(f"[trainer] (c) forecasts on the float16 wire vs the float32 wire: max |Δ| {err:.3e}, "
        f"{err / scale / U16:.2f} float16 roundings (2^-11) of max |y| {scale:.4f} (limit {WIRE_TOL / U16:.0f})")
    check(err <= WIRE_TOL * scale, "the float16 wire's forecasts are off")
    results.update({"wire_forecast_err": err, "wire_forecast_scale": scale})
    del auto, model
    return results


def _flagship(configuration=None):
    """conv3d_sat_nwp.yaml's model, its data-dependent widths from
    ``configuration`` where one is given."""
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model

    model = Model(**{k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"})
    if configuration is not None:
        model.match_configuration(configuration)
    return model


def _trainer_loops(device, tree, flagship):
    """Phase 12 (d): ``overfit_batches=2`` for 3 epochs, and
    ``reload_dataloaders_every_epoch`` for 2 with the float16 wire."""
    from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
    from predict_pv_yield_tpu_torch.training.callbacks import Callback
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    pulled = []

    class Counting(list):
        def __iter__(self):
            for item in list.__iter__(self):
                pulled.append(1)
                yield item

    trainer = Trainer(max_epochs=3, device=device, profiler=None, weights_summary=None, overfit_batches=2,
                      save_validation_plots=False)
    trainer.setup(_flagship())
    trainer.fit(trainer._model, train_dataloaders=Counting(flagship[:TRAIN_UNIQUE]))
    check(trainer.global_step == 6 and len(pulled) == 2 and "NMAE/Validation_epoch" in trainer.callback_metrics,
          f"overfit_batches: {trainer.global_step} steps, {len(pulled)} batches pulled")
    log(f"[trainer] (d) overfit_batches=2, 3 epochs: {trainer.global_step} steps on the 2 cached batches (pulled "
        f"{len(pulled)} from the loader), validated on them: NMAE/Validation_epoch "
        f"{trainer.callback_metrics['NMAE/Validation_epoch']:.6f}")
    del trainer

    inner = NetCDFDataModule(data_path=tree, num_workers=8, n_train_data=4, n_val_data=1)
    made, seen = [], []

    class Reloading:
        configuration = inner.configuration

        def train_dataloader(self):
            made.append(inner.train_dataloader())
            return made[-1]

        def val_dataloader(self):
            return inner.val_dataloader()

    class WireSeen(Callback):
        def on_train_epoch_end(self, trainer, model, metrics):
            seen.append((len(made), getattr(made[-1].transform, "_engine_wire_cast", False)))

    trainer = Trainer(max_epochs=2, device=device, profiler=None, weights_summary=None, wire_float16=True,
                      reload_dataloaders_every_epoch=True, callbacks=[WireSeen()], save_validation_plots=False)
    trainer._adopt_configuration(inner)
    trainer.setup(_flagship(inner.configuration))
    trainer.fit(trainer._model, datamodule=Reloading())
    check(seen == [(1, True), (2, True)] and made[-1].transform is None and trainer.global_step == 8,
          f"reload_dataloaders_every_epoch: {seen}")
    log(f"[trainer] (d) reload_dataloaders_every_epoch, 2 epochs from the NetCDF tree: {len(made)} train loaders, "
        f"each carrying the float16 cast in its workers while its epoch ran ({seen}), taken out after the fit")
    return {"overfit_steps": 6, "reload_loaders": len(made)}


def _read_tfevents(path):
    """The records of a tfevents file, each CRC checked → their count."""
    import struct

    from predict_pv_yield_tpu_torch.training.tfevents import _masked_crc

    records = 0
    with open(path, "rb") as fh:
        data = fh.read()
    at = 0
    while at < len(data):
        header = data[at: at + 8]
        (length,) = struct.unpack("<Q", header)
        check(struct.unpack("<I", data[at + 8: at + 12])[0] == _masked_crc(header), f"record {records}: header CRC")
        payload = data[at + 12: at + 12 + length]
        check(len(payload) == length, f"record {records} is cut short")
        check(struct.unpack("<I", data[at + 12 + length: at + 16 + length])[0] == _masked_crc(payload),
              f"record {records}: payload CRC")
        at += 16 + length
        records += 1
    check(records > 1 and b"brain.Event:2" in data[:64], "the tfevents file's first record")
    return records


def _trainer_loggers(device, flagship):
    """Phase 12 (e): a fit with ``logger=many_loggers`` (its tfevents file
    read back record by record), the SaaS loggers without their clients,
    the validation plots."""
    import glob
    import logging
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.config.instantiate import instantiate
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.loggers import JSONLLogger

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            loggers = [instantiate(node) for node in MANY_LOGGERS.values()]
            trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None, logger=loggers)
            trainer.setup(_flagship())
            trainer.fit(trainer._model, train_dataloaders=flagship[:2], val_dataloaders=flagship[TRAIN_UNIQUE:][:2])
            for lg in loggers:
                lg.finalize()
            events = glob.glob("tensorboard/default/version_0/events.out.tfevents.*")
            check(len(events) == 1, f"tfevents files: {events}")
            records = _read_tfevents(events[0])
            try:
                import matplotlib  # noqa: F401
                plots = sorted(glob.glob(os.path.join(loggers[0].log_dir, "validation_plot_epoch_0_*.html")))
                check(len(plots) == 2 and all(open(p).read().startswith("<!DOCTYPE html>") for p in plots),
                      f"validation plots: {plots}")
                note = f"{len(plots)} validation plots written as HTML ({os.path.basename(plots[0])}, …)"
            except ImportError:
                note = "matplotlib is not installed here: no validation plot is written (said once per run)"
            log(f"[trainer] (e) fit with logger=many_loggers (csv + tensorboard): the tfevents file parses back into "
                f"{records} records with valid CRCs; {note}")

            warnings = []

            class Catch(logging.Handler):
                def emit(self, record):
                    warnings.append(record.getMessage())

            handler = Catch(level=logging.WARNING)
            logging.getLogger("predict_pv_yield_tpu_torch.training.loggers").addHandler(handler)
            clients = {"wandb": "wandb", "neptune": "neptune", "mlflow": "mlflow", "comet": "comet_ml"}
            hidden = {name: sys.modules.get(name) for name in clients.values()}
            try:
                for name in clients.values():  # the fallback is what is checked: no client may reach a server
                    sys.modules[name] = None
                for backend, node in SAAS.items():
                    logger = instantiate(node)
                    check(isinstance(logger._fallback, JSONLLogger), f"{backend}: no JSONL fallback")
                    logger.log_metrics({"NMAE/Train": 0.5}, step=3)
                    logger.finalize()
                    path = os.path.join(logger._fallback.log_dir, "metrics.jsonl")
                    check(os.path.exists(path) and '"NMAE/Train": 0.5' in open(path).read(), f"{backend}: JSONL")
            finally:
                for name, module in hidden.items():
                    if module is None:
                        sys.modules.pop(name, None)
                    else:
                        sys.modules[name] = module
                logging.getLogger("predict_pv_yield_tpu_torch.training.loggers").removeHandler(handler)
            check(all(any(b in w and "falling back" in w for w in warnings) for b in SAAS), f"warnings: {warnings}")
            log(f"[trainer] (e) {', '.join(SAAS)} without their clients: each warned ({len(warnings)} warnings) and "
                "wrote its metrics as JSONL")
        finally:
            os.chdir(cwd)
    return {"tfevents_records": records}


def _trainer_debug(device, flagship):
    """Phase 12 (f): ``profiler="jax"``'s trace, and ``debug_nans`` on a
    model with one parameter set to NaN at k = 1 and 8."""
    import json as json_module
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.training.engine import TRACE_DIR, Trainer

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            trainer = Trainer(max_epochs=1, device=device, profiler="jax", weights_summary=None)
            trainer.setup(_flagship())
            trainer.fit(trainer._model, train_dataloaders=flagship[:4])
            files = os.listdir(TRACE_DIR)
            with open(os.path.join(TRACE_DIR, files[0])) as fh:
                trace = json_module.load(fh)
            kernels = sum(1 for e in trace.get("traceEvents", []) if e.get("cat") == "kernel")
            check(len(files) == 1 and kernels > 0, f"the device trace: {files}, {kernels} kernel events")
            log(f"[trainer] (f) profiler='jax': {TRACE_DIR}/{files[0]} holds {kernels} CUDA kernel events of a "
                "4-step fit")
        finally:
            os.chdir(cwd)
    messages = {}
    for k in (1, GRAPH_K):
        trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None, debug_nans=True,
                          steps_per_execution=k)
        trainer.setup(_flagship())
        with torch.no_grad():
            trainer._model.fc1.weight[0, 0] = float("nan")
        try:
            trainer.fit(trainer._model, train_dataloaders=flagship[:GRAPH_K])
        except FloatingPointError as exc:
            messages[k] = str(exc)
        check(k in messages and "fc1.weight" in messages[k], f"debug_nans at k={k}: {messages.get(k)}")
        log(f"[trainer] (f) debug_nans, steps_per_execution {k}, fc1.weight[0, 0] = NaN: FloatingPointError: "
            f"{messages[k]}")
        del trainer
    return {"trace_kernel_events": kernels}


def phase_trainer(device, tree):
    """Phase 12: the Trainer's knobs at full width — CUDA graphs of k steps,
    lr_find, the float16 wire, overfit/reload, the loggers and plots,
    debug_nans and the device trace."""
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    blur.launches = 0
    start = time.perf_counter()
    dataset = FakeDataset(model_configuration(_flagship()), length=TRAIN_UNIQUE + VAL_BATCHES)
    flagship = [dataset[i] for i in range(TRAIN_UNIQUE + VAL_BATCHES)]  # phase 7's batches, from the same seed
    results = {"graphs": _trainer_graphs(device, flagship, _flagship)}
    results.update(_trainer_lr_find(device, flagship, _flagship))
    results.update(_trainer_wire(device, tree))
    results.update(_trainer_loops(device, tree, flagship))
    results.update(_trainer_loggers(device, flagship))
    results.update(_trainer_debug(device, flagship))
    check(blur.launches == 0, "the trainer phase launched sep_blur")
    results["seconds"] = time.perf_counter() - start
    log(f"[trainer] phase 12: {results['seconds']:.2f} s; sep_blur launched {blur.launches} times")
    return results


@contextlib.contextmanager
def _recorded_maxpools(decide=None):
    """Inside the block, each ``F.max_pool2d`` call records its choices (the
    argmax of each window) and ties on the host into the yielded
    ``(indices, ties)`` lists: a tie is a window whose two largest inputs
    lie within ``RELU_TIE`` × the call's largest |input| of each other. With
    ``decide`` (another run's indices, call by call) each window takes the
    input those indices name instead of its own largest: the gradient then
    flows to the same elements as in that run."""
    import torch.nn.functional as F

    pool, indices, ties = F.max_pool2d, [], []

    def recording_pool(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False, return_indices=False):
        check(padding == 0 and dilation == 1 and not ceil_mode and not return_indices, "an unrecorded max-pool form")
        out, chosen = pool(x, kernel_size, stride, return_indices=True)
        n, c, h, w = x.shape
        patches = F.unfold(x.detach().reshape(n * c, 1, h, w), kernel_size, stride=stride or kernel_size)
        top = patches.topk(2, dim=1).values
        gap = (top[:, 0] - top[:, 1]) / x.detach().abs().max().clamp_min(torch.finfo(x.dtype).tiny)
        ties.append(torch.where(gap <= RELU_TIE, gap, -1.0).reshape(out.shape).cpu())
        indices.append(chosen.cpu())
        if decide is None:
            return out
        taken = decide[len(indices) - 1].to(x.device)
        return x.flatten(2).gather(2, taken.flatten(2)).reshape(out.shape)

    F.max_pool2d = recording_pool
    try:
        yield indices, ties
    finally:
        F.max_pool2d = pool


def _flow_step(make_model, batch, where, decide=None, mkldnn=True):
    """One ``train_flow_forecaster.train_step`` (Adam, lr 1e-4) of a fresh
    seed-0 model on ``where`` with its ``torch.relu`` and ``F.max_pool2d``
    calls recorded (:func:`_recorded_relus`, :func:`_recorded_maxpools`;
    ``decide`` holds another run's ReLU decisions and max-pool choices) →
    (loss, gradients, parameters after the step, (ReLU decisions, max-pool
    indices), (ReLU ties, max-pool ties), the model, the batch on
    ``where``)."""
    from predict_pv_yield_tpu_torch.train_flow_forecaster import train_step

    model = make_model().to(where)
    optimizer = torch.optim.Adam(model.parameters(), lr=FLOW_LR)
    batch = {k: v.to(where) for k, v in batch.items()}
    torch.backends.mkldnn.enabled = mkldnn
    try:
        relus, pools = decide if decide is not None else (None, None)
        with _recorded_relus(torch, relus) as (decisions, ties), _recorded_maxpools(pools) as (chosen, pool_ties):
            loss = float(train_step(model, optimizer, batch))
    finally:
        torch.backends.mkldnn.enabled = True
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    params = {k: v.cpu() for k, v in model.state_dict().items()}
    return loss, grads, params, (decisions, chosen), (ties, pool_ties), model, batch


def _flow_parity(device, arch):
    """(a) One step of ``arch`` at its default width, card against CPU, from
    the seed-0 weights on one seeded batch of 4 at 128→64 px, under phase
    7's rules (:func:`_train_parity`): the MSE within ``STEP_LOSS_TOL``;
    every gradient within the larger of ``GRAD_REL_TOL`` and
    ``GRAD_SPREAD_FACTOR`` × the CPU's own fp32 spread (oneDNN against
    PyTorch's own kernels) of its largest entry, against the CPU's gradients
    on the card's ReLU decisions, every decision the two disagree on a tie;
    the parameters after Adam within ``FLOW_PARAM_TOL``. Adam's first step
    moves an element by lr · g / (|g| + eps): where the card's gradient is
    within ``gap`` of the CPU's and |g| > 2 · gap, the two steps differ by at
    most lr / 2 (5e-5), but a gradient near zero may cross it and move its
    element by up to 2·lr the other way. So the elements whose CPU gradient
    lies within twice its tensor's measured gap (the largest |card − CPU|
    gradient) of zero are exempt, and counted.
    Then the step must lower the loss on that batch, as
    tests/test_flow_forecaster_variants.py:77 asks of the JAX models."""
    from predict_pv_yield_tpu_torch.models.flow_forecaster import (
        FORECAST_HORIZON,
        FORECASTER_ARCHITECTURES,
        HISTORICAL_SAT_IMAGES,
        OPTICAL_FLOW_PREDICTIONS,
        TARGET_SAT_IMAGE,
    )

    def make_model():
        return FORECASTER_ARCHITECTURES[arch](generator=torch.Generator().manual_seed(0))

    generator = torch.Generator().manual_seed(1)
    n, large, small = FLOW_PARITY_BATCH, 128, 64
    batch = {
        HISTORICAL_SAT_IMAGES: torch.randn((n, 4, large, large), generator=generator),
        OPTICAL_FLOW_PREDICTIONS: torch.randn((n, large, large), generator=generator),
        FORECAST_HORIZON: torch.randn((n,), generator=generator),
        TARGET_SAT_IMAGE: torch.randn((n, small, small), generator=generator),
    }
    start = time.perf_counter()
    card_loss, card_grads, card_params, card_decisions, _, model, on_card = _flow_step(make_model, batch, device)
    with torch.no_grad():
        after = float(torch.mean((model(on_card) - model.crop_target(on_card[TARGET_SAT_IMAGE])) ** 2))
    cpu_loss, own, _, decisions, ties, _, _ = _flow_step(make_model, batch, "cpu")
    native = _flow_step(make_model, batch, "cpu", mkldnn=False)[1]
    _, cpu_grads, cpu_params, *_ = _flow_step(make_model, batch, "cpu", decide=card_decisions)
    flips = [a != b for a, b in zip(decisions[0], card_decisions[0])]
    n_flips = sum(int(f.sum()) for f in flips)
    check(all(not (f & (t < 0)).any() for f, t in zip(flips, ties[0])),
          f"{arch}: the card and the CPU decide a ReLU input that is not a tie differently")
    # max-pool choices: the card's and the CPU's argmax differ only in tied windows
    moved = [a != b for a, b in zip(decisions[1], card_decisions[1])]
    n_moved = sum(int(m.sum()) for m in moved)
    n_pool_ties = sum(int((t >= 0).sum()) for t in ties[1])
    check(all(not (m & (t < 0)).any() for m, t in zip(moved, ties[1])),
          f"{arch}: the card and the CPU pick a max-pool window's maximum differently where it is not a tie")
    loss_err = abs(card_loss - cpu_loss)
    grad_errs = _rel_errs(card_grads.values(), cpu_grads.values())
    spread = _rel_errs(native.values(), own.values())
    grad_tol = max(GRAD_REL_TOL, GRAD_SPREAD_FACTOR * max(spread))
    exempt = {k: g.abs() < 2 * (card_grads[k] - g).abs().max() for k, g in cpu_grads.items()}
    n_exempt = sum(int(e.sum()) for e in exempt.values())
    deltas = {k: (card_params[k] - cpu_params[k]).abs() for k in cpu_params}
    param_err = max(float(torch.where(exempt[k], 0.0, d).max()) if k in exempt else float(d.max())
                    for k, d in deltas.items())
    exempt_err = max((float(deltas[k][e].max()) for k, e in exempt.items() if e.any()), default=0.0)
    n_params = sum(v.numel() for v in cpu_params.values())
    log(f"[flow-train] (a) {arch} ({n_params:,} parameters) one step at batch {n}, card vs CPU: MSE {card_loss:.7f} "
        f"vs {cpu_loss:.7f} (|Δ| {loss_err:.3e}, limit {STEP_LOSS_TOL}); gradients max |Δ| / max |g| "
        f"{max(grad_errs):.3e} on the card's ReLU decisions ({n_flips} ties decided the other way) and max-pool "
        f"choices ({n_moved} of {n_pool_ties} tied windows chosen the other way), the CPU's "
        f"own spread {max(spread):.3e}, limit {grad_tol:.3e}; parameters after Adam max |Δ| {param_err:.3e} "
        f"(limit {FLOW_PARAM_TOL}) over the {n_params - n_exempt:,} of {n_params:,} whose gradient is not within "
        f"twice the measured gap of zero, {exempt_err:.3e} over those {n_exempt:,}; the card's MSE after the step "
        f"{after:.7f}; "
        f"{time.perf_counter() - start:.2f} s")
    check(loss_err <= STEP_LOSS_TOL, f"{arch}: the card's MSE disagrees with the CPU's")
    check(max(grad_errs) <= grad_tol, f"{arch}: a card gradient disagrees with the CPU's")
    check(param_err <= FLOW_PARAM_TOL, f"{arch}: the card's Adam step disagrees with the CPU's")
    check(after < card_loss, f"{arch}: one step did not lower the loss ({card_loss} → {after})")
    return {"loss_err": loss_err, "grad_rel_err": max(grad_errs), "cpu_grad_spread": max(spread),
            "relu_flips": n_flips, "pool_moves": n_moved, "pool_ties": n_pool_ties, "param_err": param_err,
            "params_exempt": n_exempt, "exempt_err": exempt_err,
            "loss_before": card_loss, "loss_after": after}


@contextlib.contextmanager
def _marked_flow_steps():
    """Inside the block, ``train_flow_forecaster.train_step`` records a
    CUDA event after each step into the yielded list."""
    from predict_pv_yield_tpu_torch import train_flow_forecaster as tff

    marks, step = [], tff.train_step

    def marked_step(model, optimizer, batch):
        loss = step(model, optimizer, batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return loss

    tff.train_step = marked_step
    try:
        yield marks
    finally:
        tff.train_step = step


def _steady_rate(marks) -> float:
    """The median train examples/s of the last ``FLOW_STEADY`` step gaps."""
    torch.cuda.synchronize()
    gaps = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])][-FLOW_STEADY:]
    return float(np.median([FLOW_BATCH * 1e3 / gap for gap in gaps]))


def _settled_launches(dataset, quiet=3.0, timeout=300.0) -> int:
    """``sep_blur.launches`` once the dataset's producer thread has filled
    its queue and launched nothing for ``quiet`` seconds: it has then built
    its last super batch (9 launches in quick succession) and waits on the
    full queue."""
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    last, deadline = None, time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        count = blur.launches
        if count == last and dataset._queue.full():
            return count
        last = count
        time.sleep(quiet)
    raise AssertionError(f"the super-batch producer did not settle in {timeout} s")


def _traced_step_ms(step, attempts: int = 3):
    """(device ms, CUDA-event ms, the profiler's records) per call of a
    train step that keeps the card busy. A trace that drops kernel records
    (see :func:`_warm_session`) sums to less than the card's time between
    CUDA events around the same calls, so the trace is taken again until
    its sum is within ``TRACE_COVERAGE`` of that time."""
    calls = PERCEIVER_TRACED_CALLS
    for attempt in range(1, attempts + 1):
        events = _device_events(step, calls=calls)
        traced_ms = sum(e.self_device_time_total for e in events) / calls / 1e3
        evented_ms = call_ms(step, calls=calls)
        if traced_ms >= TRACE_COVERAGE * evented_ms:
            return traced_ms, evented_ms, events
        log(f"[profiler] trace {attempt} sums to {traced_ms:.4f} ms a step, the CUDA events to {evented_ms:.4f} ms: "
            f"records dropped; tracing again")
    raise AssertionError(f"the profiler's step time {traced_ms:.4f} ms is not within {TRACE_COVERAGE:.0%} "
                         f"of the CUDA events' {evented_ms:.4f} ms in {attempts} traces")


def _flow_fit(device, tmp, flops_peak):
    """(b) The JAX tool's run at full width from an HRV zarr archive, with
    background refresh; its traced window; (c) the other three
    architectures on its dataset; the same run without background refresh."""
    import os

    from predict_pv_yield_tpu_torch import train_flow_forecaster as tff
    from predict_pv_yield_tpu_torch.data.flow_dataset import FlowInMemDataset, SatelliteFlowLoader
    from predict_pv_yield_tpu_torch.data.zarr_reader import write_zarr
    from predict_pv_yield_tpu_torch.flow_nowcast import archive, drifting_archive, evaluate
    from predict_pv_yield_tpu_torch.models.flow_forecaster import FORECASTER_ARCHITECTURES, FlowForecaster
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    start = time.perf_counter()
    frames, _ = drifting_archive(n_days=FLOW_DAYS, size=PRODUCTION, seed=0)
    root = os.path.join(tmp, "hrv.zarr")
    os.makedirs(root)
    with open(os.path.join(root, ".zgroup"), "w") as fh:
        json.dump({"zarr_format": 2}, fh)
    write_zarr(os.path.join(root, "hrv"), frames, chunks=(FLOW_CHUNK, *PRODUCTION))
    log(f"[flow-train] (b) wrote a {frames.shape} int16 drifting-cloud HRV archive ({frames.nbytes / 1e6:.1f} MB, "
        f"zlib, chunks of {FLOW_CHUNK} frames) in {time.perf_counter() - start:.2f} s")
    del frames
    # the tool's dates; its June testing range lies outside this one day
    lazy, datetimes, _ = archive(root, "hrv")
    loader = SatelliteFlowLoader(data=lazy, datetimes=datetimes, num_forecast_timesteps=48,
                                 testing_date_range=FLOW_TESTING, device=device)

    def seeded(cls=FlowForecaster):
        return cls(generator=torch.Generator().manual_seed(0)).to(device)

    def dataset(background_refresh):
        return FlowInMemDataset(loader, n_super_batches=FLOW_SUPER_BATCHES,
                                n_examples_per_epoch=FLOW_STEPS * FLOW_BATCH, batch_size=FLOW_BATCH,
                                background_refresh=background_refresh)

    blur.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    refreshed = dataset(True)
    torch.cuda.synchronize()
    build = time.perf_counter() - begin
    model = seeded()
    with _marked_flow_steps() as marks:
        begin = time.perf_counter()
        losses = tff.train(model, refreshed, FLOW_STEPS, FLOW_LR)
        fit = time.perf_counter() - begin
    rate_on = _steady_rate(marks)
    scores = evaluate(model, loader, batch_size=FLOW_BATCH, n_batches=FLOW_EVAL_BATCHES)
    launches = _settled_launches(refreshed)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    first, last = float(losses[:FLOW_EDGE].mean()), float(losses[-FLOW_EDGE:].mean())
    log(f"[flow-train] (b) FlowForecaster(32) from the zarr archive at {PRODUCTION[0]}x{PRODUCTION[1]}: "
        f"{FLOW_SUPER_BATCHES} resident super batches built in {build:.3f} s; {FLOW_STEPS} steps of "
        f"{FLOW_BATCH} in {fit:.3f} s ({FLOW_STEPS * FLOW_BATCH / fit:.2f} examples/s), steady "
        f"{rate_on:.2f} train examples/s (median of the last {FLOW_STEADY} step gaps), background refresh on; "
        f"MSE first {FLOW_EDGE} {first:.5f}, last {FLOW_EDGE} {last:.5f}; "
        + ", ".join(f"SSIM {k} {v:.4f}" for k, v in scores.items())
        + f" ({FLOW_EVAL_BATCHES} testing batches); sep_blur launches {launches}; peak device memory {peak:.3f} GiB")
    check(len(losses) == FLOW_STEPS and bool(torch.isfinite(losses).all()), "a non-finite flow-training loss")
    check(last < first, f"the flow forecaster did not learn: {first} → {last}")
    check(launches % 9 == 0 and launches >= 9 * FLOW_SUPER_BATCHES,
          f"flow training launched sep_blur {launches} times: not 9 per super batch, or fewer than "
          f"{FLOW_SUPER_BATCHES} super batches")
    check(all(np.isfinite(v) and -1 <= v <= 1 for v in scores.values()), f"SSIM {scores}")

    busy, wall = _busy_share(lambda: tff.train(model, refreshed, FLOW_TRACED_STEPS, FLOW_LR),
                             warm=lambda: tff.train(model, refreshed, 2, FLOW_LR),
                             replica=lambda: tff.train(model, refreshed, FLOW_TRACED_STEPS, FLOW_LR),
                             what="[flow-train] (b) the 20-step window")
    batch = next(iter(refreshed))
    optimizer = torch.optim.Adam(model.parameters(), lr=FLOW_LR)
    step_ms, evented_ms, events = _traced_step_ms(lambda: tff.train_step(model, optimizer, batch))
    flops = 6 * _layer_macs(model, batch)  # forward, and the two products of each layer's backward
    bound_ms = flops / flops_peak * 1e3
    log(f"[flow-train] (b) busy share of a traced {FLOW_TRACED_STEPS}-step window: {busy:.1%} "
        f"({wall * 1e3:.3f} ms); the train step at batch {FLOW_BATCH}: {step_ms:.4f} ms of device time "
        f"({evented_ms:.4f} ms between CUDA events on the same calls) against a {bound_ms:.4f} ms fp32 bound "
        f"({flops / 1e9:.1f} GFLOP); top kernels:")
    _top(events, "flow-train")

    smoke = {}
    for arch in ("conv2d_ae", "maxpool_ae", "pure_conv3d"):
        begin = time.perf_counter()
        arch_losses = tff.train(seeded(FORECASTER_ARCHITECTURES[arch]), refreshed, FLOW_SMOKE_STEPS, FLOW_LR)
        seconds = time.perf_counter() - begin
        check(bool(torch.isfinite(arch_losses).all()), f"{arch}: a non-finite loss")
        smoke[arch] = {"first": float(arch_losses[0]), "last": float(arch_losses[-1]), "seconds": seconds}
        log(f"[flow-train] (c) {arch}: {FLOW_SMOKE_STEPS} steps in {seconds:.3f} s, MSE "
            f"{smoke[arch]['first']:.5f} → {smoke[arch]['last']:.5f}")

    plain = dataset(False)
    with _marked_flow_steps() as marks:
        begin = time.perf_counter()
        tff.train(seeded(), plain, FLOW_STEPS, FLOW_LR)
        fit_off = time.perf_counter() - begin
    rate_off = _steady_rate(marks)
    del plain
    log(f"[flow-train] (b) the same run with background_refresh=False: {FLOW_STEPS} steps in {fit_off:.3f} s "
        f"({FLOW_STEPS * FLOW_BATCH / fit_off:.2f} examples/s), steady {rate_off:.2f} train examples/s "
        f"(refresh on: {rate_on:.2f})")
    return {"launches": launches, "build_s": build, "fit_examples_per_s": FLOW_STEPS * FLOW_BATCH / fit,
            "steady_examples_per_s": rate_on, "fit_examples_per_s_no_refresh": FLOW_STEPS * FLOW_BATCH / fit_off,
            "steady_examples_per_s_no_refresh": rate_off, "busy_share": busy, "step_ms": step_ms,
            "step_event_ms": evented_ms,
            "step_bound_ms": bound_ms, "peak_gib": peak,
            "mse_first": first, "mse_last": last, "ssim": scores, "smoke": smoke}


def _flow_bench(device, headline_frames, headline_rate):
    """(d) ``flow_bench.main()`` and ``flow_bench.sweep()`` on the card: a
    positive host rate, and the headline within ``BENCH_AGREEMENT`` of phase
    3's rate. The flow path is host-bound and its pace drifts with the
    host's (in one run on an H100, three readings of phase 3's rate a few
    seconds apart spread 1247–1586 pairs/s, and two bench headlines
    1438–1684), so phase 3's measurement is made again on its frames in
    turns with the bench (phase 3, bench, …, phase 3: ``BENCH_READINGS``
    bench readings), and the best reading of each side is compared: a
    host-bound rate's best is steadier than its median."""
    from predict_pv_yield_tpu_torch import flow_bench

    beside, headlines = [_flow_pairs_per_s(headline_frames, runs=10)], []
    for _ in range(BENCH_READINGS):
        headlines.append(flow_bench.main(device))
        beside.append(_flow_pairs_per_s(headline_frames, runs=10))
    points = flow_bench.sweep(device)
    bench, phase3 = max(h["value"] for h in headlines), max(beside)
    agreement = bench / phase3 - 1
    host = headlines[0]["host_single_core_pairs_per_sec"]
    log(f"[flow-train] (d) flow_bench headline {', '.join(str(h['value']) for h in headlines)} pairs/s against "
        f"phase 3's measurement in turns with it, {', '.join(f'{r:.2f}' for r in beside)}: best {bench:.2f} "
        f"and {phase3:.2f} ({agreement:+.1%}; phase 3 at the start: {headline_rate:.2f}); host single core "
        f"{', '.join(str(h['host_single_core_pairs_per_sec']) for h in headlines)} pairs/s")
    check(abs(agreement) <= BENCH_AGREEMENT, "the bench's headline disagrees with phase 3's rate")
    check(all(h["host_single_core_pairs_per_sec"] > 0 for h in headlines), "no host rate")
    return {"bench": headlines, "sweep": points, "phase3_beside_bench": beside}


def phase_flow_train(device, headline_frames, headline_rate, flops_peak):
    """Phase 13: the flow forecasters' training step card vs CPU, the JAX
    tool's run at full width from a zarr archive, and the flow bench."""
    start = time.perf_counter()
    results = {"parity": {arch: _flow_parity(device, arch)
                          for arch in ("conv3d", "conv2d_ae", "maxpool_ae", "pure_conv3d")}}
    with tempfile.TemporaryDirectory() as tmp:
        results.update(_flow_fit(device, tmp, flops_peak))
        results.update(_flow_bench(device, headline_frames, headline_rate))
    results["seconds"] = time.perf_counter() - start
    log(f"[flow-train] phase 13: {results['seconds']:.2f} s")
    return results


# --- phase 14: parallel ------------------------------------------------------

#: (d): the two ranks' small geometry — the data-parallel model and batch of
#: tests/test_torch_distributed.py, the tensor-parallel perceiver of
#: tests/test_torch_tensor_parallel.py, and 4 frame pairs at 256² (2 a rank)
PARALLEL_DP_MODEL = dict(forecast_minutes=60, history_minutes=30, number_of_conv3d_layers=2, conv3d_channels=8,
                         image_size_pixels=12, nwp_image_size_pixels=12, number_sat_channels=11,
                         number_nwp_channels=10, fc1_output_features=16, fc2_output_features=16,
                         fc3_output_features=16, output_variable="gsp_yield", include_pv_yield_history=True,
                         include_future_satellite=True)
PARALLEL_DP_BATCH = 8
PARALLEL_TP_MODEL = dict(history_minutes=30, forecast_minutes=60, embedding_dem=16, num_latents=8, latent_dim=8)
PARALLEL_FRAMES = (5, 256, 256)
#: the JAX package's tensor-parallel tolerances (tests/test_tensor_parallel.py:92-105)
TP_NMAE_TOL, TP_PARAM_TOL = 1e-5, 3e-4
FLOW_SHARD_TOL = 1e-5  # px: the sharded flow against the one-rank flow
PARALLEL_WORKER_TIMEOUT = 300


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _max_diff(got, want) -> float:
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(got, want))


def _parallel_serve(device, tmp):
    """(a) a checkpoint the port's trainer writes at phase 7's
    geometry, served by ``predict.main --checkpoint`` and by
    ``Trainer.predict``, against ``predict.predict`` of the trained model."""
    import os

    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    dataset = FakeDataset(model_configuration(_flagship()), length=3)
    batches = [dataset[i] for i in range(3)]
    ckpt = ModelCheckpoint(dirpath=os.path.join(tmp, "ck"))
    trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None, callbacks=[ckpt])
    trainer.fit(_flagship(), train_dataloaders=batches[:2], val_dataloaders=batches[2:])
    check(os.path.exists(os.path.join(ckpt.best_model_path, "state.pt")), "no checkpoint directory was written")
    loader = serve.fake_loader(trainer._model, 2)
    expected = serve.predict(trainer._model, loader, device)
    scale = max(float(np.abs(y).max()) for y in expected)
    yaml_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), CONV3D_SAT_NWP_YAML)
    served = serve.main(["--model", "conv3d_sat_nwp", "--model-config", yaml_path, "--checkpoint",
                         ckpt.best_model_path, "--n-batches", "2", "--out", os.path.join(tmp, "forecasts.csv"),
                         "--device", str(device)])
    resumed = Trainer(device=device, profiler=None, weights_summary=None, resume_from_checkpoint=ckpt.best_model_path)
    predicted = resumed.predict(_flagship(), dataloaders=loader)
    fresh = serve.predict(serve.build_model("conv3d_sat_nwp", CONV3D_SAT_NWP, seed=0), loader, device)
    diffs = {"main": _max_diff(served["predictions"], expected), "trainer_predict": _max_diff(predicted, expected),
             "seed0": _max_diff(fresh, expected)}
    log(f"[parallel] (a) a ModelCheckpoint directory of conv3d_sat_nwp.yaml (2 train + 1 validation batches of 32) "
        f"served over 2 fake batches: predict.main --checkpoint max |Δ| {diffs['main']:.3e}, Trainer.predict "
        f"{diffs['trainer_predict']:.3e} against predict.predict of the trained model (limit "
        f"{SERVE_TOL:.0e} x max |y| = {SERVE_TOL * scale:.3e}); the seed-0 model differs by {diffs['seed0']:.3e}; "
        f"{served['rows']} CSV rows")
    check(diffs["main"] <= SERVE_TOL * scale and diffs["trainer_predict"] <= SERVE_TOL * scale,
          "a served checkpoint's forecasts disagree with the trained model's")
    check(diffs["seed0"] > SERVE_TOL * scale, "the seed-0 model forecasts what the trained one does")
    return diffs


def _dp_fits(device, unique, k_values, steps, **kwargs):
    """conv3d_sat_nwp.yaml fits at each ``steps_per_execution`` of
    ``k_values`` on ``steps`` rotated batches → {k: (trainer, seconds,
    rate, gaps, every step's NMAE)}."""
    return {k: _fit_k(device, _flagship, _rotated(unique, steps), k, 32, 1, 32, **kwargs) for k in k_values}


def _parallel_dp(device, unique, alone, graphs):
    """(b) data parallelism over NCCL at world size 1 (the process group is
    up): 24 steps at k = 1 and 8 bit-equal to ``alone`` (the same fits
    without a process group) and to each other, the rates of 48-step fits
    beside phase 12's, and the NCCL kernels' device time per step."""
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    with _deterministic():
        joined = _dp_fits(device, unique, (1, GRAPH_K), GRAPH_EQUAL_TRAIN)
    checks = {}
    for k in (1, GRAPH_K):
        equal, params, _ = _state_diff(alone[k][0], joined[k][0])
        checks[f"k{k}_vs_no_group"] = equal and torch.equal(alone[k][4], joined[k][4])
        check(joined[k][0]._data_group is not None, "the world-1 fit built no data group")
    _, replayed = _graph_equality((joined[1][0], joined[1][4]), (joined[GRAPH_K][0], joined[GRAPH_K][4]))
    checks["k8_replays_vs_eager"] = replayed["bit_equal"]
    log(f"[parallel] (b) conv3d_sat_nwp.yaml fp32, batch 32, NCCL at world size 1: {GRAPH_EQUAL_TRAIN} steps at k=1 "
        f"and k={GRAPH_K} ({len(joined[GRAPH_K][0]._graphs)} CUDA graph(s), the gradient all_reduce captured) "
        f"against the same fits without a process group, deterministic algorithms: bit-equal "
        f"{checks['k1_vs_no_group']} / {checks[f'k{GRAPH_K}_vs_no_group']}; the k={GRAPH_K} replays against the "
        f"k=1 steps: bit-equal {checks['k8_replays_vs_eager']}")
    check(all(checks.values()), f"data parallelism at world size 1 is not exact: {checks}")
    del joined, alone
    rates = _dp_fits(device, unique, (1, GRAPH_K), GRAPH_TRAIN)
    numbers = {f"k{k}_rate": rates[k][2] for k in rates}
    # the NCCL kernels of one step, from a warmed trace held to the CUDA events' time
    trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None)
    trainer.setup(_flagship())
    card = unique[0].numeric().to(device)
    step_ms, evented_ms, events = _traced_step_ms(lambda: trainer.train_step(card))
    nccl = [e for e in events if "nccl" in e.key.lower()]
    calls = PERCEIVER_TRACED_CALLS
    numbers.update(step_ms=step_ms, nccl_ms=sum(e.self_device_time_total for e in nccl) / calls / 1e3,
                   nccl_launches=sum(e.count for e in nccl) / calls)
    log(f"[parallel] (b) {GRAPH_TRAIN} steps, default algorithms: steady train examples/s k=1 {numbers['k1_rate']:.2f}, "
        f"k={GRAPH_K} {numbers[f'k{GRAPH_K}_rate']:.2f} (phase 12 without a process group: "
        f"{graphs['k1_rate']:.2f}, {graphs[f'k{GRAPH_K}_rate']:.2f}); one step {step_ms:.4f} ms traced "
        f"({evented_ms:.4f} ms of CUDA events), NCCL kernels {numbers['nccl_ms']:.4f} ms in "
        f"{numbers['nccl_launches']:.1f} launches a step"
        + "".join(f"; {e.self_device_time_total / calls / 1e3:.4f} ms x{e.count // calls} {e.key[:70]}"
                  for e in nccl[:3]))
    del rates, trainer, card
    torch.cuda.empty_cache()
    return {**checks, **numbers}


def _split_geglu_matches(encoder, fused) -> bool:
    """Each feed-forward shard of the partitioned ``encoder`` holds what the
    JAX package's ``split_geglu_params`` makes of the fused encoder's
    in-projection (through the port's numpy copy, on a flax-layout view)."""
    from predict_pv_yield_tpu_torch.convert import split_geglu_params

    def distinct(model):
        return list({id(layer): layer for layer in model.layers}.values())

    for block, fused_block in zip(distinct(encoder), distinct(fused)):
        pairs = [(block[1].fn, fused_block[1].fn)] + [(b[1].fn, f[1].fn) for b, f in zip(block[2], fused_block[2])]
        for shard, whole in pairs:
            first, last = whole.net[0], whole.net[2]
            tree = {"in": {"kernel": first.weight.detach().cpu().numpy().T, "bias": first.bias.detach().cpu().numpy()},
                    "out": {"kernel": last.weight.detach().cpu().numpy().T}}
            split = split_geglu_params({"ff": tree})["ff"]
            for name in ("in_value", "in_gate"):
                layer = getattr(shard, name)
                if not (np.array_equal(split[name]["kernel"].T, layer.weight.detach().cpu().numpy())
                        and np.array_equal(split[name]["bias"], layer.bias.detach().cpu().numpy())):
                    return False
    return True


def _parallel_tp(device, graphs):
    """(c) tensor parallelism at world size 1 (the NCCL group is up):
    perceiver.yaml at full width with ``partition_attention=True`` and
    ``model_parallel=1`` set up by the trainer from seed 0 against the fused
    model from seed 0, the bf16 rate at k = 8 beside phase 12's, and
    ``model_parallel=2`` raising in this one process."""
    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models.layers import init_parameters
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
    from predict_pv_yield_tpu_torch.models.perceiver_core import ShardedAttention
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    kwargs = {k: v for k, v in PERCEIVERS["perceiver"].items() if k != "_target_"}
    unique = list(serve.fake_loader(serve.build_model("perceiver", PERCEIVERS["perceiver"]), TRAIN_UNIQUE))
    trainer = Trainer(device=device, profiler=None, weights_summary=None, model_parallel=1)
    trainer.setup(PerceiverModel(**kwargs, partition_attention=True))
    encoder = trainer._model.perceiver
    check(trainer._partitioned and isinstance(encoder.layers[0][0].fn, ShardedAttention)
          and trainer._model_group is not None, "the trainer did not partition the encoder over its model group")
    fused = PerceiverModel(**kwargs)
    init_parameters(fused, torch.Generator().manual_seed(0))
    split = _split_geglu_matches(encoder, fused.perceiver)
    check(split, "the partitioned feed-forwards do not hold split_geglu_params' split of the fused weights")
    batches = unique[:2]
    got = serve.predict(trainer._model, batches, device)
    want = serve.predict(fused, batches, device)
    scale = max(float(np.abs(y).max()) for y in want)
    diff = _max_diff(got, want)
    log(f"[parallel] (c) perceiver.yaml, partition_attention=True, model_parallel=1 over the NCCL model group: "
        f"feed-forward shards equal split_geglu_params of the fused weights {split}; forward over 2 batches of 8 "
        f"against the fused model from the same seed, fp32: max |Δ| {diff:.3e} (limit {SERVE_TOL:.0e} x max |y| "
        f"= {SERVE_TOL * scale:.3e})")
    check(diff <= SERVE_TOL * scale, "the partitioned perceiver's forward disagrees with the fused one's")
    del trainer, fused, encoder
    fit, seconds, rate, gaps, _ = _fit_k(device, lambda: PerceiverModel(**kwargs, partition_attention=True),
                                         _rotated(unique, GRAPH_TRAIN), GRAPH_K, 16, 1, kwargs["batch_size"])
    log(f"[parallel] (c) the partitioned perceiver.yaml in bf16 at k={GRAPH_K}, {GRAPH_TRAIN} steps: steady train "
        f"examples/s {rate:.2f} (median of {gaps} group gaps; phase 12's unpartitioned perceiver "
        f"{graphs[f'k{GRAPH_K}_rate']:.2f}); {len(fit._graphs)} CUDA graph(s), {seconds:.2f} s")
    del fit
    try:
        Trainer(device=device, model_parallel=2)
        raised = False
    except ValueError as error:
        raised = "does not fit" in str(error)
    check(raised, "model_parallel=2 in one process did not raise ValueError")
    log("[parallel] (c) Trainer(model_parallel=2) in this one process raises ValueError (does not fit)")
    torch.cuda.empty_cache()
    return {"forward_diff": diff, "split_geglu": split, "bf16_k8_rate": rate}


def _parallel_flow(device, frames):
    """The sharded flow at world size 1 (one NCCL rank computes every pair,
    then the gather): equal to ``flow_sequence``, its ``sep_blur``
    launches counted."""
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence, flow_sequence_sharded

    expected = flow_sequence(frames)
    blur.launches = 0
    flows = flow_sequence_sharded(frames)
    launches = blur.launches  # counted on the host, at each launch
    diff = float((flows - expected).abs().max())
    log(f"[parallel] flow_sequence_sharded at world size 1 over NCCL, {frames.shape[0]}x{frames.shape[1]}x"
        f"{frames.shape[2]}: max |Δ| {diff:.3e} px against flow_sequence (limit {FLOW_SHARD_TOL}); sep_blur "
        f"launched {launches} times")
    check(diff <= FLOW_SHARD_TOL, "the sharded flow disagrees with flow_sequence")
    check(launches > 0, "the sharded flow launched no sep_blur")
    return {"flow_world1_diff": diff, "flow_world1_launches": launches}


def _tp_dataset():
    from predict_pv_yield_tpu_torch.config.dataset import Configuration
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset

    configuration = Configuration()
    configuration.process.batch_size = 2
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.nwp.nwp_image_size_pixels = 8
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    configuration.input_data.nwp.nwp_channels = configuration.input_data.nwp.nwp_channels[:10]
    return FakeDataset(configuration=configuration, length=2)


def _tp_model(partition_attention):
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel

    model = PerceiverModel(**PARALLEL_TP_MODEL, partition_attention=partition_attention)
    model.match_configuration(_tp_dataset().configuration)
    return model


def _dp_batch():
    from predict_pv_yield_tpu_torch.config.dataset import Configuration
    from predict_pv_yield_tpu_torch.data.fake import fake_batch

    configuration = Configuration()
    configuration.process.batch_size = PARALLEL_DP_BATCH
    configuration.input_data.default_history_minutes = 30
    configuration.input_data.default_forecast_minutes = 60
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 12
    configuration.input_data.nwp.nwp_image_size_pixels = 12
    return fake_batch(configuration, np.random.default_rng(0))


def _parallel_rank_work(device, rows=slice(None)):
    """What each of (d)'s ranks does (or one process, with every row): one
    data-parallel step of the small conv3d_sat_nwp on its rows of the
    global batch, a fit of two steps of the small perceiver over the model
    group, and the flow of the frame pairs → numbers and tensors on the CPU."""
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence_sharded
    from predict_pv_yield_tpu_torch.parallel.mesh import world
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    batch = _dp_batch().map(lambda name, x: x[rows])
    trainer = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None)
    trainer.setup(Model(**PARALLEL_DP_MODEL))
    nmae = float(trainer._data_mean(trainer.train_step(batch.numeric().to(device))["NMAE"]))
    params = {k: v.cpu() for k, v in trainer._model.state_dict().items()}
    tp = Trainer(max_epochs=1, device=device, profiler=None, weights_summary=None, model_parallel=world()[0])
    metrics = tp.fit(_tp_model(world()[0] > 1), train_dataloaders=_tp_dataset())
    full = {k: v.cpu() for k, v in tp.state["model"].items()}
    frames = torch.from_numpy(np.random.default_rng(7).uniform(0, 255, PARALLEL_FRAMES).astype(np.float32)).to(device)
    blur.launches = 0
    flows = flow_sequence_sharded(frames)
    return {"dp_nmae": nmae, "dp_params": params, "tp_nmae": metrics["NMAE/Train_epoch"], "tp_params": full,
            "flows": flows.cpu(), "launches": blur.launches}


def parallel_worker(rank: int, port: int, out: str) -> None:
    """One of (d)'s two ranks on ``cuda:0``: gloo (NCCL refuses two ranks on
    one device; gloo stages CUDA tensors through host memory)."""
    import os

    import torch.distributed as dist

    from predict_pv_yield_tpu_torch.parallel.distributed import host_local_batch_slice

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    try:
        result = _parallel_rank_work(torch.device("cuda", 0), host_local_batch_slice(PARALLEL_DP_BATCH))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _parallel_two_ranks(device, tmp):
    """(d) two processes on the one card over gloo, at small widths and
    k = 1, held to the one process's work: the data-parallel step to phase
    7's one-step tolerances, the tensor-parallel fit to the JAX package's,
    the sharded flow to 1e-5 px with ``sep_blur`` launching on both ranks."""
    import os

    reference = _parallel_rank_work(device)
    port = _free_port()
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", str(rank), str(port),
                               tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outputs = [proc.communicate(timeout=PARALLEL_WORKER_TIMEOUT)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for rank, (proc, output) in enumerate(zip(procs, outputs)):
        check(proc.returncode == 0, f"(d) rank {rank} failed (rc {proc.returncode}):\n{output[-3000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{rank}.pt"), weights_only=False) for rank in range(2)]
    seconds = time.perf_counter() - start
    out = {"seconds": seconds, "launches": [r["launches"] for r in ranks]}
    for name, result in enumerate(ranks):
        dp_params = max(float((result["dp_params"][k] - v).abs().max()) for k, v in reference["dp_params"].items())
        over = sum(int(((result["dp_params"][k] - v).abs() > 5e-5).sum()) for k, v in reference["dp_params"].items())
        tp_params = max(float((result["tp_params"][k] - v).abs().max()) for k, v in reference["tp_params"].items())
        flows = float((result["flows"] - reference["flows"]).abs().max())
        out[f"rank{name}"] = {"dp_nmae": abs(result["dp_nmae"] - reference["dp_nmae"]), "dp_params": dp_params,
                              "dp_over_5e-5": over, "tp_nmae": abs(result["tp_nmae"] - reference["tp_nmae"]),
                              "tp_params": tp_params, "flows": flows}
    log(f"[parallel] (d) two ranks on cuda:0 over gloo ({seconds:.2f} s with their start): "
        + "; ".join(f"rank {r}: data-parallel step NMAE |Δ| {v['dp_nmae']:.3e} (limit {STEP_LOSS_TOL}), parameters "
                    f"{v['dp_params']:.3e} (limit {STEP_PARAM_TOL}; {v['dp_over_5e-5']} above 5e-5), "
                    f"tensor-parallel fit NMAE |Δ| {v['tp_nmae']:.3e} (limit {TP_NMAE_TOL}), parameters "
                    f"{v['tp_params']:.3e} (limit {TP_PARAM_TOL}), sharded flow {v['flows']:.3e} px "
                    f"(limit {FLOW_SHARD_TOL}), sep_blur launched {out['launches'][r]} times"
                    for r, v in ((r, out[f"rank{r}"]) for r in range(2))))
    check(all(out[f"rank{r}"]["dp_nmae"] <= STEP_LOSS_TOL and out[f"rank{r}"]["dp_params"] <= STEP_PARAM_TOL
              for r in range(2)), "the two-rank data-parallel step disagrees with the one-rank step")
    check(all(out[f"rank{r}"]["tp_nmae"] <= TP_NMAE_TOL and out[f"rank{r}"]["tp_params"] <= TP_PARAM_TOL
              for r in range(2)), "the two-rank tensor-parallel fit disagrees with the unpartitioned fit")
    check(all(out[f"rank{r}"]["flows"] <= FLOW_SHARD_TOL for r in range(2)), "the two-rank flow disagrees")
    check(all(n > 0 for n in out["launches"]), "sep_blur did not launch on both ranks")
    return out


def phase_parallel(device, frames, trainer_results):
    """Phase 14: F2 and ``Trainer.predict``, data parallelism over NCCL at
    world size 1, the partitioned perceiver at world size 1, the sharded
    flow, and two ranks on the one card over gloo."""
    import os

    import torch.distributed as dist

    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
    from predict_pv_yield_tpu_torch.parallel.distributed import initialize_distributed

    start = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            results["serve"] = _parallel_serve(device, tmp)
        finally:
            os.chdir(cwd)
    # before the process group: the one-step rules of the partitioned
    # perceiver (its CPU side cannot join a NCCL group) and the fits alone
    kwargs = {k: v for k, v in PERCEIVERS["perceiver"].items() if k != "_target_"}
    results["tp_step"] = _train_parity(
        device, lambda: PerceiverModel(**{**kwargs, "batch_size": PERCEIVER_PARITY_BATCH, "partition_attention": True}),
        "parallel (c), the partitioned perceiver.yaml")
    dataset = FakeDataset(model_configuration(_flagship()), length=TRAIN_UNIQUE)
    unique = [dataset[i] for i in range(TRAIN_UNIQUE)]  # phase 7's batches, from the same seed
    with _deterministic():
        alone = _dp_fits(device, unique, (1, GRAPH_K), GRAPH_EQUAL_TRAIN)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        check(dist.get_backend() == "nccl", f"the world-1 group runs {dist.get_backend()}, not NCCL")
        results["dp"] = _parallel_dp(device, unique, alone, trainer_results["graphs"]["conv3d_sat_nwp_fp32"])
        del alone
        results["tp"] = _parallel_tp(device, trainer_results["graphs"]["perceiver_bf16"])
        results.update(_parallel_flow(device, frames))
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        results["two_ranks"] = _parallel_two_ranks(device, tmp)
    results["seconds"] = time.perf_counter() - start
    log(f"[parallel] phase 14: {results['seconds']:.2f} s; world size 1 and two ranks sharing one card measure no "
        f"scaling")
    return results


#: phase 15 runs in a temporary directory: paths of the checkout are absolute
REPO_ROOT = str(pathlib.Path(__file__).resolve().parent)
#: the JAX package's committed orbax checkpoints (tests/test_torch_orbax.py writes them)
ORBAX_FIXTURES = f"{REPO_ROOT}/predict_pv_yield_tpu_torch/testdata/orbax"
#: fixture (a)'s model (its model.yaml) and the trainer knobs it was written with
FIXTURE_KNOBS = dict(max_epochs=1, val_check_interval=3, accumulate_grad_batches=2, gradient_clip_val=0.5,
                     limit_val_batches=1)
ZSTD_REPEATS = 5  # the decoder's rate: every frame of both fixtures, decoded this many times
SWEEP_OVERRIDES = [
    "-m", "hparams_search=conv3d_optuna", "experiment=conv3d_sat_nwp", "logger=csv", "datamodule.fake_data=true",
    "datamodule.n_train_data=2", "datamodule.n_val_data=1", "trainer.max_epochs=1", "model.image_size_pixels=16",
    "model.number_sat_channels=1", "model.history_minutes=60", "model.forecast_minutes=30",
    "model.number_of_conv3d_layers=2", "model.include_nwp=false", "sweep.n_trials=2",
]


def _fixture_model():
    """Fixture (a)'s conv3d_sat_nwp, at the widths of its ``model.yaml``."""
    import os

    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.predict import load_model_config

    config = load_model_config(os.path.join(ORBAX_FIXTURES, "conv3d_sat_nwp", "model.yaml"))
    config.pop("_target_", None)
    return Model(**config)


def _fixture_dataset(length=6):
    """The batches fixture (a) was trained on: ``FakeDataset`` of the
    tests/configs/dataset_small configuration, as the JAX package draws them."""
    from predict_pv_yield_tpu_torch.config.dataset import load_yaml_configuration
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset

    return FakeDataset(configuration=load_yaml_configuration(
        f"{REPO_ROOT}/tests/configs/dataset_small/configuration.yaml"), length=length)


def _orbax_zstd():
    """(a) Every zstd frame of both fixtures through the native decoder; the
    leaves' hashes against ``expected.json``; the decoder's MB/s."""
    import hashlib
    import os

    from predict_pv_yield_tpu_torch import native
    from predict_pv_yield_tpu_torch.training.orbax import read_ocdbt, read_train_state

    results = {}
    frames = []
    for name in ("conv3d_sat_nwp", "perceiver_tp"):
        directory = os.path.join(ORBAX_FIXTURES, name, "last")
        kv = read_ocdbt(directory)
        chunks = [value for key, value in kv.items() if not key.endswith((".zarray", ".zattrs"))]
        check(all(value[:4] == b"\x28\xb5\x2f\xfd" for value in chunks), f"{name}: a chunk is no zstd frame")
        frames += chunks
        with open(os.path.join(ORBAX_FIXTURES, name, "expected.json")) as fh:
            expected = json.load(fh)

        def leaves(tree, prefix=()):
            for key, value in tree.items():
                if isinstance(value, dict):
                    yield from leaves(value, prefix + (key,))
                else:
                    yield ".".join(prefix + (key,)), value

        got = {}
        for leaf, value in leaves(read_train_state(directory)):
            bits = value.view(torch.int16).numpy() if isinstance(value, torch.Tensor) else np.ascontiguousarray(value)
            got[leaf] = {"shape": list(bits.shape),
                         "dtype": "bfloat16" if isinstance(value, torch.Tensor) else bits.dtype.name,
                         "sha256": hashlib.sha256(bits.tobytes()).hexdigest()}
        check(got == expected, f"{name}: the leaves read natively differ from expected.json")
        results[f"{name}_leaves"] = len(got)
    total = sum(len(native.zstd_decompress(frame)) for frame in frames)
    start = time.perf_counter()
    for _ in range(ZSTD_REPEATS):
        for frame in frames:
            native.zstd_decompress(frame)
    seconds = time.perf_counter() - start
    results.update(zstd_frames=len(frames), zstd_bytes=total, zstd_mb_per_s=ZSTD_REPEATS * total / seconds / 1e6)
    log(f"[orbax] (a) {len(frames)} zstd chunk frames of both fixtures ({total / 1e6:.3f} MB) decoded natively; "
        f"{results['conv3d_sat_nwp_leaves']} + {results['perceiver_tp_leaves']} leaves equal expected.json; "
        f"decoder {results['zstd_mb_per_s']:.2f} MB/s on the card's host (one core, {ZSTD_REPEATS} passes)")
    return results


def _resumed_fit(where, checkpoint, tmp, tag, max_steps=5, dataset=None):
    """The port's ``Trainer`` resumed from ``checkpoint`` on ``where`` to
    ``max_steps`` with fixture (a)'s knobs → (trainer, logged rows)."""
    from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.loggers import CSVLogger

    logger = CSVLogger(save_dir=f"{tmp}/{tag}")
    trainer = Trainer(device=where, profiler=None, weights_summary=None, logger=logger, max_steps=max_steps,
                      resume_from_checkpoint=checkpoint, **FIXTURE_KNOBS,
                      callbacks=[ModelCheckpoint(dirpath=f"{tmp}/{tag}_ck", save_top_k=0)])
    dataset = dataset if dataset is not None else _fixture_dataset()
    trainer.fit(_fixture_model(), train_dataloaders=dataset, val_dataloaders=dataset)
    return trainer, logger._rows


def _states_equal(a, b) -> bool:
    sa, sb = a.state, b.state
    if sa["model"].keys() != sb["model"].keys():
        return False
    same = all(torch.equal(sa["model"][k].cpu(), sb["model"][k].cpu()) for k in sa["model"])
    for x, y in zip(sa["optimizer"]["state"].values(), sb["optimizer"]["state"].values()):
        same &= all(torch.equal(x[k].cpu(), y[k].cpu()) for k in ("step", "exp_avg", "exp_avg_sq"))
    if sa["accumulation"] is not None:
        same &= sa["accumulation"]["mini_step"] == sb["accumulation"]["mini_step"] and all(
            torch.equal(g.cpu(), h.cpu()) for g, h in zip(sa["accumulation"]["grads"], sb["accumulation"]["grads"]))
    return bool(same)


def _orbax_resume(device, tmp):
    """(b) fixture (a) resumed for 2 steps on the card against the CPU
    under phase 7's one-step rules; the open check of bit-exact resume on
    the card, under strict deterministic algorithms."""
    import os

    checkpoint = os.path.join(ORBAX_FIXTURES, "conv3d_sat_nwp", "last")
    with open(os.path.join(checkpoint, "loop.json")) as fh:
        loop = json.load(fh)
    card, card_rows = _resumed_fit(device, checkpoint, tmp, "card")
    cpu, cpu_rows = _resumed_fit("cpu", checkpoint, tmp, "cpu")
    check(card.global_step == cpu.global_step == loop["global_step"] + 2, "resumed step counts")
    check([sorted(r) for r in card_rows] == [sorted(r) for r in cpu_rows], "resumed metric rows differ in keys")
    loss_err = max(abs(float(a[k]) - float(b[k])) for a, b in zip(card_rows, cpu_rows) for k in a
                   if k not in ("step", "epoch"))
    param_err = max(float((card._model.state_dict()[k].cpu() - v).abs().max())
                    for k, v in cpu._model.state_dict().items())
    log(f"[orbax] (b) fixture (a) (global_step {loop['global_step']}, mid-epoch, MultiSteps at mini-step 1, clip "
        f"0.5) resumed for 2 steps, card vs CPU: metric rows max |Δ| {loss_err:.3e} (limit {STEP_LOSS_TOL}), "
        f"parameters max |Δ| {param_err:.3e} (limit {STEP_PARAM_TOL})")
    check(loss_err <= STEP_LOSS_TOL, "resumed metrics: card vs CPU")
    check(param_err <= STEP_PARAM_TOL, "resumed parameters: card vs CPU")
    results = {"resume_loss_err": loss_err, "resume_param_err": param_err}

    from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    with _deterministic():
        # a port state.pt: 4 steps against 2 + `last` + resume + 2
        dataset = _fixture_dataset(4)
        knobs = dict(max_epochs=1, val_check_interval=2, limit_val_batches=1, accumulate_grad_batches=2,
                     gradient_clip_val=0.5)

        def fit(tag, max_steps=None, resume=None):
            trainer = Trainer(device=device, profiler=None, weights_summary=None, max_steps=max_steps,
                              resume_from_checkpoint=resume, callbacks=[
                                  ModelCheckpoint(dirpath=f"{tmp}/{tag}", save_top_k=0)], **knobs)
            trainer.fit(_fixture_model(), train_dataloaders=dataset, val_dataloaders=dataset)
            return trainer

        whole = fit("whole")
        fit("part", max_steps=2)
        resumed = fit("resumed", resume=f"{tmp}/part/last")
        check(whole.global_step == resumed.global_step == 4, "the state.pt fits' step counts")
        port_equal = _states_equal(whole, resumed)
        # fixture (a), resumed on the card twice from the same files
        first, _ = _resumed_fit(device, checkpoint, tmp, "det1")
        second, _ = _resumed_fit(device, checkpoint, tmp, "det2")
        fixture_equal = _states_equal(first, second)
    log(f"[orbax] (b) bit-exact resume on the card under deterministic algorithms: a port state.pt (4 steps against "
        f"2 + last + resume + 2): {'bit-equal' if port_equal else 'NOT bit-equal'}; fixture (a) resumed twice: "
        f"{'bit-equal' if fixture_equal else 'NOT bit-equal'} (parameters, Adam moments and steps, accumulation)")
    check(port_equal and fixture_equal, "resume on the card is not bit-exact")
    results.update(resume_bit_exact_state_pt=port_equal, resume_bit_exact_fixture=fixture_equal)
    return results


def _orbax_serve(tmp):
    """(c) ``predict.main --checkpoint`` on fixture (a), card against CPU."""
    import os

    from predict_pv_yield_tpu_torch import predict

    directory = os.path.join(ORBAX_FIXTURES, "conv3d_sat_nwp")
    outputs = {}
    for where in ("cuda", "cpu"):
        outputs[where] = predict.main(["--model", "conv3d_sat_nwp", "--model-config", f"{directory}/model.yaml",
                                       "--checkpoint", f"{directory}/last", "--n-batches", "2", "--out",
                                       f"{tmp}/{where}.csv", "--device", where])
    card, cpu = (np.concatenate(outputs[w]["predictions"]) for w in ("cuda", "cpu"))
    err, scale = float(np.abs(card - cpu).max()), float(np.abs(cpu).max())
    log(f"[orbax] (c) predict.main --checkpoint <orbax dir>: {outputs['cuda']['rows']} rows, card vs CPU max |Δ| "
        f"{err:.3e} (limit {SERVE_TOL} · max |y| = {SERVE_TOL * scale:.3e})")
    check(outputs["cuda"]["rows"] == outputs["cpu"]["rows"] and np.isfinite(card).all(), "orbax serve rows")
    check(err <= SERVE_TOL * scale, "orbax serve: card vs CPU")
    return {"serve_err": err, "serve_rows": outputs["cuda"]["rows"]}


def _tools_full_width(device):
    """(d) serve_bench, a short pipeline_bench, and mfu_probe's three modes
    (the perceiver at one width) at full width; their JSON lines."""
    from predict_pv_yield_tpu_torch import mfu_probe, pipeline_bench, serve_bench

    results = {"serve_bench": serve_bench.run(device)}
    log(json.dumps(results["serve_bench"]))
    results["pipeline_bench"] = pipeline_bench.run(shards=8, steps=24, workers=8, device=device)
    log(json.dumps(results["pipeline_bench"]))
    results["pipeline_bench_host"] = pipeline_bench.run(shards=8, steps=24, workers=8, host_only=True)
    log(json.dumps(results["pipeline_bench_host"]))
    for name, run in (("towers", lambda: mfu_probe.probe_towers(device)),
                      ("step", lambda: mfu_probe.probe_step(device)),
                      ("perceiver", lambda: mfu_probe.probe_perceiver(device, "24x24x32"))):
        results[f"mfu_{name}"] = run()
        log(json.dumps(results[f"mfu_{name}"]))
    serve = results["serve_bench"]
    log(f"[tools] (d) serve p50 / p99 at batch 1 {serve['p50_ms_b1']:.4f} / {serve['p99_ms_b1']:.4f} ms, "
        f"{serve['throughput_ex_s_b128']:.2f} examples/s at batch 128; pipeline {results['pipeline_bench']['value']:.3f}"
        f" batches/s end to end, host alone {results['pipeline_bench_host']['value']:.3f}; towers "
        f"{results['mfu_towers']['sat_tower']['tflops_per_s']:.2f} / {results['mfu_towers']['nwp_tower']['tflops_per_s']:.2f}"
        f" TFLOP/s (sat / nwp, bf16)")
    for name, result in results.items():
        check(not _tool_errors(result), f"{name} failed: {_tool_errors(result)}")
        numbers = list(_tool_numbers(result))
        check(numbers and all(np.isfinite(v) and v > 0 for v in numbers), f"{name} numbers: {result}")
    check("latents_24x24_b32" in results["mfu_perceiver"], "mfu_probe --mode perceiver ran no width")
    return results


def _tool_errors(result):
    """The ``error`` entries anywhere in a tool's JSON line."""
    return [v for k, v in result.items() if k == "error"] + [
        e for v in result.values() if isinstance(v, dict) for e in _tool_errors(v)]


def _tool_numbers(result):
    """Every number in a tool's JSON line (its labels skipped)."""
    for value in result.values():
        if isinstance(value, dict):
            yield from _tool_numbers(value)
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            yield float(value)
        elif not isinstance(value, str):
            yield float("nan")  # None or anything else where a number belongs


def _sweep_on_card(tmp):
    """(e) ``run.py -m`` with 2 trials at a small width on the card."""
    import contextlib as _contextlib
    import io
    import os
    import shutil

    from predict_pv_yield_tpu_torch import run

    cwd = os.getcwd()
    data = os.path.join(REPO_ROOT, "tests", "configs", "dataset_small")
    os.makedirs(f"{tmp}/sweep")
    shutil.copytree(data, f"{tmp}/sweep/ds")
    os.chdir(f"{tmp}/sweep")
    out = io.StringIO()
    try:
        start = time.perf_counter()
        with _contextlib.redirect_stdout(out):
            best = run.main(SWEEP_OVERRIDES + ["datamodule.data_path=ds"])
        seconds = time.perf_counter() - start
    finally:
        os.chdir(cwd)
    (run_dir,) = [p for p in os.scandir(f"{tmp}/sweep/logs/multiruns") if p.is_dir()]
    trials = sorted(d for d in os.listdir(run_dir.path) if d.isdigit())
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("sweep best value:")]
    log(f"[sweep] (e) run.py -m, 2 trials on the card: {line[0] if line else 'no best-value line'}; trial "
        f"directories {trials}; {seconds:.2f} s")
    check(trials == ["0", "1"] and line and best is not None and np.isfinite(best), "the sweep on the card")
    for trial in trials:
        check(os.path.exists(os.path.join(run_dir.path, trial, "checkpoints", "last", "state.pt")), f"trial {trial}")
    return {"sweep_best": best, "sweep_seconds": seconds}


def _fake_on_device(device):
    """(f) ``fake_batch_on_device`` at the flagship's configuration on the card."""
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device
    from predict_pv_yield_tpu_torch.flagship import flagship_configuration

    batch = fake_batch_on_device(flagship_configuration(32), seed=0, device=device)
    again = fake_batch_on_device(flagship_configuration(32), seed=0, device=device)
    fields = {}
    for group in ("satellite", "nwp", "pv", "gsp", "sun", "topographic", "hrvsatellite"):
        for name, value in vars(getattr(batch, group)).items():
            if isinstance(value, torch.Tensor):
                fields[name] = value
    check(all(v.device.type == "cuda" for v in fields.values()), "a fake field off the card")
    check(all(v.dtype in (torch.float32, torch.int32) for v in fields.values()), "a fake field's dtype")
    check(0 <= float(fields["gsp_yield"].min()) and float(fields["gsp_yield"].max()) < 1, "gsp_yield range")
    check(int(fields["pv_system_row_number"].max()) < 940 and int(fields["gsp_id"].max()) < 340, "id ranges")
    check(all(torch.equal(a, b) for a, b in zip(batch.leaves(), again.leaves())), "fake batches differ per seed")
    log(f"[fake] (f) fake_batch_on_device at the flagship's configuration: {len(fields)} fields on {device}, "
        f"float32 and int32, in their ranges, the same per seed; satellite {tuple(batch.satellite.data.shape)}")
    return {"fake_fields": len(fields)}


def phase_orbax(device):
    """Phase 15: the JAX package's checkpoints read natively, resumed and
    served on the card, and the tooling at full width."""
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    import os

    start = time.perf_counter()
    launches = blur.launches
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)  # the fits' result CSVs land here
        try:
            results.update(_orbax_zstd())
            results.update(_orbax_resume(device, tmp))
            results.update(_orbax_serve(tmp))
            results["tools"] = _tools_full_width(device)
            results.update(_sweep_on_card(tmp))
            results.update(_fake_on_device(device))
        finally:
            os.chdir(cwd)
    check(blur.launches == launches, "the checkpoint and tooling phase launched sep_blur")
    results["seconds"] = time.perf_counter() - start
    log(f"[orbax] phase 15: {results['seconds']:.2f} s; sep_blur launched {blur.launches - launches} times")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase 14 (d)'s two ranks
        parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    # TF32 off for matmul and cuDNN: every comparison below is in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peak_name, bandwidth, flops_peak, bf16_peak = peaks(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; peaks of {peak_name}: "
        f"{bandwidth / 1e12:.2f} TB/s, {flops_peak / 1e12:.0f} TFLOP/s fp32, {bf16_peak / 1e12:.0f} TFLOP/s "
        f"dense bf16; TF32 allowed: "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}")

    with _GateProcess("--deterministic") as gate:  # phase 9 (d) trains while nvcc builds
        phase_build()
        waited = time.perf_counter()
        gate_run = gate.result()
    log(f"[perceiver] (d) the gate's process: {gate_run['seconds']:.2f} s, {time.perf_counter() - waited:.2f} s "
        f"of it after the build")
    rows = phase_kernels(device, bandwidth, flops_peak)
    loader, load_launches, headline_rate, headline_frames = phase_nowcast(device)
    request_launches, _ = phase_requests(device, loader)
    production_rate = phase_production(device)
    serve = phase_serve(device, bandwidth, flops_peak)
    trained = phase_train(device, bandwidth, flops_peak)
    data = phase_data(device, trained)
    perceivers = phase_perceiver(device, bandwidth, flops_peak, data["baseline_nmae"], gate_run)
    zoo = phase_zoo(device, bandwidth, flops_peak, bf16_peak, serve, trained, perceivers, data["baseline_nmae"])
    with tempfile.TemporaryDirectory() as tmp:
        formats, tree = phase_formats(device, trained, data, tmp)
        trainer = phase_trainer(device, tree)
    flow_train = phase_flow_train(device, headline_frames, headline_rate, flops_peak)
    parallel = phase_parallel(device, headline_frames, trainer)
    orbax = phase_orbax(device)

    level_ms = sum(r["ms"] for r in rows if r["case"].startswith("headline"))
    log(f"[breakdown] sep_blur share of flow_sequence {FRAMES}x{SIDE}x{SIDE}: "
        f"{3 * level_ms:.3f} ms of {(FRAMES - 1) * 1e3 / headline_rate:.3f} ms")
    headline = rows[0]
    kernels = [{
        "name": "sep_blur",
        "route": "cuda",
        "source": "predict_pv_yield_tpu_torch/csrc/sep_blur.cu",
        "replaces": "predict_pv_yield_tpu/ops/pallas_blur.py:103",
        "launches": (load_launches + request_launches + flow_train["launches"] + parallel["flow_world1_launches"]
                     + sum(parallel["two_ranks"]["launches"])),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "call_ms": headline["call_ms"],
    }, {
        "name": "conv3d_wgrad",
        "route": "cuda",
        "source": "predict_pv_yield_tpu_torch/csrc/conv3d_wgrad.cu",
        "replaces": None,
        "launches_in_fit": trained["wgrad_fit_launches"],
        "max_err": max(max(r["max_err_dw"], r["max_err_db"]) for r in trained["wgrad_rows"]),
        "ms": trained["wgrad_total"]["call_device_ms"],
        "plain_ms": trained["wgrad_total"]["plain_ms"],
        "bound_ms": trained["wgrad_total"]["bound_ms"],
        "bound_by": "operations",
        "library_ms": trained["wgrad_total"]["library_ms"],
    }, {
        "name": "conv3d_dgrad",
        "route": "cuda",
        "source": "predict_pv_yield_tpu_torch/csrc/conv3d_dgrad.cu",
        "replaces": None,
        "launches_in_fit": trained["dgrad_fit_launches"],
        "max_err": max(r["max_err"] for r in trained["dgrad_rows"]),
        "ms": trained["dgrad_total"]["call_device_ms"],
        "plain_ms": trained["dgrad_total"]["plain_ms"],
        "bound_ms": trained["dgrad_total"]["bound_ms"],
        "bound_by": "operations",
        "library_ms": trained["dgrad_total"]["library_ms"],
    }]
    log(json.dumps({"pairs_per_s_256": headline_rate, "pairs_per_s_704x548": production_rate, **serve,
                    **trained, **data, "perceivers": perceivers, "zoo": zoo, "formats": formats,
                    "trainer": trainer, "flow_train": flow_train, "parallel": parallel, "orbax": orbax},
                   default=str))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
