"""Prepare an on-disk batch dataset (a port of the JAX package's
``tools/prepare_dataset.py``: the same arguments, and at the same seed the
same shards, at any ``--workers``).

The reference trains from directories of pre-prepared per-batch files plus a
``configuration.yaml`` (produced by the external ``nowcasting_dataset``
pipeline; consumed at reference ``dataloader.py:78-102``). This writes:

    <out>/configuration.yaml
    <out>/train/000000.shard ...   (flat raw format, mmap-read hot path)
    <out>/test/000000.shard ...

``--format npz`` writes numpy archives instead (smaller over a network);
``--format netcdf`` the reference's v15 per-source NetCDF tree
(``data/netcdf_writer.py``, which needs h5py) with the int16 satellite wire.

Sources: ``--fake`` synthesises batches, or ``--satellite-zarr`` samples
windows from a zarr archive through the first-party reader; ``--nwp-zarr``
adds real NWP grids (freshest-run selection, centre-cropped) and
``--gsp-csv`` real GSP targets. Usage:

    python -m predict_pv_yield_tpu_torch.prepare --out data/v0 --fake --n-train 64 --n-test 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--fake", action="store_true")
    parser.add_argument("--n-train", type=int, default=64)
    parser.add_argument("--n-test", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--history-minutes", type=int, default=30)
    parser.add_argument("--forecast-minutes", type=int, default=60)
    parser.add_argument("--satellite-pixels", type=int, default=24)
    parser.add_argument("--nwp-pixels", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--format", choices=("raw", "npz", "netcdf"), default="raw",
                        help="raw/npz = the shard formats; netcdf = the reference's v15 per-source NetCDF "
                        "batch tree (h5netcdf byte conventions, data/netcdf_writer.py)")
    parser.add_argument("--satellite-zarr", default=None,
                        help="zarr group store to sample real satellite windows from (arrays: --zarr-array "
                        "imagery sliceable on time, --zarr-time datetimes, optional x/y OSGB pixel coords); "
                        "--nwp-zarr/--hrv-zarr/--topo-zarr/--pv-csv/--gsp-csv make the remaining groups real "
                        "too; anything left uncovered stays synthetic")
    parser.add_argument("--zarr-array", default="data")
    parser.add_argument("--zarr-time", default="time")
    parser.add_argument("--nwp-zarr", default=None,
                        help="zarr group store of NWP model runs (--nwp-dims axis order; freshest run per "
                        "hourly target, cropped --nwp-pixels around each example's centre)")
    parser.add_argument("--nwp-zarr-array", default="data")
    parser.add_argument("--nwp-init-time", default="init_time")
    parser.add_argument("--nwp-step", default="step")
    parser.add_argument("--nwp-dims", default="init_time,variable,step,y,x",
                        help="comma-separated axis order of the NWP store")
    parser.add_argument("--hrv-zarr", default=None,
                        help="zarr group of the high-resolution visible channel -> the hrvsatellite group")
    parser.add_argument("--hrv-zarr-array", default="data")
    parser.add_argument("--hrv-zarr-time", default="time")
    parser.add_argument("--hrv-pixels", type=int, default=64)
    parser.add_argument("--topo-zarr", default=None,
                        help="zarr group holding one (H, W) elevation grid + OSGB x/y -> the topographic group")
    parser.add_argument("--topo-pixels", type=int, default=64)
    parser.add_argument("--pv-csv", default=None,
                        help="PVOutput/Passiv-style long-format power dump -> real PV yield series; with "
                        "--pv-metadata-csv the system locations drive every modality's extraction")
    parser.add_argument("--pv-metadata-csv", default=None, help="per-system metadata (id, kwp, location)")
    parser.add_argument("--gsp-csv", default=None,
                        help="long-format PVLive dump (datetime_gmt, gsp_id, generation_mw, capacity_mwp) "
                        "-> real 30-minute GSP targets")
    parser.add_argument("--n-gsp", type=int, default=1, help="GSPs per example when --gsp-csv is given")
    parser.add_argument("--test-fraction", type=float, default=0.2,
                        help="held-out tail of the archive's time axis used for the test split (zarr mode)")
    parser.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                        help="concurrent batch builders (threads); each batch draws from its own "
                        "(seed, split, index) rngs, so the output is the same at any worker count")
    return parser


def _open_sources(args, parser):
    """The archive's sources → (satellite, {name: other source}, locations)."""
    from predict_pv_yield_tpu_torch.data import sources
    from predict_pv_yield_tpu_torch.seqlen import SeqLens

    try:
        sat = sources.open_zarr_satellite(args.satellite_zarr, args.zarr_array, args.zarr_time,
                                          image_size_pixels=args.satellite_pixels)
    except ValueError as exc:
        parser.error(str(exc))
    others = {}
    if args.nwp_zarr:
        try:
            others["nwp"] = sources.open_zarr_nwp(
                args.nwp_zarr, array=args.nwp_zarr_array, init_time=args.nwp_init_time, step=args.nwp_step,
                dims=tuple(args.nwp_dims.split(",")), image_size_pixels=args.nwp_pixels,
                # hourly targets with the reference's ceil-history rule
                n_targets=SeqLens(args.history_minutes, args.forecast_minutes).seq_len_60)
        except (ValueError, FileNotFoundError) as exc:
            parser.error(str(exc))
    if args.hrv_zarr:
        others["hrv"] = sources.open_zarr_satellite(args.hrv_zarr, args.hrv_zarr_array, args.hrv_zarr_time,
                                                    image_size_pixels=args.hrv_pixels, key_prefix="hrv")
    if args.topo_zarr:
        others["topo"] = sources.open_zarr_topographic(args.topo_zarr, image_size_pixels=args.topo_pixels)
    locations = None
    if args.pv_csv:
        if not args.pv_metadata_csv:
            parser.error("--pv-csv requires --pv-metadata-csv")
        others["pv"] = sources.PVDataSource.from_passiv_csv(args.pv_csv, args.pv_metadata_csv)
        if others["pv"].x is not None and others["pv"].y is not None:
            # nowcasting_dataset's pick-a-system-then-extract loop
            locations = np.stack([others["pv"].x, others["pv"].y], axis=1)
    if sat.x is not None and sat.y is not None:
        # real solar angles at the archive centre
        others["sun"] = sources.SunSource(float(np.median(sat.x)), float(np.median(sat.y)))
    if args.gsp_csv:
        others["gsp"] = sources.GSPSource.from_pvlive_csv(args.gsp_csv, n_gsp_per_example=args.n_gsp)
    return sat, others, locations


def _configuration(args, parser, sat, nwp):
    from predict_pv_yield_tpu_torch.config.dataset import Configuration

    configuration = Configuration()
    configuration.process.batch_size = args.batch_size
    input_data = configuration.input_data
    input_data.default_history_minutes = args.history_minutes
    input_data.default_forecast_minutes = args.forecast_minutes
    input_data = configuration.input_data = input_data.set_all_to_defaults()
    input_data.satellite.satellite_image_size_pixels = args.satellite_pixels
    input_data.nwp.nwp_image_size_pixels = args.nwp_pixels
    if sat is not None:
        # channel count follows the archive ((T,H,W) = 1, (T,C,H,W) = C)
        n_ch = 1 if len(sat.data.shape) == 3 else sat.data.shape[1]
        channels = list(input_data.satellite.satellite_channels)
        if n_ch > len(channels):
            parser.error(f"archive has {n_ch} channels > the {len(channels)} named satellite channels")
        input_data.satellite.satellite_channels = channels[:n_ch]
    if args.gsp_csv:
        input_data.gsp.n_gsp_per_example = args.n_gsp
    if nwp is not None:
        n_nwp_ch = nwp.data.shape[2]  # canonical axis 2 = channel
        nwp_channels = list(input_data.nwp.nwp_channels)
        if n_nwp_ch > len(nwp_channels):
            parser.error(f"NWP archive has {n_nwp_ch} channels > the {len(nwp_channels)} named NWP channels")
        input_data.nwp.nwp_channels = nwp_channels[:n_nwp_ch]
    if args.hrv_zarr:
        input_data.hrvsatellite.hrvsatellite_image_size_pixels = args.hrv_pixels
    if args.topo_zarr:
        input_data.topographic.topographic_image_size_pixels = args.topo_pixels
    if args.pv_csv:
        input_data.pv.n_pv_systems_per_example = 1
    return configuration


def _write_configuration(args, configuration) -> None:
    """``<out>/configuration.yaml``: the JAX tool's file, byte for byte."""
    import yaml

    input_data = configuration.input_data
    with open(os.path.join(args.out, "configuration.yaml"), "w") as fh:
        yaml.safe_dump({
            "general": {"name": "prepared", "description": "native shard dataset"},
            "process": {"batch_size": args.batch_size},
            "input_data": {
                "default_history_minutes": args.history_minutes,
                "default_forecast_minutes": args.forecast_minutes,
                "satellite": {"satellite_image_size_pixels": args.satellite_pixels,
                              "satellite_channels": list(input_data.satellite.satellite_channels)},
                "nwp": {"nwp_image_size_pixels": args.nwp_pixels,
                        "nwp_channels": list(input_data.nwp.nwp_channels)},
                # the geometry a consumer derives shapes from must match the shards
                "gsp": {"n_gsp_per_example": int(input_data.gsp.n_gsp_per_example)},
                "hrvsatellite": {
                    "hrvsatellite_image_size_pixels": int(input_data.hrvsatellite.hrvsatellite_image_size_pixels)},
                "topographic": {
                    "topographic_image_size_pixels": int(input_data.topographic.topographic_image_size_pixels)},
                "pv": {"n_pv_systems_per_example": int(input_data.pv.n_pv_systems_per_example)},
            },
        }, fh)


def _int16_wire(batch, rng, real: bool) -> torch.Tensor:
    """The satellite imagery as the int16 counts the v15 archives ship:
    random counts for fake data; an archive's values, which must be
    integral counts in range (never wrapped)."""
    if not real:
        return torch.from_numpy(rng.integers(-1, 1023, size=tuple(batch.satellite.data.shape), dtype=np.int16))
    values = batch.satellite.data.numpy()
    info = np.iinfo(np.int16)
    if values.min() < info.min or values.max() > info.max or not np.array_equal(values, np.round(values)):
        raise ValueError("--format netcdf writes the int16 satellite wire, but the archive holds non-integral "
                         "or out-of-range values (already-decoded floats?) — use --format raw or npz")
    return torch.from_numpy(np.round(values).astype(np.int16))


def main(argv=None) -> None:
    parser = _parser()
    args = parser.parse_args(argv)

    from predict_pv_yield_tpu_torch.data.fake import fake_batch
    from predict_pv_yield_tpu_torch.data.netcdf_writer import write_v15_batch
    from predict_pv_yield_tpu_torch.data.shards import write_shard
    from predict_pv_yield_tpu_torch.data.sources import SampleGenerator, collate_samples, merge_real_groups

    if not args.fake and not args.satellite_zarr:
        parser.error("pass --fake or --satellite-zarr")
    sat, others, locations = None, {}, None
    if args.satellite_zarr:
        sat, others, locations = _open_sources(args, parser)
    elif args.gsp_csv or args.nwp_zarr or args.hrv_zarr or args.topo_zarr or args.pv_csv:
        parser.error("--gsp-csv/--nwp-zarr/--hrv-zarr/--topo-zarr/--pv-csv require --satellite-zarr")
    configuration = _configuration(args, parser, sat, others.get("nwp"))
    # the JAX tool's source order: satellite, nwp, hrv, topo, pv, sun, gsp
    split_sources = [sat] + [others[k] for k in ("nwp", "hrv", "topo", "pv", "sun", "gsp") if k in others]
    os.makedirs(args.out, exist_ok=True)
    _write_configuration(args, configuration)

    for split, count in (("train", args.n_train), ("test", args.n_test)):
        directory = os.path.join(args.out, split)
        generator = None
        if sat is not None:
            # windows come from disjoint time partitions: the archive's tail
            # is held out for test
            cut = int(len(sat.datetimes) * (1.0 - args.test_fraction))
            split_times = sat.datetimes[:cut] if split == "train" else sat.datetimes[cut:]
            generator = SampleGenerator(
                split_sources, datetimes=split_times, history_minutes=args.history_minutes,
                forecast_minutes=args.forecast_minutes,
                rng=np.random.default_rng((args.seed, split == "test", 1 << 20)), locations=locations)

        def build_one(i: int, _generator=generator, _directory=directory, _split=split) -> None:
            rng = np.random.default_rng((args.seed, _split == "test", i))
            batch = fake_batch(configuration, rng)
            if _generator is not None:
                # a per-index sampling rng, not the generator's shared
                # stream: batch i is the same batch at any --workers
                real = collate_samples(_generator.sample(
                    args.batch_size, rng=np.random.default_rng((args.seed, _split == "test", i, 7))))
                batch = merge_real_groups(batch, real)
            if args.format == "netcdf":
                wire = _int16_wire(batch, rng, real=_generator is not None)
                batch = batch.replace(satellite=dataclasses.replace(batch.satellite, data=wire))
                write_v15_batch(_directory, i, batch)
            else:
                write_shard(_directory, i, batch, fmt=args.format)

        if args.workers > 1 and count > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=args.workers) as pool:
                list(pool.map(build_one, range(count)))  # the first failure raises here
        else:
            for i in range(count):
                build_one(i)
        print(f"wrote {count} batches to {directory}")


if __name__ == "__main__":
    main()
