"""Compute per-channel mean/std/min/max of a satellite zarr archive (a port
of the JAX package's ``tools/compute_channel_stats.py``).

The reference's normalisation-constant derivation
(``notebooks/mean_and_std_of_satellite_imagery.ipynb``): stream the int16
archive, decode −1 → missing, reduce over (time, x, y) per channel, print a
JSON table ready to paste into ``consts.py``-style constants.

    python -m predict_pv_yield_tpu_torch.compute_channel_stats /path/to/archive.zarr
    python -m predict_pv_yield_tpu_torch.compute_channel_stats store.zarr --member stacked_eumetsat_data
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("zarr", help="zarr array (or group) path")
    parser.add_argument("--member", default=None, help="array within a zarr group")
    parser.add_argument("--channel-axis", type=int, default=-1,
                        help="channel axis of the archive (OCF archives: trailing)")
    parser.add_argument("--slab-timesteps", type=int, default=None,
                        help="timesteps per streamed slab (default: the zarr time chunk)")
    parser.add_argument("--names", default=None,
                        help="comma-separated channel names; 'sat' = the reference's SAT_VARIABLE_NAMES ordering")
    args = parser.parse_args(argv)

    from predict_pv_yield_tpu_torch.consts import SAT_VARIABLE_NAMES
    from predict_pv_yield_tpu_torch.data.channel_stats import compute_channel_stats
    from predict_pv_yield_tpu_torch.data.zarr_reader import open_zarr

    array = open_zarr(args.zarr, array=args.member)
    names = None
    if args.names == "sat":
        names = list(SAT_VARIABLE_NAMES)
    elif args.names:
        names = [n.strip() for n in args.names.split(",")]
    stats = compute_channel_stats(array, channel_axis=args.channel_axis, channel_names=names,
                                  slab_timesteps=args.slab_timesteps)
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
