"""Checks on the card that ``Trace.conv_s`` holds the convolution kernels'
device time: one traced run of a cell, whose kept trace is also summed by
kernel name.

    python -m pv_benchmark.conv_crosscheck --workload conv3d_sat_nwp.train --seed <n> [--seconds 10]

Per unit of the kept trace it compares (1) the part of ``conv_s`` under the
program's ``conv.*`` spans with the hand-written kernels (``conv3d_*``)
summed by name over all the trace's device events, and (2) the kernels
whose names say convolution (cuDNN's ``fprop``/``dgrad``/``wgrad`` and
``conv3d_*``) that lie under a counted event with the same kernels summed
over all events: nothing that does convolution work is missed. It also
gives the whole ``conv_s`` against the kernels named as convolutions, and
names the other kernels the counted events launch (the bias adds under
``aten::convolution``). The last line of standard output is a JSON object
with these; ``within`` says that (1) and (2) are within ``TOLERANCE``, and
the exit code is 1 where they are not.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

import torch

from pv_benchmark import trace

TOLERANCE = 0.03
#: kernel names (substrings) of the convolution work, by part
KERNELS = {"hand_written": ("conv3d_",), "fprop": ("fprop",), "dgrad": ("dgrad",), "cudnn_wgrad": ("wgrad",)}


def part_of(name: str):
    """The part of the convolution work a kernel's name says it does, else None."""
    return next((part for part, keys in KERNELS.items() if any(key in name for key in keys)), None)


def launched(event):
    """The kernels an event and the host events under it launched."""
    yield from getattr(event, "kernels", ())
    for child in getattr(event, "cpu_children", ()):
        yield from launched(child)


def parts(events):
    """→ (seconds by part: ``aten_s`` and ``spans_s`` of the outermost
    counted events, ``kernels_<part>_s`` of all device events by name,
    ``counted_<part>_s`` of those under a counted event; seconds of the
    other kernels under counted events, by name)."""
    out, other = defaultdict(float), defaultdict(float)
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            part = part_of(e.name)
            if part:
                out[f"kernels_{part}_s"] += (e.time_range.end - e.time_range.start) / 1e6
        elif trace.counted_conv(e):
            out["spans_s" if e.name.startswith(trace.CONV_SPAN_PREFIX) else "aten_s"] += e.device_time_total / 1e6
            for kernel in launched(e):
                part = part_of(kernel.name)
                if part:
                    out[f"counted_{part}_s"] += kernel.duration / 1e6
                else:
                    other[kernel.name[:trace.NAME_CHARS]] += kernel.duration / 1e6
    return dict(out), dict(other)


def main(argv=None) -> int:
    from pv_benchmark import run

    records = {}
    reduce, traced = trace.reduce, trace.traced

    def reduce_and_sum(events, wall_s, units, window_us):
        reduced = reduce(events, wall_s, units, window_us)
        records[id(reduced)] = (*parts(events), units, reduced.conv_s)
        return reduced

    kept = []
    trace.reduce = reduce_and_sum
    trace.traced = lambda warm, work: kept.append(traced(warm, work)) or kept[-1]
    args = list(argv if argv is not None else sys.argv[1:])
    if "--seconds" not in args:
        args += ["--seconds", "10"]
    try:
        rc = run.main(args + ["--trace", "1"])
    finally:
        trace.reduce, trace.traced = reduce, traced
    if rc != 0 or not kept:
        return rc or 1
    seconds, other, units, conv_s = records[id(kept[-1])]
    ms = {k: v / units * 1e3 for k, v in dict(seconds, conv_s=conv_s).items()}
    named = sum(v for k, v in ms.items() if k.startswith("kernels_"))
    pairs = {"spans": (ms.get("spans_s", 0.0), ms.get("kernels_hand_written_s", 0.0)),
             "named": (sum(v for k, v in ms.items() if k.startswith("counted_")), named)}
    # the spans' pair is judged where the trace holds hand-written kernels or spans (none on serve)
    judged = {k: pair for k, pair in pairs.items() if any(pair)}
    ratios = {k: (a / b if b > 0 else None) for k, (a, b) in judged.items()}
    within = "named" in ratios and all(q is not None and abs(q - 1) <= TOLERANCE for q in ratios.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({"units": units, "per_unit_ms": ms, "pairs_ms": pairs, "ratios": ratios,
                      "conv_s_over_named": ms["conv_s"] / named if named > 0 else None,
                      "other_under_counted_ms": [[name, v / units * 1e3] for name, v in top],
                      "tolerance": TOLERANCE, "within": within}), flush=True)
    return 0 if within else 1


if __name__ == "__main__":
    sys.exit(main())
