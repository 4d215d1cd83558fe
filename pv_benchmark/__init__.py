"""The benchmark of ``predict_pv_yield_tpu_torch`` on NVIDIA GPUs.

One run is one process and one cell of ``BENCHMARK.json``:

    python -m pv_benchmark.run --workload conv3d_sat_nwp.train --seed 7 --seconds 30 --trace 0

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in files of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names the loop,
``loops/<kind>.py``, and the loader, ``loaders/<loader>.py``),
``metrics/<metric>.py``, ``reference/<module>.py`` and ``limits/<cell>.json``.
"""
