"""PyTorch / CUDA port of ``predict_pv_yield_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``ops/optical_flow.py`` ↔ ``ops/optical_flow.py``)
and is held to it by the ``tests/test_torch_*.py`` parity tests. This
package imports ``torch``, numpy and the standard library at module level
(PyYAML, pandas, fsspec, h5py and zstandard only inside the functions that
need them) — never JAX and nothing of ``predict_pv_yield_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise instead of falling back to the CPU (``utils.resolve_device``). The TPU
kernels of the reference become hand-written CUDA kernels under ``csrc/``,
built by ``_build.py`` at first use, as are the host LZ4 codec
(``csrc/lz4.cpp``) of the blosc reader and the host Farnebäck library
(``csrc/farneback.cpp``) of the flow bench.
"""
