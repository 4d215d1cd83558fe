"""Edge-replicated separable blur — the port of ``ops/pallas_blur.py``.

The Farnebäck update averages its five accumulator fields over the
``winsize`` window (41 taps at winsize 40), three times per pyramid level.
The JAX package computes that with XLA grouped convolutions and keeps a
Pallas banded-matmul kernel (``sep_blur_pallas``) as a measured negative
result on the TPU. On Hopper the blur is a hand-written CUDA stencil,
``csrc/sep_blur.cu``: a block walks down a tile of up to 256 columns in
32-row bands, H pass first straight from device memory, W pass from the
H-passed band in shared memory, so the intermediate never goes to device
memory; each thread emits a strip of outputs from a window held in
registers, and the radius is a compile-time parameter (one instantiation per
radius 0..32), so every tap is one FMA with its weight as an operand. The
kernel's source note gives its bound and what each part of the design does
about it.

``sep_blur`` launches that kernel for a CUDA tensor and uses the plain
version ``sep_blur_reference`` only for a tensor on the CPU. ``launches``
counts kernel launches, so a run can show that its path went through the
kernel; it is bumped under a lock, since the flow dataset's producer thread
launches the kernel beside the main thread.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch import _build
from predict_pv_yield_tpu_torch.utils import full_fp32

#: kernel launches since the counter was last reset (set it to 0 to reset)
launches = 0
_launches_lock = threading.Lock()

#: the kernel's tap limit (radius <= 32); ``kMaxTaps`` in csrc/sep_blur.cu
MAX_TAPS = 65


def _check(fields: torch.Tensor, taps) -> np.ndarray:
    if not isinstance(fields, torch.Tensor):
        raise TypeError(f"fields must be a torch.Tensor, got {type(fields).__name__}")
    if fields.dtype != torch.float32:
        raise TypeError(f"fields must be float32, got {fields.dtype}")
    if fields.ndim != 4:
        raise ValueError(f"fields must be (N, C, H, W), got shape {tuple(fields.shape)}")
    if not fields.is_contiguous():
        raise ValueError("fields must be contiguous")
    taps = np.ascontiguousarray(np.asarray(taps, dtype=np.float32).reshape(-1))
    if taps.size % 2 == 0 or taps.size > MAX_TAPS:
        raise ValueError(f"taps must be an odd count <= {MAX_TAPS}, got {taps.size}")
    return taps


def sep_blur_reference(fields: torch.Tensor, taps) -> torch.Tensor:
    """Plain version: replicate pad, then two grouped convolutions (W, H)."""
    taps = _check(fields, taps)
    radius = taps.size // 2
    channels = fields.shape[1]
    k = torch.as_tensor(taps, device=fields.device)
    padded = F.pad(fields, (radius, radius, radius, radius), mode="replicate")
    with full_fp32():
        out = F.conv2d(padded, k.view(1, 1, 1, -1).repeat(channels, 1, 1, 1), groups=channels)
        return F.conv2d(out, k.view(1, 1, -1, 1).repeat(channels, 1, 1, 1), groups=channels)


def sep_blur(fields: torch.Tensor, taps) -> torch.Tensor:
    """Separable correlation of (N, C, H, W) fp32 ``fields`` with the 1-D
    odd-length ``taps`` along W then H, edges replicated.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through ``sep_blur_reference``.
    """
    taps = _check(fields, taps)
    if fields.device.type == "cpu":
        return sep_blur_reference(fields, taps)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")

    lib = _library()
    out = torch.empty_like(fields)
    n, c, height, width = fields.shape
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream(fields.device).cuda_stream
        err = lib.sep_blur_f32(
            fields.data_ptr(), out.data_ptr(), n * c, height, width,
            taps.ctypes.data, taps.size, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"sep_blur kernel launch failed: {lib.sep_blur_error_string(err).decode()}"
        )
    _count_launch()
    return out


def _count_launch() -> None:
    """Add one to ``launches``: a read-modify-write, so under a lock (two
    threads launch the kernel while a flow model trains)."""
    global launches
    with _launches_lock:
        launches += 1


def _library() -> ctypes.CDLL:
    lib = _build.load("sep_blur")
    if lib.sep_blur_f32.argtypes is None:
        lib.sep_blur_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sep_blur_f32.restype = ctypes.c_int
        lib.sep_blur_error_string.argtypes = [ctypes.c_int]
        lib.sep_blur_error_string.restype = ctypes.c_char_p
        lib.sep_blur_max_taps.argtypes = []
        lib.sep_blur_max_taps.restype = ctypes.c_int
        if lib.sep_blur_max_taps() != MAX_TAPS:
            raise RuntimeError("csrc/sep_blur.cu kMaxTaps disagrees with MAX_TAPS")
    return lib
