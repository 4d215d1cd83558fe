"""Input gradient of the conv towers' 3×3×3 fp32 convolutions.

The JAX package leaves this gradient to XLA; the port's towers sent it to
cuDNN, whose fp32 3-D data gradient ran at 31.5 % of the card's fp32 bound
and was the largest kernel of the conv3d_sat_nwp train step (PERF.md). On
Hopper it is a hand-written CUDA kernel, ``csrc/conv3d_dgrad.cu``: a tiled
direct convolution in which a block keeps 32 × 32 × 27 weights in shared
memory, each warp owns a tile of 4 rows × 4–8 columns of the input gradient
for all 32 input channels (one a lane), and the output's gradient comes in
through a ``cp.async`` ring of row windows. Each element has one owner
thread and one summation order: no atomics, no scratch, bit-identical from
run to run. The kernel's source note gives its bound and what each part of
the design does about it.

``conv3d_dgrad`` launches it for CUDA tensors and uses the plain version
``conv3d_dgrad_reference`` only for tensors on the CPU. ``launches`` counts
its calls on the card, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch import _build, tracing
from predict_pv_yield_tpu_torch.ops.conv3d_wgrad import Triple, _triple
from predict_pv_yield_tpu_torch.utils import full_fp32

#: kernel calls since the counter was last reset (set it to 0 to reset)
launches = 0
_launches_lock = threading.Lock()

#: elements of one im2col chunk of the plain version, at most
PLAIN_CHUNK_ELEMENTS = 1 << 27


def _check(grad_out, weight, input_shape: Sequence[int], padding) -> Tuple[Tuple[int, ...], Tuple[int, int, int]]:
    for name, t in (("grad_out", grad_out), ("weight", weight)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 5:
            raise ValueError(f"{name} must have 5 dimensions, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if grad_out.device != weight.device:
        raise ValueError(f"grad_out on {grad_out.device}, weight on {weight.device}")
    input_shape = tuple(int(v) for v in input_shape)
    if len(input_shape) != 5:
        raise ValueError(f"input_shape must be (N, C_in, T, H, W), got {input_shape}")
    co, ci = weight.shape[:2]
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"only a 3x3x3 kernel, got weight {tuple(weight.shape)}")
    if input_shape[1] != ci:
        raise ValueError(f"input_shape {input_shape} has {input_shape[1]} channels, the weight {ci}")
    padding = _triple(padding, "padding")
    if any(p not in (0, 1) for p in padding):
        raise ValueError(f"padding must be 0 or 1 in each dimension, got {padding}")
    n, _, t, h, w = input_shape
    expected = (n, co, *(size + 2 * p - 2 for size, p in zip((t, h, w), padding)))
    if tuple(grad_out.shape) != expected or min(expected) <= 0:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not fit input {input_shape} "
                         f"at padding {padding}: expected {expected}")
    return input_shape, padding


def conv3d_dgrad_reference(grad_out: torch.Tensor, weight: torch.Tensor, input_shape: Sequence[int],
                           padding: Triple = 0) -> torch.Tensor:
    """Plain version → the input's gradient: ``grad_out`` zero-padded by
    ``2 − padding``, im2col of its 27 shifted views, a chunk of the batch at
    a time, each chunk one matrix product with the flipped weights, their
    channel axes swapped."""
    pt, ph, pw = _triple(padding, "padding")
    n, ci, t, h, w = (int(v) for v in input_shape)
    co = grad_out.shape[1]
    padded = F.pad(grad_out, (2 - pw, 2 - pw, 2 - ph, 2 - ph, 2 - pt, 2 - pt))
    flipped = weight.flip(2, 3, 4).reshape(co, ci, 27).transpose(0, 1).reshape(ci, co * 27)
    chunk = max(1, min(n, PLAIN_CHUNK_ELEMENTS // max(co * 27 * t * h * w, 1)))
    parts = []
    with full_fp32():
        for start in range(0, n, chunk):
            part = padded[start : start + chunk]
            views = [part[:, :, a : a + t, b : b + h, c : c + w] for a in range(3) for b in range(3) for c in range(3)]
            cols = torch.stack(views, dim=2)  # (b, co, 27, t, h, w)
            cols = cols.permute(1, 2, 0, 3, 4, 5).reshape(co * 27, -1)
            parts.append((flipped @ cols).view(ci, -1, t, h, w).transpose(0, 1))
    return torch.cat(parts).contiguous()


def conv3d_dgrad(grad_out: torch.Tensor, weight: torch.Tensor, input_shape: Sequence[int],
                 padding: Triple = 0) -> torch.Tensor:
    """The gradient of a 3×3×3 convolution with stride 1 and zero
    ``padding`` of 0 or 1 per dimension with respect to its fp32 NCDHW
    input of ``input_shape``, from the output's gradient ``grad_out`` and
    the convolution's ``weight`` (C_out, C_in, 3, 3, 3). Both must be
    contiguous; anything else raises.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    ``conv3d_dgrad_reference``.
    """
    input_shape, padding = _check(grad_out, weight, input_shape, padding)
    if grad_out.device.type == "cpu":
        return conv3d_dgrad_reference(grad_out, weight, input_shape, padding)
    if grad_out.device.type != "cuda":
        raise ValueError(f"unsupported device {grad_out.device}")

    lib = _library()
    n, ci, t, h, w = input_shape
    dims = (n, ci, grad_out.shape[1], t, h, w, *padding)
    with torch.cuda.device(grad_out.device):
        grad_input = torch.empty(input_shape, device=grad_out.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(grad_out.device).cuda_stream
        with tracing.span("conv.dgrad"):
            err = lib.conv3d_dgrad_f32(grad_out.data_ptr(), weight.data_ptr(), grad_input.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_dgrad kernel launch failed for {dims}: "
                           f"{lib.conv3d_dgrad_error_string(err).decode()}")
    _count_launch()
    return grad_input


def _count_launch() -> None:
    """Add one to ``launches``, under a lock: autograd runs backward nodes
    on its own device threads."""
    global launches
    with _launches_lock:
        launches += 1


def _library() -> ctypes.CDLL:
    lib = _build.load("conv3d_dgrad")
    if lib.conv3d_dgrad_f32.argtypes is None:
        ints = [ctypes.c_int] * 9
        lib.conv3d_dgrad_f32.argtypes = [ctypes.c_void_p] * 3 + ints + [ctypes.c_void_p]
        lib.conv3d_dgrad_f32.restype = ctypes.c_int
        lib.conv3d_dgrad_error_string.argtypes = [ctypes.c_int]
        lib.conv3d_dgrad_error_string.restype = ctypes.c_char_p
    return lib
