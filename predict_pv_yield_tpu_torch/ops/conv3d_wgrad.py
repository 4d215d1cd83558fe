"""Weight and bias gradients of the conv towers' 3×3×3 fp32 convolutions.

The JAX package leaves these gradients to XLA; the port's towers sent them
to cuDNN, whose fp32 3-D weight gradient ran at 9 % of the card's fp32 bound
and took 60 % of the conv3d_sat_nwp train step (PERF.md). On Hopper they
are a hand-written CUDA kernel, ``csrc/conv3d_wgrad.cu``: a split-K
reduction in which each block takes all 32 output channels of a chunk and
16 or 32 input channels × 27 taps over a run of output rows, with the input
rows staged channel-innermost in shared memory by ``cp.async``, 72
accumulators a thread, and a second kernel that sums the blocks' partials in
a fixed order (bit-identical from run to run, no atomics). The kernel's
source note gives its bound and what each part of the design does about it.

``conv3d_wgrad`` launches it for CUDA tensors and uses the plain version
``conv3d_wgrad_reference`` only for tensors on the CPU. ``launches`` counts
its calls on the card, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch import _build, tracing
from predict_pv_yield_tpu_torch.utils import full_fp32

#: kernel calls since the counter was last reset (set it to 0 to reset)
launches = 0
_launches_lock = threading.Lock()

#: elements of one im2col chunk of the plain version, at most
PLAIN_CHUNK_ELEMENTS = 1 << 27

Triple = Union[int, Sequence[int]]


def _triple(value: Triple, name: str) -> Tuple[int, int, int]:
    value = (value,) * 3 if isinstance(value, int) else tuple(int(v) for v in value)
    if len(value) != 3:
        raise ValueError(f"{name} must be an int or three ints, got {value}")
    return value


def _check(x, grad_out, kernel_size, stride, padding, dilation, groups) -> Tuple[int, int, int]:
    for name, t in (("x", x), ("grad_out", grad_out)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 5:
            raise ValueError(f"{name} must be (N, C, T, H, W), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device != grad_out.device:
        raise ValueError(f"x on {x.device}, grad_out on {grad_out.device}")
    if _triple(kernel_size, "kernel_size") != (3, 3, 3):
        raise ValueError(f"only a 3x3x3 kernel, got {kernel_size}")
    if _triple(stride, "stride") != (1, 1, 1):
        raise ValueError(f"only stride 1, got {stride}")
    if _triple(dilation, "dilation") != (1, 1, 1):
        raise ValueError(f"only dilation 1, got {dilation}")
    if groups != 1:
        raise ValueError(f"only groups 1, got {groups}")
    padding = _triple(padding, "padding")
    if any(p not in (0, 1) for p in padding):
        raise ValueError(f"padding must be 0 or 1 in each dimension, got {padding}")
    n, _, t, h, w = x.shape
    expected = (n, grad_out.shape[1], *(size + 2 * p - 2 for size, p in zip((t, h, w), padding)))
    if tuple(grad_out.shape) != expected or min(expected) <= 0:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not fit x {tuple(x.shape)} "
                         f"at padding {padding}: expected {expected}")
    return padding


def conv3d_wgrad_reference(x: torch.Tensor, grad_out: torch.Tensor, padding: Triple = 0):
    """Plain version → ``(grad_weight, grad_bias)``: im2col of the 27 shifted
    views of the padded input, a chunk of the batch at a time, each chunk one
    matrix product."""
    pt, ph, pw = _triple(padding, "padding")
    n, co, to, ho, wo = grad_out.shape
    ci = x.shape[1]
    padded = F.pad(x, (pw, pw, ph, ph, pt, pt))
    per_sample = ci * 27 * to * ho * wo
    chunk = max(1, min(n, PLAIN_CHUNK_ELEMENTS // max(per_sample, 1)))
    grad_weight = x.new_zeros(co, ci * 27)
    with full_fp32():
        for start in range(0, n, chunk):
            part = padded[start : start + chunk]
            views = [part[:, :, kt : kt + to, kh : kh + ho, kw : kw + wo]
                     for kt in range(3) for kh in range(3) for kw in range(3)]
            cols = torch.stack(views, dim=2)  # (b, ci, 27, to, ho, wo)
            cols = cols.permute(1, 2, 0, 3, 4, 5).reshape(ci * 27, -1)
            g = grad_out[start : start + chunk].transpose(0, 1).reshape(co, -1)
            grad_weight += g @ cols.T
    return grad_weight.view(co, ci, 3, 3, 3), grad_out.sum(dim=(0, 2, 3, 4))


def conv3d_wgrad(x: torch.Tensor, grad_out: torch.Tensor, kernel_size: Triple = 3, stride: Triple = 1,
                 padding: Triple = 0, dilation: Triple = 1, groups: int = 1):
    """``(grad_weight, grad_bias)`` of a 3×3×3 convolution of fp32 NCDHW ``x``
    with stride 1 and zero ``padding`` of 0 or 1 per dimension, from the
    output's gradient ``grad_out``. Both must be contiguous; anything else
    raises.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    ``conv3d_wgrad_reference``.
    """
    padding = _check(x, grad_out, kernel_size, stride, padding, dilation, groups)
    if x.device.type == "cpu":
        return conv3d_wgrad_reference(x, grad_out, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _library()
    n, ci, t, h, w = x.shape
    co = grad_out.shape[1]
    dims = (n, ci, co, t, h, w, *padding)
    with torch.cuda.device(x.device):
        floats = lib.conv3d_wgrad_workspace(*dims)
        if floats < 0:
            raise RuntimeError(f"conv3d_wgrad cannot plan {dims}: "
                               f"{lib.conv3d_wgrad_error_string(-floats).decode()}")
        workspace = torch.empty(floats, device=x.device, dtype=torch.float32)
        grad_weight = torch.empty((co, ci, 3, 3, 3), device=x.device, dtype=torch.float32)
        grad_bias = torch.empty(co, device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with tracing.span("conv.wgrad"):
            err = lib.conv3d_wgrad_f32(x.data_ptr(), grad_out.data_ptr(), grad_weight.data_ptr(),
                                       grad_bias.data_ptr(), workspace.data_ptr(), floats, *dims, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_wgrad kernel launch failed: {lib.conv3d_wgrad_error_string(err).decode()}")
    _count_launch()
    return grad_weight, grad_bias


def _count_launch() -> None:
    """Add one to ``launches``, under a lock: autograd runs backward nodes
    on its own device threads."""
    global launches
    with _launches_lock:
        launches += 1


def _library() -> ctypes.CDLL:
    lib = _build.load("conv3d_wgrad")
    if lib.conv3d_wgrad_f32.argtypes is None:
        ints = [ctypes.c_int] * 9
        lib.conv3d_wgrad_workspace.argtypes = ints
        lib.conv3d_wgrad_workspace.restype = ctypes.c_longlong
        lib.conv3d_wgrad_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + ints + [ctypes.c_void_p]
        lib.conv3d_wgrad_f32.restype = ctypes.c_int
        lib.conv3d_wgrad_error_string.argtypes = [ctypes.c_int]
        lib.conv3d_wgrad_error_string.restype = ctypes.c_char_p
    return lib
