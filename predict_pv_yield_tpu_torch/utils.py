"""Device selection and numeric-precision helpers shared by the port."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is no card.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU (the tests) says ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matrix products in full fp32 (no TF32) inside the
    block.

    PyTorch lets cuDNN run fp32 convolutions in TF32 by default (about three
    decimal digits), and a caller may have allowed TF32 matmuls too; either
    would break the flow solver's sub-pixel parity. The flags are scoped to
    the calls that need them rather than set for the whole process, and
    restored on exit. The flags themselves are process-wide, so a thread
    that runs such calls concurrently sees them too. On the CPU they change
    nothing.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    previous = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = previous
