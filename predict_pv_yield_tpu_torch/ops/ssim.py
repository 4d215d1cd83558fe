"""Structural similarity (SSIM) — the port of
``predict_pv_yield_tpu/ops/ssim.py``.

Matches scikit-image's ``structural_similarity`` defaults as the JAX module
does: 7×7 uniform window, K1=0.01, K2=0.03, sample covariance, mean over the
valid (interior) region, and ``data_range`` 2.0 when none is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch.utils import full_fp32


def _uniform_filter(images: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter of (B, H, W) with VALID padding → (B, H-size+1, W-size+1)."""
    kernel = images.new_full((1, 1, size, size), 1.0 / (size * size))
    with full_fp32():
        return F.conv2d(images[:, None], kernel)[:, 0]


def ssim(
    im1: torch.Tensor,
    im2: torch.Tensor,
    data_range: float | torch.Tensor | None = None,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM between images (..., H, W) → a tensor of the leading shape
    (a scalar for two (H, W) images). ``data_range`` is a number or a tensor
    of the leading shape (one range per image pair)."""
    leading = im1.shape[:-2]
    im1 = im1.float().reshape(-1, *im1.shape[-2:])
    im2 = im2.float().reshape(-1, *im2.shape[-2:])
    if data_range is None:
        # the reference-era skimage used the float dtype range, 2.0
        data_range = 2.0
    data_range = torch.as_tensor(data_range, dtype=torch.float32, device=im1.device)
    data_range = data_range.expand(leading).reshape(-1, 1, 1)

    n = win_size * win_size
    cov_norm = n / (n - 1)  # sample covariance, as in skimage

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    numerator = (2 * ux * uy + c1) * (2 * vxy + c2)
    denominator = (ux**2 + uy**2 + c1) * (vx + vy + c2)
    return (numerator / denominator).mean(dim=(-2, -1)).reshape(leading)
