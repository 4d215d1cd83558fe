"""Farnebäck dense optical flow in PyTorch — the port of
``predict_pv_yield_tpu/ops/optical_flow.py``.

Same algorithm and the same OpenCV ``calcOpticalFlowFarneback`` semantics as
the JAX module (see its docstring for the derivation): polynomial expansion
as two convolutions and a constant 6×6 solve, the displacement update with
cv2's out-of-bounds branch and 5-px border ramp, and the levels+1 pyramid of
smoothed INTER_LINEAR resizes of the original frame. Layouts match the JAX
functions at every public boundary: images (N, H, W), packed expansions
(N, H, W, 5) as ``[a11, a12, a22, bx, by]``, flows (N, H, W, 2) as (x, y).

The five-field window average of each update goes through ``sep_blur``,
which launches the hand-written CUDA kernel on a card
(``ops/sep_blur.py``). The other device work (the expansion and pyramid
convolutions, the gathers, the resize) is plain PyTorch; its convolutions
and the 6×6 solve run inside ``full_fp32()`` so that cuDNN cannot drop to
TF32 on the card.

Flow convention matches OpenCV: ``flow[..., 0]`` is the x (column)
displacement, ``flow[..., 1]`` the y (row) displacement, such that
``im1(y, x) ≈ im2(y + flow_y, x + flow_x)``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from predict_pv_yield_tpu_torch.ops.sep_blur import sep_blur
from predict_pv_yield_tpu_torch.utils import full_fp32

# ---------------------------------------------------------------------------
# kernels / constants (host numpy, as in the JAX module)
# ---------------------------------------------------------------------------


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _poly_exp_solver(poly_n: int, poly_sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    """(kernels, Ginv) for the quadratic fit.

    kernels: (3, 2n+1) array [g, x·g, x²·g].
    Ginv: (6, 6) inverse normal-equation matrix for basis
    [1, x, y, x², y², xy] with the separable applicability g(x)g(y).
    """
    n = poly_n
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * poly_sigma**2))
    g /= g.sum()
    kernels = np.stack([g, x * g, (x**2) * g]).astype(np.float32)

    # 1-D moments of the applicability: s[k] = Σ g(x) x^k
    s = np.array([np.sum(g * x**k) for k in range(5)])
    exps = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1)]  # (p, q) per basis fn
    G = np.zeros((6, 6))
    for i, (pi, qi) in enumerate(exps):
        for j, (pj, qj) in enumerate(exps):
            G[i, j] = s[pi + pj] * s[qi + qj]
    Ginv = np.linalg.inv(G).astype(np.float32)
    return kernels, Ginv


@functools.lru_cache(maxsize=None)
def _poly_exp_conv_kernels(poly_n: int, poly_sigma: float):
    """Conv weights for the six moments: one 3-channel x-pass (3, 1, 1, K)
    and one dense (6-out, 3-in) y-pass (6, 3, K, 1)."""
    kernels, _ = _poly_exp_solver(poly_n, float(poly_sigma))
    g, xg, xxg = kernels
    size = 2 * poly_n + 1
    kx = np.stack([g, xg, xxg])[:, None, None, :].astype(np.float32)
    # y-pass moment order [m00, m10, m01, m20, m02, m11]
    ky = np.zeros((6, 3, size, 1), np.float32)
    ky[0, 0, :, 0] = g     # m00 = c0 ∘y g
    ky[1, 1, :, 0] = g     # m10 = c1 ∘y g
    ky[2, 0, :, 0] = xg    # m01 = c0 ∘y xg
    ky[3, 2, :, 0] = g     # m20 = c2 ∘y g
    ky[4, 0, :, 0] = xxg   # m02 = c0 ∘y xxg
    ky[5, 1, :, 0] = xg    # m11 = c1 ∘y xg
    return kx, ky


# ---------------------------------------------------------------------------
# polynomial expansion (batched)
# ---------------------------------------------------------------------------


def polynomial_expansion_packed(
    images: torch.Tensor, poly_n: int = 5, poly_sigma: float = 0.7
) -> torch.Tensor:
    """Per-pixel quadratic-fit coefficients for (N, H, W) images, packed as
    (N, H, W, 5) channels ``[a11, a12, a22, bx, by]``."""
    _, Ginv = _poly_exp_solver(poly_n, float(poly_sigma))
    kx_np, ky_np = _poly_exp_conv_kernels(poly_n, float(poly_sigma))
    device = images.device
    kx, ky = torch.as_tensor(kx_np, device=device), torch.as_tensor(ky_np, device=device)

    padded = F.pad(images[:, None], (poly_n,) * 4, mode="replicate")  # (N, 1, H+2n, W+2n)
    with full_fp32():
        rows = F.conv2d(padded, kx)  # (N, 3, H+2n, W)
        moments = F.conv2d(rows, ky)  # (N, 6, H, W)
        r = torch.einsum("ij,njhw->nihw", torch.as_tensor(Ginv, device=device), moments)
    # moment order of r is [m00, m10, m01, m20, m02, m11]
    # → a11=r3, a22=r4, a12=r5/2, b=(r1, r2)
    return torch.stack([r[:, 3], r[:, 5] / 2, r[:, 4], r[:, 1], r[:, 2]], dim=-1)


def polynomial_expansion_batched(
    images: torch.Tensor, poly_n: int = 5, poly_sigma: float = 0.7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, H, W, 2, 2) symmetric quadratic term and b (N, H, W, 2) linear
    term, in (x, y) order — an inspection form of the packed expansion."""
    p = polynomial_expansion_packed(images, poly_n, poly_sigma)
    A = torch.stack(
        [torch.stack([p[..., 0], p[..., 1]], dim=-1), torch.stack([p[..., 1], p[..., 2]], dim=-1)],
        dim=-2,
    )
    return A, p[..., 3:5]


def polynomial_expansion(
    image: torch.Tensor, poly_n: int = 5, poly_sigma: float = 0.7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image convenience wrapper → A (H, W, 2, 2), b (H, W, 2)."""
    A, b = polynomial_expansion_batched(image[None], poly_n, poly_sigma)
    return A[0], b[0]


# ---------------------------------------------------------------------------
# sampling / resize
# ---------------------------------------------------------------------------


def bilinear_gather_batched(
    field: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
) -> torch.Tensor:
    """Bilinear sampling of ``field`` (N, H, W, C) at fractional (ys, xs) of
    shape (N, H', W') → (N, H', W', C); borders clamped (clamp first, then
    ``floor``). The flow solver samples at the field's own grid (H' = H)."""
    n, height, width, channels = field.shape
    ys = ys.clamp(0.0, height - 1.0)
    xs = xs.clamp(0.0, width - 1.0)
    y0 = ys.floor().long()
    x0 = xs.floor().long()
    y1 = (y0 + 1).clamp(max=height - 1)
    x1 = (x0 + 1).clamp(max=width - 1)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]

    flat = field.reshape(n * height * width, channels)
    base = (torch.arange(n, device=field.device) * (height * width))[:, None, None]

    def gather(yi, xi):
        return flat[(base + yi * width + xi).reshape(-1)].reshape(*ys.shape, channels)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bottom = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bottom * wy


def bilinear_sample(field: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``field`` (H, W) or (H, W, C) at fractional (ys, xs), clamped
    borders."""
    planar = field.ndim == 2
    field = field[None, ..., None] if planar else field[None]
    out = bilinear_gather_batched(field, ys[None], xs[None])[0]
    return out[..., 0] if planar else out


def _resize_linear(field: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Resize the two spatial dims of (N, H, W) or (N, H, W, C) with plain
    (non-antialiased) bilinear point sampling at half-pixel-centre
    coordinates — OpenCV ``INTER_LINEAR`` semantics, written out as the JAX
    module does (``F.interpolate`` is not assumed to match)."""
    in_h, in_w = field.shape[1:3]
    out_h, out_w = shape
    arange = functools.partial(torch.arange, dtype=torch.float32, device=field.device)
    ys = (arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    xs = (arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    n = field.shape[0]
    planar = field.ndim == 3
    out = bilinear_gather_batched(
        field[..., None] if planar else field,
        grid_y.expand(n, out_h, out_w),
        grid_x.expand(n, out_h, out_w),
    )
    return out[..., 0] if planar else out


def _cv_round(value: float) -> int:
    """OpenCV cvRound: round half to even (C rint semantics)."""
    return int(np.rint(value))


@functools.lru_cache(maxsize=None)
def _pyramid_smooth_kernel(sigma: float, size: int) -> np.ndarray:
    """OpenCV ``getGaussianKernel`` semantics: fixed binomial coefficients for
    sigma<=0 at small sizes, a sampled normalised Gaussian otherwise."""
    if sigma <= 0 and size <= 7:
        fixed = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        }
        return np.asarray(fixed[size], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _smooth_reflect101(images: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of (N, H, W), H pass then W pass, with
    BORDER_REFLECT_101 (``F.pad(mode="reflect")``; OpenCV ``GaussianBlur``
    default)."""
    radius = len(kernel) // 2
    k = torch.as_tensor(kernel, device=images.device)
    padded = F.pad(images[:, None], (radius,) * 4, mode="reflect")
    with full_fp32():
        out = F.conv2d(padded, k.view(1, 1, -1, 1))
        out = F.conv2d(out, k.view(1, 1, 1, -1))
    return out[:, 0]


def _pyramid_level(images: torch.Tensor, level: int, pyr_scale: float) -> torch.Tensor:
    """Level ``k`` input image, OpenCV ``calcOpticalFlowFarneback`` semantics:
    Gaussian-smooth the ORIGINAL full-resolution image with
    ``sigma = (1/scale − 1)/2`` (ksize = round(5σ)|1, min 3), then one
    INTER_LINEAR resize straight to the level's size."""
    scale = pyr_scale**level
    sigma = (1.0 / scale - 1.0) * 0.5
    size = max(_cv_round(sigma * 5) | 1, 3)
    smoothed = _smooth_reflect101(images, _pyramid_smooth_kernel(sigma, size))
    if level == 0:
        return smoothed
    out_h = _cv_round(images.shape[1] * scale)
    out_w = _cv_round(images.shape[2] * scale)
    return _resize_linear(smoothed, (out_h, out_w))


# ---------------------------------------------------------------------------
# flow estimation (batched)
# ---------------------------------------------------------------------------


# OpenCV's FarnebackUpdateMatrices damps the normal-equation fields in a
# 5-pixel border ramp (constants from cv2's optflowgf, as in the JAX module).
_BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


@functools.lru_cache(maxsize=None)
def _border_scale(height: int, width: int) -> np.ndarray:
    """(H, W) damping factors: ramp within 5 px of any edge, 1 elsewhere."""
    ramp = _BORDER_RAMP

    def axis_weights(size: int) -> np.ndarray:
        w = np.ones(size, np.float32)
        m = min(len(ramp), size)
        w[:m] *= ramp[:m]
        w[size - m:] *= ramp[:m][::-1]
        return w

    return axis_weights(height)[:, None] * axis_weights(width)[None, :]


def _window_taps(winsize: int, gaussian: bool) -> np.ndarray:
    """The update's window average: 2·(winsize//2)+1 Gaussian or box taps."""
    radius = winsize // 2
    if gaussian:
        return _gaussian_kernel(radius, radius * 0.3)  # cv2: sigma = (block/2)*0.3
    return np.full(2 * radius + 1, 1.0 / (2 * radius + 1), dtype=np.float32)


def _update_flow(
    p1: torch.Tensor, p2: torch.Tensor, flow: torch.Tensor, winsize: int, gaussian: bool
) -> torch.Tensor:
    """One Farnebäck iteration on packed expansions ``p1``/``p2`` (N, H, W, 5)
    and flow (N, H, W, 2) in (x, y). When the warped sample's floor cell
    leaves [0, W-2]×[0, H-2] the pixel uses Ā = A1 and keeps 0.5·b1 (cv2's
    FarnebackUpdateMatrices); all fields are damped by the border ramp before
    the window average; the 2×2 solve adds cv2's 1e-3 to the determinant."""
    height, width = flow.shape[1:3]
    arange = functools.partial(torch.arange, dtype=flow.dtype, device=flow.device)
    fx, fy = flow[..., 0], flow[..., 1]
    sample_y = arange(height)[None, :, None] + fy
    sample_x = arange(width)[None, None, :] + fx

    warped = bilinear_gather_batched(p2, sample_y, sample_x)

    # cv2 takes the no-warp branch unless floor(sample) is strictly interior
    x_floor = sample_x.floor()
    y_floor = sample_y.floor()
    oob = ~(
        (x_floor >= 0) & (x_floor <= width - 2) & (y_floor >= 0) & (y_floor <= height - 2)
    )
    a11 = torch.where(oob, p1[..., 0], 0.5 * (p1[..., 0] + warped[..., 0]))
    a12 = torch.where(oob, p1[..., 1], 0.5 * (p1[..., 1] + warped[..., 1]))
    a22 = torch.where(oob, p1[..., 2], 0.5 * (p1[..., 2] + warped[..., 2]))
    # the OOB branch zeroes only the WARPED b2 taps: the pixel keeps 0.5*b1
    bdx = -0.5 * (torch.where(oob, 0.0, warped[..., 3]) - p1[..., 3])
    bdy = -0.5 * (torch.where(oob, 0.0, warped[..., 4]) - p1[..., 4])
    dx = bdx + a11 * fx + a12 * fy
    dy = bdy + a12 * fx + a22 * fy

    scale = torch.as_tensor(_border_scale(height, width), device=flow.device)[None]
    a11, a12, a22 = a11 * scale, a12 * scale, a22 * scale
    dx, dy = dx * scale, dy * scale

    # ĀᵀĀ and Āᵀδb with Ā symmetric, per channel
    g11 = a11 * a11 + a12 * a12
    g12 = a12 * (a11 + a22)
    g22 = a12 * a12 + a22 * a22
    h1 = a11 * dx + a12 * dy
    h2 = a12 * dx + a22 * dy

    fields = torch.stack([g11, g12, g22, h1, h2], dim=1)  # (N, 5, H, W)
    g11, g12, g22, h1, h2 = sep_blur(fields, _window_taps(winsize, gaussian)).unbind(1)

    det = g11 * g22 - g12 * g12 + 1e-3
    new_x = (g22 * h1 - g12 * h2) / det
    new_y = (g11 * h2 - g12 * h1) / det
    return torch.stack([new_x, new_y], dim=-1)


def farneback_flow_batched(
    im1: torch.Tensor,
    im2: torch.Tensor,
    pyr_scale: float = 0.5,
    levels: int = 2,
    winsize: int = 40,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 0.7,
    gaussian: bool = True,
) -> torch.Tensor:
    """Dense flow for (N, H, W) image pairs → (N, H, W, 2), (dx, dy).

    ``levels`` counts DOWNSCALE steps (levels+1 pyramid images), capped so
    no level's short side drops below 32 px; the flow moves to a finer level
    by an INTER_LINEAR resize, then a division by ``pyr_scale``.
    """
    im1 = im1.float()
    im2 = im2.float()

    min_side = min(im1.shape[1], im1.shape[2])
    levels_used = 0
    for k in range(levels):
        if min_side * pyr_scale ** (k + 1) < 32.0:
            break
        levels_used = k + 1

    flow = None
    for level in reversed(range(levels_used + 1)):
        level_im1 = _pyramid_level(im1, level, pyr_scale)
        level_im2 = _pyramid_level(im2, level, pyr_scale)
        if flow is None:
            flow = level_im1.new_zeros((*level_im1.shape, 2))
        elif flow.shape[1:3] != level_im1.shape[1:3]:
            flow = _resize_linear(flow, tuple(level_im1.shape[1:3])) / pyr_scale
        p1 = polynomial_expansion_packed(level_im1, poly_n, poly_sigma)
        p2 = polynomial_expansion_packed(level_im2, poly_n, poly_sigma)
        for _ in range(iterations):
            flow = _update_flow(p1, p2, flow, winsize, gaussian)
    return flow


def farneback_flow(im1: torch.Tensor, im2: torch.Tensor, **kwargs) -> torch.Tensor:
    """Single-pair convenience wrapper → (H, W, 2)."""
    return farneback_flow_batched(im1[None], im2[None], **kwargs)[0]


def flow_sequence(
    frames: torch.Tensor,
    winsize: int = 40,
    levels: int = 2,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 0.7,
    gaussian: bool = True,
) -> torch.Tensor:
    """Flow for every consecutive frame pair of a (T, H, W) sequence →
    (T-1, H, W, 2), all pairs in one batch on the frames' device."""
    return farneback_flow_batched(
        frames[:-1],
        frames[1:],
        levels=levels,
        winsize=winsize,
        iterations=iterations,
        poly_n=poly_n,
        poly_sigma=poly_sigma,
        gaussian=gaussian,
    )
