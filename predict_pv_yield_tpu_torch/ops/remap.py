"""Flow-based image warping and the triangular prediction matrix — the port
of ``predict_pv_yield_tpu/ops/remap.py``.

``remap_image`` matches the reference notebook's cv2.remap (INTER_LINEAR,
constant-NaN border): ``dst(y, x) = src(y − flow_y(y, x), x − flow_x(y, x))``
with bilinear interpolation and NaN wherever a sample's support leaves the
image. ``flow_predictions`` computes the dense (T0, step) grid of warped
frames; consumers index its triangle.
"""

from __future__ import annotations

import functools

import torch

from predict_pv_yield_tpu_torch.ops.optical_flow import bilinear_gather_batched


def remap_batched(images: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Warp ``images`` (N, H, W) forward by ``flows`` (N, H, W, 2), (dx, dy).
    Out-of-bounds samples become NaN."""
    n, height, width = images.shape
    arange = functools.partial(torch.arange, dtype=torch.float32, device=images.device)
    sample_y = arange(height)[None, :, None] - flows[..., 1]
    sample_x = arange(width)[None, None, :] - flows[..., 0]

    # cv2.remap NaNs a sample whenever its bilinear support crosses the edge
    # — including exactly the last row/column — so the far bound is exclusive
    in_bounds = (
        (sample_y >= 0.0)
        & (sample_y < height - 1.0)
        & (sample_x >= 0.0)
        & (sample_x < width - 1.0)
    )
    warped = bilinear_gather_batched(images[..., None], sample_y, sample_x)[..., 0]
    return torch.where(in_bounds, warped, torch.nan)


def remap_image(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Single-image convenience wrapper over :func:`remap_batched`."""
    return remap_batched(image[None], flow[None])[0]


def flow_predictions(sat_data: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """The prediction matrix.

    Args:
        sat_data: (T, H, W) normalised satellite frames.
        flows: (T-1, H, W, 2) flow between consecutive frames.

    Returns:
        (T-1, T-1, H, W): ``out[i, s]`` is frame i warped forward by
        ``flows[i] * (s+1)`` — the prediction for timestep ``i + s + 1``.
        Entries with ``i + s + 1 >= T`` have no ground truth; consumers
        index the triangle ``s < T - 1 - i``.
    """
    num_flows = flows.shape[0]
    height, width = sat_data.shape[1:]
    steps = torch.arange(1, num_flows + 1, dtype=torch.float32, device=flows.device)
    sources = (
        sat_data[:-1, None]
        .expand(num_flows, num_flows, height, width)
        .reshape(num_flows * num_flows, height, width)
    )
    scaled_flows = (flows[:, None] * steps[None, :, None, None, None]).reshape(
        num_flows * num_flows, height, width, 2
    )
    return remap_batched(sources, scaled_flows).reshape(num_flows, num_flows, height, width)


def weighted_average_flow(flows: torch.Tensor) -> torch.Tensor:
    """Recency-weighted average of (N, H, W, 2) flows with weights 1..N (the
    most recent pair counts most) → (H, W, 2)."""
    n = flows.shape[0]
    weights = torch.arange(1, n + 1, dtype=torch.float32, device=flows.device)
    return (flows * weights[:, None, None, None]).sum(dim=0) / weights.sum()


def prediction_valid_mask(num_source_timesteps: int) -> torch.Tensor:
    """(T-1, T-1) bool: which (source i, step s) pairs have ground truth."""
    num_flows = num_source_timesteps - 1
    i = torch.arange(num_flows)[:, None]
    s = torch.arange(num_flows)[None, :]
    return i + s + 1 < num_source_timesteps
