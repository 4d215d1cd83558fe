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


#: pixels warped per ``remap_batched`` call of ``flow_predictions``: its
#: eager temporaries (coordinates, int64 gather indices, gathered corners)
#: take ~60 bytes a pixel, so one call over a 704×548 super batch's
#: 48 × 48 warps would want ~53 GB beside the 3.6 GB result
PREDICTION_CHUNK_PIXELS = 1 << 25


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

    The warps are computed a few source frames at a time (at most
    ``PREDICTION_CHUNK_PIXELS`` pixels a call, at least one source frame);
    each pixel's arithmetic is the same whatever the chunk.
    """
    num_flows = flows.shape[0]
    height, width = sat_data.shape[1:]
    steps = torch.arange(1, num_flows + 1, dtype=torch.float32, device=flows.device)
    out = torch.empty((num_flows, num_flows, height, width), dtype=sat_data.dtype, device=sat_data.device)
    per_call = max(1, PREDICTION_CHUNK_PIXELS // (num_flows * height * width))
    for first in range(0, num_flows, per_call):
        chunk = slice(first, min(first + per_call, num_flows))
        n = chunk.stop - chunk.start
        sources = sat_data[chunk, None].expand(n, num_flows, height, width).reshape(n * num_flows, height, width)
        scaled_flows = (flows[chunk, None] * steps[None, :, None, None, None]).reshape(
            n * num_flows, height, width, 2
        )
        out[chunk] = remap_batched(sources, scaled_flows).reshape(n, num_flows, height, width)
    return out


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
