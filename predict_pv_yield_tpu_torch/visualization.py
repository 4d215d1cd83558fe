"""Validation-plot utilities (a port of the JAX package's
``visualization.py``; numpy in, self-contained HTML out).

Native equivalents of ``nowcasting_utils.visualization``:

* :func:`plot_batch_results` — grid of truth-vs-forecast time series for a
  whole validation batch; the returned figure exposes ``write_html`` so the
  engine's upload path matches the reference's plotly usage
  (reference ``base_model.py:215-220`` writes ``temp_{i}.html`` and uploads
  for batch_idx 0–4).
* :func:`plot_example` — satellite frame at its OSGB National Grid extent
  with a coastline basemap (``geo.py``), a GB context panel locating the
  crop, and the yield time series (the reference's path is dead code behind
  ``if 0:``, ``base_model.py:174-192``, and used tilemapbase OSM tiles;
  the geo layer here is first-party and offline).

Implemented with matplotlib, imported inside the functions (the trainer
writes no plot where it is missing), rendered into a self-contained HTML
document, logger-agnostic. Batches are the port's ``Batch`` of CPU tensors
or numpy arrays.
"""

from __future__ import annotations

import base64
import io
from typing import Optional, Sequence

import numpy as np


class HTMLFigure:
    """A rendered figure with plotly-compatible ``write_html``."""

    def __init__(self, html: str):
        self.html = html

    def write_html(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.html)

    def _repr_html_(self) -> str:  # notebook display
        return self.html


def _fig_to_html(fig, title: str) -> HTMLFigure:
    import html as html_module

    buffer = io.BytesIO()
    fig.savefig(buffer, format="png", dpi=110, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    encoded = base64.b64encode(buffer.getvalue()).decode()
    safe_title = html_module.escape(title)
    html = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{safe_title}</title></head><body>"
        f"<h3>{safe_title}</h3><img src='data:image/png;base64,{encoded}'/>"
        "</body></html>"
    )
    return HTMLFigure(html)


def plot_batch_results(
    model_name: str,
    y: np.ndarray,
    y_hat: np.ndarray,
    x: Optional[Sequence] = None,
    x_hat: Optional[Sequence] = None,
    max_examples: int = 16,
) -> HTMLFigure:
    """Truth vs forecast for each example in a batch.

    Args:
        y: (batch, T) truth series (full window).
        y_hat: (batch, forecast_len) forecasts.
        x: per-example time axes for y (optional).
        x_hat: per-example time axes for y_hat (optional).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y = np.asarray(y)
    y_hat = np.asarray(y_hat)
    n = min(len(y), max_examples)
    if n == 0:
        # an empty host-local shard of a partial batch has nothing to plot
        return None
    cols = 4
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.2 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i >= n:
            ax.axis("off")
            continue
        xs = np.asarray(x[i]) if x is not None else np.arange(y.shape[1])
        xs_hat = (
            np.asarray(x_hat[i])
            if x_hat is not None
            else np.arange(y.shape[1] - y_hat.shape[1], y.shape[1])
        )
        ax.plot(xs, y[i], label="truth", color="#1f77b4")
        ax.plot(xs_hat, y_hat[i], label="forecast", color="#d62728")
        ax.set_title(f"example {i}", fontsize=8)
        ax.tick_params(labelsize=6)
        if i == 0:
            ax.legend(fontsize=6)
    fig.suptitle(f"{model_name}: truth vs forecast")
    fig.tight_layout()
    return _fig_to_html(fig, f"{model_name} batch results")


def plot_example(
    batch,
    model_output,
    history_minutes: int,
    forecast_minutes: int,
    nwp_channels: Sequence[str] = (),
    example_i: int = 0,
    epoch: int = 0,
    output_variable: str = "gsp_yield",
) -> HTMLFigure:
    """Satellite frame + yield series for one example."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from predict_pv_yield_tpu_torch.geo import gb_coastline_osgb

    fig, (ax_img, ax_map, ax_ts) = plt.subplots(1, 3, figsize=(12.5, 3.5))

    sat = batch.satellite.data
    sat_x = batch.satellite.x
    sat_y = batch.satellite.y
    extent = None
    if sat is not None:
        if getattr(batch.satellite, "channel_last", False):
            # host batch still in the (B, T, H, W, C) wire layout
            frame = np.asarray(sat[example_i, -1, :, :, 0], np.float32)
        else:
            frame = np.asarray(sat[example_i, 0, -1], np.float32)
        if sat_x is not None and sat_y is not None:
            xs = np.asarray(sat_x[example_i], np.float64)
            ys = np.asarray(sat_y[example_i], np.float64)
            # Respect the stored orientation: column 0 sits at xs[0] and row 0
            # at ys[0] whatever their sort order (imshow flips the raster when
            # an extent edge pair is reversed). The axes limits are then set
            # min→max so the display is always north-up/east-right.
            extent = (xs[0], xs[-1], ys[-1], ys[0])
            ax_img.imshow(frame, cmap="viridis", extent=extent, origin="upper")
            coast_x, coast_y = gb_coastline_osgb()
            ax_img.plot(coast_x, coast_y, color="white", linewidth=0.8, alpha=0.9)
            ax_img.set_xlim(xs.min(), xs.max())
            ax_img.set_ylim(ys.min(), ys.max())
            ax_img.set_xlabel("OSGB easting (m)", fontsize=7)
            ax_img.set_ylabel("OSGB northing (m)", fontsize=7)
            ax_img.tick_params(labelsize=6)
            ax_img.set_title("satellite (last frame, ch 0)", fontsize=8)
        else:
            ax_img.imshow(frame, cmap="viridis")
            ax_img.set_title("satellite (last frame, ch 0)", fontsize=8)
            ax_img.axis("off")
    else:
        ax_img.axis("off")

    # context panel: where in Great Britain the crop sits (the reference
    # draws this on a tilemapbase OSM basemap; offline coastline here)
    coast_x, coast_y = gb_coastline_osgb()
    ax_map.plot(coast_x, coast_y, color="#444444", linewidth=0.9)
    ax_map.set_aspect("equal")
    if extent is not None:
        from matplotlib.patches import Rectangle

        x_lo, x_hi = min(extent[0], extent[1]), max(extent[0], extent[1])
        y_lo, y_hi = min(extent[2], extent[3]), max(extent[2], extent[3])
        ax_map.add_patch(
            Rectangle(
                (x_lo, y_lo), x_hi - x_lo, y_hi - y_lo,
                edgecolor="#d62728", facecolor="none", linewidth=1.2,
            )
        )
        ax_map.plot(
            [(x_lo + x_hi) / 2], [(y_lo + y_hi) / 2],
            marker="x", color="#d62728", markersize=4,
        )
    ax_map.set_title("crop location", fontsize=8)
    ax_map.tick_params(labelsize=6)

    if output_variable == "gsp_yield":
        series = np.asarray(batch.gsp.gsp_yield[example_i, :, 0])
    else:
        series = np.asarray(batch.pv.pv_yield[example_i, :, 0])
    prediction = np.asarray(model_output[example_i])
    ax_ts.plot(np.arange(len(series)), series, label="truth")
    ax_ts.plot(
        np.arange(len(series) - len(prediction), len(series)),
        prediction,
        label="forecast",
    )
    ax_ts.set_title(f"{output_variable} (epoch {epoch})", fontsize=8)
    ax_ts.legend(fontsize=7)
    fig.tight_layout()
    return _fig_to_html(fig, f"example {example_i}")
