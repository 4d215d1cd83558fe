"""Per-forecast-horizon metrics (a port of the JAX package's ``metrics.py``):
each returns one value per horizon, the mean over the batch."""

from __future__ import annotations

import torch


def mse_each_forecast_horizon(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(forecast_len,) mean squared error per horizon."""
    return torch.mean((output - target) ** 2, dim=0)


def mae_each_forecast_horizon(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(forecast_len,) mean absolute error per horizon."""
    return torch.mean(torch.abs(output - target), dim=0)
