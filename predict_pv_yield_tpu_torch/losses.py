"""Loss functions (a port of the JAX package's ``losses.py``).

The exponentially weighted losses are *summed* over the batch, with
per-horizon weights normalised to sum to 1: the reference's published
metric values (``MAE_EXP / NMAE = 32.0`` at batch 32) pin that down. "NMAE"
is the reference's name for the plain mean absolute error of
[0, 1]-normalised yield; it is also the training loss.
"""

from __future__ import annotations

import numpy as np
import torch


class WeightedLosses:
    """Exponentially decaying per-forecast-horizon loss weights:
    ``weights[i] ∝ exp(-decay_rate * i)``, summing to 1 over the horizon."""

    def __init__(self, decay_rate: float | None = None, forecast_length: int = 6, device="cpu"):
        if decay_rate is None:
            decay_rate = 0.5
        self.decay_rate = decay_rate
        self.forecast_length = forecast_length
        weights = np.exp(-decay_rate * np.arange(forecast_length, dtype=np.float32))
        self.weights = torch.as_tensor(weights / weights.sum(), device=device)

    def get_mse_exp(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Batch-summed, horizon-weighted squared error."""
        return torch.sum(self.weights * (output - target) ** 2)

    def get_mae_exp(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Batch-summed, horizon-weighted absolute error."""
        return torch.sum(self.weights * torch.abs(output - target))


def mse_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain mean squared error."""
    return torch.mean((output - target) ** 2)


def nmae_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's "NMAE": plain mean absolute error."""
    return torch.mean(torch.abs(output - target))
