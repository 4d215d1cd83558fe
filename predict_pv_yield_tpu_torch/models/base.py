"""Model base class (a port of the JAX package's ``models/base.py``).

``BaseModel`` supplies what the forecast models share: the sequence-length
arithmetic (incl. the 60-minute ceil quirk, via :class:`SeqLens`), the
target variable (``pv_yield`` → 5-minute cadence, 128 samples per batch;
``gsp_yield`` → 30-minute cadence, 32) and the target slice
``y[0:batch_size, -forecast_len:, 0]``. Hyperparameters are constructor
arguments with the JAX package's names and defaults, so
``Model(**model_yaml)`` works.

The precision policy (the JAX package's module ``dtype``): a model's
``compute_dtype`` is None (fp32) unless the trainer runs at ``precision``
16/bf16 (:func:`is_bf16`), which sets it to ``torch.bfloat16``. The forward
then runs under ``torch.autocast`` (:meth:`BaseModel.compute_precision`):
convolutions, matrix products and attention in bf16, while parameters,
gradients and the optimiser's state stay fp32 and no loss is scaled.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Optional

import torch
from torch import nn

from predict_pv_yield_tpu_torch.consts import SAT_VARIABLE_NAMES
from predict_pv_yield_tpu_torch.seqlen import SeqLens

#: the ``precision`` values that select bf16 compute, as the JAX engine's
#: ``_bf16`` reads them; any other value runs fp32
BF16_PRECISIONS = ("16", "bf16", "16-mixed", "bf16-mixed")

#: the default dataset geometry: 11 satellite channels (all but HRV) and
#: images of 64 px; the widths that follow the data start from it
DEFAULT_SAT_CHANNELS = len(SAT_VARIABLE_NAMES) - 1
DEFAULT_IMAGE_SIZE_PIXELS = 64


def is_bf16(precision) -> bool:
    """Whether a trainer ``precision`` selects bf16 compute."""
    return str(precision) in BF16_PRECISIONS


class BaseModel(nn.Module):
    """Shared hyperparameters and derived quantities of the forecast models."""

    #: model-zoo name
    model_name = "base"
    #: the forward's compute dtype: None runs fp32, ``torch.bfloat16`` runs
    #: it under autocast (set by the trainer from its ``precision``)
    compute_dtype: Optional[torch.dtype] = None

    def __init__(
        self,
        history_minutes: int = 60,
        forecast_minutes: int = 30,
        output_variable: str = "pv_yield",
        batch_size: int = 32,
        results_file_name: str = "results_epoch",
    ):
        super().__init__()
        self.history_minutes = history_minutes
        self.forecast_minutes = forecast_minutes
        self.output_variable = output_variable
        #: examples per batch: targets and embedding ids are sliced to
        #: ``[0:batch_size]``, while the conv3d family consumes the whole file
        #: batch, so a file batch of another size fails in the forward
        self.batch_size = batch_size
        #: stem of the per-epoch validation-results CSV
        self.results_file_name = results_file_name

    def compute_precision(self, device: torch.device) -> ContextManager:
        """The context the forward runs in on ``device``: autocast to
        ``compute_dtype``, or nothing for fp32. Autocast keeps no cache of
        cast weights: a weight is cast at each use and the gradients of its
        uses are summed in fp32, as the JAX package's per-use cast does. A
        cache would sum a weight used more than once (the Perceiver's) in
        bf16 first, and cannot be kept inside a CUDA graph of train steps,
        so eager steps would not equal graphed ones."""
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(torch.device(device).type, dtype=self.compute_dtype, cache_enabled=False)

    @property
    def seq_lens(self) -> SeqLens:
        return SeqLens(self.history_minutes, self.forecast_minutes)

    @property
    def history_len_5(self) -> int:
        return self.seq_lens.history_len_5

    @property
    def forecast_len_5(self) -> int:
        return self.seq_lens.forecast_len_5

    @property
    def history_len_30(self) -> int:
        return self.seq_lens.history_len_30

    @property
    def forecast_len_30(self) -> int:
        return self.seq_lens.forecast_len_30

    @property
    def history_len_60(self) -> int:
        return self.seq_lens.history_len_60

    @property
    def forecast_len_60(self) -> int:
        return self.seq_lens.forecast_len_60

    @property
    def total_seq_length(self) -> int:
        """5-minute steps incl. t0 (== seq_len_5)."""
        return self.seq_lens.seq_len_5

    @property
    def forecast_len(self) -> int:
        return self.seq_lens.target_lens(self.output_variable)[1]

    @property
    def history_len(self) -> int:
        return self.seq_lens.target_lens(self.output_variable)[0]

    @property
    def number_of_samples_per_batch(self) -> int:
        return self.seq_lens.target_lens(self.output_variable)[2]

    @property
    def number_of_pv_samples_per_batch(self) -> int:
        return 128

    def target(self, batch) -> torch.Tensor:
        """Ground truth: centre system/GSP, last ``forecast_len`` steps."""
        y = batch.gsp.gsp_yield if self.output_variable == "gsp_yield" else batch.pv.pv_yield
        return y[0 : self.batch_size, -self.forecast_len :, 0]
