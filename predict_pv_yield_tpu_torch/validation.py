"""Validation-results tables (a port of the JAX package's ``validation.py``,
written with numpy and the ``csv`` module).

One row per (example, forecast horizon), ``n_batches * batch_size *
forecast_len_30`` rows, with the columns ``t0_datetime_utc,
target_datetime_utc, gsp_id, actual_gsp_pv_outturn_mw,
forecast_gsp_pv_outturn_mw, capacity_mwp, batch_index`` in that order.
Values arrive de-normalised to MW; GSP targets are at 30-minute cadence,
so ``target_datetime_utc = t0 + 30 min * (horizon_index + 1)``. Cells are
formatted as ``pandas.DataFrame.to_csv`` formats them, so the file equals
the JAX package's byte for byte on equal values.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger(__name__)

COLUMNS = (
    "t0_datetime_utc",
    "target_datetime_utc",
    "gsp_id",
    "actual_gsp_pv_outturn_mw",
    "forecast_gsp_pv_outturn_mw",
    "capacity_mwp",
    "batch_index",
)

_THIRTY_MINUTES = np.timedelta64(30, "m")


def make_validation_results(
    truths_mw: np.ndarray,
    predictions_mw: np.ndarray,
    capacity_mwp: np.ndarray,
    gsp_ids: Sequence[int],
    batch_idx: int,
    t0_datetimes_utc,
) -> Dict[str, np.ndarray]:
    """The per-batch validation results table as ``{column: array}``.

    Args:
        truths_mw: (batch_size, forecast_len) actual GSP outturn in MW.
        predictions_mw: (batch_size, forecast_len) forecast outturn in MW.
        capacity_mwp: (batch_size, forecast_len) GSP capacity in MWp.
        gsp_ids: (batch_size,) GSP identifiers.
        batch_idx: index of this validation batch.
        t0_datetimes_utc: (batch_size,) forecast origins, int64 ns or
            datetime64.
    """
    truths_mw = np.asarray(truths_mw)
    batch_size, forecast_len = truths_mw.shape
    t0 = np.asarray(t0_datetimes_utc)
    t0 = t0.astype("datetime64[ns]") if t0.dtype.kind == "M" else t0.astype(np.int64).view("datetime64[ns]")
    t0 = np.repeat(t0, forecast_len)
    horizons = np.tile(np.arange(1, forecast_len + 1), batch_size)
    return {
        "t0_datetime_utc": t0,
        "target_datetime_utc": t0 + horizons * _THIRTY_MINUTES,
        "gsp_id": np.repeat(np.asarray(gsp_ids), forecast_len),
        "actual_gsp_pv_outturn_mw": truths_mw.reshape(-1),
        "forecast_gsp_pv_outturn_mw": np.asarray(predictions_mw).reshape(-1),
        "capacity_mwp": np.asarray(capacity_mwp).reshape(-1),
        "batch_index": np.full(batch_size * forecast_len, batch_idx, dtype=np.int64),
    }


def _format_datetimes(values: np.ndarray) -> List[str]:
    """pandas' CSV format of a datetime64[ns] column: dates alone when every
    value is a midnight, else the coarsest of s / ms / us / ns that holds
    every value exactly."""
    ns = values.astype("datetime64[ns]").astype(np.int64)
    unit = "D"
    for candidate, per in (("D", 86_400 * 10**9), ("s", 10**9), ("ms", 10**6), ("us", 10**3), ("ns", 1)):
        unit = candidate
        if not np.any(ns % per):
            break
    return [text.replace("T", " ") for text in np.datetime_as_string(values, unit=unit)]


def _column_cells(values: np.ndarray) -> List[str]:
    if values.dtype.kind == "M":
        return _format_datetimes(values)
    return [str(value) for value in values]


def save_validation_results_to_logger(
    results_dfs: List[Dict[str, np.ndarray]],
    results_file_name: str,
    current_epoch: int,
    logger=None,
) -> str:
    """Concatenate per-batch tables and write ``{results_file_name}_{epoch}.csv``.

    If the experiment logger has ``log_artifact`` the CSV path is also
    passed to it.
    """
    if not results_dfs:
        return ""
    columns = [_column_cells(np.concatenate([table[name] for table in results_dfs])) for name in COLUMNS]
    path = f"{results_file_name}_{current_epoch}.csv"
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows(zip(*columns))
    if logger is not None and hasattr(logger, "log_artifact"):
        try:
            logger.log_artifact(path)
        except Exception as exc:  # logging must never kill training
            logging.getLogger(__name__).warning("could not upload %s: %s", path, exc, exc_info=True)
    return path
