"""Per-horizon evaluation metrics in numpy (``evaluation/metrics.py`` of the
JAX package, which imports no JAX; copied so that the port stands alone).

The reference's semantics, each of which moves the reported numbers:

* scaled predictions are ``nan_to_num``-guarded to 0 before anything else;
* per horizon, truths and predictions are inverse-transformed by the target
  scaler; non-finite values after it become nan -> 0, +inf -> 100, -inf -> 0;
* predictions (not truths) are clipped to [TEC_MIN, TEC_MAX] TECU;
* arrays are reshaped to (samples, outputs): MAE and RMSE are overall means,
  R^2 is per output then averaged (sklearn's ``r2_score``), Pearson r is over
  the flattened arrays with a std > 0 guard returning 0.0;
* ``evaluate_horizons`` returns ``{metric}_avg`` and ``{metric}_by_horizon``.

The streaming form of the same numbers, reduced on the device, is
``evaluation/streaming.py``.
"""

from __future__ import annotations

import logging

import numpy as np

from tec_mollm_tpu_torch.data.scaler import StandardScaler

logger = logging.getLogger(__name__)

TEC_MIN, TEC_MAX = 0.0, 200.0


def _mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(y_true - y_pred)))


def _rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def _r2(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``r2_score``: per-column R^2, averaged; a zero-variance
    column scores 1.0 if predicted exactly, else 0.0."""
    ss_res = ((y_true - y_pred) ** 2).sum(axis=0)
    ss_tot = ((y_true - y_true.mean(axis=0)) ** 2).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = 1.0 - ss_res / ss_tot
    r2 = np.where(ss_tot == 0, np.where(ss_res == 0, 1.0, 0.0), r2)
    return float(np.mean(r2))


def _pearson(y_true_flat: np.ndarray, y_pred_flat: np.ndarray) -> float:
    if np.std(y_true_flat) > 0 and np.std(y_pred_flat) > 0:
        yt = y_true_flat - y_true_flat.mean()
        yp = y_pred_flat - y_pred_flat.mean()
        return float((yt @ yp) / np.sqrt((yt @ yt) * (yp @ yp)))
    return 0.0


def _as_2d(a: np.ndarray) -> np.ndarray:
    if a.ndim > 2:
        return a.reshape(-1, a.shape[-1])
    if a.ndim == 1:
        return a[:, None]
    return a


def evaluate_metrics_unscaled_fallback(
    y_true_unscaled: np.ndarray, y_pred_unscaled: np.ndarray
) -> dict[str, float]:
    """Metrics on data already in physical units, with the reference's
    fallback semantics: Pearson is the mean of PER-COLUMN correlations (the
    scaled path flattens before Pearson)."""
    yt = _as_2d(np.asarray(y_true_unscaled, dtype=np.float64))
    yp = _as_2d(np.asarray(y_pred_unscaled, dtype=np.float64))
    return {
        "mae": _mae(yt, yp),
        "rmse": _rmse(yt, yp),
        "r2_score": _r2(yt, yp),
        "pearson_r": float(np.mean([_pearson(yt[:, i], yp[:, i]) for i in range(yt.shape[1])])),
    }


def evaluate_metrics(
    y_true_scaled: np.ndarray,
    y_pred_scaled: np.ndarray,
    scaler: StandardScaler | None,
) -> dict[str, float]:
    """Metrics of one horizon slice in scaled units; ``scaler=None`` means the
    data is already physical (flattened Pearson still)."""
    y_true = np.asarray(y_true_scaled, dtype=np.float64)
    y_pred = np.asarray(y_pred_scaled, dtype=np.float64)
    if scaler is not None:
        shape_t, shape_p = y_true.shape, y_pred.shape
        y_true = scaler.inverse_transform(y_true.reshape(-1, 1)).reshape(shape_t)
        y_pred = scaler.inverse_transform(y_pred.reshape(-1, 1)).reshape(shape_p)
    if not np.all(np.isfinite(y_true)):
        y_true = np.nan_to_num(y_true, nan=0.0, posinf=100.0, neginf=0.0)
    if not np.all(np.isfinite(y_pred)):
        y_pred = np.nan_to_num(y_pred, nan=0.0, posinf=100.0, neginf=0.0)
    y_pred = np.clip(y_pred, TEC_MIN, TEC_MAX)
    y_true, y_pred = _as_2d(y_true), _as_2d(y_pred)
    return {
        "mae": _mae(y_true, y_pred),
        "rmse": _rmse(y_true, y_pred),
        "r2_score": _r2(y_true, y_pred),
        "pearson_r": _pearson(y_true.ravel(), y_pred.ravel()),
    }


def evaluate_horizons(
    y_true_horizons_scaled: np.ndarray,
    y_pred_horizons_scaled: np.ndarray,
    target_scaler: StandardScaler | str | None = None,
) -> dict[str, object]:
    """Metrics per horizon and their averages; inputs (B, L_out, ...) scaled.
    ``target_scaler`` is a scaler, the path of a saved one, or None (data
    already physical)."""
    y_true = np.asarray(y_true_horizons_scaled)
    y_pred = np.asarray(y_pred_horizons_scaled)
    if not np.all(np.isfinite(y_pred)):
        logger.warning("Overflow guard: %d non-finite predictions clamped to 0", int(np.sum(~np.isfinite(y_pred))))
        y_pred = np.nan_to_num(y_pred, nan=0.0, posinf=0.0, neginf=0.0)
    scaler = StandardScaler.load(target_scaler) if isinstance(target_scaler, str) else target_scaler
    per_h = [evaluate_metrics(y_true[:, h], y_pred[:, h], scaler) for h in range(y_true.shape[1])]
    return {
        "mae_avg": float(np.mean([m["mae"] for m in per_h])),
        "rmse_avg": float(np.mean([m["rmse"] for m in per_h])),
        "r2_score_avg": float(np.mean([m["r2_score"] for m in per_h])),
        "pearson_r_avg": float(np.mean([m["pearson_r"] for m in per_h])),
        "mae_by_horizon": [m["mae"] for m in per_h],
        "rmse_by_horizon": [m["rmse"] for m in per_h],
        "r2_by_horizon": [m["r2_score"] for m in per_h],
        "pearson_by_horizon": [m["pearson_r"] for m in per_h],
    }
