"""Streaming validation metrics, reduced on the device.

Each eval batch reduces to 8 sufficient statistics per horizon on the device::

    n, sum|e|, sum e^2, sum y, sum y^2, sum p, sum p^2, sum y*p

computed on inverse-transformed values with the reference's guards: scaled
non-finite predictions zeroed first; after the inverse transform nan -> 0,
+inf -> 100, -inf -> 0; predictions (not truths) clipped to [TEC_MIN, TEC_MAX].
The batches' statistics are summed on the device in float64 and read by the
host once, at ``finalize``, which returns the JAX package's
``StreamingHorizonMetrics.finalize`` keys and layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.evaluation.metrics import TEC_MAX, TEC_MIN

NUM_STATS = 8


def scaler_affine(scaler: StandardScaler | None) -> tuple[float, float]:
    """(scale, mean) with inverse_transform(x) = x * scale + mean for the
    single target channel."""
    if scaler is None:
        return 1.0, 0.0
    return float(scaler.scale_[0]), float(scaler.mean_[0])


def batch_metric_stats(
    y_true_scaled: torch.Tensor,  # (B, L_out, ...) scaled
    y_pred_scaled: torch.Tensor,
    valid: torch.Tensor,          # (B,) bool
    scale: float,
    mean: float,
) -> torch.Tensor:
    """(L_out, 8) float32 per-horizon sufficient statistics."""
    b, l_out = y_true_scaled.shape[:2]
    yt = y_true_scaled.reshape(b, l_out, -1).float()
    yp = y_pred_scaled.reshape(b, l_out, -1).float()
    yp = torch.nan_to_num(yp, nan=0.0, posinf=0.0, neginf=0.0)
    yt = yt * scale + mean
    yp = yp * scale + mean
    yt = torch.nan_to_num(yt, nan=0.0, posinf=100.0, neginf=0.0)
    yp = torch.clamp(torch.nan_to_num(yp, nan=0.0, posinf=100.0, neginf=0.0), TEC_MIN, TEC_MAX)
    w = valid.float()[:, None, None]
    err = (yp - yt) * w
    yt_w, yp_w = yt * w, yp * w
    n = w.sum() * yt.shape[-1]
    return torch.stack(
        [
            n.expand(l_out),
            err.abs().sum(dim=(0, 2)),
            (err**2).sum(dim=(0, 2)),
            yt_w.sum(dim=(0, 2)),
            (yt_w**2).sum(dim=(0, 2)),
            yp_w.sum(dim=(0, 2)),
            (yp_w**2).sum(dim=(0, 2)),
            (yt_w * yp_w).sum(dim=(0, 2)),
        ],
        dim=-1,
    )


class StreamingHorizonMetrics:
    """Sums ``batch_metric_stats`` on the device; ``finalize`` gives MAE,
    RMSE, R^2 (sklearn's per-output form on the flattened horizon) and
    Pearson r, averaged and by horizon."""

    def __init__(
        self,
        num_horizons: int,
        scaler: StandardScaler | None = None,
        device: torch.device | str = "cpu",
    ):
        self.scale, self.mean = scaler_affine(scaler)
        self.stats = torch.zeros(num_horizons, NUM_STATS, dtype=torch.float64, device=device)

    def update(
        self,
        y_true_scaled: torch.Tensor,
        y_pred_scaled: torch.Tensor,
        valid: torch.Tensor | None = None,
    ) -> None:
        if valid is None:
            valid = torch.ones(y_true_scaled.shape[0], dtype=torch.bool, device=y_true_scaled.device)
        self.stats += batch_metric_stats(y_true_scaled, y_pred_scaled, valid, self.scale, self.mean).double()

    def finalize(self) -> dict[str, Any]:
        stats = self.stats.cpu().numpy()
        n = stats[:, 0]
        n = np.where(n == 0, 1.0, n)
        sum_abs, sum_sq = stats[:, 1], stats[:, 2]
        sy, syy = stats[:, 3], stats[:, 4]
        sp, spp = stats[:, 5], stats[:, 6]
        syp = stats[:, 7]

        mae = sum_abs / n
        rmse = np.sqrt(sum_sq / n)
        ss_tot = syy - sy**2 / n
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = 1.0 - sum_sq / ss_tot
        r2 = np.where(ss_tot <= 0, np.where(sum_sq == 0, 1.0, 0.0), r2)
        var_t = syy / n - (sy / n) ** 2
        var_p = spp / n - (sp / n) ** 2
        cov = syp / n - (sy / n) * (sp / n)
        with np.errstate(divide="ignore", invalid="ignore"):
            pearson = cov / np.sqrt(var_t * var_p)
        pearson = np.where((var_t <= 0) | (var_p <= 0), 0.0, pearson)
        return {
            "mae_avg": float(mae.mean()),
            "rmse_avg": float(rmse.mean()),
            "r2_score_avg": float(r2.mean()),
            "pearson_r_avg": float(pearson.mean()),
            "mae_by_horizon": mae.tolist(),
            "rmse_by_horizon": rmse.tolist(),
            "r2_by_horizon": r2.tolist(),
            "pearson_by_horizon": pearson.tolist(),
        }
