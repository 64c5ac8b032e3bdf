"""Streaming validation metrics, reduced on the device.

Each eval batch reduces to 8 sufficient statistics per horizon on the device::

    n, sum|e|, sum e^2, sum y, sum y^2, sum p, sum p^2, sum y*p

computed on inverse-transformed values with the reference's guards: scaled
non-finite predictions zeroed first; after the inverse transform nan -> 0,
+inf -> 100, -inf -> 0; predictions (not truths) clipped to [TEC_MIN, TEC_MAX].
The batches' statistics are summed on the device in float64 and read by the
host once, at ``finalize``, which returns the JAX package's
``StreamingHorizonMetrics.finalize`` keys and layout. Under data parallelism
each rank sums its own rows and ``all_reduce`` adds the ranks' float64
statistics before ``finalize``.

The quantile head's forecasts reduce the same way to 1 + 2Q statistics per
horizon (n, the pinball loss and the count of truths at or below the forecast,
per level), optionally after split-conformal offsets
(``evaluation/conformal.py``); ``StreamingQuantileMetrics.finalize`` gives the
pinball, calibration and interval-coverage summaries.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.evaluation.metrics import TEC_MAX, TEC_MIN
from tec_mollm_tpu_torch.parallel.mesh import all_reduce_sum, data_group

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

    def all_reduce(self) -> "StreamingHorizonMetrics":
        """Sum the statistics over the data-parallel ranks (the data group: the
        ranks of a model group hold the same rows), in place (a no-op without
        a process group); every rank then finalizes the whole split."""
        all_reduce_sum(self.stats, data_group())
        return self

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


def batch_quantile_stats(
    y_true_scaled: torch.Tensor,    # (B, L_out, ...) scaled
    y_pred_q_scaled: torch.Tensor,  # (B, L_out, ..., Q) scaled, one per level
    valid: torch.Tensor,            # (B,) bool
    scale: float,
    mean: float,
    quantiles: tuple[float, ...],
    offsets: torch.Tensor | None = None,  # (L_out, Q) conformal offsets
    offsets_mode: str = "additive",
) -> torch.Tensor:
    """(L_out, 1 + 2Q) float32 per-horizon statistics of probabilistic
    forecasts: [n, pinball sum per level, below count per level], in physical
    units with the point statistics' guards. ``offsets`` applies split-conformal
    calibration in ``offsets_mode`` (additive: + TECU; scale: median + offset x
    band width), then re-sorts the levels and re-clips; None scores the raw
    forecasts."""
    nq = len(quantiles)
    b, l_out = y_true_scaled.shape[:2]
    yt = y_true_scaled.reshape(b, l_out, -1).float()
    yp = y_pred_q_scaled.reshape(b, l_out, -1, nq).float()
    yp = torch.nan_to_num(yp, nan=0.0, posinf=0.0, neginf=0.0)
    yt = yt * scale + mean
    yp = yp * scale + mean
    yt = torch.nan_to_num(yt, nan=0.0, posinf=100.0, neginf=0.0)
    yp = torch.clamp(torch.nan_to_num(yp, nan=0.0, posinf=100.0, neginf=0.0), TEC_MIN, TEC_MAX)
    if offsets is not None:
        off = offsets[None, :, None, :].float()
        if offsets_mode == "scale":
            from tec_mollm_tpu_torch.evaluation.conformal import WIDTH_EPS

            mi = quantiles.index(0.5)
            width = torch.clamp_min(yp[..., -1:] - yp[..., :1], WIDTH_EPS)
            yp = yp[..., mi : mi + 1] + off * width
        else:
            yp = yp + off
        yp = torch.clamp(torch.sort(yp, dim=-1).values, TEC_MIN, TEC_MAX)
    w = valid.float()[:, None, None, None]
    q = torch.tensor(quantiles, dtype=torch.float32, device=yp.device)
    err = yt[..., None] - yp                                  # (B, L, M, Q)
    pinball = torch.maximum(q * err, (q - 1.0) * err) * w
    below = (yt[..., None] <= yp).float() * w
    n = w.sum() * yt.shape[-1]
    return torch.cat([n.expand(l_out, 1), pinball.sum(dim=(0, 2)), below.sum(dim=(0, 2))], dim=-1)


class StreamingQuantileMetrics:
    """Sums ``batch_quantile_stats`` on the device; ``finalize`` gives the
    pinball loss, each level's calibration (the share of truths at or below
    it) and the outer levels' interval coverage, in the JAX package's keys."""

    def __init__(
        self,
        num_horizons: int,
        quantiles: tuple[float, ...],
        scaler: StandardScaler | None = None,
        offsets=None,
        device: torch.device | str = "cpu",
    ):
        """``offsets``: a ``ConformalOffsets`` (it carries its mode) or a bare
        (L_out, Q) array taken as additive; the metrics then score the
        calibrated intervals. None scores the head's own."""
        self.quantiles = tuple(quantiles)
        self.scale, self.mean = scaler_affine(scaler)
        self.device = torch.device(device)
        self.offsets_mode = getattr(offsets, "mode", "additive")
        offsets = getattr(offsets, "offsets", offsets)
        self.offsets = None if offsets is None else torch.as_tensor(offsets, dtype=torch.float32, device=self.device)
        self.stats = torch.zeros(num_horizons, 1 + 2 * len(self.quantiles), dtype=torch.float64, device=self.device)

    def update(
        self,
        y_true_scaled: torch.Tensor,
        y_pred_q_scaled: torch.Tensor,
        valid: torch.Tensor | None = None,
        offsets_override=None,
    ) -> torch.Tensor:
        """Adds one batch; returns its (L_out, 1 + 2Q) statistics on the device
        (the adaptive conformal pass reads its below-rates back).
        ``offsets_override``: this batch's (L_out, Q) additive offsets in
        place of the constructor's."""
        if valid is None:
            valid = torch.ones(y_true_scaled.shape[0], dtype=torch.bool, device=y_true_scaled.device)
        if offsets_override is not None:
            offsets = torch.as_tensor(offsets_override, dtype=torch.float32).to(self.device)
            mode = "additive"
        else:
            offsets, mode = self.offsets, self.offsets_mode
        s = batch_quantile_stats(
            y_true_scaled, y_pred_q_scaled, valid, self.scale, self.mean, self.quantiles, offsets, mode
        )
        self.stats += s.double()
        return s

    def all_reduce(self) -> "StreamingQuantileMetrics":
        """Sum the statistics over the data-parallel ranks (the data group),
        in place (a no-op without a process group)."""
        all_reduce_sum(self.stats, data_group())
        return self

    def finalize(self) -> dict[str, Any]:
        stats = self.stats.cpu().numpy()
        nq = len(self.quantiles)
        n = stats[:, 0]
        n = np.where(n == 0, 1.0, n)
        pinball = stats[:, 1 : 1 + nq] / n[:, None]             # (L, Q)
        below = stats[:, 1 + nq :] / n[:, None]                 # (L, Q)
        out: dict[str, Any] = {
            "quantiles": list(self.quantiles),
            "pinball_avg": float(pinball.mean()),
            "pinball_by_level": pinball.mean(axis=0).tolist(),
            "pinball_by_horizon": pinball.mean(axis=1).tolist(),
            "pinball_by_horizon_level": pinball.tolist(),
            "calibration_by_level": below.mean(axis=0).tolist(),
        }
        if nq >= 2:
            lo, hi = self.quantiles[0], self.quantiles[-1]
            cover = below[:, -1] - below[:, 0]                  # P(p_lo < y <= p_hi)
            out["interval_nominal"] = hi - lo
            out["interval_coverage"] = float(cover.mean())
            out["interval_coverage_by_horizon"] = cover.tolist()
        return out
