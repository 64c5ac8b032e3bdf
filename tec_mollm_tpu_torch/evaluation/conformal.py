"""Split-conformal calibration of the quantile head's intervals
(``evaluation/conformal.py`` of the JAX package, in PyTorch).

Per level q and horizon h the adjusted forecast is
``sort_q(pred_qh(x) + delta[h, q])``, with ``delta[h, q]`` the q-th empirical
quantile (with the (n+1)/n finite-sample correction) of the calibration
residuals ``y - pred_qh(x)`` (Romano, Patterson & Candes 2019, the marginal
variant of CQR). The sort keeps the levels from crossing.

Residual quantiles come from histograms built on the device, one batch at a
time: each batch scatter-adds its physical residuals into (L_out, Q, BINS)
bins of 0.1 TECU over [-200, 200] (the metric suite's guards and clip first),
and the host inverts the CDF once. The bin of a residual is
``floor((resid - RESID_LO) / width)`` in fp32, the JAX package's arithmetic,
so the same residuals land in the same bins in both packages. Counts are whole
numbers: a batch adds at most B * L_out * N per level to a bin, far below
fp32's 2^24, and batches are summed in float64.

``ConformalOffsets`` writes ``conformal.npz`` with the JAX package's keys, so
each package reads the other's file. ``evaluate_adaptive_conformal`` is the
rolling form on a chronological stream.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np
import torch

from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.evaluation.metrics import TEC_MAX, TEC_MIN
from tec_mollm_tpu_torch.evaluation.streaming import StreamingQuantileMetrics, scaler_affine

logger = logging.getLogger(__name__)

# residual range: truths lie in [0, ~200] after the guards, predictions are
# clipped to [0, 200], so y - p lies in [-200, 200]; 4000 bins = 0.1 TECU each
RESID_LO = -200.0
RESID_HI = 200.0
BINS = 4000

# scale mode: t = (y - p_median) / max(band width, WIDTH_EPS); |t| > 20 band
# widths does not occur in practice: 4000 bins = 0.01 each
T_LO = -20.0
T_HI = 20.0
WIDTH_EPS = 0.5  # TECU floor on the band width


def _physical(y_true_scaled, y_pred_q_scaled, nq: int, scale: float, mean: float):
    """(B, L, M) truths and (B, L, M, Q) forecasts in TECU, guarded and
    clipped as the metric suite does."""
    b, l_out = y_true_scaled.shape[:2]
    yt = y_true_scaled.reshape(b, l_out, -1).float()
    yp = y_pred_q_scaled.reshape(b, l_out, -1, nq).float()
    yp = torch.nan_to_num(yp, nan=0.0, posinf=0.0, neginf=0.0)
    yt = yt * scale + mean
    yp = yp * scale + mean
    yt = torch.nan_to_num(yt, nan=0.0, posinf=100.0, neginf=0.0)
    yp = torch.clamp(torch.nan_to_num(yp, nan=0.0, posinf=100.0, neginf=0.0), TEC_MIN, TEC_MAX)
    return yt, yp


def _bin_index(values: torch.Tensor, lo: float, hi: float, bins: int) -> torch.Tensor:
    """``floor((values - lo) / width)`` clipped to [0, bins). The width is a
    tensor on the values' device: CUDA turns a division by a host scalar into
    a multiply by its reciprocal, which can move a value across a bin edge."""
    width = torch.tensor((hi - lo) / bins, dtype=torch.float32, device=values.device)
    return torch.clamp(torch.floor((values - lo) / width).to(torch.int64), 0, bins - 1)


def _weighted_counts(seg: torch.Tensor, valid: torch.Tensor, size: int) -> torch.Tensor:
    """Counts of ``seg``'s values in [0, size), each row b weighing valid[b]."""
    w = valid.float().reshape((-1,) + (1,) * (seg.dim() - 1)).expand_as(seg)
    return torch.zeros(size, dtype=torch.float32, device=seg.device).scatter_add_(0, seg.reshape(-1), w.reshape(-1))


def batch_residual_hist(
    y_true_scaled: torch.Tensor,    # (B, L_out, ...) scaled
    y_pred_q_scaled: torch.Tensor,  # (B, L_out, ..., Q) scaled
    valid: torch.Tensor,            # (B,) bool
    scale: float,
    mean: float,
    nq: int,
    bins: int = BINS,
) -> torch.Tensor:
    """(L_out, nq, bins) float32 histogram of the physical residuals y - p."""
    yt, yp = _physical(y_true_scaled, y_pred_q_scaled, nq, scale, mean)
    l_out = yt.shape[1]
    idx = _bin_index(yt[..., None] - yp, RESID_LO, RESID_HI, bins)     # (B, L, M, Q)
    l_ids = torch.arange(l_out, device=idx.device)[None, :, None, None]
    q_ids = torch.arange(nq, device=idx.device)[None, None, None, :]
    seg = (l_ids * nq + q_ids) * bins + idx
    return _weighted_counts(seg, valid, l_out * nq * bins).reshape(l_out, nq, bins)


def batch_scaled_residual_hist(
    y_true_scaled: torch.Tensor,
    y_pred_q_scaled: torch.Tensor,
    valid: torch.Tensor,
    scale: float,
    mean: float,
    nq: int,
    median_index: int,
    bins: int = BINS,
) -> torch.Tensor:
    """(L_out, bins) histogram of the normalized residuals
    t = (y - p_median) / max(p_hi - p_lo, WIDTH_EPS), the scale mode's score;
    one histogram serves every level."""
    yt, yp = _physical(y_true_scaled, y_pred_q_scaled, nq, scale, mean)
    l_out = yt.shape[1]
    width = torch.clamp_min(yp[..., -1] - yp[..., 0], WIDTH_EPS)
    idx = _bin_index((yt - yp[..., median_index]) / width, T_LO, T_HI, bins)  # (B, L, M)
    seg = torch.arange(l_out, device=idx.device)[None, :, None] * bins + idx
    return _weighted_counts(seg, valid, l_out * bins).reshape(l_out, bins)


def _hist_quantile(counts: np.ndarray, q: float, edges: np.ndarray) -> float:
    """Finite-sample conformal quantile of one histogram: the ceil(q (n+1))-th
    order statistic, interpolated linearly inside its bin (a hard upper edge
    overshoots coverage by up to one bin's mass)."""
    n = counts.sum()
    if n <= 0:
        return 0.0
    width = edges[1] - edges[0]
    target = min(np.ceil(q * (n + 1)), n)
    cdf = np.cumsum(counts)
    k = int(np.searchsorted(cdf, target - 1e-9))
    prev = cdf[k - 1] if k > 0 else 0.0
    frac = (target - prev) / max(counts[k], 1.0)
    return float(edges[k] + width * min(frac, 1.0))


def offsets_from_histograms(hist: np.ndarray, quantiles: tuple[float, ...]) -> np.ndarray:
    """(L, Q, BINS) additive residual histograms -> (L, Q) offsets."""
    edges = np.linspace(RESID_LO, RESID_HI, BINS + 1)
    out = np.zeros(hist.shape[:2])
    for h in range(hist.shape[0]):
        for j, q in enumerate(quantiles):
            out[h, j] = _hist_quantile(hist[h, j], q, edges)
    return out


class ConformalOffsets:
    """Per-(horizon, level) conformal offsets and their file.

    mode 'additive': offsets in TECU, pred'_q = pred_q + delta.
    mode 'scale': offsets in band widths,
    pred'_q = pred_med + delta * max(pred_hi - pred_lo, WIDTH_EPS)."""

    def __init__(
        self,
        quantiles: tuple[float, ...],
        offsets: np.ndarray,              # (L_out, Q)
        n_calibration: float = 0.0,
        mode: str = "additive",
    ):
        if mode not in ("additive", "scale"):
            raise ValueError(f"unknown conformal mode {mode!r}")
        self.quantiles = tuple(float(q) for q in quantiles)
        self.offsets = np.asarray(offsets, dtype=np.float64)
        self.n_calibration = float(n_calibration)
        self.mode = mode
        if self.offsets.ndim != 2 or self.offsets.shape[1] != len(self.quantiles):
            raise ValueError(
                f"offsets shape {self.offsets.shape} does not match {len(self.quantiles)} quantile levels"
            )

    @property
    def median_index(self) -> int:
        return self.quantiles.index(0.5)

    def apply_physical(self, yp_phys: np.ndarray) -> np.ndarray:
        """Adjust (..., L_out, N, Q) TECU forecasts by the mode, re-sort the
        levels and re-clip."""
        if self.mode == "scale":
            med = yp_phys[..., self.median_index : self.median_index + 1]
            w = np.maximum(yp_phys[..., -1:] - yp_phys[..., :1], WIDTH_EPS)
            adj = med + self.offsets[:, None, :] * w
        else:
            adj = yp_phys + self.offsets[:, None, :]
        return np.clip(np.sort(adj, axis=-1), TEC_MIN, TEC_MAX)

    def save(self, path: str) -> None:
        np.savez(
            path,
            quantiles=np.asarray(self.quantiles, dtype=np.float64),
            offsets=self.offsets,
            n_calibration=np.asarray(self.n_calibration),
            mode=np.asarray(self.mode),
        )

    @classmethod
    def load(cls, path: str) -> "ConformalOffsets":
        with np.load(path) as d:
            return cls(
                quantiles=tuple(d["quantiles"].tolist()),
                offsets=d["offsets"],
                n_calibration=float(d["n_calibration"]),
                mode=str(d["mode"]) if "mode" in d else "additive",
            )

    @classmethod
    def path_for(cls, checkpoint_path: str) -> str:
        """Where the offsets of a checkpoint live: beside it, as its config.json."""
        return os.path.join(os.path.dirname(checkpoint_path), "conformal.npz")


class ConformalCalibrator:
    """Sums residual histograms of (truth, quantile forecast) batches on the
    device and inverts them into ``ConformalOffsets``.

    mode 'additive' histograms y - p per (horizon, level); mode 'scale' the
    normalized residual per horizon. Under drift of the residual scale (the
    solar cycle carries the error scale and the predicted band width up
    together) the normalized score transfers where TECU offsets under-cover."""

    def __init__(
        self,
        num_horizons: int,
        quantiles: tuple[float, ...],
        scaler: StandardScaler | None = None,
        mode: str = "additive",
        device: torch.device | str = "cpu",
    ):
        if mode not in ("additive", "scale"):
            raise ValueError(f"unknown conformal mode {mode!r}")
        self.mode = mode
        self.quantiles = tuple(quantiles)
        self.num_horizons = num_horizons
        self.scale, self.mean = scaler_affine(scaler)
        shape = (num_horizons, len(self.quantiles), BINS) if mode == "additive" else (num_horizons, BINS)
        self.hist = torch.zeros(shape, dtype=torch.float64, device=device)

    def update(self, y_true_scaled, y_pred_q_scaled, valid=None) -> None:
        if valid is None:
            valid = torch.ones(y_true_scaled.shape[0], dtype=torch.bool, device=y_true_scaled.device)
        nq = len(self.quantiles)
        if self.mode == "additive":
            h = batch_residual_hist(y_true_scaled, y_pred_q_scaled, valid, self.scale, self.mean, nq)
        else:
            h = batch_scaled_residual_hist(
                y_true_scaled, y_pred_q_scaled, valid, self.scale, self.mean, nq, self.quantiles.index(0.5)
            )
        self.hist += h.double()

    def finalize(self) -> ConformalOffsets:
        hist = self.hist.cpu().numpy()
        nq = len(self.quantiles)
        if self.mode == "additive":
            offsets = offsets_from_histograms(hist, self.quantiles)
            n_total = float(hist[0].sum(axis=-1).max()) if nq else 0.0
        else:
            edges = np.linspace(T_LO, T_HI, BINS + 1)
            offsets = np.array([[_hist_quantile(hist[h], q, edges) for q in self.quantiles]
                                for h in range(self.num_horizons)])
            n_total = float(hist[0].sum())
        return ConformalOffsets(self.quantiles, offsets, n_calibration=n_total, mode=self.mode)


def fit_conformal(
    cfg,
    state_dict,
    dataset,
    graph,
    target_scaler: StandardScaler | None,
    batch_size: int = 16,
    mode: str = "additive",
    device: torch.device | str | None = None,
) -> ConformalOffsets:
    """Inference over a calibration split (normally val) and the offsets fit
    on it. Only the (L_out, Q, BINS) counts leave the device, once."""
    from tec_mollm_tpu_torch.evaluation.harness import EvalExecutor, device_dataset_of

    quantiles = cfg.model.quantiles
    if not quantiles:
        raise ValueError("conformal calibration needs a quantile-head model (ModelConfig.quantiles)")
    ex = EvalExecutor(cfg, graph, state_dict, batch_size, device=device, device_dataset=device_dataset_of(dataset))
    cal = ConformalCalibrator(cfg.train.L_out, quantiles, target_scaler, mode=mode, device=ex.device)
    for batch in ex.loader(dataset):
        _, preds, trues, valid = ex.run(batch)
        cal.update(trues, preds, valid)
    off = cal.finalize()
    logger.info(
        "conformal offsets (%s) fit on %d windows: per-level range %s",
        mode, len(dataset),
        {f"{q:g}": (round(float(off.offsets[:, j].min()), 2), round(float(off.offsets[:, j].max()), 2))
         for j, q in enumerate(off.quantiles)},
    )
    return off


def evaluate_adaptive_conformal(
    cfg,
    state_dict,
    dataset,
    graph,
    target_scaler: StandardScaler | None,
    batch_size: int = 16,
    warm_offsets: ConformalOffsets | None = None,
    decay: float = 0.99,
    level_gain: float = 0.05,
    min_residual_mass: float = 10_000.0,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Adaptive conformal on the chronological stream: the offsets applied to
    window k come from an exponentially decayed histogram of the residuals of
    windows j <= k - L_out, forecasts whose whole target range was observed
    before k's forecast was issued. The maturity lag holds the newest
    ceil(L_out / B) + 1 batch histograms out of the aggregate; below
    ``min_residual_mass`` the warm offsets (or none) apply.

    ``level_gain`` adds the ACI feedback (Gibbs & Candes 2021): the histogram
    is inverted at effective levels that integrate the realized coverage
    error, q_eff += gain * (q - observed below-rate), which steers out the
    lag of a rolling histogram under a monotone drift; 0 disables it.

    The loader keeps the stream's order and pads only the last batch, whose
    padded rows weigh 0. Returns the quantile metrics of the evolving offsets
    with the adaptation's record under ``adaptive``."""
    from tec_mollm_tpu_torch.evaluation.harness import EvalExecutor, device_dataset_of

    quantiles = cfg.model.quantiles
    if not quantiles:
        raise ValueError("adaptive conformal needs a quantile-head model")
    nq, l_out = len(quantiles), cfg.train.L_out
    ex = EvalExecutor(cfg, graph, state_dict, batch_size, device=device, device_dataset=device_dataset_of(dataset))
    acc = StreamingQuantileMetrics(l_out, quantiles, target_scaler, device=ex.device)
    scale, mean = scaler_affine(target_scaler)
    H = np.zeros((l_out, nq, BINS), dtype=np.float64)
    pending: list[np.ndarray] = []
    lag_batches = -(-l_out // max(ex.batch_size, 1)) + 1
    warm = None if warm_offsets is None else warm_offsets.offsets
    used_adaptive = n_batches = 0
    q_eff = np.asarray(quantiles, dtype=np.float64)

    for batch in ex.loader(dataset):
        _, preds, trues, valid = ex.run(batch)
        if float(H[0].sum(axis=-1).max()) >= min_residual_mass:
            offs = offsets_from_histograms(H, tuple(q_eff))
            used_adaptive += 1
        elif warm is not None:
            offs = warm
        else:
            offs = np.zeros((l_out, nq))
        s = acc.update(trues, preds, valid, offsets_override=offs)
        if level_gain > 0.0:
            # this batch's realized below-rate of the adjusted forecasts
            s_host = s.cpu().numpy().astype(np.float64)   # (L, 1 + 2Q)
            n_b = max(float(s_host[:, 0].max()), 1.0)
            below_rate = s_host[:, 1 + nq :].sum(axis=0) / (n_b * l_out)
            q_eff = np.clip(q_eff + level_gain * (np.asarray(quantiles) - below_rate), 0.005, 0.995)
        pending.append(batch_residual_hist(trues, preds, valid, scale, mean, nq).cpu().numpy().astype(np.float64))
        if len(pending) > lag_batches:
            H = decay * H + pending.pop(0)
        n_batches += 1

    result = acc.finalize()
    result["adaptive"] = {
        "decay": decay,
        "lag_batches": lag_batches,
        "batches": n_batches,
        "batches_on_adaptive_offsets": used_adaptive,
        "warm_start": warm_offsets is not None,
        "level_gain": level_gain,
        "final_effective_levels": [round(float(v), 4) for v in q_eff],
    }
    return result
