"""Autoregressive rollout: forecasts beyond L_out, each chunk's forecast fed
back as input (``evaluation/rollout.py`` of the JAX package; a Python loop over
the chunks in place of its ``lax.scan``).

Per chunk of L_out steps:

  1. one eval forward of the current window (on the card: one GAT kernel launch);
  2. the median level (the point forecast) goes from target-scaled units to
     feature-scaled TEC: both scalers are affine, so it is ``y * a + b``;
  3. the rows [that TEC | the observed space-weather indices of those steps]
     are appended to the window, whose oldest L_out rows drop, and the time
     features move on.

The space weather and the time features of the future are observations, not
model outputs: the caller supplies them.
"""

from __future__ import annotations

import numpy as np
import torch

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.graph.builder import GraphData


def target_to_feature_affine(
    feature_scaler: StandardScaler | None, target_scaler: StandardScaler | None
) -> tuple[float, float]:
    """(a, b) with feature-scaled TEC = a * target-scaled TEC + b (channel 0)."""
    if feature_scaler is None or target_scaler is None:
        return 1.0, 0.0
    t_mean, t_scale = float(target_scaler.mean_[0]), float(target_scaler.scale_[0])
    f_mean, f_scale = float(feature_scaler.mean_[0]), float(feature_scaler.scale_[0])
    return t_scale / f_scale, (t_mean - f_mean) / f_scale


def autoregressive_rollout(
    cfg: Config,
    state_dict,
    graph: GraphData,
    x_init: np.ndarray,        # (B, L_in, N, C) feature-scaled window
    tf_full: np.ndarray,       # (B, L_in + steps, 4) time features incl. the future
    sw_future: np.ndarray,     # (B, steps, 5) feature-scaled space-weather indices
    num_steps: int,
    feature_scaler: StandardScaler | None = None,
    target_scaler: StandardScaler | None = None,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """(B, num_steps, N, 1) predictions in target-scaled units."""
    from tec_mollm_tpu_torch.evaluation.harness import build_eval_model

    cfg = cfg.resolved()
    m = cfg.model
    L_in, L_out = m.temporal_seq_len, m.prediction_horizon
    num_chunks = -(-num_steps // L_out)
    total = num_chunks * L_out
    if tf_full.shape[1] < L_in + total:
        raise ValueError(
            f"time features cover {tf_full.shape[1]} steps; rollout needs "
            f"{L_in + total} (L_in + ceil(steps/L_out)*L_out)"
        )
    if sw_future.shape[1] < total:
        raise ValueError(f"space weather covers {sw_future.shape[1]} < {total} steps")

    a, b = target_to_feature_affine(feature_scaler, target_scaler)
    model, graph_dev, device = build_eval_model(cfg, graph, state_dict, device)
    window = torch.as_tensor(x_init, dtype=torch.float32).to(device)
    tf_dev = torch.as_tensor(tf_full[:, : L_in + total], dtype=torch.int32).to(device)
    sw_dev = torch.as_tensor(sw_future[:, :total], dtype=torch.float32).to(device)
    n = window.shape[2]
    chunks = []
    with torch.inference_mode():
        for k in range(num_chunks):
            preds = model(window, tf_dev[:, k * L_out : k * L_out + L_in], *graph_dev)
            # feed back (and report) the point forecast: the 0.5 level of a
            # quantile head; rolling out the tail levels would compound them
            preds = preds[..., m.median_index : m.median_index + 1]   # (B, L_out, N, 1)
            sw = sw_dev[:, k * L_out : (k + 1) * L_out]               # (B, L_out, 5)
            rows = torch.cat([preds * a + b, sw[:, :, None, :].expand(-1, -1, n, -1)], dim=-1)
            window = torch.cat([window[:, L_out:], rows], dim=1)
            chunks.append(preds)
    return torch.cat(chunks, dim=1)[:, :num_steps].cpu().numpy()
