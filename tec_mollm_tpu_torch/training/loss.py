"""Losses: Huber (the reference's nn.HuberLoss(delta=1.0), mean reduction) and
the pinball loss of the quantile head, each with an optional 0/1 weight mask
whose mean runs over the weighted elements only (``training/loss.py`` of the
JAX package)."""

from __future__ import annotations

import torch


def huber_elementwise(preds: torch.Tensor, targets: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = (preds - targets).abs()
    quadratic = torch.clamp_max(abs_err, delta)
    linear = abs_err - quadratic
    return 0.5 * quadratic.square() + delta * linear


def pinball_elementwise(
    preds: torch.Tensor, targets: torch.Tensor, quantiles: tuple[float, ...]
) -> torch.Tensor:
    """preds (..., Q), targets (..., 1): max(q*e, (q-1)*e) with e = y - p."""
    q = torch.tensor(quantiles, dtype=preds.dtype, device=preds.device)
    err = targets - preds
    return torch.maximum(q * err, (q - 1.0) * err)


def weighted_mean(elementwise: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    if weights is None:
        return elementwise.mean()
    weights = torch.broadcast_to(weights, elementwise.shape)
    return (elementwise * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def huber_loss(
    preds: torch.Tensor, targets: torch.Tensor, delta: float = 1.0, weights: torch.Tensor | None = None
) -> torch.Tensor:
    return weighted_mean(huber_elementwise(preds, targets, delta), weights)


def pinball_loss(
    preds: torch.Tensor,
    targets: torch.Tensor,
    quantiles: tuple[float, ...],
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    return weighted_mean(pinball_elementwise(preds, targets, quantiles), weights)
