"""First-party batched SARIMA(1,1,1)x(1,1,1,s) baseline (``models/sarima.py``
of the JAX package, in PyTorch).

* One conditional-sum-of-squares (CSS) objective over all nodes at once: the
  series is differenced as (1-B)(1-B^s), scaled per node by its population
  std, and the 4 coefficients of each node (phi, Phi, theta, Theta, each
  0.99 tanh of a raw parameter that starts at 0) are fitted jointly with
  Adam on the mean squared innovation past the burn-in of s + 1 steps.
* Each window is forecast from its own L_in history: the innovations
  recursion over the window, then L_out steps ahead with future innovations
  0, the double difference inverted.

Model, in backshift notation with d = D = 1::

    (1 - phi B)(1 - Phi B^s) y_t = (1 + theta B)(1 + Theta B^s) eps_t
    y = (1 - B)(1 - B^s) x

The recursions are the kernels of ``ops/sarima.py`` (``csrc/sarima.cu``) on
the card and their plain versions on the CPU. ``device=None`` is the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.ops import sarima as ops

_difference = ops.difference
_lagged = ops.lagged


@dataclasses.dataclass
class SarimaParams:
    """Per-node coefficients, each (N,) float32 in (-1, 1)."""

    phi: np.ndarray
    sphi: np.ndarray
    theta: np.ndarray
    stheta: np.ndarray

    def coeffs(self, device) -> torch.Tensor:
        """(4, N) float32 on ``device``, in the kernels' order."""
        stacked = np.stack([self.phi, self.sphi, self.theta, self.stheta]).astype(np.float32)
        return torch.from_numpy(stacked).to(device)


def _innovations(coeffs: torch.Tensor, y: torch.Tensor, season: int) -> torch.Tensor:
    """The CSS innovations e (T, N) of the differenced series y (T, N) under
    the coefficients (4, N)."""
    return ops.css_forward(y, coeffs, season)[0]


def scaled_difference(series: np.ndarray, season: int, device) -> torch.Tensor:
    """(1-B)(1-B^s) of ``series`` (T, N) on ``device``, each node divided by
    its population std (floored at 1e-6): what the fit's recursion reads."""
    y = _difference(torch.as_tensor(np.asarray(series, np.float32), device=device), season)
    return (y / y.std(dim=0, correction=0).clamp_min(1e-6)).contiguous()


def adam_fit(
    y: torch.Tensor, season: int, steps: int, lr: float = 0.05, loss_and_grad=ops.css_loss_and_grad
) -> torch.Tensor:
    """The raw parameters (4, N) after ``steps`` Adam steps from 0 on the CSS
    loss of ``y`` (``scaled_difference``), each step's loss and gradient from
    ``loss_and_grad`` (the kernels; ``ops.css_loss_and_grad_reference`` for
    the plain versions)."""
    raw = torch.zeros((4, y.shape[1]), dtype=torch.float32, device=y.device)
    opt = torch.optim.Adam([raw], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        raw.grad = loss_and_grad(raw, y, season)[1]
        opt.step()
    return raw


def fit_sarima(
    series: np.ndarray,
    season: int = 12,
    steps: int = 400,
    lr: float = 0.05,
    seed: int = 0,
    device=None,
) -> SarimaParams:
    """CSS fit of per-node SARIMA(1,1,1)x(1,1,1,season) on ``series`` (T, N).

    All nodes fit at once: the raw parameters (4, N) start at 0 and take
    ``steps`` steps of ``torch.optim.Adam`` (betas (0.9, 0.999), eps 1e-8: optax's
    defaults) on the mean squared innovation. ``seed`` is kept for the JAX
    signature; the start is deterministic."""
    del seed
    if series.shape[0] < 3 * (season + 1):
        raise ValueError(
            f"series length {series.shape[0]} too short for seasonal differencing at s={season}"
        )
    # scaled per node, so that one lr fits every node's scale
    raw = adam_fit(scaled_difference(series, season, resolve_device(device)), season, steps, lr)
    phi, sphi, theta, stheta = (0.99 * torch.tanh(raw)).cpu().numpy()
    return SarimaParams(phi, sphi, theta, stheta)


def forecast_windows(
    params: SarimaParams,
    windows: np.ndarray | torch.Tensor,
    L_out: int,
    season: int = 12,
    device=None,
) -> np.ndarray | torch.Tensor:
    """Forecast L_out steps beyond each window: windows (B, L_in, N) raw series
    -> (B, L_out, N), all windows and nodes in one pass. A numpy input gives
    numpy (JAX's contract); a tensor stays a tensor on its own device."""
    L_in = windows.shape[1]
    if L_in < 2 * (season + 1):
        raise ValueError(
            f"L_in={L_in} too short to condition SARIMA at s={season} (need >= {2 * (season + 1)})"
        )
    if isinstance(windows, torch.Tensor):
        x = windows.float().contiguous()
        return ops.forecast(x, params.coeffs(x.device), L_out, season)
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(windows, np.float32), device=dev)
    return ops.forecast(x, params.coeffs(dev), L_out, season).cpu().numpy()
