"""Baseline forecasters in numpy (``models/baselines.py`` of the JAX package).

* ``WindowMeanBaseline``: the reference's wired Historical-Average row: the
  mean of the input window's TEC channel, repeated for every horizon. The
  improvement percentages of the eval CLI are measured against it.
* ``HistoricalAverage``: per-(node, time-of-day slot) climatology, which the
  reference defines and never wires.
* ``SeasonalNaive``: the matching slot of the window's last full period.
* ``sarima_baseline``: the reference's per-node statsmodels SARIMAX, which
  needs statsmodels; the batched first-party fit is ``models/sarima.py``
  (``--baseline sarima`` of the test CLI).
"""

from __future__ import annotations

import numpy as np


class WindowMeanBaseline:
    """prediction[b, h, n] = mean_t(window_tec[b, t, n]) for every horizon h."""

    def predict_batch(self, x_window_tec: np.ndarray, L_out: int) -> np.ndarray:
        """x_window_tec: (B, L_in, N) -> (B, L_out, N, 1)."""
        mean = x_window_tec.mean(axis=1)  # (B, N)
        return np.repeat(mean[:, None, :, None], L_out, axis=1)

    def predict_dataset(self, dataset, L_out: int, tec_channel: int = 0) -> np.ndarray:
        """Every window of a ``SlidingWindowDataset`` -> (num_samples, L_out, N, 1)."""
        batch = dataset.gather_batch(np.arange(len(dataset)))
        return self.predict_batch(batch["x"][..., tec_channel], L_out)


class HistoricalAverage:
    """Per-(node, time-of-day slot) climatology."""

    def __init__(self, slots_per_day: int = 12):
        self.slots = slots_per_day
        self.averages: np.ndarray | None = None  # (N, slots)

    def fit(self, tec: np.ndarray, tod_slots: np.ndarray) -> "HistoricalAverage":
        """tec (T, N); tod_slots (T,) int in [0, slots)."""
        sums = np.zeros((tec.shape[1], self.slots))
        counts = np.zeros(self.slots)
        np.add.at(sums.T, tod_slots, tec)
        np.add.at(counts, tod_slots, 1)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.averages = sums / counts[None, :]
        return self

    def predict(self, tod_slots: np.ndarray) -> np.ndarray:
        """tod_slots (T,) -> (T, N)."""
        if self.averages is None:
            raise RuntimeError("fit first")
        return self.averages[:, tod_slots].T

    def save(self, path: str) -> None:
        np.savez(path, averages=self.averages, slots=self.slots)

    @classmethod
    def load(cls, path: str) -> "HistoricalAverage":
        with np.load(path) as d:
            obj = cls(slots_per_day=int(d["slots"]))
            obj.averages = d["averages"]
        return obj


class SeasonalNaive:
    """prediction[t + h] = value[t + h - period]: the matching slot of the
    input window's most recent full period."""

    def __init__(self, period: int = 12):
        self.period = period

    def predict_batch(self, x_window_tec: np.ndarray, L_out: int) -> np.ndarray:
        """x_window_tec: (B, L_in, N) -> (B, L_out, N, 1)."""
        L_in = x_window_tec.shape[1]
        if L_in < self.period:
            raise ValueError(f"window {L_in} shorter than period {self.period}")
        last_period = x_window_tec[:, L_in - self.period :, :]  # (B, period, N)
        reps = -(-L_out // self.period)
        return np.tile(last_period, (1, reps, 1))[:, :L_out, :, None]


def sarima_baseline(*args, **kwargs):
    """Per-node SARIMAX(1,1,1)(1,1,1,12) through statsmodels, as the
    reference defines it. Raises ``ImportError`` without statsmodels: the
    batched first-party fit (``models/sarima.py``, ``--baseline sarima``)
    needs no such package."""
    try:
        from statsmodels.tsa.statespace.sarimax import SARIMAX
    except ImportError as e:
        raise ImportError(
            "statsmodels is not available in this environment; use the first-party models/sarima.py "
            "(python -m tec_mollm_tpu_torch.test --baseline sarima), SeasonalNaive, or HistoricalAverage"
        ) from e

    class SarimaBaseline:
        def __init__(self, order=(1, 1, 1), seasonal_order=(1, 1, 1, 12)):
            self.models = {}
            self.order = order
            self.seasonal_order = seasonal_order

        def fit(self, tec: np.ndarray, node_indices: list[int]):
            for idx in node_indices:
                self.models[idx] = SARIMAX(tec[:, idx], order=self.order, seasonal_order=self.seasonal_order).fit(
                    disp=False)
            return self

        def predict(self, node_indices: list[int], steps: int) -> dict[int, np.ndarray]:
            return {idx: self.models[idx].forecast(steps=steps) for idx in node_indices if idx in self.models}

    return SarimaBaseline(*args, **kwargs)
