"""Baseline forecasters in numpy (``models/baselines.py`` of the JAX package).

* ``WindowMeanBaseline``: the reference's wired Historical-Average row: the
  mean of the input window's TEC channel, repeated for every horizon. The
  improvement percentages of the eval CLI are measured against it.
* ``HistoricalAverage``: per-(node, time-of-day slot) climatology, which the
  reference defines and never wires.
* ``SeasonalNaive``: the matching slot of the window's last full period.

The batched SARIMA baseline (``--baseline sarima``) is not ported yet.
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
