"""Per-feature z-score scaler persisted as ``.npz`` (``mean``, ``scale``).

The JAX package fits and writes these files in its preprocessing; the port only
reads them back to turn scaled forecasts into physical units.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    """transform(x) = (x - mean) / scale; inverse_transform undoes it."""

    def __init__(self, mean: np.ndarray, scale: np.ndarray):
        self.mean_ = np.asarray(mean, dtype=np.float64)
        self.scale_ = np.asarray(scale, dtype=np.float64)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.mean_

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean_, scale=self.scale_)

    @classmethod
    def load(cls, path: str) -> "StandardScaler":
        with np.load(path) as data:
            return cls(mean=data["mean"], scale=data["scale"])
