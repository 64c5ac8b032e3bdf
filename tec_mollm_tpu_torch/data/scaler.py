"""Per-feature z-score scaler persisted as ``.npz`` (``mean``, ``scale``).

The JAX package's ``data/scaler.py``: sklearn's semantics (per-column mean,
ddof=0 standard deviation, a zero-variance column scales by 1), fit and
applied in row chunks so a multi-GB archive split never gets a float64 copy.
The preprocess CLI (``data/preprocess.py``) fits and writes these files; the
device-resident archive (``data/device_data.py``) applies the same fp32
constants as ``transform(..., dtype=np.float32)``, bit for bit.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    """transform(x) = (x - mean) / scale; inverse_transform undoes it."""

    # rows per chunk of the streaming fit and transforms
    CHUNK_ROWS = 4_000_000

    def __init__(self, mean: np.ndarray | None = None, scale: np.ndarray | None = None):
        self.mean_ = None if mean is None else np.asarray(mean, dtype=np.float64)
        self.scale_ = None if scale is None else np.asarray(scale, dtype=np.float64)

    def fit(self, x: np.ndarray) -> "StandardScaler":
        """Per-column mean and ddof=0 scale of (n_samples, n_features) ``x``,
        two passes over row chunks with float64 accumulators."""
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"fit expects 2D (n_samples, n_features), got {x.shape}")
        n = x.shape[0]
        total = np.zeros(x.shape[1], dtype=np.float64)
        for i in range(0, n, self.CHUNK_ROWS):
            total += x[i : i + self.CHUNK_ROWS].sum(axis=0, dtype=np.float64)
        mean = total / max(n, 1)
        sq = np.zeros(x.shape[1], dtype=np.float64)
        for i in range(0, n, self.CHUNK_ROWS):
            d = x[i : i + self.CHUNK_ROWS].astype(np.float64) - mean
            sq += np.einsum("ij,ij->j", d, d)
        scale = np.sqrt(sq / max(n, 1))
        scale[scale == 0.0] = 1.0
        self.mean_ = mean
        self.scale_ = scale
        return self

    def _check(self) -> None:
        if self.mean_ is None or self.scale_ is None:
            raise RuntimeError("Scaler is not fitted")

    def _affine(self, x: np.ndarray, shift: np.ndarray, mul: np.ndarray, dtype) -> np.ndarray:
        """(x - shift) * mul in row chunks, computed and returned in ``dtype``
        (float64 by default, sklearn's numbers; float32 skips the full-size
        float64 temporaries)."""
        x = np.asarray(x)
        dtype = np.dtype(np.float64 if dtype is None else dtype)
        shift = shift.astype(dtype)
        mul = mul.astype(dtype)
        out = np.empty(x.shape, dtype=dtype)
        for i in range(0, max(x.shape[0], 1), self.CHUNK_ROWS):
            s = slice(i, i + self.CHUNK_ROWS)
            np.multiply(x[s] - shift, mul, out=out[s])
        return out

    def transform(self, x: np.ndarray, dtype=None) -> np.ndarray:
        self._check()
        return self._affine(x, self.mean_, 1.0 / self.scale_, dtype)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        self._check()
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.mean_

    def save(self, path: str) -> None:
        self._check()
        np.savez(path, mean=self.mean_, scale=self.scale_)

    @classmethod
    def load(cls, path: str) -> "StandardScaler":
        with np.load(path) as data:
            return cls(mean=data["mean"], scale=data["scale"])
