"""Sliding-window view over a processed split, gathered with numpy.

Same contract as the JAX package's ``SlidingWindowDataset``: window starts are
``range(0, T - L_in - L_out + 1, stride)``; item i is ``x = X[i : i+L_in]``,
``time_features = tf[i : i+L_in]`` and ``y = Y[i + L_in - 1]`` (Y holds the
L_out future steps of the window ending at t). Arrays are node-flattened:
X (T, N, C), Y (T, N, L_out), time_features (T, 4).
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def valid_window_starts(
    starts: np.ndarray, segment_id: np.ndarray, L_in: int, L_out: int
) -> np.ndarray:
    """Keep the window starts whose raw span [i, i+L_in+L_out-1] lies in one
    segment (``segment_id`` < 0 marks a bad step and starts no window)."""
    starts = np.asarray(starts, dtype=np.int64)
    if not len(starts):
        return starts
    end = starts + L_in + L_out - 1
    if int(end.max()) >= len(segment_id):
        raise ValueError(
            f"segment_id length {len(segment_id)} does not cover window end "
            f"{int(end.max())} — pass the raw-length segment array"
        )
    s0 = segment_id[starts]
    keep = (s0 >= 0) & (s0 == segment_id[end])
    return starts[keep]


class SlidingWindowDataset:
    """Windowed view over a processed split {X, Y, time_features[, segment_id]}."""

    def __init__(
        self, data: dict[str, np.ndarray], L_in: int, L_out: int, stride: int = 1
    ):
        self.X = np.ascontiguousarray(data["X"], dtype=np.float32)
        self.Y = np.ascontiguousarray(data["Y"], dtype=np.float32)
        self.time_features = np.ascontiguousarray(data["time_features"], dtype=np.int32)
        if self.X.ndim != 3 or self.Y.ndim != 3:
            raise ValueError(
                f"Expect node-flattened X (T,N,C) / Y (T,N,L_out); got {self.X.shape} / "
                f"{self.Y.shape}. Use preprocess to flatten the grid."
            )
        self.L_in = L_in
        self.L_out = L_out
        max_start = len(self.X) - L_in - L_out + 1
        self.sample_indices = np.arange(0, max(max_start, 0), stride, dtype=np.int64)
        segment_id = data.get("segment_id")
        if segment_id is not None and len(self.sample_indices):
            before = len(self.sample_indices)
            self.sample_indices = valid_window_starts(
                self.sample_indices, np.asarray(segment_id), L_in, L_out
            )
            dropped = before - len(self.sample_indices)
            if dropped:
                logger.info(
                    "segment filter: dropped %d/%d windows spanning gaps", dropped, before
                )

    @classmethod
    def from_dir(
        cls, data_dir: str, mode: str, L_in: int, L_out: int, stride: int = 1
    ) -> "SlidingWindowDataset":
        """Load ``{mode}_set.npz`` as written by the preprocess CLI."""
        with np.load(os.path.join(data_dir, f"{mode}_set.npz")) as d:
            data = {k: d[k] for k in ("X", "Y", "time_features")}
            if "segment_id" in d:
                data["segment_id"] = d["segment_id"]
        return cls(data, L_in=L_in, L_out=L_out, stride=stride)

    def __len__(self) -> int:
        return len(self.sample_indices)

    def gather_batch(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        """Windows at dataset indices ``idxs``: x (B, L, N, C), y (B, N, L_out),
        time_features (B, L, 4)."""
        starts = self.sample_indices[idxs]
        window = starts[:, None] + np.arange(self.L_in)[None, :]
        return {
            "x": self.X[window],
            "y": self.Y[starts + self.L_in - 1],
            "time_features": self.time_features[window],
        }
