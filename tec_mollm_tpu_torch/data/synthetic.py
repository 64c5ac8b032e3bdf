"""A synthetic processed split for benchmarks and tests (numpy only).

The JAX package's ``synthetic_processed_split``: standardized normal X and Y
and the time features of a 2-hourly series, exactly long enough for
``num_windows`` stride-1 windows.
"""

from __future__ import annotations

import numpy as np


def synthetic_processed_split(
    num_windows: int,
    L_in: int,
    L_out: int,
    num_nodes: int,
    in_features: int = 6,
    num_years: int = 13,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    t = num_windows + L_in + L_out - 1
    x = rng.normal(0, 1, size=(t, num_nodes, in_features)).astype(np.float32)
    y = rng.normal(0, 1, size=(t, num_nodes, L_out)).astype(np.float32)
    steps = np.arange(t)
    tf = np.stack(
        [
            steps % 12,
            (steps // 12) % 366,
            np.zeros_like(steps) if num_years == 1 else (steps // (12 * 366)) % num_years,
            (steps // (12 * 91)) % 4,
        ],
        axis=-1,
    ).astype(np.int32)
    return {"X": x, "Y": y, "time_features": tf}
