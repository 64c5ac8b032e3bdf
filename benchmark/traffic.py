"""The one generator of the benchmark's inputs: data splits and request
schedules, from a traffic file's parameters and the run's seed.

A split is a scaled TEC-like series on the configuration's grid, as the
preprocess CLI writes one: X (T, N, 6) with a diurnal cycle of 12 two-hour
steps plus noise in channel 0 and noise in the five space-weather channels,
Y (T, N, L_out) the next L_out values of channel 0, and time features
(time of day, day of year, year index, season). A split of W stride-1 windows
holds W + L_in + L_out - 1 steps.

A request schedule is an open loop: every seed gets the same multiset of
inter-arrival gaps (the quantiles of an exponential distribution at the
traffic's rate, so the arrivals are Poisson-like) and the same multiset of
request sizes (equal thirds of 1, 2 and 3 windows), in an order drawn from the
seed; only the order and the window indices change with the seed.
"""

from __future__ import annotations

import numpy as np

# The target scaler of the synthetic archive (TECU): forecasts come back as
# scaled * TARGET_SCALE + TARGET_MEAN.
TARGET_MEAN = 25.0
TARGET_SCALE = 12.0
YEAR_INDEX = 11
DATA_STREAM = 0x0DA7A


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def split(config: dict, windows: int, seed: int, stream: int) -> dict[str, np.ndarray]:
    m, t = config["model"], config["train"]
    n, c, l_in, l_out = m["num_nodes"], m["in_features"], t["L_in"], t["L_out"]
    length = windows + l_in + l_out - 1
    g = rng(seed, DATA_STREAM + stream)
    steps = np.arange(length)
    tec = g.standard_normal((length, n), dtype=np.float32)
    tec *= 0.3
    tec += np.sin(2 * np.pi * steps / 12.0).astype(np.float32)[:, None]
    x = np.empty((length, n, c), dtype=np.float32)
    x[..., 0] = tec
    x[..., 1:] = g.standard_normal((length, n, c - 1), dtype=np.float32)
    x[..., 1:] *= 0.5
    y = np.empty((length, n, l_out), dtype=np.float32)
    for h in range(l_out):
        y[..., h] = np.roll(tec, -h - 1, axis=0)
    tf = np.stack([steps % 12, (steps // 12) % 366, np.full_like(steps, YEAR_INDEX), ((steps // 12) // 91) % 4],
                  axis=-1).astype(np.int32)
    return {"X": x, "Y": y, "time_features": tf}


def windows_of(data: dict[str, np.ndarray], starts: np.ndarray, l_in: int):
    """(x (B, L_in, N, C), tf (B, L_in, 4), y (B, N, L_out)) of windows starting at ``starts``."""
    starts = np.asarray(starts, dtype=np.int64)
    idx = starts[:, None] + np.arange(l_in)[None, :]
    return data["X"][idx], data["time_features"][idx], data["Y"][starts + l_in - 1]


def schedule(traffic: dict, seed: int, seconds: float, n_windows: int, stream: int = 0) -> list[tuple[float, list[int]]]:
    """[(due second from the start, window indices)] of every request due in
    ``seconds`` at the traffic's ``rate_per_s``."""
    rate = float(traffic["rate_per_s"])
    count = max(1, round(rate * seconds))
    lo, hi = traffic["windows_per_request"]
    sizes = lo + np.arange(count) % (hi - lo + 1)
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count) / rate
    gaps *= seconds / gaps.sum()
    g = rng(seed, 0x5C4ED + stream)
    gaps, sizes = g.permutation(gaps), g.permutation(sizes)
    due = np.cumsum(gaps) - gaps
    return [(float(t), g.integers(0, n_windows, int(s)).tolist()) for t, s in zip(due, sizes)]
