"""Feature engineering: split arrays -> aligned (X, Y, time_features) tensors + scalers.

The JAX package's ``data/features.py``, in the port's own copy (numpy only):

  * X = concat([TEC[..., None], five broadcast indices], axis=-1) -> (T, 41, 71, 6);
  * Y[t] = TEC[t+1 .. t+horizon] transposed to (41, 71, horizon) -> (T-horizon, 41, 71, H),
    through a vectorized ``sliding_window_view``;
  * time features per step: [hour//2, dayofyear-1, year - base_year, season]
    with season = (month % 12 + 3)//3 - 1 and one base year for the whole
    archive;
  * X and time_features are truncated to len(Y);
  * the feature scaler is fit on train X reshaped (-1, 6) and applied to all
    splits; the target scaler is fit on train Y and applied to Y of every split.
"""

from __future__ import annotations

import logging

import numpy as np

from tec_mollm_tpu_torch.data.hdf5_io import check_cadence, compute_segments, load_and_split_data
from tec_mollm_tpu_torch.data.scaler import StandardScaler

logger = logging.getLogger(__name__)


def broadcast_indices(indices: np.ndarray, spatial_shape: tuple[int, int]) -> np.ndarray:
    """(T, 5) space-weather indices -> (T, H, W, 5) via broadcast
    (reference feature_engineering.py:27-36 broadcasts each index separately)."""
    t, k = indices.shape
    return np.broadcast_to(indices[:, None, None, :], (t,) + spatial_shape + (k,))


def construct_feature_tensor(tec: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """X = [TEC | AE | Dst | F107 | Kp | ap] -> (T, H, W, 6)."""
    broadcast = broadcast_indices(indices, tec.shape[1:])
    return np.concatenate([tec[..., None], broadcast], axis=-1)


def construct_target_tensor(tec: np.ndarray, horizon: int = 12) -> np.ndarray:
    """Y[t, i, j, k] = tec[t + 1 + k, i, j] for k in [0, horizon).

    Matches the reference loop (feature_engineering.py:63-65) but vectorized:
    sliding_window_view over the time axis of tec[1:].
    """
    num_targets = tec.shape[0] - horizon
    if num_targets <= 0:
        raise ValueError(f"Need > {horizon} timesteps, got {tec.shape[0]}")
    windows = np.lib.stride_tricks.sliding_window_view(tec[1:], horizon, axis=0)
    # windows: (T - horizon, H, W, horizon), windows[t, i, j, k] == tec[1 + t + k, i, j]
    return np.ascontiguousarray(windows[:num_targets]).astype(tec.dtype)


def extract_time_features(times: np.ndarray, base_year: int | None = None) -> np.ndarray:
    """(T,) datetime64 -> (T, 4) int32 [tod_slot, doy0, year_index, season]
    (reference feature_engineering.py:69-102).

    tod_slot = hour // 2 in [0, 12); doy0 = dayofyear - 1 in [0, 366);
    year_index = year - base_year; season: DJF=0 MAM=1 JJA=2 SON=3.

    `base_year` anchors the year index. The reference computes
    `year - min(year)` over whatever slice it is handed — and it is handed each
    SPLIT separately (feature_engineering.py:90-91 inside the per-split loop),
    so its val (2022-23) and test (2024-25) windows get year indices 0-1,
    COLLIDING with train's 2013-14 rows. The model then recalls 2013/2014-
    specific content on 2022+ data (measured at 9-year archive scale: val Huber
    stuck at ~4x train while the model memorizes — BASELINE.md round 3).
    build_split_tensors therefore passes the min year of the WHOLE archive so
    every split indexes the same table rows; base_year=None keeps the
    per-slice reference behavior for isolated use.
    """
    times = np.asarray(times, dtype="datetime64[s]")
    hours = times.astype("datetime64[h]").astype(np.int64) % 24
    days = times.astype("datetime64[D]")
    years_d = times.astype("datetime64[Y]")
    doy0 = (days - years_d.astype("datetime64[D]")).astype(np.int64)
    years = years_d.astype(np.int64) + 1970
    months = times.astype("datetime64[M]").astype(np.int64) % 12 + 1
    tod = hours // 2
    year_index = years - (int(years.min()) if base_year is None else base_year)
    season = (months % 12 + 3) // 3 - 1
    return np.stack([tod, doy0, year_index, season], axis=-1).astype(np.int32)


def create_features_and_targets(file_paths: list[str], horizon: int = 12) -> dict[str, dict[str, np.ndarray]]:
    """The whole pipeline per split: the HDF5 files split by year, then the
    aligned (X, Y, time_features) of each split."""
    return build_split_tensors(load_and_split_data(file_paths), horizon)


def build_split_tensors(
    data_splits: dict[str, dict[str, np.ndarray]],
    horizon: int = 12,
    cadence_policy: str = "warn",
) -> dict[str, dict[str, np.ndarray]]:
    """Split dicts {tec, time, space_weather_indices} -> aligned {X, Y, time_features}.

    ``cadence_policy`` governs within-split timestamp irregularities (outages,
    out-of-order files), which corrupt raw-position windows (reference
    dataset.py:46-53 assumes continuity):
      * "warn"    — log loudly, build everything anyway (reference-equivalent);
      * "raise"   — abort preprocessing on any irregularity;
      * "segment" — attach a raw-length ``segment_id`` array (hdf5_io.compute_segments,
        with mostly-non-finite TEC steps flagged bad via the split's optional
        ``bad_steps`` mask) so the windowing layers drop exactly the windows
        that would span a discontinuity (hdf5_io.valid_window_starts).
    """
    if cadence_policy not in ("warn", "raise", "segment"):
        raise ValueError(f"unknown cadence_policy {cadence_policy!r}")
    # one archive-wide base year so train/val/test index the same embedding rows
    # (the reference's per-split min-year makes val/test collide with the first
    # train years — see extract_time_features)
    base_year = min(
        int(np.asarray(d["time"], dtype="datetime64[Y]").astype(np.int64).min()) + 1970
        for d in data_splits.values()
        if len(d["time"])
    )
    processed: dict[str, dict[str, np.ndarray]] = {}
    for split_name, data in data_splits.items():
        # windows/targets index raw positions, so WITHIN-split gaps corrupt
        # them (gaps at split boundaries are benign — windows are per split)
        irregular = check_cadence(data["time"], context=f"split '{split_name}'")
        if cadence_policy == "raise" and irregular:
            raise ValueError(
                f"split '{split_name}' has {irregular} timestamp irregularities "
                "(cadence_policy='raise'; use 'segment' to window around them)"
            )
        x = construct_feature_tensor(data["tec"], data["space_weather_indices"])
        y = construct_target_tensor(data["tec"], horizon)
        tf = extract_time_features(data["time"], base_year=base_year)
        num_targets = y.shape[0]
        processed[split_name] = {
            "X": x[:num_targets],
            "Y": y,
            "time_features": tf[:num_targets],
        }
        if cadence_policy == "segment":
            # RAW length (num_targets + horizon): valid_window_starts checks
            # the target's reach beyond the truncated X
            processed[split_name]["segment_id"] = compute_segments(
                data["time"], bad_steps=data.get("bad_steps")
            )
        logger.info(
            "split %-5s: X %s Y %s tf %s",
            split_name,
            processed[split_name]["X"].shape,
            y.shape,
            processed[split_name]["time_features"].shape,
        )
    return processed


def standardize_features(
    processed_splits: dict[str, dict[str, np.ndarray]],
    scaler_path: str | None = None,
) -> tuple[dict[str, dict[str, np.ndarray]], StandardScaler]:
    """Fit a per-feature scaler on train X, transform X of all splits
    (reference feature_engineering.py:146-194). Y and time_features pass through."""
    x_train = processed_splits["train"]["X"]
    scaler = StandardScaler().fit(x_train.reshape(-1, x_train.shape[-1]))
    if scaler_path:
        scaler.save(scaler_path)

    out: dict[str, dict[str, np.ndarray]] = {}
    for name, data in processed_splits.items():
        x = data["X"]
        # float32 fast path: one output allocation, no full-size float64
        # temporaries (the 13-year archive splits are multi-GB)
        x_scaled = scaler.transform(
            x.reshape(-1, x.shape[-1]), dtype=np.float32
        ).reshape(x.shape)
        out[name] = dict(data)
        out[name]["X"] = x_scaled
    return out, scaler


def standardize_targets(
    processed_splits: dict[str, dict[str, np.ndarray]],
    scaler_path: str | None = None,
) -> tuple[dict[str, dict[str, np.ndarray]], StandardScaler]:
    """Fit a single-feature scaler on train Y and scale Y of every split
    (reference preprocess.py:45-82)."""
    y_train = processed_splits["train"]["Y"]
    scaler = StandardScaler().fit(y_train.reshape(-1, 1))
    if scaler_path:
        scaler.save(scaler_path)

    out: dict[str, dict[str, np.ndarray]] = {}
    for name, data in processed_splits.items():
        y = data["Y"]
        y_scaled = scaler.transform(y.reshape(-1, 1), dtype=np.float32).reshape(
            y.shape
        )
        out[name] = dict(data)
        out[name]["Y"] = y_scaled
    return out, scaler
