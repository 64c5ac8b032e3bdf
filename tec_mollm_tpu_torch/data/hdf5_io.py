"""HDF5 ingestion: raw CRIM space-weather files -> aggregated, temporally split arrays.

The JAX package's ``data/hdf5_io.py``, in the port's own copy (numpy only):

  * each file holds ``ionosphere/TEC`` (T, 41, 71), ``coordinates/datetime_utc``
    (T,) byte-string timestamps, ``coordinates/latitude`` (41) / ``longitude``
    (71), and a ``space_weather_indices`` group with AE/Dst/F107/Kp/ap (T,);
  * Kp is multiplied by its ``scale_factor`` attribute;
  * the five indices stack to (T, 5) in order [AE, Dst, F107, Kp, ap];
  * files concatenate along time; coordinates come from the first file;
  * temporal split: train <= 2021-12-31, val 2022-01-01..2023-12-31, test >=
    2024-01-01; static keys are copied into every split;
  * gap tolerance: ``compute_segments`` and ``valid_window_starts`` drop
    exactly the windows that span an outage or a bad step.

``h5py`` is imported inside the reader only: the synthetic path of the
preprocess CLI runs where it is not installed.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

INDEX_NAMES = ("AE_Index", "Dst_Index", "F107_Index", "Kp_Index", "ap_Index")

TEC_KEY = "ionosphere/TEC"
TIME_KEY = "coordinates/datetime_utc"
LAT_KEY = "coordinates/latitude"
LON_KEY = "coordinates/longitude"
SW_GROUP = "space_weather_indices"


def load_hdf5_file(file_path: str) -> dict[str, np.ndarray]:
    """Read one CRIM HDF5 file into {tec, time, space_weather_indices, latitude, longitude}.

    Raises on missing required datasets rather than returning an empty dict (the
    reference logs-and-returns-{} at data_loader.py:28-37, which silently drops files).
    """
    import h5py  # local import: keep h5py optional for pure-synthetic workflows

    data: dict[str, np.ndarray] = {}
    with h5py.File(file_path, "r") as f:
        if TEC_KEY not in f:
            raise KeyError(f"{TEC_KEY} not found in {file_path}")
        if TIME_KEY not in f:
            raise KeyError(f"{TIME_KEY} not found in {file_path}")
        data["tec"] = f[TEC_KEY][:]
        data["time"] = f[TIME_KEY][:]

        if SW_GROUP in f:
            cols = []
            for name in INDEX_NAMES:
                ds = f[f"{SW_GROUP}/{name}"]
                arr = ds[:].astype(np.float64)
                # Kp ships as scaled integers with a scale_factor attribute
                # (reference data_loader.py:47-50 applies it only to Kp).
                if name == "Kp_Index":
                    arr = arr * float(ds.attrs.get("scale_factor", 1.0))
                cols.append(arr)
            data["space_weather_indices"] = np.stack(cols, axis=-1)
        else:
            logger.warning("%s group not found in %s", SW_GROUP, file_path)

        if LAT_KEY in f and LON_KEY in f:
            data["latitude"] = f[LAT_KEY][:]
            data["longitude"] = f[LON_KEY][:]

    return data


def decode_times(raw_time: np.ndarray) -> np.ndarray:
    """Byte-string timestamps -> numpy datetime64[s] (reference data_loader.py:114-121)."""
    if np.issubdtype(raw_time.dtype, np.datetime64):
        return raw_time.astype("datetime64[s]")
    if raw_time.dtype.kind in ("S", "O"):
        decoded = np.char.decode(raw_time.astype("S32"))
    else:
        decoded = raw_time
    return np.asarray(decoded, dtype="datetime64[s]")


def check_cadence(times: np.ndarray, context: str = "") -> int:
    """Diagnose timestamp irregularities; returns the number of irregular steps.

    The reference assumes a perfectly uniform 2-hour archive (its sliding
    windows index raw positions, dataset.py:46-53) and would silently build
    windows/targets spanning any gap. Real multi-year archives have outages,
    so this beyond-reference check warns — loudly, with locations — when
    (a) timestamps are not strictly increasing (files concatenated out of
    order corrupt every window) or (b) the cadence has gaps (windows crossing
    a gap mix non-adjacent epochs; targets 'horizon steps ahead' silently
    reach further into the future than configured).
    """
    t = np.asarray(times, dtype="datetime64[s]").astype(np.int64)
    if t.size < 2:
        return 0
    deltas = np.diff(t)
    where = f" in {context}" if context else ""
    nonmono = np.flatnonzero(deltas <= 0)
    if nonmono.size:
        logger.warning(
            "%d non-increasing timestamp step(s)%s (first at index %d: %s -> %s) "
            "— input files are likely concatenated out of order; every window "
            "built from this range is corrupt",
            nonmono.size, where, int(nonmono[0]),
            np.datetime64(int(t[nonmono[0]]), "s"),
            np.datetime64(int(t[nonmono[0] + 1]), "s"),
        )
    step = int(np.median(deltas))
    gaps = np.flatnonzero((deltas != step) & (deltas > 0))
    if gaps.size:
        logger.warning(
            "%d cadence gap(s)%s (median step %d s; first gap of %d s after %s) "
            "— sliding windows spanning a gap will mix non-adjacent epochs",
            gaps.size, where, step, int(deltas[gaps[0]]),
            np.datetime64(int(t[gaps[0]]), "s"),
        )
    return int(nonmono.size + gaps.size)


def compute_segments(
    times: np.ndarray, bad_steps: np.ndarray | None = None
) -> np.ndarray:
    """Per-timestep contiguity segment ids for gap-tolerant windowing.

    Real CRIM archives have outages; the reference would silently build windows
    spanning them (data_loader.py:84-130 assumes continuity; dataset.py:46-53
    indexes raw positions). Instead of aborting the whole split, windowing can
    drop exactly the windows that cross a discontinuity: this returns an int32
    array where two timesteps share an id iff every step between them is present
    at the archive's median cadence (and, optionally, not flagged bad).

    ``bad_steps`` (bool, per step) marks unusable timesteps (e.g. mostly-NaN
    TEC maps): they get id -1 and break the segments around them, so no window
    can contain or span one.
    """
    t = np.asarray(times, dtype="datetime64[s]").astype(np.int64)
    n = t.size
    seg = np.zeros(n, dtype=np.int32)
    if n == 0:
        return seg
    breaks = np.zeros(n, dtype=bool)
    if n > 1:
        deltas = np.diff(t)
        step = int(np.median(deltas))
        breaks[1:] = (deltas != step) | (deltas <= 0)
    if bad_steps is not None:
        bad = np.asarray(bad_steps, dtype=bool)
        breaks[1:] |= bad[:-1]  # a new segment starts after every bad step
    seg = np.cumsum(breaks).astype(np.int32)
    if bad_steps is not None:
        seg[np.asarray(bad_steps, dtype=bool)] = -1
    return seg


def valid_window_starts(
    starts: np.ndarray, segment_id: np.ndarray, L_in: int, L_out: int
) -> np.ndarray:
    """Filter window starts to those whose full raw span sits in one segment.

    A window at start i consumes X[i : i+L_in] and the target Y[i+L_in-1],
    which reaches raw steps [i+L_in, i+L_in+L_out-1] — the contiguity span is
    [i, i+L_in+L_out-1]. ``segment_id`` must cover the RAW (untruncated) length.
    """
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


def aggregate_files(file_paths: list[str]) -> dict[str, np.ndarray]:
    """Concatenate per-year files along time; decode timestamps; keep static coords
    from the first file (reference data_loader.py:84-130)."""
    per_file = [load_hdf5_file(p) for p in file_paths]
    if not per_file:
        raise ValueError("No input files given")

    aggregated: dict[str, np.ndarray] = {}
    for key in ("tec", "time", "space_weather_indices"):
        parts = [d[key] for d in per_file if key in d]
        if parts:
            aggregated[key] = np.concatenate(parts, axis=0)
    aggregated["time"] = decode_times(aggregated["time"])
    for key in ("latitude", "longitude"):
        if key in per_file[0]:
            aggregated[key] = per_file[0][key]
    check_cadence(aggregated["time"], context="aggregated archive")
    return aggregated


def split_by_time(
    aggregated: dict[str, np.ndarray],
    train_end: str = "2021-12-31 23:59:59",
    val_start: str = "2022-01-01 00:00:00",
    val_end: str = "2023-12-31 23:59:59",
    test_start: str = "2024-01-01 00:00:00",
) -> dict[str, dict[str, np.ndarray]]:
    """Boolean-mask temporal split (reference data_loader.py:132-178).

    Time-varying arrays (ndim > 1, plus 'time' itself) are masked; static arrays
    (latitude/longitude) are copied into every split unchanged.
    """
    times = aggregated["time"]

    def ts(s: str) -> np.datetime64:
        return np.datetime64(s.replace(" ", "T"), "s")

    masks = {
        "train": times <= ts(train_end),
        "val": (times >= ts(val_start)) & (times <= ts(val_end)),
        "test": times >= ts(test_start),
    }
    splits: dict[str, dict[str, np.ndarray]] = {}
    for name, mask in masks.items():
        split: dict[str, np.ndarray] = {}
        for key, value in aggregated.items():
            if key == "time" or (hasattr(value, "ndim") and value.ndim > 1):
                split[key] = value[mask]
            else:
                split[key] = value
        splits[name] = split
        logger.info("split %-5s: %d timesteps", name, len(split["time"]))
    return splits


def load_and_split_data(
    file_paths: list[str],
    train_end: str = "2021-12-31 23:59:59",
    val_start: str = "2022-01-01 00:00:00",
    val_end: str = "2023-12-31 23:59:59",
    test_start: str = "2024-01-01 00:00:00",
) -> dict[str, Any]:
    """Load + aggregate + split (reference data_loader.py:180-207)."""
    aggregated = aggregate_files(file_paths)
    return split_by_time(aggregated, train_end, val_start, val_end, test_start)
