"""Synthetic data for hermetic tests and benchmarks (numpy only).

The JAX package's ``data/synthetic.py``, in the port's own copy: (a) in-memory
archives with the statistical structure of the CRIM data (diurnal and
seasonal TEC cycles over the lat/lon grid, optionally an 11-year solar cycle
with storms), (b) small on-disk HDF5 files in the exact CRIM layout that
``data/hdf5_io.py`` reads, and (c) a processed split made directly. Draws are
the JAX package's, so both packages make the same arrays from one seed.
"""

from __future__ import annotations

import numpy as np

from tec_mollm_tpu_torch.graph.builder import grid_coordinates

__all__ = ["grid_coordinates", "synthetic_processed_split", "synthetic_raw_data", "write_synthetic_hdf5"]


def synthetic_raw_data(
    num_steps: int = 240,
    grid_h: int = 41,
    grid_w: int = 71,
    start: str = "2014-01-01T00:00:00",
    seed: int = 0,
    times: np.ndarray | None = None,
    solar_cycle: bool = False,
) -> dict[str, np.ndarray]:
    """In-memory equivalent of one aggregated CRIM dataset.

    TEC follows a physically plausible pattern: a latitude-dependent mean plus diurnal
    and seasonal cycles plus noise, clipped to [0, 200] TECU. Space-weather indices are
    smooth random walks. 2-hour cadence (12 steps/day) like the real data.

    `times` (datetime64[s], len num_steps) overrides the contiguous range from
    `start`; the diurnal/seasonal pattern is computed FROM the given timestamps,
    so callers that piece together disjoint calendar ranges (preprocess
    --synthetic spreads data over the train/val/test year windows) get TEC whose
    phase is consistent with its time-feature labels. Without this, val/test
    carried day-of-year labels from a different season than their data — the
    time embeddings then actively mislead any trained model on those splits.

    `solar_cycle=True` (opt-in; the default output is bit-identical to before
    the flag existed) adds the two kinds of nonstationarity the default lacks,
    making multi-year experiments meaningful:

    * an ~11-year activity cycle (maxima mid-2014 and early 2025, minimum
      ~2020, like real solar cycles 24/25) multiplicatively modulates TEC
      amplitude — so the 2013-21 train split and the 2024+ test split sit at
      DIFFERENT activity levels, a genuine distribution shift;
    * the space-weather indices become physically coupled to TEC instead of
      uninformative random walks: F10.7 tracks the activity level, geomagnetic
      storms (random onsets, exponential ~18 h recovery) spike Kp/ap/AE and
      depress Dst, and TEC responds to each storm with a lagged depletion —
      so the 5 index input channels carry real predictive signal.
    """
    rng = np.random.default_rng(seed)
    lat, lon = grid_coordinates(grid_h, grid_w)
    if times is None:
        times = np.datetime64(start, "s") + np.arange(num_steps) * np.timedelta64(
            7200, "s"
        )
    else:
        times = np.asarray(times, dtype="datetime64[s]")
        if times.shape != (num_steps,):
            raise ValueError(f"times has shape {times.shape}, want ({num_steps},)")

    hours = times.astype("datetime64[h]").astype(np.int64) % 24
    days = times.astype("datetime64[D]").astype(np.int64)
    diurnal = np.sin(2 * np.pi * (hours[:, None, None] - 14) / 24.0)
    seasonal = np.cos(2 * np.pi * days[:, None, None] / 365.25)
    lat_profile = 30.0 - 0.3 * np.abs(lat[None, :, None] - lat.mean())
    noise = rng.normal(0, 1.5, size=(num_steps, grid_h, grid_w))

    if solar_cycle:
        # Separate stream so the default path's draws stay bit-identical.
        rng_sc = np.random.default_rng(np.random.SeedSequence([seed, 0x5C]))
        day_f = times.astype(np.int64) / 86400.0  # float days since epoch
        peak = np.datetime64("2014-07-01T00:00:00", "s").astype(np.int64) / 86400.0
        # activity in [0, 1]: 11-year (4015-day) cycle; 2014 max, ~2020 min,
        # early-2025 max — train (2013-21) spans max->min, test (2024+) is at
        # the NEXT maximum.
        activity = 0.5 + 0.5 * np.cos(2 * np.pi * (day_f - peak) / 4015.0)
        # Storm onsets: a few per month at solar max, rare at minimum; each has
        # a gamma-distributed magnitude and an exponential ~18 h (9-step) tail.
        onset_p = (0.02 + 0.10 * activity) / 12.0  # per 2-hour step
        mag = rng_sc.gamma(2.0, 1.2, size=num_steps) * (
            rng_sc.random(num_steps) < onset_p
        )
        kern = np.exp(-np.arange(24) / 9.0)
        storm = np.convolve(mag, kern)[:num_steps]  # Kp excess above quiet
        kp = np.clip(
            2.0 + storm + rng_sc.normal(0, 0.3, num_steps), 0.0, 9.0
        )
        f107 = 70.0 + 150.0 * activity + rng_sc.normal(0, 6.0, num_steps)
        dst = -10.0 - 25.0 * storm + rng_sc.normal(0, 4.0, num_steps)
        ae = 80.0 + 150.0 * storm + rng_sc.normal(0, 25.0, num_steps)
        ap = 3.0 * np.exp(kp / 2.2)  # roughly the real Kp->ap quasi-log table
        indices = np.stack([ae, dst, f107, kp, ap], axis=-1).astype(np.float32)
        # TEC amplitude follows activity; storms deplete TEC with a 3-step
        # (6-hour) lag — so an input window that saw the Kp spike carries the
        # information needed to predict the depletion/recovery that follows.
        amp = (0.55 + 0.9 * activity)[:, None, None]
        lagged = np.concatenate([np.zeros(3), storm[:-3]])
        depletion = (-1.5 * lagged)[:, None, None]
        tec = (lat_profile + 12.0 * diurnal + 5.0 * seasonal) * amp + depletion + noise
    else:
        tec = lat_profile + 12.0 * diurnal + 5.0 * seasonal + noise
        walks = np.cumsum(rng.normal(0, 1, size=(num_steps, 5)), axis=0)
        base = np.array([200.0, -20.0, 120.0, 3.0, 15.0])
        scale = np.array([50.0, 10.0, 20.0, 0.5, 5.0])
        indices = (
            base + scale * walks / np.sqrt(np.arange(1, num_steps + 1))[:, None]
        ).astype(np.float32)

    tec = np.clip(tec, 0.0, 200.0).astype(np.float32)

    return {
        "tec": tec,
        "time": times,
        "space_weather_indices": indices,
        "latitude": lat,
        "longitude": lon,
    }


def write_synthetic_hdf5(
    path: str,
    year: int = 2014,
    num_steps: int = 48,
    grid_h: int = 41,
    grid_w: int = 71,
    seed: int = 0,
) -> None:
    """Write a miniature CRIM-layout HDF5 file (same dataset paths as hdf5_io.py expects,
    including the Kp scale_factor attribute exercised by data_loader.py:47-50)."""
    import h5py

    raw = synthetic_raw_data(
        num_steps=num_steps,
        grid_h=grid_h,
        grid_w=grid_w,
        start=f"{year}-01-01T00:00:00",
        seed=seed + year,
    )
    time_strs = np.array(
        [np.datetime_as_string(t, unit="s").encode() for t in raw["time"]]
    )
    with h5py.File(path, "w") as f:
        f.create_dataset("ionosphere/TEC", data=raw["tec"])
        f.create_dataset("coordinates/datetime_utc", data=time_strs)
        f.create_dataset("coordinates/latitude", data=raw["latitude"])
        f.create_dataset("coordinates/longitude", data=raw["longitude"])
        names = ["AE_Index", "Dst_Index", "F107_Index", "Kp_Index", "ap_Index"]
        for i, name in enumerate(names):
            col = raw["space_weather_indices"][:, i]
            if name == "Kp_Index":
                # store scaled-by-10 ints with a scale_factor attr, like the real files
                ds = f.create_dataset(
                    f"space_weather_indices/{name}", data=np.round(col * 10).astype(np.int32)
                )
                ds.attrs["scale_factor"] = 0.1
            else:
                f.create_dataset(f"space_weather_indices/{name}", data=col)


def synthetic_processed_split(
    num_windows: int,
    L_in: int,
    L_out: int,
    num_nodes: int,
    in_features: int = 6,
    num_years: int = 13,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Directly fabricate a processed split {X, Y, time_features} (already standardized)
    of exactly the length needed for `num_windows` stride-1 windows."""
    rng = np.random.default_rng(seed)
    # SlidingWindowDataset counts T - L_in - L_out + 1 stride-1 windows
    # (reference dataset.py:46), so:
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
