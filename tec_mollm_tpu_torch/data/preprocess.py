"""Offline preprocessing CLI: raw HDF5 -> standardized npz splits + scalers + graph.

``python -m tec_mollm_tpu_torch.data.preprocess``, the JAX package's
``data/preprocess.py`` with its flags and files, in the port (numpy only; no
JAX, and ``h5py`` only to read HDF5):
  1. load + aggregate + split the per-year HDF5 files;
  2. build aligned (X, Y, time_features) per split;
  3. fit the feature scaler on train X, transform all splits (scaler.npz);
  4. fit the target scaler on train Y, scale Y everywhere (target_scaler.npz);
  5. save {split}_set.npz with node-flattened X (T,N,C), Y (T,N,L_out), tf (T,4),
     and {split}_raw.npz with the de-duplicated raw series the device-resident
     archive reads (segment ids under ``segment`` cadence);
  6. build the geographic graph from the file coordinates -> graph.npz.

``--synthetic N`` generates an N-step synthetic archive instead of reading HDF5
(the hermetic path of the tests and ``chip_smoke.py``).

Usage:
    python -m tec_mollm_tpu_torch.data.preprocess [--raw-dir data/raw] [--out data/processed]
    python -m tec_mollm_tpu_torch.data.preprocess --synthetic 2000 --out /tmp/proc
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from tec_mollm_tpu_torch.config import Config, DataConfig
from tec_mollm_tpu_torch.data.features import (
    build_split_tensors,
    standardize_features,
    standardize_targets,
)
from tec_mollm_tpu_torch.data.hdf5_io import compute_segments, load_and_split_data, split_by_time
from tec_mollm_tpu_torch.data.synthetic import synthetic_raw_data
from tec_mollm_tpu_torch.graph.builder import build_graph
from tec_mollm_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)


def flatten_grid(split: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """(T, H, W, C) -> (T, H*W, C): done once offline instead of per batch
    (reference reshapes per batch, train.py:62)."""
    t = split["X"].shape[0]
    out = {
        "X": split["X"].reshape(t, -1, split["X"].shape[-1]).astype(np.float32),
        "Y": split["Y"].reshape(t, -1, split["Y"].shape[-1]).astype(np.float32),
        "time_features": split["time_features"].astype(np.int32),
    }
    if "segment_id" in split:  # raw-length contiguity ids (cadence_policy=segment)
        out["segment_id"] = split["segment_id"].astype(np.int32)
    return out


def sanitize_raw_tec(splits: dict[str, dict[str, np.ndarray]]) -> None:
    """Guard against NaN/inf in raw TEC and space-weather arrays (in place).

    The reference only nan-guards at METRIC time (metrics.py:137-144) — a NaN
    in the raw archive would silently poison the scaler fit and every training
    loss. Here non-finite raw values are counted, logged loudly, and replaced
    with 0 before feature construction (the same nan_to_num stance the
    reference applies downstream). Timesteps whose TEC map is mostly
    (>``bad_step_frac``) non-finite are additionally recorded in a per-split
    ``bad_steps`` mask: under cadence_policy='segment' such dropout steps are
    excluded from every window (features.build_split_tensors) instead of
    entering training as mostly-zero maps."""
    bad_step_frac = 0.5
    for name, data in splits.items():
        for key in ("tec", "space_weather_indices"):
            arr = data.get(key)
            if arr is None:
                continue
            bad = ~np.isfinite(arr)
            n_bad = int(bad.sum())
            if n_bad:
                if key == "tec" and arr.ndim >= 2:
                    frac = bad.reshape(arr.shape[0], -1).mean(axis=1)
                    data["bad_steps"] = frac > bad_step_frac
                    n_bad_steps = int(data["bad_steps"].sum())
                    if n_bad_steps:
                        logger.warning(
                            "split %s: %d timestep(s) with >%d%% non-finite TEC "
                            "flagged bad (windowed around under "
                            "cadence_policy='segment')",
                            name, n_bad_steps, int(bad_step_frac * 100),
                        )
                logger.warning(
                    "split %s: %d non-finite values (%.4f%%) in %s -> replaced with 0",
                    name, n_bad, 100.0 * n_bad / arr.size, key,
                )
                data[key] = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)


def run_preprocess(
    data_cfg: DataConfig,
    out_dir: str,
    synthetic_steps: int | None = None,
    synthetic_grid: tuple[int, int] = (41, 71),
    seed: int = 0,
    solar_cycle: bool = False,
    cadence_policy: str = "warn",
    synthetic_drop: tuple[int, int] | None = None,
) -> dict[str, int]:
    os.makedirs(out_dir, exist_ok=True)

    if synthetic_steps is not None:
        gh, gw = synthetic_grid
        # Spread the synthetic time range so all three splits are populated:
        # nominally 60% train (<=2021), 25% val (2022-23), 15% test (>=2024).
        # Each piece is CAPACITY-AWARE: at 2-h cadence the val window holds only
        # 2 years (~8766 steps) and test ~2 years — a naive 25% of a 13-year-
        # sized archive would spill past the split mask and be SILENTLY DROPPED
        # (caught by the r3 scale rehearsal: 57k steps kept only 4.4k train).
        # Overflow beyond a piece's span goes to train, whose window is anchored
        # to END at 2021-12-31 (the reference's 2013-2021 train years).
        t = synthetic_steps
        step_s = np.timedelta64(7200, "s")

        def span_steps(start: str, end: str) -> int:
            return int(
                (np.datetime64(end, "s") - np.datetime64(start, "s"))
                // step_s
            )

        train_cap = span_steps("2013-01-01T00:00:00", "2022-01-01T00:00:00")
        val_cap = span_steps("2022-01-01T00:00:00", "2024-01-01T00:00:00")
        test_cap = span_steps("2024-01-01T00:00:00", "2026-01-01T00:00:00")
        val_n = min(int(t * 0.25), val_cap)
        test_n = min(t - int(t * 0.6) - int(t * 0.25), test_cap)
        train_n = t - val_n - test_n
        if train_n > train_cap:
            # train overflow spills into whatever test/val capacity the 15%/25%
            # formulas left unused, so every t up to the advertised archive
            # maximum is actually accepted
            spill = train_n - train_cap
            to_test = min(spill, test_cap - test_n)
            test_n += to_test
            val_n += min(spill - to_test, val_cap - val_n)
            train_n = t - val_n - test_n
        if train_n > train_cap:
            raise ValueError(
                f"--synthetic {t} exceeds the 2013-2025 archive capacity "
                f"(max {train_cap + val_cap + test_cap} steps at 2-h cadence)"
            )
        times = np.concatenate([
            np.datetime64("2022-01-01T00:00:00", "s") - train_n * step_s
            + np.arange(train_n) * step_s,
            np.datetime64("2022-01-01T00:00:00", "s")
            + np.arange(val_n) * step_s,
            np.datetime64("2024-01-01T00:00:00", "s")
            + np.arange(test_n) * step_s,
        ])
        raw = synthetic_raw_data(
            num_steps=synthetic_steps, grid_h=gh, grid_w=gw, seed=seed,
            times=times, solar_cycle=solar_cycle,
        )
        if synthetic_drop is not None:
            # carve a real outage into the archive (gap-tolerance fixture):
            # drop `count` consecutive steps starting at archive index `start`
            start, count = synthetic_drop
            keep = np.ones(raw["time"].shape[0], dtype=bool)
            keep[start : start + count] = False
            for key in ("tec", "time", "space_weather_indices"):
                raw[key] = raw[key][keep]
            logger.info(
                "synthetic outage: dropped steps [%d, %d) -> %d remain",
                start, start + count, int(keep.sum()),
            )
        splits = split_by_time(
            raw, data_cfg.train_end, data_cfg.val_start, data_cfg.val_end,
            data_cfg.test_start,
        )
    else:
        paths = [p for p in data_cfg.file_paths() if os.path.exists(p)]
        if not paths:
            raise FileNotFoundError(
                f"No HDF5 files found under {data_cfg.raw_dir} "
                f"(expected {data_cfg.file_pattern})"
            )
        logger.info("loading %d HDF5 files", len(paths))
        splits = load_and_split_data(
            paths, data_cfg.train_end, data_cfg.val_start, data_cfg.val_end,
            data_cfg.test_start,
        )

    sanitize_raw_tec(splits)
    # De-duplicated raw series per split, read by the device-resident archive
    # (data/device_data.py). The materialized X/Y windows are ~48x redundant
    # (every timestep appears in L_in windows) and the five space-weather
    # indices are broadcast to all N nodes; the raw form, TEC (T, N) plus the
    # indices (T, 5), is ~18x smaller and fits in device memory, where
    # windows are gathered instead of streamed from the host.
    for name, data in splits.items():
        t = data["tec"].shape[0]
        raw_payload = {
            "tec": data["tec"].reshape(t, -1).astype(np.float32),
            "sw": data["space_weather_indices"].astype(np.float32),
        }
        if cadence_policy == "segment":
            raw_payload["segment_id"] = compute_segments(
                data["time"], bad_steps=data.get("bad_steps")
            )
        np.savez(os.path.join(out_dir, f"{name}_raw.npz"), **raw_payload)
    tensors = build_split_tensors(
        splits, horizon=data_cfg.horizon, cadence_policy=cadence_policy
    )
    tensors, _ = standardize_features(
        tensors, scaler_path=os.path.join(out_dir, "scaler.npz")
    )
    tensors, _ = standardize_targets(
        tensors, scaler_path=os.path.join(out_dir, "target_scaler.npz")
    )

    sizes = {}
    for name, data in tensors.items():
        flat = flatten_grid(data)
        np.savez(os.path.join(out_dir, f"{name}_set.npz"), **flat)
        sizes[name] = flat["X"].shape[0]
        logger.info("saved %s_set.npz: X %s", name, flat["X"].shape)

    lat = splits["train"]["latitude"]
    lon = splits["train"]["longitude"]
    graph = build_graph(
        lat, lon,
        distance_threshold_km=data_cfg.distance_threshold_km,
        earth_radius_km=data_cfg.earth_radius_km,
    )
    graph.save(os.path.join(out_dir, "graph.npz"))
    logger.info(
        "saved graph.npz: %d nodes, %d edges, max degree %d",
        graph.num_nodes, graph.edge_index.shape[1], graph.max_degree,
    )

    with open(os.path.join(out_dir, "preprocess_meta.json"), "w") as f:
        json.dump(
            {
                "sizes": sizes,
                "horizon": data_cfg.horizon,
                "grid": [len(lat), len(lon)],
                "synthetic": synthetic_steps is not None,
            },
            f,
        )
    return sizes


def main(argv: list[str] | None = None) -> dict[str, int]:
    parser = argparse.ArgumentParser(description="Offline preprocessing")
    parser.add_argument("--raw-dir", default="data/raw")
    parser.add_argument("--out", default="data/processed")
    parser.add_argument("--horizon", type=int, default=12)
    parser.add_argument("--synthetic", type=int, default=None, metavar="STEPS",
                        help="generate a synthetic dataset with STEPS timesteps")
    parser.add_argument("--synthetic-grid", type=int, nargs=2, default=(41, 71))
    parser.add_argument("--solar-cycle", action="store_true",
                        help="synthetic realism: 11-year activity cycle modulating "
                        "TEC amplitude + space-weather indices physically coupled "
                        "to TEC (storm depletions) instead of uninformative walks")
    parser.add_argument("--config", default=None, help="config json path")
    parser.add_argument("--cadence-policy", default="warn",
                        choices=("warn", "raise", "segment"),
                        help="within-split timestamp gaps: warn (reference-"
                        "equivalent), raise (abort), or segment (drop exactly "
                        "the windows that would span a gap/bad step)")
    parser.add_argument("--synthetic-drop", type=int, nargs=2, default=None,
                        metavar=("START", "COUNT"),
                        help="carve an outage into the synthetic archive: drop "
                        "COUNT consecutive steps at archive index START")
    args = parser.parse_args(argv)

    setup_logging()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
        data_cfg = cfg.data
    else:
        data_cfg = DataConfig(raw_dir=args.raw_dir, horizon=args.horizon)

    sizes = run_preprocess(
        data_cfg, args.out,
        synthetic_steps=args.synthetic,
        synthetic_grid=tuple(args.synthetic_grid),
        solar_cycle=args.solar_cycle,
        cadence_policy=args.cadence_policy,
        synthetic_drop=(
            tuple(args.synthetic_drop) if args.synthetic_drop else None
        ),
    )
    logger.info("done: %s", sizes)
    return sizes


if __name__ == "__main__":
    main()
