"""Evaluation harness on one GPU: a checkpoint against the Historical-Average
baseline on a processed split (``evaluation/harness.py`` of the JAX package,
in PyTorch).

* windows at stride 1, padded to the eval batch with ``valid`` flags (one
  shape on the card, so one GAT kernel configuration);
* the model built as the JAX ``EvalExecutor`` builds it: compute dtype from
  ``cfg.train.bf16``, without the opt-in kernels; on the card its stencil GAT
  is the kernel;
* every batch reduces to per-horizon statistics on the device
  (``evaluation/streaming.py``), for the model and for the window-mean HA
  baseline, and ``evaluation_results.csv``, ``evaluation_summary.txt`` and
  ``quantile_metrics*.csv`` are the JAX package's, column for column;
* split and adaptive conformal calibration of a quantile head
  (``evaluation/conformal.py``), the autoregressive rollout
  (``evaluation/rollout.py``) and forecasts of chosen windows
  (``run_prediction``);
* checkpoints resolve as in the JAX package (``latest`` is the newest
  ``best_params.pt``, optionally within one run); the port's own files and
  the reference's ``.pth`` load through one importer (``models/ref_import.py``).

A config with ``device_data`` evaluates on the device-resident archive
(``data/device_data.py``): the loader yields window starts and the eval step
gathers the windows on the card; the HA baseline reads the same windows
through the dataset's host mirror. Without ``*_raw.npz`` it falls back to the
host pipeline with a warning, as the JAX package does.

Not ported yet, and refused: the SARIMA baseline (ROADMAP Queue A item 8) and
multi-process evaluation (item 7).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Mapping

import numpy as np
import torch

from tec_mollm_tpu_torch.config import Config, load_config
from tec_mollm_tpu_torch.data.dataset import BatchLoader, SlidingWindowDataset
from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset
from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.evaluation.conformal import (
    ConformalOffsets,
    evaluate_adaptive_conformal,
    fit_conformal,
)
from tec_mollm_tpu_torch.evaluation.rollout import autoregressive_rollout
from tec_mollm_tpu_torch.evaluation.streaming import StreamingHorizonMetrics, StreamingQuantileMetrics
from tec_mollm_tpu_torch.graph.builder import GraphData
from tec_mollm_tpu_torch.models.baselines import WindowMeanBaseline
from tec_mollm_tpu_torch.models.ref_import import load_reference_checkpoint
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.training.checkpoint import find_latest_checkpoint
from tec_mollm_tpu_torch.training.train_state import make_eval_step, point_forecast, put_batch

logger = logging.getLogger(__name__)

SARIMA_REFUSAL = (
    "--baseline sarima: the batched SARIMA baseline is not ported yet "
    "(ROADMAP Queue A item 8, baselines and host preprocessing)"
)


def build_eval_model(
    cfg: Config, graph: GraphData, state_dict: Mapping[str, torch.Tensor], device=None
) -> tuple[TECMoLLM, tuple, torch.device]:
    """(model in eval mode on the device, graph tensors, device): the compute
    dtype from ``cfg.train.bf16`` and no opt-in kernel, as the JAX
    ``EvalExecutor`` builds its model. ``device=None`` is the GPU."""
    device = resolve_device(device)
    shifts, graph_dev = graph_inputs(graph, device)
    model = TECMoLLM(cfg.model, shifts, dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32, seed=None)
    model.load_state_dict(state_dict)
    return model.to(device).eval(), graph_dev, device


class EvalExecutor:
    """The eval model, its graph and the eval step on one device; batches of
    ``batch_size`` windows (the loader pads the last one, marked invalid).

    ``device_dataset`` (a ``DeviceResidentDataset``): its raw series go to the
    device once, the loader yields window starts and the eval step gathers
    the windows there (the JAX ``EvalExecutor``'s ``device_dataset``)."""

    def __init__(
        self,
        cfg: Config,
        graph: GraphData,
        state_dict: Mapping[str, torch.Tensor],
        batch_size: int,
        device=None,
        device_dataset: DeviceResidentDataset | None = None,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.model, self.graph, self.device = build_eval_model(cfg, graph, state_dict, device)
        self.eval_step = make_eval_step(self.model, cfg)
        # x in the dtype the host path casts it to (put_batch)
        self._data = None if device_dataset is None else device_dataset.device_split(
            self.device, torch.bfloat16 if cfg.train.bf16 else torch.float32)

    def loader(self, dataset: SlidingWindowDataset | DeviceResidentDataset) -> BatchLoader:
        """The dataset in order, in batches of ``batch_size`` (the last padded,
        its padding marked invalid), gathered by a prefetch thread; window
        starts alone with a device dataset."""
        return BatchLoader(dataset, batch_size=self.batch_size, drop_remainder=False, prefetch=2,
                           index_only=self._data is not None)

    def run(self, batch: dict[str, np.ndarray]):
        """(loss, preds, trues, valid), all on the device."""
        dev = put_batch(batch, self.device, self.cfg.train.bf16)
        loss, preds, trues = self.eval_step(dev, self.graph, self._data)
        return loss, preds, trues, dev["valid"]

    def stream_metrics(
        self,
        dataset: SlidingWindowDataset,
        scaler: StandardScaler | None,
        conformal_offsets: ConformalOffsets | None = None,
    ) -> dict[str, Any]:
        """The point metrics of the dataset (the 0.5 level of a quantile head),
        each batch reduced on the device; a quantile head adds
        ``quantile_metrics``, and ``conformal_offsets`` a second accumulator
        scoring the calibrated intervals in the same pass."""
        cfg, quantiles = self.cfg, self.cfg.model.quantiles
        acc = StreamingHorizonMetrics(cfg.train.L_out, scaler, self.device)
        acc_q = StreamingQuantileMetrics(cfg.train.L_out, quantiles, scaler, device=self.device) if quantiles else None
        acc_qc = (
            StreamingQuantileMetrics(cfg.train.L_out, quantiles, scaler, offsets=conformal_offsets, device=self.device)
            if quantiles and conformal_offsets is not None else None
        )
        for batch in self.loader(dataset):
            _, preds, trues, valid = self.run(batch)
            if acc_q is not None:
                acc_q.update(trues, preds, valid)
                if acc_qc is not None:
                    acc_qc.update(trues, preds, valid)
                preds = point_forecast(preds, cfg)
            acc.update(trues, preds, valid)
        result = acc.finalize()
        if acc_q is not None:
            result["quantile_metrics"] = acc_q.finalize()
        if acc_qc is not None:
            result["quantile_metrics_conformal"] = acc_qc.finalize()
        return result


def device_dataset_of(dataset) -> DeviceResidentDataset | None:
    """``dataset`` when it is device-resident, else None (the executor's
    ``device_dataset``)."""
    return dataset if isinstance(dataset, DeviceResidentDataset) else None


def get_model_predictions(
    cfg: Config,
    state_dict: Mapping[str, torch.Tensor],
    dataset: SlidingWindowDataset | DeviceResidentDataset,
    graph: GraphData,
    batch_size: int = 16,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(y_true, y_pred), each (num_samples, L_out, N, 1) scaled, of the whole
    dataset on the host (the point level of a quantile head). Prefer
    ``evaluate_model_streaming`` for metrics."""
    ex = EvalExecutor(cfg, graph, state_dict, batch_size, device, device_dataset_of(dataset))
    preds_all, trues_all = [], []
    for batch in ex.loader(dataset):
        _, preds, trues, _ = ex.run(batch)
        valid = batch["valid"]
        preds_all.append(point_forecast(preds, cfg).cpu().numpy()[valid])
        trues_all.append(trues.cpu().numpy()[valid])
    return np.concatenate(trues_all), np.concatenate(preds_all)


def evaluate_model_streaming(
    cfg: Config,
    state_dict: Mapping[str, torch.Tensor],
    dataset: SlidingWindowDataset | DeviceResidentDataset,
    graph: GraphData,
    scaler: StandardScaler | None,
    batch_size: int = 16,
    conformal_offsets: ConformalOffsets | None = None,
    device=None,
) -> dict[str, Any]:
    """Inference and metrics without the predictions on the host
    (``EvalExecutor.stream_metrics``); on the card's copy of a
    device-resident dataset."""
    ex = EvalExecutor(cfg, graph, state_dict, batch_size, device, device_dataset_of(dataset))
    return ex.stream_metrics(dataset, scaler, conformal_offsets)


def host_targets(dataset: SlidingWindowDataset) -> np.ndarray:
    """Every target in the model's output layout (num_samples, L_out, N, 1),
    straight from the dataset. Materializes the split: for tests and small
    splits."""
    y = dataset.gather_batch(np.arange(len(dataset)))["y"]  # (S, N, L_out)
    return y.transpose(0, 2, 1)[..., None]


def get_baseline_predictions(dataset: SlidingWindowDataset, L_out: int) -> np.ndarray:
    """(num_samples, L_out, N, 1): the scaled window mean of the TEC channel.
    Materializes the split (see ``host_targets``)."""
    return WindowMeanBaseline().predict_dataset(dataset, L_out)


def evaluate_baseline_streaming(
    dataset: SlidingWindowDataset | DeviceResidentDataset,
    L_out: int,
    scaler: StandardScaler | None,
    batch_size: int = 64,
    device=None,
) -> dict[str, Any]:
    """The window-mean HA baseline, batch by batch: the window means on the
    host (numpy, as the JAX package; a device-resident dataset through its
    host mirror, the same windows bit for bit), the model's metric
    statistics on the device; host memory of one batch."""
    device = resolve_device(device)
    acc = StreamingHorizonMetrics(L_out, scaler, device)
    baseline = WindowMeanBaseline()
    for batch in BatchLoader(dataset, batch_size=batch_size, drop_remainder=False, prefetch=2):
        preds = baseline.predict_batch(batch["x"][..., 0], L_out)
        trues = batch["y"].transpose(0, 2, 1)[..., None]
        acc.update(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (trues, preds, batch["valid"])))
    return acc.finalize()


def improvement_report(model_metrics: dict, baseline_metrics: dict) -> dict[str, float]:
    """Improvement % of the model over the baseline per metric."""
    return {
        "mae_improvement_pct": (baseline_metrics["mae_avg"] - model_metrics["mae_avg"])
        / baseline_metrics["mae_avg"] * 100.0,
        "rmse_improvement_pct": (baseline_metrics["rmse_avg"] - model_metrics["rmse_avg"])
        / baseline_metrics["rmse_avg"] * 100.0,
        "r2_improvement_pct": (model_metrics["r2_score_avg"] - baseline_metrics["r2_score_avg"])
        / abs(baseline_metrics["r2_score_avg"]) * 100.0,
        "pearson_improvement_pct": (model_metrics["pearson_r_avg"] - baseline_metrics["pearson_r_avg"])
        / baseline_metrics["pearson_r_avg"] * 100.0,
    }


def _quantile_block(f, m: dict, title: str) -> None:
    f.write(f"\n{title}:\n")
    f.write(f"  levels:       {m['quantiles']}\n")
    f.write(f"  pinball avg:  {m['pinball_avg']:.6f}\n")
    cal = ", ".join(f"{q:g}->{c:.3f}" for q, c in zip(m["quantiles"], m["calibration_by_level"]))
    f.write(f"  calibration:  {cal}\n")
    if "interval_coverage" in m:
        f.write(f"  interval:     {m['interval_coverage']:.3f} observed vs {m['interval_nominal']:.3f} nominal\n")


def _quantile_csv(m: dict, path: str) -> None:
    n_h = len(m["pinball_by_horizon"])
    cov = m.get("interval_coverage_by_horizon", [float("nan")] * n_h)
    with open(path, "w") as f:
        f.write("horizon," + ",".join(f"pinball_q{q:g}" for q in m["quantiles"]) + ",interval_coverage\n")
        f.write(
            "avg," + ",".join(f"{p:.6f}" for p in m["pinball_by_level"])
            + f",{m.get('interval_coverage', float('nan')):.6f}\n"
        )
        for h in range(n_h):
            f.write(f"{h+1}," + ",".join(f"{p:.6f}" for p in m["pinball_by_horizon_level"][h]) + f",{cov[h]:.6f}\n")


def write_results(results: dict[str, dict], improvements: dict[str, float], output_dir: str) -> tuple[str, str]:
    """``evaluation_results.csv``, ``evaluation_summary.txt`` and, for a
    quantile head, ``quantile_metrics.csv`` (raw), ``_conformal.csv`` and
    ``_adaptive.csv``: the JAX package's files, column for column."""
    os.makedirs(output_dir, exist_ok=True)
    csv_path = os.path.join(output_dir, "evaluation_results.csv")
    scalar_keys = ["mae_avg", "rmse_avg", "r2_score_avg", "pearson_r_avg"]
    horizon_keys = ["mae_by_horizon", "rmse_by_horizon", "r2_by_horizon", "pearson_by_horizon"]
    with open(csv_path, "w") as f:
        n_h = len(next(iter(results.values()))["mae_by_horizon"])
        cols = scalar_keys + [f"{k[:-11]}_h{h+1}" for k in horizon_keys for h in range(n_h)]
        f.write("model," + ",".join(cols) + "\n")
        for name, m in results.items():
            vals = [f"{m[k]:.6f}" for k in scalar_keys] + [f"{m[k][h]:.6f}" for k in horizon_keys for h in range(n_h)]
            f.write(name + "," + ",".join(vals) + "\n")

    model = results.get("TEC-MoLLM", {})
    qm, qmc, qma = (model.get(k) for k in (
        "quantile_metrics", "quantile_metrics_conformal", "quantile_metrics_adaptive"))
    txt_path = os.path.join(output_dir, "evaluation_summary.txt")
    with open(txt_path, "w") as f:
        f.write("TEC-MoLLM evaluation summary\n")
        f.write("=" * 50 + "\n\n")
        for name, m in results.items():
            f.write(f"{name}:\n")
            f.write(f"  MAE avg:      {m['mae_avg']:.6f}\n")
            f.write(f"  RMSE avg:     {m['rmse_avg']:.6f}\n")
            f.write(f"  R2 avg:       {m['r2_score_avg']:.6f}\n")
            f.write(f"  Pearson avg:  {m['pearson_r_avg']:.6f}\n\n")
        f.write("Improvement vs HistoricalAverage:\n")
        for k, v in improvements.items():
            f.write(f"  {k}: {v:+.2f}%\n")
        if qm:
            _quantile_block(f, qm, "Probabilistic forecast (quantile head)")
        if qmc:
            _quantile_block(f, qmc, "Probabilistic forecast (conformal-calibrated)")
        if qma:
            _quantile_block(
                f, qma, f"Probabilistic forecast (ADAPTIVE conformal, decay {qma['adaptive']['decay']:g})"
            )
    for m, name in ((qm, "quantile_metrics.csv"), (qmc, "quantile_metrics_conformal.csv"),
                    (qma, "quantile_metrics_adaptive.csv")):
        if m:
            _quantile_csv(m, os.path.join(output_dir, name))
    return csv_path, txt_path


def resolve_checkpoint(checkpoint: str, workdir: str = ".", run_name: str | None = None) -> str:
    """'latest' -> the newest ``best_params.pt`` under ``<workdir>/checkpoints``
    (optionally within one run); else the given path. A relative path that
    does not exist from the current directory but does under the workdir
    resolves against the workdir."""
    if checkpoint == "latest":
        return find_latest_checkpoint(os.path.join(workdir, "checkpoints"), run_name=run_name)
    if not os.path.isabs(checkpoint) and not os.path.exists(checkpoint):
        in_workdir = os.path.join(workdir, checkpoint)
        if os.path.exists(in_workdir):
            return in_workdir
    return checkpoint


def resolve_cli_config(
    config_path: str | None,
    checkpoint: str,
    workdir: str = ".",
    run_name: str | None = None,
    fallback: Config | None = None,
) -> tuple[Config, str]:
    """The config policy of every eval-side CLI (test, predict, serve):

      1. an explicit --config (preset name or json) wins;
      2. else the config.json the train CLI wrote beside the RESOLVED
         checkpoint (so the default ``--checkpoint latest`` picks up the run's
         own config);
      3. else a warning and ``fallback`` (default: the flagship ``Config()``).

    Returns (config, resolved checkpoint); callers pass the resolved path on,
    since resolving 'latest' again could pair one run's config with another
    run's weights. When nothing resolves, the given string comes back and the
    load raises its own FileNotFoundError."""
    try:
        resolved = resolve_checkpoint(checkpoint, workdir, run_name)
    except FileNotFoundError:
        resolved = None
    if config_path:
        return load_config(config_path), resolved or checkpoint
    if resolved:
        candidate = os.path.join(os.path.dirname(resolved), "config.json")
        if os.path.exists(candidate):
            with open(candidate) as f:
                return Config.from_json(f.read()), resolved
    logger.warning(
        "no config.json found next to the checkpoint — falling back to %s; restoring a checkpoint "
        "trained with a different config will fail (pass --config <run>/config.json)",
        "the flagship default Config()" if fallback is None else "the flag-built config",
    )
    return (Config() if fallback is None else fallback), resolved or checkpoint


def warn_on_config_mismatch(cfg: Config, checkpoint_path: str) -> bool:
    """Warn when the model section of ``cfg`` disagrees with the config.json
    beside the checkpoint; True when it does."""
    candidate = os.path.join(os.path.dirname(checkpoint_path), "config.json")
    if not os.path.exists(candidate):
        return False
    try:
        with open(candidate) as f:
            saved = Config.from_json(f.read()).resolved()
    except (KeyError, ValueError, TypeError):
        logger.warning("could not parse %s for a config cross-check", candidate)
        return False
    cur, ref = dataclasses.asdict(cfg.resolved().model), dataclasses.asdict(saved.model)
    diffs = {k: (ref[k], cur[k]) for k in ref if ref[k] != cur.get(k)}
    if diffs:
        logger.warning(
            "config in use disagrees with the checkpoint's own config.json (%s) on model fields %s "
            "(saved vs current) — restore will likely fail or produce garbage; pass --config %s",
            candidate, {k: f"{a!r} vs {b!r}" for k, (a, b) in diffs.items()}, candidate,
        )
    return bool(diffs)


def load_params_for_eval(cfg: Config, checkpoint_path: str) -> dict[str, torch.Tensor]:
    """The checkpoint's weights as the port's fp32 state_dict, held against
    the model ``cfg`` builds. The port's ``best_params.pt`` and a reference
    ``.pth`` go through the same importer (``models/ref_import.py``)."""
    state_dict = load_reference_checkpoint(checkpoint_path, cfg.model)
    template = TECMoLLM(cfg.model, seed=None)
    try:
        template.load_state_dict(state_dict, strict=True)
    except RuntimeError as e:
        raise RuntimeError(
            f"checkpoint at {checkpoint_path} does not match the model built from the current config "
            "— usually a config/preset mismatch. Pass the run's config.json (written next to the "
            "checkpoint by the train CLI) via --config, or let 'latest' resolution pick it up."
        ) from e
    return template.state_dict()


def _load_checkpoint(cfg: Config, checkpoint: str, workdir: str, run_name: str | None):
    """(resolved path, state_dict), with the config cross-check."""
    ckpt_path = resolve_checkpoint(checkpoint, workdir, run_name)
    warn_on_config_mismatch(cfg, ckpt_path)
    return ckpt_path, load_params_for_eval(cfg, ckpt_path)


def _target_scaler(data_dir: str) -> StandardScaler | None:
    path = os.path.join(data_dir, "target_scaler.npz")
    return StandardScaler.load(path) if os.path.exists(path) else None


def run_rollout_eval(
    cfg: Config,
    data_dir: str,
    checkpoint: str,
    rollout_steps: int,
    num_windows: int = 8,
    output_dir: str = "results",
    workdir: str = ".",
    run_name: str | None = None,
    device=None,
) -> dict[str, Any]:
    """Autoregressive rollout beyond L_out on the test split: ``num_windows``
    evenly spaced windows, each rolled ``rollout_steps`` steps with its
    forecasts fed back, scored in TECU (forecasts clipped to [0, 200])
    against the true TEC. Writes ``rollout_results.csv``."""
    cfg = cfg.resolved()
    L_in, L_out = cfg.train.L_in, cfg.train.L_out
    total = -(-rollout_steps // L_out) * L_out
    with np.load(os.path.join(data_dir, "test_set.npz")) as d:
        X = d["X"]  # (T, N, C) feature-scaled
        TF = d["time_features"]
    graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
    fscaler = StandardScaler.load(os.path.join(data_dir, "scaler.npz"))
    tscaler = StandardScaler.load(os.path.join(data_dir, "target_scaler.npz"))
    max_start = X.shape[0] - L_in - total
    if max_start < 0:
        raise ValueError(
            f"test split too short for a {rollout_steps}-step rollout (need {L_in + total} steps, have {X.shape[0]})"
        )
    starts = np.unique(np.linspace(0, max_start, num_windows, dtype=np.int64))
    _, state_dict = _load_checkpoint(cfg, checkpoint, workdir, run_name)

    x_init = np.stack([X[s : s + L_in] for s in starts])
    tf_full = np.stack([TF[s : s + L_in + total] for s in starts])
    sw_future = np.stack([X[s + L_in : s + L_in + total, 0, 1:] for s in starts])  # node-constant indices
    preds_scaled = autoregressive_rollout(
        cfg, state_dict, graph, x_init, tf_full, sw_future, rollout_steps,
        feature_scaler=fscaler, target_scaler=tscaler, device=device,
    )  # (W, steps, N, 1) target-scaled

    truth_scaled = np.stack([X[s + L_in : s + L_in + rollout_steps, :, 0] for s in starts])[..., None]
    truth_phys = truth_scaled * fscaler.scale_[0] + fscaler.mean_[0]
    preds_phys = np.clip(preds_scaled * tscaler.scale_[0] + tscaler.mean_[0], 0.0, 200.0)
    err = preds_phys - truth_phys
    per_step_mae = np.abs(err).mean(axis=(0, 2, 3))
    per_step_rmse = np.sqrt((err**2).mean(axis=(0, 2, 3)))
    result = {
        "rollout_steps": rollout_steps,
        "num_windows": int(len(starts)),
        "mae_avg": float(per_step_mae.mean()),
        "rmse_avg": float(per_step_rmse.mean()),
        "mae_by_step": per_step_mae.tolist(),
        "rmse_by_step": per_step_rmse.tolist(),
    }
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "rollout_results.csv")
    with open(path, "w") as f:
        f.write("step,mae,rmse\n")
        for i, (a, r) in enumerate(zip(per_step_mae, per_step_rmse), 1):
            f.write(f"{i},{a:.6f},{r:.6f}\n")
    logger.info(
        "rollout %d steps over %d windows: MAE %.4f RMSE %.4f (-> %s)",
        rollout_steps, len(starts), result["mae_avg"], result["rmse_avg"], path,
    )
    return result


def run_prediction(
    cfg: Config,
    data_dir: str,
    checkpoint: str,
    split: str = "test",
    indices: list[int] | None = None,
    output_dir: str = "results",
    workdir: str = ".",
    run_name: str | None = None,
    device=None,
) -> dict[str, Any]:
    """Forecast chosen windows of a processed split in TECU (inverse target
    scaling, clipped to [0, 200]). ``indices`` are window starts of the
    stride-1 split; the default is the most recent. Writes ``forecast.npz``
    {indices, forecast, truth} with (W, L_out, N) arrays, and for a quantile
    head ``forecast_quantiles`` (W, L_out, N, Q) and ``quantile_levels``, plus
    ``forecast_quantiles_conformal`` and ``conformal_offsets`` when a
    ``conformal.npz`` of the same levels lies beside the checkpoint."""
    cfg = cfg.resolved()
    ds = SlidingWindowDataset.from_dir(data_dir, split, cfg.train.L_in, cfg.train.L_out, stride=1)
    if len(ds) == 0:
        raise ValueError(f"split '{split}' has no complete windows")
    graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
    tscaler = _target_scaler(data_dir)
    if indices is None:
        indices = [len(ds) - 1]
    idx = np.asarray(indices, dtype=np.int64)
    if (idx < 0).any() or (idx >= len(ds)).any():
        raise ValueError(f"window indices {indices} out of range [0, {len(ds)})")

    ckpt_path, state_dict = _load_checkpoint(cfg, checkpoint, workdir, run_name)
    ex = EvalExecutor(cfg, graph, state_dict, batch_size=len(idx), device=device)
    batch = ds.gather_batch(idx)
    batch["valid"] = np.ones(len(idx), dtype=bool)
    _, preds, trues, _ = ex.run(batch)
    preds, trues = preds.cpu().numpy(), trues.cpu().numpy()

    def to_physical(a: np.ndarray, what: str, channel: int | None) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        a = a[..., channel] if channel is not None else a  # (W, L_out, N[, Q])
        if tscaler is not None:
            a = a * tscaler.scale_[0] + tscaler.mean_[0]
        n_bad = int((~np.isfinite(a)).sum())
        if n_bad:
            # a checkpoint that gives non-finite output must not pass for a valid all-zero forecast
            logger.warning(
                "%d non-finite value(s) in %s replaced with 0 — the checkpoint may be corrupt or mismatched",
                n_bad, what,
            )
        return np.nan_to_num(a)

    quantiles = cfg.model.quantiles
    forecast = np.clip(to_physical(preds, "model predictions", cfg.model.median_index), 0.0, 200.0)
    truth = to_physical(trues, "target values", 0)
    extra: dict[str, np.ndarray] = {}
    if quantiles:
        qphys = np.clip(to_physical(preds, "quantile predictions", None), 0.0, 200.0)
        extra["forecast_quantiles"] = qphys
        extra["quantile_levels"] = np.asarray(quantiles, dtype=np.float64)
        conf_path = ConformalOffsets.path_for(ckpt_path)
        if os.path.exists(conf_path):
            off = ConformalOffsets.load(conf_path)
            if tuple(off.quantiles) == tuple(quantiles):
                extra["forecast_quantiles_conformal"] = off.apply_physical(qphys)
                extra["conformal_offsets"] = off.offsets
                logger.info("conformal calibration applied (%s)", conf_path)
            else:
                logger.warning(
                    "conformal offsets at %s have levels %s != model %s — skipped",
                    conf_path, off.quantiles, quantiles,
                )
    out_path = os.path.join(output_dir, "forecast.npz")
    os.makedirs(output_dir, exist_ok=True)
    np.savez(out_path, indices=idx, forecast=forecast, truth=truth, **extra)
    mae = float(np.abs(forecast - truth).mean())
    logger.info(
        "forecast %d window(s) of split '%s' -> %s (MAE vs observed: %.4f TECU)", len(idx), split, out_path, mae
    )
    return {"indices": idx.tolist(), "forecast": forecast, "truth": truth, "path": out_path, "mae": mae, **extra}


def eval_dataset(
    cfg: Config, data_dir: str, split: str, tail_frac: float = 1.0
) -> SlidingWindowDataset | DeviceResidentDataset:
    """The stride-1 windows of a split: device-resident when the config has
    ``device_data`` (the run's config.json records it, so a checkpoint
    trained that way evaluates that way), else, or when the archive has no
    ``*_raw.npz``, the host pipeline's."""
    L_in, L_out = cfg.train.L_in, cfg.train.L_out
    if cfg.train.device_data:
        try:
            return DeviceResidentDataset(data_dir, split, L_in, L_out, stride=1, tail_frac=tail_frac)
        except FileNotFoundError:
            logger.warning(
                "config has device_data=true but %s has no *_raw.npz — falling back to the "
                "host-streamed eval pipeline", data_dir,
            )
    return SlidingWindowDataset.from_dir(data_dir, split, L_in, L_out, stride=1, tail_frac=tail_frac)


def _resolve_conformal(
    conformal: str,
    cfg: Config,
    state_dict: Mapping[str, torch.Tensor],
    data_dir: str,
    ckpt_path: str,
    graph: GraphData,
    scaler: StandardScaler | None,
    batch_size: int,
    tail_frac: float = 1.0,
    mode: str = "additive",
    device=None,
) -> ConformalOffsets | None:
    """``run_evaluation``'s ``conformal`` -> offsets or None. 'fit' calibrates
    on the val split (its chronologically last ``tail_frac``: split conformal
    assumes exchangeability, and the val tail is the closest proxy for the
    period after it) and saves conformal.npz beside the checkpoint, where
    'auto', predict and the server find it."""
    if not cfg.model.quantiles:
        logger.warning(
            "--conformal requested but the model has no quantile head (ModelConfig.quantiles empty) "
            "— nothing to calibrate"
        )
        return None
    if conformal == "fit":
        val_ds = eval_dataset(cfg, data_dir, "val", tail_frac)
        if len(val_ds) == 0:
            logger.warning("val split empty — cannot fit conformal offsets")
            return None
        off = fit_conformal(cfg, state_dict, val_ds, graph, scaler, batch_size, mode=mode, device=device)
        path = ConformalOffsets.path_for(ckpt_path)
        off.save(path)
        logger.info("conformal offsets saved to %s", path)
        return off
    path = ConformalOffsets.path_for(ckpt_path) if conformal == "auto" else conformal
    if not os.path.exists(path):
        if conformal == "auto":
            return None
        raise FileNotFoundError(
            f"conformal offsets file {path} not found — run the test CLI with --conformal fit first "
            "(it saves conformal.npz next to the checkpoint)"
        )
    off = ConformalOffsets.load(path)
    if tuple(off.quantiles) != tuple(cfg.model.quantiles):
        raise ValueError(
            f"conformal offsets at {path} were fit for levels {off.quantiles} but the model has {cfg.model.quantiles}"
        )
    logger.info("conformal offsets loaded from %s", path)
    return off


def run_evaluation(
    cfg: Config,
    data_dir: str,
    checkpoint: str,
    output_dir: str = "results",
    batch_size: int = 16,
    workdir: str = ".",
    run_name: str | None = None,
    baselines: tuple[str, ...] = (),
    split: str = "test",
    tail_frac: float = 1.0,
    conformal: str | None = None,
    conformal_tail_frac: float = 1.0,
    conformal_mode: str = "additive",
    conformal_decay: float = 0.99,
    conformal_level_gain: float = 0.05,
    device=None,
) -> dict[str, Any]:
    """Score a checkpoint and the HA baseline on a processed split.

    ``split`` / ``tail_frac`` default to the whole test split; the val tail is
    the model-selection probe under distribution shift. ``conformal`` (a
    quantile head only): None scores the raw intervals; 'auto' loads
    conformal.npz beside the checkpoint if there is one; 'fit' fits offsets
    on the val split in ``conformal_mode`` and saves them there; a path loads
    that file. Mode 'adaptive' adds a second, chronological pass with rolling
    offsets warm-started from the static additive ones. ``baselines`` names
    the rows beyond the HA: 'sarima' is not ported yet and is refused."""
    if "sarima" in baselines:
        raise ValueError(SARIMA_REFUSAL)
    cfg = cfg.resolved()
    test_ds = eval_dataset(cfg, data_dir, split, tail_frac)
    graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
    scaler = _target_scaler(data_dir)
    ckpt_path, state_dict = _load_checkpoint(cfg, checkpoint, workdir, run_name)
    logger.info("checkpoint: %s", ckpt_path)

    adaptive = conformal_mode == "adaptive"
    offsets = None
    if conformal is not None:
        offsets = _resolve_conformal(
            conformal, cfg, state_dict, data_dir, ckpt_path, graph, scaler, batch_size,
            tail_frac=conformal_tail_frac,
            # the adaptive stream warm-starts from a static ADDITIVE fit
            mode="additive" if adaptive else conformal_mode, device=device,
        )
    logger.info(
        "running model inference over %d %s windows%s", len(test_ds), split,
        f" (tail {tail_frac:g} of the split)" if tail_frac < 1.0 else "",
    )
    model_metrics = evaluate_model_streaming(
        cfg, state_dict, test_ds, graph, scaler, batch_size, conformal_offsets=offsets, device=device
    )
    if adaptive and cfg.model.quantiles:
        logger.info(
            "adaptive conformal pass (decay %.3f, warm start %s)",
            conformal_decay, "static fit" if offsets is not None else "none",
        )
        model_metrics["quantile_metrics_adaptive"] = evaluate_adaptive_conformal(
            cfg, state_dict, test_ds, graph, scaler, batch_size, warm_offsets=offsets,
            decay=conformal_decay, level_gain=conformal_level_gain, device=device,
        )
    results = {
        "TEC-MoLLM": model_metrics,
        "HistoricalAverage": evaluate_baseline_streaming(test_ds, cfg.train.L_out, scaler, device=device),
    }
    improvements = improvement_report(results["TEC-MoLLM"], results["HistoricalAverage"])
    csv_path, txt_path = write_results(results, improvements, output_dir)
    logger.info("results: %s, %s", csv_path, txt_path)
    for name, m in results.items():
        logger.info(
            "%s: MAE %.4f RMSE %.4f R2 %.4f r %.4f",
            name, m["mae_avg"], m["rmse_avg"], m["r2_score_avg"], m["pearson_r_avg"],
        )
    logger.info(
        "improvement vs HA: MAE %+.2f%% RMSE %+.2f%%",
        improvements["mae_improvement_pct"], improvements["rmse_improvement_pct"],
    )
    qmc = model_metrics.get("quantile_metrics_conformal")
    if qmc and "interval_coverage" in qmc:
        logger.info(
            "conformal %g%% interval: coverage %.3f observed (raw head: %.3f)",
            100 * qmc["interval_nominal"], qmc["interval_coverage"],
            model_metrics["quantile_metrics"].get("interval_coverage", float("nan")),
        )
    qma = model_metrics.get("quantile_metrics_adaptive")
    if qma and "interval_coverage" in qma:
        logger.info(
            "ADAPTIVE conformal %g%% interval: coverage %.3f observed (calibration %s)",
            100 * qma["interval_nominal"], qma["interval_coverage"],
            [round(c, 3) for c in qma["calibration_by_level"]],
        )
    return {"results": results, "improvements": improvements}
