"""Trainer: epoch loop, validation, early stopping, checkpoints and resume, on
one GPU (``training/trainer.py`` of the JAX package, in PyTorch).

Per epoch: ``loader.set_epoch`` -> train epoch -> validate -> log, the best
weights saved on a val-loss gain above ``min_delta``, early stop after
``patience`` epochs without one, a resumable ``latest`` checkpoint and a line
of ``<workdir>/logs/<run_name>.jsonl`` with the JAX trainer's record keys.

The macro batch is ``accumulation_steps * batch_size`` windows; the last one
of an epoch is padded with repeats whose ``valid`` is False, so every window
trains each epoch. Losses stay on the device and are read back every
``host_sync_every`` steps, where a non-finite loss stops the run before any
checkpoint can overwrite ``latest``. Validation runs the deterministic eval
step on the EMA weights when they are tracked (else the raw ones), whose
stencil GAT is the kernel on the card where the model routes it there, and
reduces per-horizon metric statistics on the device.

A SIGTERM or SIGINT during ``fit`` finishes the current macro step, saves
``latest`` with the position in the epoch and stops; ``fit(resume=True)``
continues from there: the epoch's batch order is a function of seed and epoch,
and dropout is seeded from the step, so the resumed run repeats the
uninterrupted one.

With ``DeviceResidentDataset`` splits (``TrainConfig.device_data``, the train
CLI's ``--device-data``) the raw series live on the card: the loaders yield
window starts only (``BatchLoader(index_only=True)``) and each microbatch is
gathered on the device right before its forward (``data/device_data.py``),
validation's batches too.

Not ported here (refused by ``unsupported``): multi-process data parallelism,
tensor parallelism and the remat policies other than full recomputation.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
from typing import Any

import numpy as np
import torch

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.data.dataset import BatchLoader, SlidingWindowDataset
from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset
from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.evaluation.streaming import StreamingHorizonMetrics
from tec_mollm_tpu_torch.graph.builder import GraphData
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.training.checkpoint import CheckpointManager
from tec_mollm_tpu_torch.training.train_state import (
    create_train_state,
    make_eval_step,
    make_train_step,
    point_forecast,
    put_batch,
)
from tec_mollm_tpu_torch.utils.profiler import StepTimer
from tec_mollm_tpu_torch.utils.run_name import make_run_name

logger = logging.getLogger(__name__)


def unsupported(cfg: Config) -> str | None:
    """Why the port cannot train ``cfg`` yet, naming the ROADMAP item that
    brings it, or None."""
    t = cfg.train
    if t.model_parallel > 1:
        return (
            f"model_parallel={t.model_parallel}: tensor parallelism is not ported yet "
            "(ROADMAP Queue A item 7, data and tensor parallelism)"
        )
    if t.remat_policy not in (None, "full"):
        return (
            f"remat_policy={t.remat_policy!r}: the port recomputes whole GPT-2 blocks only "
            "(None or 'full'); the other policies come with ROADMAP Queue A item 9"
        )
    return None


class Trainer:
    def __init__(
        self,
        cfg: Config,
        train_ds: SlidingWindowDataset | DeviceResidentDataset,
        val_ds: SlidingWindowDataset | DeviceResidentDataset | None,
        graph: GraphData,
        target_scaler: StandardScaler | None,
        workdir: str = ".",
        run_name: str | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = cfg.resolved()
        reason = unsupported(cfg)
        if reason is not None:
            raise ValueError(reason)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_name = run_name or make_run_name(
            cfg.train.L_in, cfg.train.train_stride, cfg.train.batch_size, cfg.train.lr, cfg.model.llm_layers,
        )
        stencil_shifts, self.graph = graph_inputs(graph, self.device)
        # built without the opt-in kernels (fused_attn, fused MLP), as the JAX
        # trainer builds its model
        self.model = TECMoLLM(
            cfg.model, stencil_shifts, dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
            remat_llm=cfg.train.remat_llm, seed=cfg.train.seed,
        ).to(self.device)
        self.target_scaler = target_scaler
        self.ckpt = CheckpointManager(workdir, self.run_name)

        # the device-resident archive: both splits on the card, the loaders
        # yield window starts, the steps gather
        self.device_mode = isinstance(train_ds, DeviceResidentDataset)
        if val_ds is not None and isinstance(val_ds, DeviceResidentDataset) != self.device_mode:
            raise TypeError("the train and validation splits must both be device-resident, or neither")
        self.macro_batch = cfg.train.accumulation_steps * cfg.train.batch_size
        # the final short macro batch is padded with loss-masked repeats, not
        # dropped: every train window contributes a gradient each epoch
        self.train_loader = BatchLoader(
            train_ds, batch_size=self.macro_batch, shuffle=cfg.train.shuffle, seed=cfg.train.seed,
            drop_remainder=False, index_only=self.device_mode,
        )
        self.val_loader = (
            BatchLoader(val_ds, batch_size=max(cfg.train.batch_size, 1), shuffle=False, drop_remainder=False,
                        index_only=self.device_mode)
            if val_ds is not None else None
        )
        self._train_data = self._val_data = None
        if self.device_mode:
            # x in the dtype the host path casts it to (put_batch)
            x_dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
            self._train_data = train_ds.device_split(self.device, x_dtype)
            if val_ds is not None:
                self._val_data = val_ds.device_split(self.device, x_dtype)
            logger.info(
                "device-resident archive: train %.1f MB%s on %s",
                train_ds.nbytes() / 1e6,
                f" + val {val_ds.nbytes() / 1e6:.1f} MB" if val_ds is not None else "", self.device,
            )

        # trainable fp32, frozen bf16 under the bf16 policy
        self.state, _ = create_train_state(
            self.model, cfg, frozen_dtype=torch.bfloat16 if cfg.train.bf16 else None,
        )
        self._train_step = make_train_step(self.model, cfg)
        self._eval_step = make_eval_step(self.model, cfg)

        self.epoch = 0
        self.best_val_loss = float("inf")
        self.patience_counter = 0
        self.history: list[dict[str, Any]] = []
        os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
        self._history_path = os.path.join(workdir, "logs", f"{self.run_name}.jsonl")

    # ------------------------------------------------------------------

    def set_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Replace the model's parameters from a full state_dict (imported
        GPT-2 weights, another run's best), keeping each tensor's device,
        dtype and trainable/frozen split."""
        with torch.no_grad():
            self.model.load_state_dict(state_dict)

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return put_batch(batch, self.device, self.cfg.train.bf16)

    def train_epoch(
        self,
        start_step: int = 0,
        stop_requested: dict[str, bool] | None = None,
        checkpoints: bool = True,
    ) -> dict[str, Any]:
        """One (possibly partial) training epoch from macro step ``start_step``.
        ``stop_requested['flag']`` is polled after every macro step: when set,
        the epoch stops there and reports ``interrupted``. ``checkpoints=False``
        skips the periodic saves (an epoch that is not part of the run, such
        as a profiled one, must not overwrite its 'latest')."""
        self.train_loader.set_epoch(self.epoch)
        device_losses = []
        steps = start_step
        interrupted = False
        sync_every = self.cfg.train.host_sync_every
        ckpt_every = self.cfg.train.checkpoint_every_steps if checkpoints else 0
        timer = StepTimer(self.device)
        timer.start()
        for batch in self.train_loader.iter_from(start_step):
            self.state, metrics = self._train_step(self.state, self._put(batch), self.graph, self._train_data)
            device_losses.append(metrics["loss"])
            steps += 1
            if sync_every and steps % sync_every == 0:
                # bounds the queued work, and a diverged loss stops the run
                # before the next save can overwrite 'latest'
                self._check_finite(float(metrics["loss"]), steps)
            if ckpt_every and steps % ckpt_every == 0:
                self._check_finite(float(metrics["loss"]), steps)
                self._save_latest(step_in_epoch=steps)
            if stop_requested is not None and stop_requested["flag"]:
                interrupted = True
                break
        total_loss = float(torch.stack(device_losses).sum()) if device_losses else 0.0
        steps_this_run = steps - start_step
        timer.stop(items=steps_this_run * self.macro_batch)
        self._check_finite(total_loss, steps)
        return {
            "train_loss": total_loss / max(steps_this_run, 1),
            "updates": steps_this_run,
            "steps_in_epoch": steps,
            "interrupted": interrupted,
            "windows_per_sec": timer.items_per_sec,
        }

    def validate(self) -> tuple[float, dict[str, Any]]:
        """Validation loss (the valid-weighted mean over the split) and the
        per-horizon metrics of the point forecast, reduced on the device and
        read back once."""
        if self.val_loader is None:
            raise RuntimeError("no validation split")
        acc = StreamingHorizonMetrics(self.cfg.train.L_out, self.target_scaler, self.device)
        loss_terms: list[torch.Tensor] = []
        sync_every = self.cfg.train.host_sync_every
        with self.state.eval_params():
            for batch in self.val_loader:
                dev_batch = self._put(batch)
                valid = dev_batch["valid"]
                loss, preds, trues = self._eval_step(dev_batch, self.graph, self._val_data)
                loss_terms.append(torch.stack([loss.float(), valid.sum().float()]))
                acc.update(trues, point_forecast(preds, self.cfg), valid)
                if sync_every and len(loss_terms) % sync_every == 0:
                    float(loss)  # bounds the queued batches
        if loss_terms:
            stacked = torch.stack(loss_terms).cpu().numpy().astype(np.float64)
            total = float(np.sum(stacked[:, 0] * stacked[:, 1]))
            count = float(np.sum(stacked[:, 1]))
        else:
            total = count = 0.0
        return total / max(count, 1.0), acc.finalize()

    def _check_finite(self, loss: float, steps: int) -> None:
        """Stop on a diverged loss before any further checkpoint write: 'latest'
        then still holds the last finite state."""
        if not math.isfinite(loss):
            raise RuntimeError(
                f"non-finite training loss ({loss}) at epoch {self.epoch} macro step {steps}: "
                "aborting before any further checkpoint write. 'latest' still holds the last "
                "finite state; resume from it (or 'best') after diagnosing — common causes are "
                "lr/accumulation misconfiguration or corrupt input data."
            )

    def _save_latest(self, step_in_epoch: int = 0) -> None:
        """The resumable 'latest' checkpoint. step_in_epoch=0 means the epoch is
        complete (resume starts at epoch + 1); k > 0 means k macro steps of
        this epoch are applied (resume re-enters it at batch k)."""
        self.ckpt.save_state(
            self.state,
            {
                "epoch": self.epoch,
                "step_in_epoch": step_in_epoch,
                "best_val_loss": self.best_val_loss,
                "patience_counter": self.patience_counter,
                "config": json.loads(self.cfg.to_json()),
                "process_count": 1,
            },
            "latest",
        )

    def _check_resume_geometry(self, meta: dict[str, Any]) -> None:
        """Refuse a mid-epoch resume under another batch geometry: the step in
        the epoch counts macro steps of one (batch_size, accumulation_steps,
        train_stride, seed, process_count), and skipping that many batches of
        another would skip or repeat windows without any other error."""
        saved = meta.get("config", {}).get("train", {})
        cur = json.loads(self.cfg.to_json())["train"]
        diffs = {
            k: (saved[k], cur[k])
            for k in ("batch_size", "accumulation_steps", "train_stride", "seed")
            if k in saved and saved[k] != cur[k]
        }
        saved_pc = meta.get("process_count")
        if saved_pc is not None and saved_pc != 1:
            diffs["process_count"] = (saved_pc, 1)
        if diffs:
            detail = ", ".join(f"{k}: saved {a} vs current {b}" for k, (a, b) in diffs.items())
            raise RuntimeError(
                "mid-epoch resume with a different batch geometry would silently skip or "
                f"double-train windows ({detail}). Resume with the checkpoint's original "
                "settings (its config.json / latest.meta.json records them), or restart from "
                "the last epoch-boundary checkpoint."
            )

    # ------------------------------------------------------------------

    def fit(self, resume: bool = False) -> list[dict[str, Any]]:
        """Train to ``epochs`` (or an early stop, or a signal); returns the
        history records of this call."""
        stop_requested = {"flag": False}

        def _request_stop(signum, frame):
            logger.warning("signal %s received: will checkpoint and stop", signum)
            stop_requested["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                pass
        try:
            return self._fit_loop(resume, stop_requested)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _fit_loop(self, resume: bool, stop_requested: dict[str, bool]) -> list[dict[str, Any]]:
        cfg = self.cfg
        start_step = 0
        if resume and self.ckpt.has_checkpoint("latest"):
            self.state, meta = self.ckpt.restore_state(self.state, "latest")
            start_step = meta.get("step_in_epoch", 0)
            if start_step:
                self._check_resume_geometry(meta)
            self.epoch = meta["epoch"] + (0 if start_step else 1)
            self.best_val_loss = meta["best_val_loss"]
            self.patience_counter = meta["patience_counter"]
            if start_step:
                logger.info(
                    "Resumed mid-epoch: epoch %d at macro step %d (best val %.6f)",
                    self.epoch, start_step, self.best_val_loss,
                )
            else:
                logger.info("Resumed from epoch %d (best val %.6f)", self.epoch, self.best_val_loss)

        for epoch in range(self.epoch, cfg.train.epochs):
            self.epoch = epoch
            train_stats = self.train_epoch(start_step, stop_requested)
            start_step = 0  # only the resumed epoch starts mid-way
            if train_stats.pop("interrupted"):
                # no validation on a partial epoch: save the position and stop
                self._save_latest(step_in_epoch=train_stats["steps_in_epoch"])
                logger.warning(
                    "stopping mid-epoch %d after %d step(s) on signal (resumable)",
                    epoch, train_stats["steps_in_epoch"],
                )
                break
            record: dict[str, Any] = {"epoch": epoch, **train_stats}

            if self.val_loader is not None:
                val_loss, val_metrics = self.validate()
                record["val_loss"] = val_loss
                record.update(
                    {k: val_metrics[k] for k in ("mae_avg", "rmse_avg", "r2_score_avg", "pearson_r_avg")}
                )
                logger.info(
                    "epoch %d | train %.4f | val %.4f | %.1f win/s",
                    epoch, train_stats["train_loss"], val_loss, train_stats["windows_per_sec"],
                )
                if (epoch + 1) % cfg.train.log_every_epochs == 0 or epoch == cfg.train.epochs - 1:
                    logger.info(
                        "MAE %.6f RMSE %.6f R2 %.6f r %.6f | by-horizon MAE %s",
                        val_metrics["mae_avg"], val_metrics["rmse_avg"],
                        val_metrics["r2_score_avg"], val_metrics["pearson_r_avg"],
                        [round(m, 4) for m in val_metrics["mae_by_horizon"]],
                    )
                if val_loss < self.best_val_loss - cfg.train.min_delta:
                    self.best_val_loss = val_loss
                    self.patience_counter = 0
                    # the weights validate just scored: the EMA ones when tracked
                    with self.state.eval_params() as model:
                        self.ckpt.save_params(model.state_dict(), "best")
                    logger.info("new best model (val %.6f)", val_loss)
                else:
                    self.patience_counter += 1

            self._save_latest(step_in_epoch=0)
            self.history.append(record)
            with open(self._history_path, "a") as f:
                f.write(json.dumps(record) + "\n")

            if self.patience_counter >= cfg.train.patience:
                logger.info("early stopping at epoch %d", epoch + 1)
                break
            if stop_requested["flag"]:
                logger.warning("stopping after epoch %d on signal (resumable)", epoch)
                break
        return self.history

