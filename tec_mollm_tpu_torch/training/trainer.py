"""Trainer: epoch loop, validation, early stopping, checkpoints and resume, on
one GPU or one process a GPU (``training/trainer.py`` of the JAX package, in
PyTorch).

Per epoch: ``loader.set_epoch`` -> train epoch -> validate -> log, the best
weights saved on a val-loss gain above ``min_delta``, early stop after
``patience`` epochs without one, a resumable ``latest`` checkpoint and a line
of ``<workdir>/logs/<run_name>.jsonl`` with the JAX trainer's record keys.

The macro batch is ``accumulation_steps * batch_size * world`` windows; the
last one of an epoch is padded with repeats whose ``valid`` is False, so every
window trains each epoch. Losses stay on the device and are read back every
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

Data parallelism (``parallel/mesh.py``): with a process group (the train
CLI's ``--multihost`` under ``torchrun``) each rank loads its strided shard of
every macro and validation batch (``BatchLoader(num_shards=world,
shard_index=rank)``), the model trains wrapped in ``DistributedDataParallel``
(``make_train_step`` divides by the global valid count, so the loss is the
global mean however the rows are split), validation runs the unwrapped model
and all-reduces its loss terms and metric statistics, so every rank returns
the same numbers. Rank 0 writes the checkpoints and the history. A signal
stops a multi-process run at the next epoch boundary, once every rank agrees
(``any_flag``); a mid-epoch stop is a single-process feature, as in JAX. The
device-resident archive keeps every split whole on every rank; only the
window starts are sharded.

Tensor parallelism (``TrainConfig.model_parallel`` = mp > 1, the train CLI's
``--model-parallel`` with ``--multihost``): the process group is laid out as
JAX's (data, model) mesh (``init_distributed(model_parallel=mp)``), every rank
builds the same seeded model and keeps its slices of the GPT-2 backbone and
head (``parallel/tensor_parallel.shard_model_``), the loaders shard over the
data group (the ranks of a model group load the same rows), the macro batch
is ``accumulation_steps * batch_size * dp``, DDP and every reduction of the
losses and metrics run over the data group, and the checkpoints hold whole
tensors (gathered over the model group before rank 0 writes), so they resume
on any layout at an epoch boundary and serve on one card.

``remat_llm`` recomputes the GPT-2 blocks in the backward under
``remat_policy`` (``models/gpt2.REMAT_POLICIES``: whole blocks, or
``dots_saveable``'s saved matrix products).

While a ``torch.profiler`` is active, ``train_epoch``'s stages are spans
(``utils/profiler.py``): ``train.put`` (the copy to the card), ``train.step``
(the step's host time; the device runs behind it), ``train.sync`` (each read
of a loss back to the host) and ``train.save``; the loader adds ``data.wait``.
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
from torch.nn.parallel import DistributedDataParallel

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.data.dataset import BatchLoader, SlidingWindowDataset
from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset
from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.evaluation.streaming import StreamingHorizonMetrics
from tec_mollm_tpu_torch.graph.builder import GraphData
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    any_flag,
    broadcast_object,
    check_model_parallel,
    data_group,
    data_rank,
    data_world,
    is_initialized,
    model_rank,
    model_world,
    rank,
    world_size,
)
from tec_mollm_tpu_torch.parallel.tensor_parallel import (
    gather_full_state_dict,
    shard_model_,
    shard_state_dict,
)
from tec_mollm_tpu_torch.training.checkpoint import CheckpointManager
from tec_mollm_tpu_torch.training.train_state import (
    create_train_state,
    make_eval_step,
    make_train_step,
    point_forecast,
    put_batch,
)
from tec_mollm_tpu_torch.utils import profiler
from tec_mollm_tpu_torch.utils.run_name import make_run_name

logger = logging.getLogger(__name__)


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
        # one process a card: the process group's layout must be the config's
        mp = cfg.train.model_parallel
        if not is_initialized():
            check_model_parallel(1, mp)
        elif mp != model_world():
            raise ValueError(
                f"model_parallel={mp} but the process group was made with model_parallel={model_world()} "
                "(init_distributed(model_parallel=...))"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        # rank 0's name: the ranks may read the clock in different minutes
        self.run_name = broadcast_object(run_name or make_run_name(
            cfg.train.L_in, cfg.train.train_stride, cfg.train.batch_size, cfg.train.lr, cfg.model.llm_layers,
        ))
        stencil_shifts, self.graph = graph_inputs(graph, self.device)
        # built without the opt-in kernels (fused_attn, fused MLP), as the JAX
        # trainer builds its model
        self.model = TECMoLLM(
            cfg.model, stencil_shifts, dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32,
            remat_llm=cfg.train.remat_llm, remat_policy=cfg.train.remat_policy, seed=cfg.train.seed,
        ).to(self.device)
        # every rank built the same seeded model; each keeps its slices
        shard_model_(self.model, model_rank(), mp)
        self.target_scaler = target_scaler
        self.ckpt = CheckpointManager(workdir, self.run_name)

        # the device-resident archive: both splits on the card, the loaders
        # yield window starts, the steps gather
        self.device_mode = isinstance(train_ds, DeviceResidentDataset)
        if val_ds is not None and isinstance(val_ds, DeviceResidentDataset) != self.device_mode:
            raise TypeError("the train and validation splits must both be device-resident, or neither")
        self.world, self.rank = world_size(), rank()
        self.dp, self.mp = data_world(), mp
        self.macro_batch = cfg.train.accumulation_steps * cfg.train.batch_size * self.dp
        # each data rank loads its strided shard (order[rank::dp]), so the
        # union of the data ranks' batch b is the single-process macro batch b
        # (the ranks of a model group load the same rows); the final short
        # macro batch is padded with loss-masked repeats, not dropped: every
        # train window contributes a gradient each epoch
        shard = dict(num_shards=self.dp, shard_index=data_rank())
        self.train_loader = BatchLoader(
            train_ds, batch_size=self.macro_batch // self.dp, shuffle=cfg.train.shuffle, seed=cfg.train.seed,
            drop_remainder=False, index_only=self.device_mode, **shard,
        )
        val_global_batch = max(cfg.train.batch_size * self.dp, self.dp)
        self.val_loader = (
            BatchLoader(val_ds, batch_size=val_global_batch // self.dp, shuffle=False, drop_remainder=False,
                        index_only=self.device_mode, **shard)
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
        # trained through DDP whenever a process group exists (world 1 too);
        # validation and checkpoints use the model itself
        trained = self.model
        if is_initialized():
            cuda = self.device.type == "cuda"
            trained = DistributedDataParallel(
                self.model, device_ids=[self.device] if cuda else None, output_device=self.device if cuda else None,
                process_group=data_group(),
            )
        self._train_step = make_train_step(trained, cfg)
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
        dtype and trainable/frozen split; a split model takes its slices."""
        with torch.no_grad():
            self.model.load_state_dict(shard_state_dict(state_dict, model_rank(), self.mp, self.cfg.model))

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's whole tensors on every rank (gathered over the model
        group when split; collective)."""
        return gather_full_state_dict(self.model)

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return put_batch(batch, self.device, self.cfg.train.bf16)

    def train_epoch(
        self,
        start_step: int = 0,
        stop_requested: dict[str, bool] | None = None,
        checkpoints: bool = True,
    ) -> dict[str, Any]:
        """One (possibly partial) training epoch from macro step ``start_step``.
        ``stop_requested['flag']`` is polled after every macro step of a
        single-process run: when set, the epoch stops there and reports
        ``interrupted``. ``checkpoints=False`` skips the periodic saves (an
        epoch that is not part of the run, such as a profiled one, must not
        overwrite its 'latest')."""
        self.train_loader.set_epoch(self.epoch)
        device_losses = []
        steps = start_step
        interrupted = False
        sync_every = self.cfg.train.host_sync_every
        ckpt_every = self.cfg.train.checkpoint_every_steps if checkpoints else 0
        timer = profiler.StepTimer(self.device)
        timer.start()
        for batch in self.train_loader.iter_from(start_step):
            with profiler.span("train.put"):
                dev_batch = self._put(batch)
            with profiler.span("train.step"):
                self.state, metrics = self._train_step(self.state, dev_batch, self.graph, self._train_data)
            device_losses.append(metrics["loss"])
            steps += 1
            if sync_every and steps % sync_every == 0:
                # bounds the queued work, and a diverged loss stops the run
                # before the next save can overwrite 'latest'
                with profiler.span("train.sync"):
                    self._check_finite(float(metrics["loss"]), steps)
            if ckpt_every and steps % ckpt_every == 0:
                with profiler.span("train.sync"):
                    self._check_finite(float(metrics["loss"]), steps)
                with profiler.span("train.save"):
                    self._save_latest(step_in_epoch=steps)
            # several ranks stop together at the epoch boundary instead: a
            # lone rank leaving the step sequence would wedge the others
            if stop_requested is not None and stop_requested["flag"] and self.world == 1:
                interrupted = True
                break
        with profiler.span("train.sync"):
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
        read back once; summed over the ranks, so every rank returns the
        numbers of the whole split."""
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
        totals = torch.zeros(2, dtype=torch.float64, device=self.device)
        if loss_terms:
            stacked = torch.stack(loss_terms).double()
            totals = torch.stack([(stacked[:, 0] * stacked[:, 1]).sum(), stacked[:, 1].sum()])
        total, count = all_reduce_sum(totals, data_group()).tolist()
        return total / max(count, 1.0), acc.all_reduce().finalize()

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
                "process_count": self.world,
            },
            "latest",
        )

    def _check_resume_geometry(self, meta: dict[str, Any]) -> None:
        """Refuse a mid-epoch resume under another batch geometry: the step in
        the epoch counts macro steps of one (batch_size, accumulation_steps,
        train_stride, seed, process_count, model_parallel: the config's, which
        is the layout's), and skipping that many batches of another would skip
        or repeat windows without any other error."""
        saved = meta.get("config", {}).get("train", {})
        cur = json.loads(self.cfg.to_json())["train"]
        diffs = {
            k: (saved[k], cur[k])
            for k in ("batch_size", "accumulation_steps", "train_stride", "seed", "model_parallel")
            if k in saved and saved[k] != cur[k]
        }
        saved_pc = meta.get("process_count")
        if saved_pc is not None and saved_pc != self.world:
            diffs["process_count"] = (saved_pc, self.world)
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
                        self.ckpt.save_params(gather_full_state_dict(model), "best")
                    logger.info("new best model (val %.6f)", val_loss)
                else:
                    self.patience_counter += 1

            # the validation numbers are the same on every rank, so best and
            # patience stay in step and every rank enters the same saves
            self._save_latest(step_in_epoch=0)
            self.history.append(record)
            if self.rank == 0:
                with open(self._history_path, "a") as f:
                    f.write(json.dumps(record) + "\n")

            if self.patience_counter >= cfg.train.patience:
                logger.info("early stopping at epoch %d", epoch + 1)
                break
            if any_flag(stop_requested["flag"]):
                logger.warning("stopping after epoch %d on signal (resumable)", epoch)
                break
        return self.history

