"""Train state and the train / eval steps (``training/train_state.py`` of the
JAX package, in PyTorch).

The state holds the model, whose parameters are split as the reference splits
them: the trainable ones stay fp32 and are optimized; the frozen GPT-2 base
weights get ``requires_grad=False`` and may be stored in bf16. One train step
accumulates the weighted loss SUM and the weight count over
``accumulation_steps`` microbatches, divides once, clips by global norm, sets
the scheduled rate, takes one AdamW step and updates the EMA. PyTorch updates
in place: the step mutates the state and returns it.

Dropout: every microbatch's forward runs inside ``torch.random.fork_rng`` with
the default generators seeded from (state seed, step, microbatch), as the JAX
step folds the step count into ``state.rng``. Every dropout site, and the seed
the attention kernel draws per call, comes from those generators, so a step
re-run from the same state and batch gives the same loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.training.loss import (
    huber_elementwise,
    huber_loss,
    pinball_elementwise,
    pinball_loss,
)
from tec_mollm_tpu_torch.training.optimizer import (
    build_optimizer,
    clip_by_global_norm_,
    trainable_mask,
)
from tec_mollm_tpu_torch.training.schedule import cosine_annealing_warm_restarts


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int                # dropout seed; each step derives its own from it
    step: int = 0            # optimizer updates performed
    # EMA of the trainable parameters when TrainConfig.ema_decay > 0, else None
    ema: dict[str, torch.Tensor] | None = None

    def trainable(self) -> dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters() if p.requires_grad}

    def frozen(self) -> dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters() if not p.requires_grad}

    @contextlib.contextmanager
    def eval_params(self) -> Iterator[torch.nn.Module]:
        """The model with the parameters evaluation should use: the EMA weights
        when tracked (swapped in for the block and back out after it), else
        the raw ones. The JAX TrainState's ``eval_params``."""
        if self.ema is None:
            yield self.model
            return
        params = self.trainable()
        for n, p in params.items():
            p.data, self.ema[n] = self.ema[n], p.data
        try:
            yield self.model
        finally:
            for n, p in params.items():
                p.data, self.ema[n] = self.ema[n], p.data


def create_train_state(
    model: torch.nn.Module,
    cfg: Config,
    seed: int | None = None,
    frozen_dtype: torch.dtype | None = None,
) -> tuple[TrainState, dict[str, bool]]:
    """Freeze ``model``'s non-trainable parameters in place (cast to
    ``frozen_dtype`` when given, e.g. bf16) and build the optimizer over the
    rest. Returns (state, trainable mask by parameter name)."""
    mask = trainable_mask(model)
    for name, p in model.named_parameters():
        if not mask[name]:
            p.requires_grad_(False)
            if frozen_dtype is not None:
                p.data = p.data.to(frozen_dtype)
    trainable = [p for name, p in model.named_parameters() if mask[name]]
    state = TrainState(
        model=model,
        optimizer=build_optimizer(trainable, cfg.train),
        seed=cfg.train.seed if seed is None else seed,
        # the EMA starts AT the initial weights: no debiasing term
        ema={n: p.detach().clone() for n, p in model.named_parameters() if mask[n]}
        if cfg.train.ema_decay > 0 else None,
    )
    return state, mask


def dropout_seed(seed: int, step: int, micro: int) -> int:
    """The default generators' seed for one microbatch of one step."""
    return int(np.random.SeedSequence([seed, step, micro]).generate_state(1, np.uint64)[0] >> 1)


def point_forecast(preds: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(B, L_out, N, Q) -> (B, L_out, N, 1): the forecast itself, or the 0.5
    level in quantile mode."""
    q = cfg.model.median_index
    return preds[..., q : q + 1]


def _targets(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """y (B, N, L_out) -> (B, L_out, N, 1), the model's output layout."""
    return batch["y"].transpose(1, 2)[..., None]


def _objective(preds, targets, cfg: Config, weights=None) -> torch.Tensor:
    if cfg.model.quantiles:
        return pinball_loss(preds, targets, cfg.model.quantiles, weights=weights)
    return huber_loss(preds, targets, delta=cfg.train.huber_delta, weights=weights)


def make_sum_loss_fn(model: torch.nn.Module, cfg: Config) -> Callable:
    """loss_fn(batch, graph) -> (weighted SUM of the elementwise objective,
    weight count); ``graph`` is the (neighbors, neighbor_mask) pair of
    ``graph_inputs``. ``batch['valid']`` (B,) bool, when present, gives
    padded rows weight 0. Summing both over microbatches and dividing once gives
    the valid-weighted mean of the macro batch however its rows are split."""

    def loss_fn(batch: dict[str, torch.Tensor], graph: tuple[torch.Tensor, torch.Tensor | None]):
        preds = model(batch["x"], batch["time_features"], *graph)
        targets = _targets(batch)
        if cfg.model.quantiles:
            elem = pinball_elementwise(preds, targets, cfg.model.quantiles)
        else:
            elem = huber_elementwise(preds, targets, delta=cfg.train.huber_delta)
        valid = batch.get("valid")
        w = torch.ones(preds.shape[0], dtype=elem.dtype, device=elem.device) if valid is None else valid.to(elem.dtype)
        wb = torch.broadcast_to(w[:, None, None, None], elem.shape)
        return (elem * wb).sum(), wb.sum()

    return loss_fn


def make_train_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """train_step(state, batch, graph) -> (state, {"loss", "grad_norm"}).

    ``batch`` arrays have leading dim accumulation_steps * microbatch. Only the
    trainable parameters get gradients."""
    accum = cfg.train.accumulation_steps
    loss_fn = make_sum_loss_fn(model, cfg)
    schedule = cosine_annealing_warm_restarts(
        cfg.train.lr, cfg.train.sched_t0, cfg.train.sched_t_mult, cfg.train.sched_eta_min
    )

    def train_step(state: TrainState, batch: dict[str, torch.Tensor], graph: tuple[torch.Tensor, torch.Tensor | None]):
        model.train()
        params = list(state.trainable().values())
        for p in params:
            p.grad = None
        device = graph[0].device
        forked = [device] if device.type == "cuda" else []
        micro = batch["x"].shape[0] // accum
        loss_sum = torch.zeros((), device=device)
        count_sum = torch.zeros((), device=device)
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()} if accum > 1 else batch
            with torch.random.fork_rng(devices=forked):
                torch.manual_seed(dropout_seed(state.seed, state.step, i))
                wsum, count = loss_fn(mb, graph)
            wsum.backward()
            loss_sum += wsum.detach()
            count_sum += count
        denom = torch.clamp_min(count_sum, 1.0)
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad.div_(denom))
        grad_norm = clip_by_global_norm_(grads, cfg.train.clip_grad_norm)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        if state.ema is not None:
            d = cfg.train.ema_decay
            with torch.no_grad():
                for name, p in state.trainable().items():
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss_sum / denom, "grad_norm": grad_norm}

    return train_step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """eval_step(batch, graph) -> (loss, preds, targets), deterministic
    and under ``torch.no_grad()``; padded rows (``batch['valid']``) carry zero
    loss weight."""

    def eval_step(batch: dict[str, torch.Tensor], graph: tuple[torch.Tensor, torch.Tensor | None]):
        model.eval()
        with torch.no_grad():
            preds = model(batch["x"], batch["time_features"], *graph)
            targets = _targets(batch)
            valid = batch.get("valid")
            if valid is None:
                valid = torch.ones(preds.shape[0], dtype=torch.bool, device=preds.device)
            w = valid.to(preds.dtype)[:, None, None, None]
            return _objective(preds, targets, cfg, weights=w), preds, targets

    return eval_step
