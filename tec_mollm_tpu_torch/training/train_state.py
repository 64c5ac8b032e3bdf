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
the default generators seeded from (state seed, step, microbatch, and the
data-parallel rank when it is not 0), as the JAX step folds the step count
into ``state.rng``. Every dropout site, and the seed
the attention kernel draws per call, comes from those generators, so a step
re-run from the same state and batch gives the same loss. The ranks of one
model group share a data rank, so they draw the same masks over their
replicated activations; the sites inside a split region fold the model rank
in (``parallel/tensor_parallel.split_dropout``).

Tensor parallelism (a model split by ``parallel/tensor_parallel.shard_model_``):
the loss and count are reduced over the data group, DDP runs over the data
group, the partial gradients of ``c_attn``'s replicated ``lora_A`` are summed
over the model group once a macro step, and the clip's norm counts each split
tensor's slices from every rank of the model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    data_group,
    data_rank,
    data_world,
    model_group,
)
from tec_mollm_tpu_torch.parallel.tensor_parallel import partial_grad_names, split_names
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


def dropout_seed(seed: int, step: int, micro: int, rank: int = 0) -> int:
    """The default generators' seed for one microbatch of one step on one
    data-parallel rank (``rank`` is the data rank): each data rank draws its
    own masks over its own rows, and data rank 0 draws those of a
    single-process run."""
    entropy = [seed, step, micro] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def point_forecast(preds: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(B, L_out, N, Q) -> (B, L_out, N, 1): the forecast itself, or the 0.5
    level in quantile mode."""
    q = cfg.model.median_index
    return preds[..., q : q + 1]


def put_batch(batch: dict[str, np.ndarray], device: torch.device, bf16: bool) -> dict[str, torch.Tensor]:
    """A loader batch on ``device``: pinned host memory and an asynchronous
    copy on CUDA. Under ``bf16``, x is cast on the host (the model casts it
    anyway), which halves the bytes of the largest tensor; y stays fp32 for
    the loss and the metrics."""
    out = {}
    cuda = device.type == "cuda"
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if k == "x" and bf16:
            t = t.to(torch.bfloat16)
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=cuda)
    return out


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
    """train_step(state, batch, graph[, data]) -> (state, {"loss", "grad_norm"}).

    ``batch`` arrays have leading dim accumulation_steps * microbatch. Only the
    trainable parameters get gradients. With ``data`` (a ``DeviceSplit``, the
    device-resident archive) ``batch`` is {"starts", "valid"} and each
    microbatch's windows are gathered on the device right before its forward,
    so no more than one microbatch of windows is ever materialized.

    ``model`` may be the ``DistributedDataParallel`` wrapper of the state's
    model: ``batch`` is then this data rank's share of the macro batch. Every
    microbatch but the last runs under ``no_sync``, so the gradients are
    all-reduced once a step, and DDP averages them over the data group. One
    all-reduce of (loss sum, weight count) over the data group gives the
    global count, and the averaged gradient is divided by ``count / dp``: the
    step takes the gradient of the global valid-weighted mean, however the
    rows are split over ranks and microbatches, and every rank applies the
    same update."""
    accum = cfg.train.accumulation_steps
    loss_fn = make_sum_loss_fn(model, cfg)
    ddp = isinstance(model, DistributedDataParallel)
    world, rank = (data_world(), data_rank()) if ddp else (1, 0)
    module = model.module if ddp else model
    split, partial = split_names(module), partial_grad_names(module)
    schedule = cosine_annealing_warm_restarts(
        cfg.train.lr, cfg.train.sched_t0, cfg.train.sched_t_mult, cfg.train.sched_eta_min
    )

    def train_step(
        state: TrainState,
        batch: dict[str, torch.Tensor],
        graph: tuple[torch.Tensor, torch.Tensor | None],
        data=None,
    ):
        model.train()
        trainable = state.trainable()
        params = list(trainable.values())
        for p in params:
            p.grad = None
        device = graph[0].device
        forked = [device] if device.type == "cuda" else []
        micro = batch["starts" if data is not None else "x"].shape[0] // accum
        loss_sum = torch.zeros((), device=device)
        count_sum = torch.zeros((), device=device)
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()} if accum > 1 else batch
            if data is not None:
                mb = data.gather(mb["starts"], mb.get("valid"))
            sync = model.no_sync() if ddp and i < accum - 1 else contextlib.nullcontext()
            with sync:
                with torch.random.fork_rng(devices=forked):
                    torch.manual_seed(dropout_seed(state.seed, state.step, i, rank))
                    wsum, count = loss_fn(mb, graph)
                wsum.backward()
            loss_sum += wsum.detach()
            count_sum += count
        if ddp:
            totals = all_reduce_sum(torch.stack([loss_sum, count_sum]), data_group())
            loss_sum, count_sum = totals[0], totals[1]
        denom = torch.clamp_min(count_sum, 1.0)
        grad_denom = denom / world if world > 1 else denom
        grads = []
        for name, p in trainable.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if name in partial:
                all_reduce_sum(p.grad, model_group())
            grads.append(p.grad.div_(grad_denom))
        grad_norm = clip_by_global_norm_(
            grads, cfg.train.clip_grad_norm, [n in split for n in trainable] if split else None
        )
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        if state.ema is not None:
            d = cfg.train.ema_decay
            with torch.no_grad():
                for name, p in trainable.items():
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss_sum / denom, "grad_norm": grad_norm}

    return train_step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """eval_step(batch, graph[, data]) -> (loss, preds, targets), deterministic
    and under ``torch.no_grad()``; padded rows (``batch['valid']``) carry zero
    loss weight. With ``data`` (a ``DeviceSplit``) ``batch`` is {"starts",
    "valid"} and the windows are gathered on the device, as in the train step."""

    def eval_step(batch: dict[str, torch.Tensor], graph: tuple[torch.Tensor, torch.Tensor | None], data=None):
        model.eval()
        if data is not None:
            batch = data.gather(batch["starts"], batch.get("valid"))
        with torch.no_grad():
            preds = model(batch["x"], batch["time_features"], *graph)
            targets = _targets(batch)
            valid = batch.get("valid")
            if valid is None:
                valid = torch.ones(preds.shape[0], dtype=torch.bool, device=preds.device)
            w = valid.to(preds.dtype)[:, None, None, None]
            return _objective(preds, targets, cfg, weights=w), preds, targets

    return eval_step
