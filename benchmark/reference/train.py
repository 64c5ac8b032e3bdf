"""The reference's training steps: Huber loss, gradients, clipping, AdamW.

One step over a macro batch of windows: the Huber loss (delta from the
configuration) summed over every element of every valid window and divided
once by their count, its gradient with respect to the trainable tensors only
(``model.trainable``), clipped by global norm (scale ``min(1, max / norm)``),
then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
trainable tensor) at the rate of ``CosineAnnealingWarmRestarts(T_0, T_mult,
eta_min)`` at that step.

The caller names the rows of each step's macro batch on each data rank and
hands the dropout masks of each (step, rank) to ``model.Masks``: the
reference follows the rows and masks it is given, whatever rule chose them.
A rank's macro batch is ``accumulation_steps`` microbatches of
``batch_size`` rows, in order; the loss and the gradient are the mean over
every row of every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import model as ref


def learning_rate(step: int, base: float, t0: int, t_mult: int, eta_min: float) -> float:
    start, length = 0, t0
    while step >= start + length:
        start, length = start + length, length * t_mult
    return eta_min + (base - eta_min) * 0.5 * (1.0 + math.cos(math.pi * (step - start) / length))


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    err = (pred - target).abs()
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad * quad + delta * (err - quad)


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], weight_decay: float):
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params, grads, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
        self.t += 1
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p.mul_(1 - lr * self.wd).sub_(lr * m_hat / (v_hat.sqrt() + eps))


def run_steps(
    params: dict[str, torch.Tensor],
    windows,                   # windows(rows) -> (x (B, L, N, C), tf (B, L, 4), y (B, N, L_out)) on the device
    batches: list[list],       # batches[step][rank]: the window rows of that rank's macro batch
    config: dict,
    graph: ref.Graph,
    prec: ref.Precision,
    masks,                     # masks(step, rank): the source of that rank's dropout masks in the step
    half_batch: bool = False,
) -> dict:
    """One step per entry of ``batches`` from ``params`` (changed in place):
    {"loss": [per step], "grad_norms": {name: norm of the clipped gradient of
    step 1}, "params": the trainable tensors after the last step}.
    ``half_batch`` plants a fault: half of each macro batch's rows left out,
    the mean taken over the rest."""
    t = config["train"]
    dims = ref.Dims.of(config)
    micro, accum = t["batch_size"], t["accumulation_steps"]
    per_rank = micro * accum
    train = {k: v.requires_grad_(True) for k, v in params.items() if ref.trainable(k)}
    opt = Adam(train, t["weight_decay"])
    device = next(iter(params.values())).device
    losses, first_grads = [], {}
    for step, ranks in enumerate(batches):
        total = torch.zeros((), dtype=torch.float64, device=device)
        grads = {k: torch.zeros_like(v) for k, v in train.items()}
        pieces = []
        for r, rows in enumerate(ranks):
            rows = np.asarray(rows)
            if len(rows) != per_rank:
                raise ValueError(f"the reference follows full macro batches of {per_rank} rows, not {len(rows)}")
            for i in range(accum):
                pieces.append((r, rows[i * micro:(i + 1) * micro]))
        if half_batch:
            pieces = [(r, rows[: max(1, len(rows) // 2)]) if micro > 1 else (r, rows)
                      for k, (r, rows) in enumerate(pieces) if micro > 1 or k % accum < accum // 2]
        count = sum(len(rows) for _, rows in pieces) * dims.l_out * dims.n
        sources = {r: masks(step, r) for r in range(len(ranks))}
        for r, rows in pieces:
            x, tf, y = windows(rows)
            pred = ref.forward(params, x, tf, graph, dims, prec, ref.Masks(dims, len(rows), device, sources[r]))
            loss_sum = huber(pred, y.transpose(1, 2)[..., None], t["huber_delta"]).sum()
            g = torch.autograd.grad(loss_sum / count, list(train.values()))
            for k, gk in zip(train, g):
                grads[k] += gk
            total += loss_sum.detach().double()
        if not half_batch:
            for source in sources.values():
                source.finish()
        norm = torch.sqrt(sum((gk.double() ** 2).sum() for gk in grads.values()))
        scale = 1.0 if norm < t["clip_grad_norm"] else float(t["clip_grad_norm"] / norm)
        for gk in grads.values():
            gk.mul_(scale)
        if step == 0:
            first_grads = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        lr = learning_rate(step, t["lr"], t["sched_t0"], t["sched_t_mult"], t["sched_eta_min"])
        opt.step(train, grads, lr)
        losses.append(float(total / count))
    return {"loss": losses, "grad_norms": first_grads,
            "params": {k: v.detach() for k, v in train.items()}}
