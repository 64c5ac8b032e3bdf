"""The byte LM's pretraining step (``scripts/pretrain_backbone.py:119-131`` of
the JAX package, in PyTorch).

One step: the next-byte loss of the model in train mode, its gradients, optax's
``clip_by_global_norm(1.0)``, and AdamW (b1 0.9, b2 0.999, eps 1e-8, weight
decay 0.01) over every parameter, since optax's ``adamw`` has no mask there, at
the schedule's rate for the 0-based update count. Parameters stay fp32; the
model's ``dtype`` is the compute dtype (bf16 in the CLI, as the JAX script's
``ByteLM(cfg, dtype=jnp.bfloat16)``). The step's dropout draws come from the
default generators seeded from (seed, step), as in the forecast model's step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tec_mollm_tpu_torch.models.byte_lm import ByteLM, next_byte_loss
from tec_mollm_tpu_torch.training.optimizer import clip_by_global_norm_
from tec_mollm_tpu_torch.training.train_state import dropout_seed

CLIP_NORM = 1.0
WEIGHT_DECAY = 0.01


@dataclasses.dataclass
class PretrainState:
    model: ByteLM
    optimizer: torch.optim.AdamW
    seed: int      # dropout seed; each step derives its own from it
    step: int = 0  # optimizer updates performed


def create_pretrain_state(model: ByteLM, seed: int = 0) -> PretrainState:
    """AdamW over every parameter; the step sets ``lr`` before each update."""
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY
    )
    return PretrainState(model=model, optimizer=optimizer, seed=seed)


def make_pretrain_step(schedule: Callable[[int], float]) -> Callable:
    """step(state, tokens (B, T) int) -> {"loss", "grad_norm"}; updates the
    state in place."""

    def step(state: PretrainState, tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        forked = [tokens.device] if tokens.device.type == "cuda" else []
        with torch.random.fork_rng(devices=forked):
            torch.manual_seed(dropout_seed(state.seed, state.step, 0))
            loss = next_byte_loss(model(tokens), tokens)
        loss.backward()
        grad_norm = clip_by_global_norm_([p.grad for p in params], CLIP_NORM)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def val_loss(model: ByteLM, tokens: torch.Tensor) -> torch.Tensor:
    """The deterministic (eval-mode) next-byte loss, without gradients."""
    model.eval()
    with torch.no_grad():
        return next_byte_loss(model(tokens), tokens)
