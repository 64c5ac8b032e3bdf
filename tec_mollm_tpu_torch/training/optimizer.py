"""AdamW over the trainable parameters, global-norm clipping and the schedule.

The reference's policy (``training/optimizer.py`` of the JAX package): every
parameter outside the GPT-2 backbone trains, and inside it only ``lora_A``,
``lora_B``, the LayerNorms ``ln_1``, ``ln_2``, ``ln_f`` and ``wpe``. In the
DeepSeek-V2 backbone the same: LoRA and the RMSNorm weights
(``input_layernorm``, ``post_attention_layernorm``, ``kv_a_layernorm``,
``norm``); the router and the experts stay frozen. AdamW with
b1 0.9, b2 0.999, eps 1e-8 and weight decay on every trainable tensor
(``torch.optim.AdamW`` computes optax's ``adamw`` update), after clipping by
global norm with optax's factor ``min(1, max_norm / norm)``.

Under tensor parallelism the norm is the whole tree's, as optax's over JAX's
sharded tree: the squares of the tensors split over the model group are
summed over it, those of the replicated ones counted once.
"""

from __future__ import annotations

import torch
from torch import nn

from tec_mollm_tpu_torch.config import TrainConfig
from tec_mollm_tpu_torch.parallel.mesh import all_reduce_sum, model_group

TRAINABLE_LLM_TOKENS = (
    "lora_A", "lora_B", "ln_1", "ln_2", "ln_f", "wpe",
    "input_layernorm", "post_attention_layernorm", "kv_a_layernorm", "norm",
)
LLM_MODULE = "llm_backbone"


def is_trainable(name: str, llm_module_name: str = LLM_MODULE) -> bool:
    toks = name.split(".")
    if llm_module_name not in toks:
        return True  # everything outside the LLM trains
    return any(t in toks for t in TRAINABLE_LLM_TOKENS)


def trainable_mask(model: nn.Module, llm_module_name: str = LLM_MODULE) -> dict[str, bool]:
    """Parameter name -> trainable, over ``model.named_parameters()``."""
    return {name: is_trainable(name, llm_module_name) for name, _ in model.named_parameters()}


def build_optimizer(params: list[torch.Tensor], train_cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW at the schedule's first rate; the train step sets ``lr`` before
    every update."""
    return torch.optim.AdamW(
        params, lr=train_cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=train_cfg.weight_decay
    )


def global_norm(grads: list[torch.Tensor], split: list[bool] | None = None) -> torch.Tensor:
    """The L2 norm of every tensor of ``grads`` together. ``split[i]`` marks a
    tensor of which this rank holds a slice: ``sqrt(sum of the replicated
    squares + the model group's sum of the split squares)``."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if not split or not any(split):
        return torch.linalg.vector_norm(norms)
    is_split = torch.tensor(split, device=norms.device)
    squares = norms.square()
    split_sq = all_reduce_sum(squares[is_split].sum(), model_group())
    return torch.sqrt(squares[~is_split].sum() + split_sq)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float, split: list[bool] | None = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / norm)`` (optax's
    ``clip_by_global_norm``: no epsilon added to the norm); returns the norm
    before clipping. ``split`` as in ``global_norm``."""
    norm = global_norm(grads, split)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
