"""Prediction head: flatten the LLM tokens -> Linear -> exact GELU -> Dropout ->
Linear to L_out * num_outputs (``prediction_head.mlp.{0,3}`` in the reference).

Under tensor parallelism (``split``, set by
``parallel/tensor_parallel.shard_model_``) fc1 is column-parallel, the
dropout draws a per-rank mask over the rank's hidden units, and fc2 is
row-parallel: the partial products are summed over the model group and its
bias added once after the sum."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models.temporal import lecun_normal_
from tec_mollm_tpu_torch.parallel.tensor_parallel import (
    copy_to_model_group,
    reduce_from_model_group,
    split_dropout,
)


class PredictionHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hidden = cfg.head_input_dim // cfg.head_hidden_ratio
        self.mlp = nn.Sequential(
            nn.Linear(cfg.head_input_dim, hidden),
            nn.GELU(),
            nn.Dropout(cfg.head_dropout),
            nn.Linear(hidden, cfg.prediction_horizon * cfg.num_outputs),
        )
        self.split = False

    def reset_parameters(self, g: torch.Generator) -> None:
        for lin in (self.mlp[0], self.mlp[3]):
            lecun_normal_(lin.weight, lin.in_features, g)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, P, d_llm) -> (B, L_out * num_outputs)."""
        x = x.reshape(x.shape[0], -1)
        fc1, drop, fc2 = self.mlp[0], self.mlp[2], self.mlp[3]
        dt = x.dtype
        if self.split:
            x = F.gelu(F.linear(copy_to_model_group(x), fc1.weight.to(dt), fc1.bias.to(dt)))
            x = split_dropout(x, drop.p, self.training, True)
            return reduce_from_model_group(F.linear(x, fc2.weight.to(dt))) + fc2.bias.to(dt)
        x = F.gelu(F.linear(x, fc1.weight.to(dt), fc1.bias.to(dt)))
        return F.linear(drop(x), fc2.weight.to(dt), fc2.bias.to(dt))
