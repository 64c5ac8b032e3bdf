"""Dense projection with an additive low-rank adapter (peft LoRA semantics).

    y = x @ W + b + (alpha / r) * lora_B(lora_A(dropout(x)))

``weight`` keeps GPT-2's Conv1D layout (in, out), and ``lora_A.weight`` (r, in)
and ``lora_B.weight`` (out, r) keep peft's, so a reference state_dict loads
without transposes. lora_A starts kaiming-uniform (bound 1/sqrt(in)), lora_B at
zero, so the adapter starts as the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LoRADense(nn.Module):
    def __init__(
        self,
        in_features: int,
        features: int,
        rank: int = 0,
        alpha: float = 0.0,
        lora_dropout: float = 0.0,
    ):
        super().__init__()
        self.rank = rank
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        if rank > 0:
            self.lora_A = nn.Linear(in_features, rank, bias=False)
            self.lora_B = nn.Linear(rank, features, bias=False)
            self.scaling = alpha / rank
            self.lora_dropout = lora_dropout

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=g)
        nn.init.zeros_(self.bias)
        if self.rank > 0:
            bound = 1.0 / math.sqrt(self.weight.shape[0])
            nn.init.uniform_(self.lora_A.weight, -bound, bound, generator=g)
            nn.init.zeros_(self.lora_B.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = x @ self.weight.to(dt) + self.bias.to(dt)
        if self.rank > 0:
            h = F.dropout(x, self.lora_dropout, self.training)
            a = self.lora_A.weight.t().to(dt)
            b = self.lora_B.weight.t().to(dt)
            y = y + (h @ a) @ b * self.scaling
        return y
