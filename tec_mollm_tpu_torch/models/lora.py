"""Dense projection with an additive low-rank adapter (peft LoRA semantics).

    y = x @ W + b + (alpha / r) * lora_B(lora_A(dropout(x)))

``weight`` keeps GPT-2's Conv1D layout (in, out), and ``lora_A.weight`` (r, in)
and ``lora_B.weight`` (out, r) keep peft's, so a reference state_dict loads
without transposes. lora_A starts kaiming-uniform (bound 1/sqrt(in)), lora_B at
zero, so the adapter starts as the identity.

``parallel`` is the layer's tensor-parallel form once
``parallel/tensor_parallel.shard_model_`` has sliced it: ``"column"`` holds
this rank's output columns (and ``lora_B`` rows) and takes its input through
``copy_to_model_group``; ``"row"`` holds this rank's input rows, sums the
partial products over the model group and adds the bias once, after the sum.
``None`` is the whole layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.parallel.tensor_parallel import copy_to_model_group, reduce_from_model_group


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
        self.parallel: str | None = None
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
        if self.parallel == "row":
            if self.rank > 0:
                raise ValueError("a row-parallel layer takes no LoRA adapter")
            return reduce_from_model_group(x @ self.weight.to(dt)) + self.bias.to(dt)
        if self.parallel == "column":
            x = copy_to_model_group(x)
        y = x @ self.weight.to(dt) + self.bias.to(dt)
        if self.rank > 0:
            h = F.dropout(x, self.lora_dropout, self.training)
            a = self.lora_A.weight.t().to(dt)
            b = self.lora_B.weight.t().to(dt)
            y = y + (h @ a) @ b * self.scaling
        return y
