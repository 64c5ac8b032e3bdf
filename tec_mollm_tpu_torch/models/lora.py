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

Every form but the row-parallel one finishes the layer inside one product:
``addmm`` on the 2-D view of the input adds the bias in the GEMM's epilogue
(cuBLASLt's, on the card), and an adapter joins the same product as extra
columns of its input, ``[x | dropout(x) A] @ [[W], [s B]]``, its scale folded
into ``lora_B``'s cast weight. So no elementwise pass runs over the layer's
output. That product's backward (``_AdaptedProduct``) forms only the
gradients its inputs need: a frozen ``W`` gets none, as it would from its own
product. The row-parallel form adds its bias after the sum over the group,
which no epilogue can. Each call counts its form in the tracer
(``llm.dense.epilogue`` or ``llm.dense.row_parallel``).

``bias=False`` is the bias-free form (DeepSeek-V2's projections): the same
one product, ``mm`` in place of ``addmm``, adapter columns and all.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.parallel.tensor_parallel import copy_to_model_group, reduce_from_model_group
from tec_mollm_tpu_torch.utils.profiler import count


def _product(bias: torch.Tensor | None, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, plus ``bias`` in the product's epilogue where there is one."""
    return torch.mm(x, w) if bias is None else torch.addmm(bias, x, w)


class _AdaptedProduct(torch.autograd.Function):
    """``addmm(bias, [x | xa], [[w], [b]])`` for 2-D ``x`` (M, K), ``xa``
    (M, r), ``w`` (K, F), ``b`` (r, F): one product over K + r, whose backward
    takes the weights' gradients from their own inputs, so that a weight that
    needs none costs nothing. ``bias`` None: ``mm`` of the same."""

    @staticmethod
    def forward(ctx, bias, x, w, xa, b):
        wb = torch.cat([w, b])
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None, xa, wb)
        return _product(bias, torch.cat([x, xa], dim=1), wb)

    @staticmethod
    def backward(ctx, g):
        x, xa, wb = ctx.saved_tensors
        need_bias, need_x, need_w, need_xa, need_b = ctx.needs_input_grad
        g_x = g_xa = None
        if need_x or need_xa:
            g_x, g_xa = (g @ wb.t()).split([wb.shape[0] - xa.shape[1], xa.shape[1]], dim=1)
        return (
            g.sum(0) if need_bias else None,
            g_x,
            x.t() @ g if need_w else None,
            g_xa,
            xa.t() @ g if need_b else None,
        )


class LoRADense(nn.Module):
    def __init__(
        self,
        in_features: int,
        features: int,
        rank: int = 0,
        alpha: float = 0.0,
        lora_dropout: float = 0.0,
        bias: bool = True,
    ):
        super().__init__()
        self.rank = rank
        self.parallel: str | None = None
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        if rank > 0:
            self.lora_A = nn.Linear(in_features, rank, bias=False)
            self.lora_B = nn.Linear(rank, features, bias=False)
            self.scaling = alpha / rank
            self.lora_dropout = lora_dropout

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=g)
        if self.bias is not None:
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
            count("llm.dense.row_parallel")
            y = reduce_from_model_group(x @ self.weight.to(dt))
            return y if self.bias is None else y + self.bias.to(dt)
        if self.parallel == "column":
            x = copy_to_model_group(x)
        count("llm.dense.epilogue")
        k = x.shape[-1]
        x2, w = x.reshape(-1, k), self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.rank > 0:
            h = F.dropout(x, self.lora_dropout, self.training).reshape(-1, k)
            a = self.lora_A.weight.t().to(dt)
            b = (self.lora_B.weight.t() * self.scaling).to(dt)
            y = _AdaptedProduct.apply(bias, x2, w, h @ a, b)
        else:
            y = _product(bias, x2, w)
        return y.reshape(*x.shape[:-1], y.shape[-1])
