"""Truncated GPT-2 backbone with LoRA on c_attn (HF GPT-2 numerics).

inputs_embeds + wpe -> ``llm_layers`` blocks -> ln_f; LayerNorm eps 1e-5,
tanh-GELU MLP, attention scale 1/sqrt(head_dim), causal mask, dropout 0.1.
Parameter names follow HF/peft under the reference's ``llm_backbone.model``.

Paths, as in the JAX package:

* LayerNorm is the lean form (fp32 statistics from E[x^2] - mu^2, affine in
  the compute dtype), the JAX forecast model's default; ``lean_ln=False`` gives
  the JAX backbone's own default, fp32 LayerNorms cast to the compute dtype
  (the byte LM's);
* attention over T <= ``UNROLL_MAX_SEQ`` tokens is the unrolled form, or the
  short-attention kernel with ``fused_attn=True``; longer sequences take the
  flash-attention kernel with ``use_flash=True``, else the einsum form. Both
  kernels drop attention probabilities in training, as JAX's einsum branch
  does (JAX's own flash branch draws no mask, but its ``ByteLM`` pretrains
  through the einsum branch, and the port's pretrains through the kernel);
* ``use_fused_mlp=True`` sends ln_2 -> MLP -> residual of an eval call to the
  fused kernel, whose LayerNorm is two-pass (as ``ops/fused_mlp.py`` is);
* on eval calls on the card, ``GPT2Backbone`` runs every lean LayerNorm with
  the residual add before it as one CUDA kernel (``ops/add_layernorm.py``: the
  same arithmetic, one read and one write of each row) wherever
  ``GPT2Backbone.norm_kernel_refusal`` finds nothing against it; each call
  counts ``llm.ln.kernel`` in the tracer;
* ``remat=True`` recomputes each block in the backward under a named policy
  (``REMAT_POLICIES``, the JAX backbone's): None, 'full' and
  'nothing_saveable' save nothing and recompute the whole block;
  'dots_saveable' saves the outputs of the matrix products (``aten.mm``,
  ``addmm``, ``bmm``) and recomputes everything else, the kernels' ops too.

Under tensor parallelism (``parallel/tensor_parallel.shard_model_``) an
attention runs its rank's ``heads / mp`` heads through whichever path above
(``c_attn`` column-parallel, ``c_proj`` row-parallel) and draws its
probability-dropout masks per rank; the MLP's ``c_fc`` is column-parallel and
its ``c_proj`` row-parallel.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models.deepseek_v2 import DeepSeekV2Backbone
from tec_mollm_tpu_torch.models.lora import LoRADense
from tec_mollm_tpu_torch.ops.add_layernorm import add_layernorm, add_layernorm_takes, lean_layernorm
from tec_mollm_tpu_torch.ops.flash_attention import flash_attention
from tec_mollm_tpu_torch.ops.fused_mlp import fused_ln_mlp
from tec_mollm_tpu_torch.ops.short_attention import short_causal_attention
from tec_mollm_tpu_torch.parallel.tensor_parallel import fold_model_rank, split_dropout
from tec_mollm_tpu_torch.utils.profiler import count

# Sequences up to this length use the unrolled attention (or the kernel).
UNROLL_MAX_SEQ = 8
# the devices whose tensors take the add + LayerNorm kernel on eval calls (its
# op runs the plain mirror on a CPU tensor, which a test reaches by adding "cpu")
KERNEL_DEVICES = ("cuda",)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save what the matrix products return, recompute the rest (JAX's
    ``jax.checkpoint_policies.dots_saveable``)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


# The remat policies by name: the selective-checkpoint policy of each, None
# meaning the whole block is recomputed.
REMAT_POLICIES = {
    None: None,
    "full": None,
    "dots_saveable": _dots_saveable,
    "nothing_saveable": None,
}


def fp32_layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """Statistics and affine in fp32, the result cast to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def unrolled_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, dropout: float = 0.0, split: bool = False
) -> torch.Tensor:
    """Causal softmax attention over (M, T, D) with the (query, key) pairs
    unrolled: q*k in the compute dtype, scores and softmax in fp32, the
    weighted sum in the compute dtype. ``dropout`` applies to the weights
    (per model rank when the heads are ``split``)."""
    m, t, d = q.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd)

    def split(a: torch.Tensor) -> torch.Tensor:  # (M, D) -> (M, H, Dh)
        return a.reshape(m, heads, hd)

    ks = [split(k[:, s]) for s in range(t)]
    vs = [split(v[:, s]) for s in range(t)]
    outs = []
    for tq in range(t):
        qt = split(q[:, tq])
        scores = [(qt * ks[s]).float().sum(dim=-1) * scale for s in range(tq + 1)]
        mx = scores[0]
        for s_val in scores[1:]:
            mx = torch.maximum(mx, s_val)
        exps = [torch.exp(s_val - mx) for s_val in scores]
        denom = sum(exps)
        alphas = [split_dropout(e / denom, dropout, dropout > 0.0, split) for e in exps]
        out_t = alphas[0].to(v.dtype)[:, :, None] * vs[0]
        for s in range(1, tq + 1):
            out_t = out_t + alphas[s].to(v.dtype)[:, :, None] * vs[s]
        outs.append(out_t.reshape(m, d))
    return torch.stack(outs, dim=1)


def _einsum_causal_attention(q, k, v, heads: int, dropout: float, split: bool = False) -> torch.Tensor:
    """fp32 scores and softmax, probabilities cast back for the PV product."""
    b, t, d = q.shape
    hd = d // heads
    q4, k4, v4 = (a.reshape(b, t, heads, hd) for a in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q4.float(), k4.float()) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
    probs = split_dropout(torch.softmax(scores, dim=-1).to(q.dtype), dropout, dropout > 0.0, split)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v4).reshape(b, t, d)


def _call_seed(p: float, split: bool = False) -> int:
    if p == 0.0:
        return 0
    seed = int(torch.randint(0, 2**31 - 1, ()))
    return fold_model_rank(seed) if split else seed


class GPT2Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, fused_attn: bool = False, use_flash: bool = False):
        super().__init__()
        d = cfg.d_llm
        self.heads = cfg.llm_heads  # this rank's heads once split
        self.split = False  # set by tensor_parallel.shard_model_
        self.dropout = cfg.llm_dropout
        self.fused_attn = fused_attn
        self.use_flash = use_flash
        self.c_attn = LoRADense(d, 3 * d, cfg.lora_r, cfg.lora_alpha, cfg.lora_dropout)
        self.c_proj = LoRADense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        d = q.shape[-1]  # the local heads' width
        p = self.dropout if self.training else 0.0
        # a kernel's dropout seed: fresh per call from the default generator, as
        # the JAX model draws one from its dropout rng; the train step seeds
        # that generator
        if self.fused_attn and t <= UNROLL_MAX_SEQ:
            out = short_causal_attention(q, k, v, self.heads, dropout_rate=p, seed=_call_seed(p, self.split))
        elif self.use_flash and t > 1 and t > UNROLL_MAX_SEQ:
            q4, k4, v4 = (a.reshape(b, t, self.heads, d // self.heads) for a in (q, k, v))
            out = flash_attention(
                q4, k4, v4, causal=True, dropout_rate=p, seed=_call_seed(p, self.split)
            ).reshape(b, t, d)
        elif t <= UNROLL_MAX_SEQ:
            out = unrolled_causal_attention(q, k, v, self.heads, p, self.split)
        else:
            out = _einsum_causal_attention(q, k, v, self.heads, p, self.split)
        return F.dropout(self.c_proj(out), self.dropout, self.training)


class GPT2MLP(nn.Module):
    def __init__(self, d: int, ratio: int):
        super().__init__()
        self.c_fc = LoRADense(d, ratio * d)
        self.c_proj = LoRADense(ratio * d, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(h), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig,
        fused_attn: bool = False,
        use_fused_mlp: bool = False,
        use_flash: bool = False,
        lean_ln: bool = True,
    ):
        super().__init__()
        d = cfg.d_llm
        self.use_fused_mlp = use_fused_mlp
        self.dropout = cfg.llm_dropout
        self.norm = lean_layernorm if lean_ln else fp32_layernorm
        self.ln_1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = GPT2Attention(cfg, fused_attn, use_flash)
        self.ln_2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = GPT2MLP(d, cfg.llm_mlp_ratio)

    def fused_mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x + MLP(ln_2(x)) through the fused LN -> MLP -> residual kernel."""
        d = x.shape[-1]
        fc, proj = self.mlp.c_fc, self.mlp.c_proj
        out = fused_ln_mlp(
            x.reshape(-1, d), self.ln_2.weight, self.ln_2.bias,
            fc.weight, fc.bias, proj.weight, proj.bias, self.ln_2.eps,
        )
        return out.reshape(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm(x, self.ln_1.weight, self.ln_1.bias, self.ln_1.eps))
        if self.use_fused_mlp and not self.training:
            return self.fused_mlp(x)
        h = self.norm(x, self.ln_2.weight, self.ln_2.bias, self.ln_2.eps)
        return x + F.dropout(self.mlp(h), self.dropout, self.training)


class GPT2Backbone(nn.Module):
    """inputs_embeds (B, T, d_llm) -> last hidden state (B, T, d_llm)."""

    def __init__(
        self,
        cfg: ModelConfig,
        fused_attn: bool = False,
        use_fused_mlp: bool = False,
        use_flash: bool = False,
        lean_ln: bool = True,
        remat: bool = False,
        remat_policy: str | None = None,
    ):
        super().__init__()
        self.dropout = cfg.llm_dropout
        self.lean_ln = lean_ln
        self.norm = lean_layernorm if lean_ln else fp32_layernorm
        # recompute each block's activations in the backward under the named
        # policy (the JAX model's remat_llm and remat_policy); the checkpoint
        # restores the RNG state, so the recomputed dropout masks are the forward's
        self.remat = remat
        self.context_fn = noop_context_fn
        if remat:
            if remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    f"unknown remat_policy {remat_policy!r}; valid values: "
                    f"{sorted(k for k in REMAT_POLICIES if k is not None)} (or None, meaning full remat)"
                )
            policy = REMAT_POLICIES[remat_policy]
            if policy is not None:
                self.context_fn = functools.partial(create_selective_checkpoint_contexts, policy)
        self.wpe = nn.Embedding(cfg.llm_max_positions, cfg.d_llm)
        self.h = nn.ModuleList(
            GPT2Block(cfg, fused_attn, use_fused_mlp, use_flash, lean_ln)
            for _ in range(cfg.llm_layers)
        )
        self.ln_f = nn.LayerNorm(cfg.d_llm, eps=1e-5)

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.wpe.weight, 0.0, 0.02, generator=g)
        for block in self.h:
            for ln in (block.ln_1, block.ln_2):
                nn.init.ones_(ln.weight)
                nn.init.zeros_(ln.bias)
            for dense in (block.attn.c_attn, block.attn.c_proj, block.mlp.c_fc, block.mlp.c_proj):
                dense.reset_parameters(g)
        nn.init.ones_(self.ln_f.weight)
        nn.init.zeros_(self.ln_f.bias)

    def norm_kernel_refusal(self, x: torch.Tensor) -> str | None:
        """None when this call's LayerNorms and residual adds run the add +
        LayerNorm kernel, else why the plain ones run them: the kernel takes
        eval calls on the card that need no gradient, with the lean
        LayerNorm, at the dtype and width ``add_layernorm_takes`` accepts."""
        if x.device.type not in KERNEL_DEVICES:
            return f"a {x.device.type} tensor: the kernel runs on the card"
        if self.training:
            return "train mode: the training forward and its backward stay with autograd"
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in self.parameters())):
            return "an input requires grad under grad mode: the kernel has no backward"
        if not self.lean_ln:
            return "lean_ln=False: the fp32 LayerNorms are another algorithm"
        return add_layernorm_takes(x.shape[-1], x.dtype)

    def _add_norm(self, x: torch.Tensor, delta: torch.Tensor | None, ln: nn.LayerNorm):
        count("llm.ln.kernel")
        return add_layernorm(x, delta, ln.weight, ln.bias, ln.eps)

    def _kernel_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The eval loop on the add + LayerNorm kernel, carrying the residual
        stream x and its normalised rows h from block to block: block 0's ln_1
        alone, then in each block the attention's residual add with ln_2 and
        the MLP's with the next block's ln_1 (ln_f after the last). A block on
        the fused MLP kernel keeps its own ln_2 and MLP residual, and the next
        norm takes no residual."""
        norms = [block.ln_1 for block in self.h] + [self.ln_f]
        h = self._add_norm(x, None, norms[0])
        for block, ln_next in zip(self.h, norms[1:]):
            a = block.attn(h)
            if block.use_fused_mlp:
                x = block.fused_mlp(x + a)
                h = self._add_norm(x, None, ln_next)
            else:
                x, h = self._add_norm(x, a, block.ln_2)
                x, h = self._add_norm(x, block.mlp(h), ln_next)
        return h

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        t = inputs_embeds.shape[1]
        dt = inputs_embeds.dtype
        x = F.dropout(inputs_embeds + self.wpe.weight[:t].to(dt)[None], self.dropout, self.training)
        if self.norm_kernel_refusal(x) is None:
            return self._kernel_forward(x)
        for block in self.h:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False, context_fn=self.context_fn)
            else:
                x = block(x)
        return self.norm(x, self.ln_f.weight, self.ln_f.bias, self.ln_f.eps)


class LLMBackbone(nn.Module):
    """Holder that gives the backbone the reference's ``llm_backbone.model``
    prefix: GPT-2, or DeepSeek-V2 where the config sets ``deepseek_v2``
    (``models/deepseek_v2.py``)."""

    def __init__(self, cfg: ModelConfig, **kwargs):
        super().__init__()
        backbone = GPT2Backbone if cfg.deepseek_v2 is None else DeepSeekV2Backbone
        self.model = backbone(cfg, **kwargs)

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        return self.model(inputs_embeds)
