"""DeepSeek-V2 backbone (HF ``modeling_deepseek.py`` numerics) for TEC-MoLLM.

inputs_embeds (B, T, d) -> ``llm_layers`` blocks -> RMSNorm ``norm``; no
learned positions (RoPE inside the attention). A block is

    x += MLA(RMSNorm_in(x));  x += FFN(RMSNorm_post(x))

* **MLA** (multi-head latent attention, no query compression): q = x W_q as
  (heads, nope + rope); [c_kv | k_pe] = x W_kva, c_kv through its RMSNorm,
  [k_nope | v] = c_kv W_kvb per head, k_pe shared by every head. RoPE on q_pe
  and k_pe in HF DeepSeek-V2's interleaved layout, at YaRN's frequencies
  (``yarn_inv_freq``); scores q.k over nope + rope dims times
  ``softmax_scale`` (1/sqrt(q_head_dim) times YaRN's mscale squared), causal,
  softmax in fp32. LoRA on ``q_proj`` and ``kv_a_proj_with_mqa`` (the
  counterparts of GPT-2's ``c_attn``), in ``LoRADense``'s bias-free form.
* **FFN**: the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; the rest DeepSeekMoE (``MoE``): shared experts (one
  SwiGLU of ``n_shared_experts`` x ``moe_intermediate_size``) plus the top-k
  routed experts of a softmax gate in fp32 (greedy; each expert's output
  weighted by its probability, not renormalised, as V2-Lite publishes).

Dispatch runs on the device without reading anything back (``dispatch_plan``):
the (token, slot) rows are sorted by expert, each expert's group padded to a
multiple of ``ALIGN`` rows with zero rows, and the routed experts
(``RoutedExperts``, the stacked (E, ...) weights in a submodule of their own)
are three grouped products (``torch._grouped_mm``) over that buffer; the
combine gathers each token's k weighted rows back and sums them. Padding rows
are zero in and zero out.

Parameter names follow HF's under the reference's ``llm_backbone.model``
(``layers.{i}.self_attn.q_proj``, ``mlp.gate``, ``mlp.shared_experts.*``,
``norm``), so importing a published checkpoint stacks the per-expert tensors
(``mlp.experts.{e}.gate_proj.weight`` -> ``mlp.experts.gate_proj``, HF's
(out, in) layout kept) and transposes ``q_proj`` and ``kv_a_proj_with_mqa``
(``LoRADense`` keeps GPT-2's (in, out)). Departures from the published
model: no auxiliary balance loss (the router is frozen and the loss is the
forecast's) and no dropout inside the backbone but LoRA's.

While a profiler records, each call opens the spans ``llm.mla.attention``,
``llm.moe.route``, ``llm.moe.dispatch``, ``llm.moe.experts`` and
``llm.moe.combine`` and counts ``llm.moe.calls``, ``llm.moe.rows`` (routed
rows) and ``llm.moe.rows_max`` (the heaviest expert's rows, the one read of
the device it makes, and only then).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import DeepSeekV2Config, ModelConfig
from tec_mollm_tpu_torch.models.lora import LoRADense
from tec_mollm_tpu_torch.utils import profiler

# rows of each expert's group in the grouped products: a multiple of this
ALIGN = 16


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_positions: int) -> float:
    return dim * math.log(max_positions / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(ds: DeepSeekV2Config) -> torch.Tensor:
    """(rope_dim / 2,) fp32: the original frequencies below the correction
    range, those divided by ``rope_factor`` above it, a linear ramp between."""
    dim, base = ds.qk_rope_head_dim, ds.rope_theta
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inter = extra / ds.rope_factor
    orig = ds.rope_original_max_position_embeddings
    low = max(math.floor(_correction_dim(ds.rope_beta_fast, dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(ds.rope_beta_slow, dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def softmax_scale(ds: DeepSeekV2Config) -> float:
    m = yarn_mscale(ds.rope_factor, ds.rope_mscale_all_dim) if ds.rope_mscale_all_dim else 1.0
    return ds.q_head_dim ** -0.5 * m * m


def rotary(ds: DeepSeekV2Config, inv_freq: torch.Tensor, t: int, dtype: torch.dtype):
    """(cos, sin), each (T, 1, rope_dim) in ``dtype``, at positions 0..T-1."""
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=inv_freq.device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(ds.rope_factor, ds.rope_mscale) / yarn_mscale(ds.rope_factor, ds.rope_mscale_all_dim)
    return (emb.cos() * m).to(dtype)[:, None], (emb.sin() * m).to(dtype)[:, None]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on (..., T, H, D) in HF DeepSeek-V2's layout: the interleaved pairs
    (2i, 2i + 1) gathered into halves, then ``rotate_half``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class RMSNorm(nn.Module):
    """fp32 statistics, the weight applied in the input's dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return self.weight.to(x.dtype) * xf.to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype))


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x): the dense layers' FFN and the shared experts."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.silu(_linear(x, self.gate_proj)) * _linear(x, self.up_proj), self.down_proj)


class MLAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        ds = cfg.deepseek_v2
        d, h = cfg.d_llm, cfg.llm_heads
        self.ds, self.heads = ds, h
        self.scale = softmax_scale(ds)
        lora = (cfg.lora_r, cfg.lora_alpha, cfg.lora_dropout)
        self.q_proj = LoRADense(d, h * ds.q_head_dim, *lora, bias=False)
        self.kv_a_proj_with_mqa = LoRADense(d, ds.kv_lora_rank + ds.qk_rope_head_dim, *lora, bias=False)
        self.kv_a_layernorm = RMSNorm(ds.kv_lora_rank, ds.rms_norm_eps)
        self.kv_b_proj = nn.Linear(ds.kv_lora_rank, h * (ds.qk_nope_head_dim + ds.v_head_dim), bias=False)
        self.o_proj = nn.Linear(h * ds.v_head_dim, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        ds, h = self.ds, self.heads
        b, t, _ = x.shape
        nope, rope = ds.qk_nope_head_dim, ds.qk_rope_head_dim
        with profiler.span("llm.mla.attention"):
            q_nope, q_pe = self.q_proj(x).view(b, t, h, nope + rope).split([nope, rope], dim=-1)
            c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([ds.kv_lora_rank, rope], dim=-1)
            kv = _linear(self.kv_a_layernorm(c_kv), self.kv_b_proj).view(b, t, h, nope + ds.v_head_dim)
            k_nope, v = kv.split([nope, ds.v_head_dim], dim=-1)
            q = torch.cat([q_nope, apply_rotary(q_pe, cos, sin)], dim=-1).transpose(1, 2)   # (B, H, T, qh)
            k_pe = apply_rotary(k_pe.view(b, t, 1, rope), cos, sin).expand(b, t, h, rope)
            k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
            scores = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale
            causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1).to(x.dtype)
            o = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, t, h * ds.v_head_dim)
            return _linear(o, self.o_proj)


class MoEGate(nn.Module):
    """Softmax over the experts from fp32 operands, greedy top-k."""

    def __init__(self, d: int, ds: DeepSeekV2Config):
        super().__init__()
        self.ds = ds
        self.weight = nn.Parameter(torch.empty(ds.n_routed_experts, d))

    def forward(self, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weights (M, k) fp32, experts (M, k) int64) of rows ``x2`` (M, d)."""
        scores = F.linear(x2.float(), self.weight.float()).softmax(dim=-1)
        return torch.topk(scores, self.ds.num_experts_per_tok, dim=-1, sorted=False)


def dispatch_plan(idx: torch.Tensor, experts: int, align: int = ALIGN):
    """Where each routed row goes, from the device alone.

    ``idx`` (M, k): each token's experts. Returns (``rows`` (P,): the (token,
    slot) row ``t * k + s`` that fills each buffer row, or M * k (nothing: a
    zero row) for padding; ``pos`` (M * k,): each row's buffer row; ``offs``
    (E,) int32: each expert's group end, the last at P; ``counts`` (E,)).
    The buffer holds the rows sorted by expert, each group padded to a
    multiple of ``align``; its size P is fixed by the shapes (every group
    padded by its most), so nothing is read back."""
    flat = idx.reshape(-1)
    r = flat.numel()
    dev = flat.device
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(experts, dtype=torch.int64, device=dev).scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + align - 1) // align * align
    ends = torch.cumsum(padded, 0)
    size = -(-(r + experts * (align - 1)) // align) * align
    e_sorted = flat[order]
    shift = (ends - padded) - (torch.cumsum(counts, 0) - counts)   # padded start less the packed start
    pos = torch.empty_like(order)
    pos[order] = torch.arange(r, device=dev) + shift[e_sorted]
    rows = torch.full((size,), r, dtype=torch.int64, device=dev)
    rows[pos] = torch.arange(r, device=dev)
    offs = ends.to(torch.int32)
    offs = torch.cat([offs[:-1], offs.new_full((1,), size)])   # the last group takes the tail
    return rows, pos, offs, counts


class RoutedExperts(nn.Module):
    """The stacked SwiGLU experts, HF's (out, in) layout: ``gate_proj`` and
    ``up_proj`` (E, I, d), ``down_proj`` (E, d, I). Takes the dispatched
    buffer (P, d), each row's routing weight (P,) and the groups' ends."""

    def __init__(self, d: int, ds: DeepSeekV2Config):
        super().__init__()
        e, width = ds.n_routed_experts, ds.moe_intermediate_size
        self.gate_proj = nn.Parameter(torch.empty(e, width, d))
        self.up_proj = nn.Parameter(torch.empty(e, width, d))
        self.down_proj = nn.Parameter(torch.empty(e, d, width))

    def forward(self, xb: torch.Tensor, wb: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        dt = xb.dtype

        def grouped(a, w):
            return torch._grouped_mm(a, w.to(dt).transpose(-2, -1), offs=offs)

        h = F.silu(grouped(xb, self.gate_proj)) * grouped(xb, self.up_proj) * wb.to(dt)[:, None]
        return grouped(h, self.down_proj)


class MoE(nn.Module):
    def __init__(self, d: int, ds: DeepSeekV2Config):
        super().__init__()
        self.ds = ds
        self.gate = MoEGate(d, ds)
        self.experts = RoutedExperts(d, ds)
        self.shared_experts = SwiGLU(d, ds.moe_intermediate_size * ds.n_shared_experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ds = self.ds
        x2 = x.reshape(-1, x.shape[-1])
        m, k = x2.shape[0], ds.num_experts_per_tok
        with profiler.span("llm.moe.route"):
            w, idx = self.gate(x2)
        with profiler.span("llm.moe.dispatch"):
            rows, pos, offs, counts = dispatch_plan(idx, ds.n_routed_experts)
            xb = torch.cat([x2, x2.new_zeros(1, x2.shape[1])])[rows // k]
            wb = torch.cat([w.reshape(-1), w.new_zeros(1)])[rows]
        with profiler.span("llm.moe.experts"):
            yb = self.experts(xb, wb, offs)
        with profiler.span("llm.moe.combine"):
            y = yb[pos].view(m, k, -1).sum(dim=1)
        profiler.count("llm.moe.calls")
        profiler.count("llm.moe.rows", m * k)
        if profiler.recording():
            profiler.count("llm.moe.rows_max", int(counts.max()))
        return (y + self.shared_experts(x2)).view_as(x)


class DeepSeekV2Block(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: int):
        super().__init__()
        ds, d = cfg.deepseek_v2, cfg.d_llm
        self.input_layernorm = RMSNorm(d, ds.rms_norm_eps)
        self.self_attn = MLAttention(cfg)
        self.post_attention_layernorm = RMSNorm(d, ds.rms_norm_eps)
        self.mlp = SwiGLU(d, ds.intermediate_size) if layer < ds.first_k_dense_replace else MoE(d, ds)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepSeekV2Backbone(nn.Module):
    """inputs_embeds (B, T, d_llm) -> last hidden state (B, T, d_llm). Takes
    none of GPT-2's opt-in paths: the fused kernels compute GPT-2's block,
    and the blocks are not recomputed (``remat``)."""

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
        taken = {"fused_attn": fused_attn, "use_fused_mlp": use_fused_mlp, "use_flash": use_flash, "remat": remat}
        if any(taken.values()):
            raise ValueError(f"the DeepSeek-V2 backbone takes none of {[k for k, v in taken.items() if v]}")
        self.ds = cfg.deepseek_v2
        self.layers = nn.ModuleList(DeepSeekV2Block(cfg, i) for i in range(cfg.llm_layers))
        self.norm = RMSNorm(cfg.d_llm, self.ds.rms_norm_eps)
        self.register_buffer("inv_freq", yarn_inv_freq(self.ds), persistent=False)

    def reset_parameters(self, g: torch.Generator) -> None:
        """HF's initialisers: normal(0, 0.02) for every projection and expert,
        the gate kaiming-uniform, RMSNorm weights 1, LoRA as ``LoRADense``."""
        for module in self.modules():
            if isinstance(module, RMSNorm):
                nn.init.ones_(module.weight)
            elif isinstance(module, LoRADense):
                module.reset_parameters(g)
            elif isinstance(module, nn.Linear):
                nn.init.normal_(module.weight, 0.0, 0.02, generator=g)
            elif isinstance(module, RoutedExperts):
                for p in module.parameters():
                    nn.init.normal_(p, 0.0, 0.02, generator=g)
            elif isinstance(module, MoEGate):
                bound = 1.0 / math.sqrt(module.weight.shape[1])
                nn.init.uniform_(module.weight, -bound, bound, generator=g)

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        cos, sin = rotary(self.ds, self.inv_freq, inputs_embeds.shape[1], inputs_embeds.dtype)
        x = inputs_embeds
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)
