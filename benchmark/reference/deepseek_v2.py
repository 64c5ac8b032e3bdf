"""TEC-MoLLM on a DeepSeek-V2 backbone in plain PyTorch, float32, from the
published description (HF DeepSeek-V2's ``config.json`` and modelling code).

    x (B, L, N, 6) -> embeddings, GATv2 + residual, multi-scale convolutions,
    latent patching to T tokens of d (the front end of ``reference/model.py``,
    copied) -> ``layers`` DeepSeek-V2 blocks -> RMSNorm -> head Linear / GELU /
    Linear -> (B, L_out, N, 1)

A block: x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x)).

* MLA, no query compression: q = x W_q + LoRA, split per head into q_nope and
  q_pe; [c_kv | k_pe] = x W_kva + LoRA; [k_nope | v] = RMSNorm(c_kv) W_kvb per
  head, k_pe shared by the heads. RoPE rotates the pairs (2i, 2i + 1) of q_pe
  and k_pe by position x YaRN's frequency i, and the rotated pair's two
  halves are laid out as HF DeepSeek-V2 does (first every pair's first
  value, then every second value). Scores over nope + rope dims times
  1/sqrt(nope + rope) times YaRN's mscale(factor, mscale_all_dim) squared,
  causal, softmax; o = P v, then W_o.
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU; the others the
  shared experts' SwiGLU plus, for each token, its top-k routed experts by a
  softmax over x W_g^T, each expert's SwiGLU output weighted by its
  probability (not renormalised over the k: ``norm_topk_prob`` false,
  ``routed_scaling_factor`` 1). Each expert runs on the tokens routed to it,
  one expert at a time, and the reference routes on its own scores.

Parameters under the program's names (``specs``); every product takes its
operands through ``model.Precision`` (float32 with TF32 off, or the float8
control). No dropout: the reference scores a frozen model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref

# the seeded weights' scales (``specs``), in units of 1/sqrt(fan_in)
GATE_STD, EXPERT_DOWN_STD, OUT_STD = 1.5, 2.0, 1.0
TRAINABLE_LLM_TOKENS = ("lora_A", "lora_B", "input_layernorm", "post_attention_layernorm", "kv_a_layernorm", "norm")
BACKBONE = "llm_backbone.model"


@dataclass(frozen=True)
class Dims:
    base: ref.Dims
    kv_rank: int
    nope: int
    rope: int
    v: int
    inter: int
    moe_inter: int
    experts: int
    top_k: int
    shared: int
    first_dense: int
    eps: float
    theta: float
    factor: float
    original: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    @classmethod
    def of(cls, config: dict) -> "Dims":
        ds = config["model"]["deepseek_v2"]
        return cls(
            base=ref.Dims.of(config), kv_rank=ds["kv_lora_rank"], nope=ds["qk_nope_head_dim"],
            rope=ds["qk_rope_head_dim"], v=ds["v_head_dim"], inter=ds["intermediate_size"],
            moe_inter=ds["moe_intermediate_size"], experts=ds["n_routed_experts"], top_k=ds["num_experts_per_tok"],
            shared=ds["n_shared_experts"], first_dense=ds["first_k_dense_replace"], eps=ds["rms_norm_eps"],
            theta=ds["rope_theta"],
            factor=ds["rope_factor"], original=ds["rope_original_max_position_embeddings"],
            beta_fast=ds["rope_beta_fast"], beta_slow=ds["rope_beta_slow"], mscale=ds["rope_mscale"],
            mscale_all_dim=ds["rope_mscale_all_dim"],
        )

    def moe(self, layer: int) -> bool:
        return layer >= self.first_dense


def specs(dims: Dims) -> list[tuple[str, tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter, in a fixed order: the
    front end's and the head's as in ``model.specs``, the backbone's between.
    Input projections draw std 1/sqrt(fan_in) and output projections
    1/sqrt(2 x layers x fan_in), the routed experts' 2/sqrt(fan_in) and the
    gate's 1.5/sqrt(d): each sublayer then adds to the residual about as much
    as it holds, and the router's softmax leaves the 6th expert a share worth
    routing to."""
    b = dims.base
    front = [s for s in ref.specs(b) if not s[0].startswith(("llm_backbone.", "prediction_head."))]
    head = [s for s in ref.specs(b) if s[0].startswith("prediction_head.")]
    d, h, r, layers = b.d, b.llm_heads, b.lora_r, b.layers
    qh = dims.nope + dims.rope

    def inp(fan_in):
        return 1.0 / math.sqrt(fan_in)

    def out(fan_in):
        return OUT_STD / math.sqrt(2 * layers * fan_in)

    def swiglu(p, width, down_std):
        return [(f"{p}.gate_proj.weight", (width, d), 0.0, inp(d)), (f"{p}.up_proj.weight", (width, d), 0.0, inp(d)),
                (f"{p}.down_proj.weight", (d, width), 0.0, down_std(width))]

    out_specs = []
    for i in range(layers):
        p = f"{BACKBONE}.layers.{i}"
        a = f"{p}.self_attn"
        out_specs += [
            (f"{p}.input_layernorm.weight", (d,), 1.0, 0.1),
            (f"{a}.q_proj.weight", (d, h * qh), 0.0, inp(d)),
            (f"{a}.q_proj.lora_A.weight", (r, d), 0.0, inp(d)),
            (f"{a}.q_proj.lora_B.weight", (h * qh, r), 0.0, 0.02),
            (f"{a}.kv_a_proj_with_mqa.weight", (d, dims.kv_rank + dims.rope), 0.0, inp(d)),
            (f"{a}.kv_a_proj_with_mqa.lora_A.weight", (r, d), 0.0, inp(d)),
            (f"{a}.kv_a_proj_with_mqa.lora_B.weight", (dims.kv_rank + dims.rope, r), 0.0, 0.02),
            (f"{a}.kv_a_layernorm.weight", (dims.kv_rank,), 1.0, 0.1),
            (f"{a}.kv_b_proj.weight", (h * (dims.nope + dims.v), dims.kv_rank), 0.0, inp(dims.kv_rank)),
            (f"{a}.o_proj.weight", (d, h * dims.v), 0.0, out(h * dims.v)),
            (f"{p}.post_attention_layernorm.weight", (d,), 1.0, 0.1),
        ]
        if not dims.moe(i):
            out_specs += swiglu(f"{p}.mlp", dims.inter, out)
            continue
        e, w = dims.experts, dims.moe_inter
        out_specs += [
            (f"{p}.mlp.gate.weight", (e, d), 0.0, GATE_STD * inp(d)),
            (f"{p}.mlp.experts.gate_proj", (e, w, d), 0.0, inp(d)),
            (f"{p}.mlp.experts.up_proj", (e, w, d), 0.0, inp(d)),
            (f"{p}.mlp.experts.down_proj", (e, d, w), 0.0, EXPERT_DOWN_STD * inp(w)),
        ]
        out_specs += swiglu(f"{p}.mlp.shared_experts", w * dims.shared, out)
    out_specs.append((f"{BACKBONE}.norm.weight", (d,), 1.0, 0.1))
    return front + out_specs + head


def trainable(name: str) -> bool:
    """Everything outside the backbone trains; inside it LoRA and the RMSNorm
    weights only."""
    toks = name.split(".")
    return "llm_backbone" not in toks or any(t in toks for t in TRAINABLE_LLM_TOKENS)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(dims: Dims) -> torch.Tensor:
    """YaRN: theta^(-2i/D), divided by ``factor`` past the correction range
    [floor(c(beta_fast)), ceil(c(beta_slow))], a linear blend inside it, with
    c(beta) = D ln(original / (2 pi beta)) / (2 ln theta)."""
    dim = dims.rope

    def c(beta):
        return dim * math.log(dims.original / (2 * math.pi * beta)) / (2 * math.log(dims.theta))

    low, high = max(math.floor(c(dims.beta_fast)), 0), min(math.ceil(c(dims.beta_slow)), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = dims.theta ** (-2.0 * i / dim)
    ramp = ((i - low) / (high - low if high != low else 0.001)).clamp(0, 1)
    return (extra * (1 - ramp) + extra / dims.factor * ramp).float()


def softmax_scale(dims: Dims) -> float:
    m = yarn_mscale(dims.factor, dims.mscale_all_dim)
    return (dims.nope + dims.rope) ** -0.5 * m * m


def rope(x: torch.Tensor, t: int, dims: Dims) -> torch.Tensor:
    """x (..., T, H, D): pair i of position p rotated by p * inv_freq[i], the
    rotated pairs' first values first, then their second values."""
    angle = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq(dims).to(x.device)
    m = yarn_mscale(dims.factor, dims.mscale) / yarn_mscale(dims.factor, dims.mscale_all_dim)
    cos, sin = (angle.cos() * m)[:, None], (angle.sin() * m)[:, None]          # (T, 1, D/2)
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], dim=-1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def swiglu(P: dict, p: str, x: torch.Tensor, prec: ref.Precision) -> torch.Tensor:
    g = prec.linear(x, P[f"{p}.gate_proj.weight"])
    u = prec.linear(x, P[f"{p}.up_proj.weight"])
    return prec.linear(F.silu(g) * u, P[f"{p}.down_proj.weight"])


def adapted(P: dict, p: str, x: torch.Tensor, dims: Dims, prec: ref.Precision) -> torch.Tensor:
    """x W + (alpha / r) (x A^T) B^T, W in (in, out)."""
    b = dims.base
    lora = prec.mm(prec.mm(x, P[f"{p}.lora_A.weight"].t()), P[f"{p}.lora_B.weight"].t())
    return prec.mm(x, P[f"{p}.weight"]) + lora * (b.lora_alpha / b.lora_r)


def attention(P: dict, p: str, x: torch.Tensor, dims: Dims, prec: ref.Precision) -> torch.Tensor:
    m, t, _ = x.shape
    h = dims.base.llm_heads
    q = adapted(P, f"{p}.q_proj", x, dims, prec).reshape(m, t, h, dims.nope + dims.rope)
    ckv = adapted(P, f"{p}.kv_a_proj_with_mqa", x, dims, prec)
    c, k_pe = ckv[..., : dims.kv_rank], ckv[..., dims.kv_rank:]
    kv = prec.linear(rms_norm(c, P[f"{p}.kv_a_layernorm.weight"], dims.eps), P[f"{p}.kv_b_proj.weight"])
    kv = kv.reshape(m, t, h, dims.nope + dims.v)
    q = torch.cat([q[..., : dims.nope], rope(q[..., dims.nope:], t, dims)], dim=-1)
    k_pe = rope(k_pe.reshape(m, t, 1, dims.rope), t, dims).expand(m, t, h, dims.rope)
    k = torch.cat([kv[..., : dims.nope], k_pe], dim=-1)
    v = kv[..., dims.nope:]
    s = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * softmax_scale(dims)      # (M, H, T, T)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = prec.mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(m, t, h * dims.v)
    return prec.linear(o, P[f"{p}.o_proj.weight"])


def moe(P: dict, p: str, x: torch.Tensor, dims: Dims, prec: ref.Precision, routes: list | None) -> torch.Tensor:
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    scores = torch.softmax(prec.linear(x2, P[f"{p}.gate.weight"]), dim=-1)
    w, idx = torch.topk(scores, dims.top_k, dim=-1)
    if routes is not None:
        routes.append(idx)
    out = torch.zeros_like(x2)
    for e in range(dims.experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        xe = x2[tok]
        g = prec.linear(xe, P[f"{p}.experts.gate_proj"][e])
        u = prec.linear(xe, P[f"{p}.experts.up_proj"][e])
        ye = prec.linear(F.silu(g) * u, P[f"{p}.experts.down_proj"][e])
        out.index_add_(0, tok, ye * w[tok, slot, None])
    return (out + swiglu(P, f"{p}.shared_experts", x2, prec)).reshape(shape)


def backbone(P: dict, x: torch.Tensor, dims: Dims, prec: ref.Precision, routes: list | None = None) -> torch.Tensor:
    """(M, T, d) -> (M, T, d); ``routes`` collects each MoE layer's (M*T, k)
    expert choices."""
    for i in range(dims.base.layers):
        p = f"{BACKBONE}.layers.{i}"
        x = x + attention(P, f"{p}.self_attn", rms_norm(x, P[f"{p}.input_layernorm.weight"], dims.eps), dims, prec)
        hn = rms_norm(x, P[f"{p}.post_attention_layernorm.weight"], dims.eps)
        x = x + (moe(P, f"{p}.mlp", hn, dims, prec, routes) if dims.moe(i) else swiglu(P, f"{p}.mlp", hn, prec))
    return rms_norm(x, P[f"{BACKBONE}.norm.weight"], dims.eps)


def front_end(P: dict, x: torch.Tensor, tf: torch.Tensor, graph: ref.Graph, d: ref.Dims,
              prec: ref.Precision) -> torch.Tensor:
    """(B, L, N, C) -> the backbone's input (B*N, T, d_llm): ``model.forward``'s
    front end, as it is there."""
    b, length, n, _ = x.shape
    tf = tf.long()
    emb = "spatio_temporal_embedding"
    temporal = sum(P[f"{emb}.{t}_embedding.weight"][tf[..., i]] for i, t in enumerate(("tod", "doy", "year", "season")))
    combined = P[f"{emb}.node_embedding.weight"][None, None] + temporal[:, :, None]
    h = torch.cat([x, combined.expand(b, length, n, d.d_emb)], dim=-1)

    g = "spatial_encoder.gat_conv"
    heads, ch = d.heads, d.channels
    xl = prec.linear(h, P[f"{g}.lin_l.weight"], P[f"{g}.lin_l.bias"]).reshape(b, length, n, heads, ch)
    xr = prec.linear(h, P[f"{g}.lin_r.weight"], P[f"{g}.lin_r.bias"]).reshape(b, length, n, heads, ch)
    att = P[f"{g}.att"].reshape(heads, ch)
    valid = graph.valid[:, :, None]
    scores = []
    for o in range(len(graph.shifts)):
        e = F.leaky_relu(xl[:, :, graph.index[o]] + xr, d.slope)
        s = (prec.q(e) * prec.q(att)).sum(-1)
        scores.append(torch.where(valid[o], s, torch.tensor(float("-inf"), device=s.device)))
    alpha = torch.softmax(torch.stack(scores), dim=0)
    out = torch.zeros_like(xl)
    for o in range(len(graph.shifts)):
        out = out + prec.q(alpha[o])[..., None] * prec.q(xl[:, :, graph.index[o]])
    h = h + out.reshape(b, length, n, heads * ch) + P[f"{g}.bias"]

    h = h.permute(0, 2, 3, 1).reshape(b * n, d.c_in, length)
    chans = (d.c_in,) + d.conv
    for blk, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        p = f"temporal_encoder.conv_embedder.embedder.{blk}"
        branches = []
        for j, k in enumerate(d.kernels):
            y = prec.conv1d(h, P[f"{p}.convs.{j}.0.weight"], P[f"{p}.convs.{j}.0.bias"], padding=(k - 1) // 2)
            y = F.group_norm(y, 1, P[f"{p}.convs.{j}.1.weight"], P[f"{p}.convs.{j}.1.bias"], 1e-5)
            branches.append(F.gelu(y))
        h = prec.conv1d(torch.cat(branches, 1), P[f"{p}.final_conv.weight"], P[f"{p}.final_conv.bias"],
                        stride=d.strides[blk])
    h = h.transpose(1, 2).reshape(b * n, d.tokens, d.patch * d.conv[-1])
    return prec.linear(h, P["temporal_encoder.patcher.projection.weight"], P["temporal_encoder.patcher.projection.bias"])


def forward(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,       # (B, L, N, C) float32
    tf: torch.Tensor,      # (B, L, 4) int
    graph: ref.Graph,
    dims: Dims,
    prec: ref.Precision,
    routes: list | None = None,
) -> torch.Tensor:
    """(B, L_out, N, 1) float32 predictions in the targets' scaled units."""
    P, d = params, dims.base
    b, _, n, _ = x.shape
    h = backbone(P, front_end(P, x, tf, graph, d, prec), dims, prec, routes)
    z = F.gelu(prec.linear(h.reshape(b * n, d.tokens * d.d), P["prediction_head.mlp.0.weight"],
                           P["prediction_head.mlp.0.bias"]))
    y = prec.linear(z, P["prediction_head.mlp.3.weight"], P["prediction_head.mlp.3.bias"])
    return y.reshape(b, n, d.l_out).transpose(1, 2)[..., None]
