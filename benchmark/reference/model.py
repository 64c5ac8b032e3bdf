"""TEC-MoLLM in plain PyTorch, float32, from the published description.

    x (B, L, N, 6) -> + node / time-of-day / day-of-year / year / season
    embeddings (d 16) -> GATv2 (heads x channels = 22, self loops) + residual
    -> per node: multi-scale conv blocks (k 3/5/7, GroupNorm(1), GELU, concat,
    strided 1x1) -> latent patching to T tokens of d_llm -> GPT-2 blocks with
    LoRA on c_attn (pre-LN, causal, tanh GELU) -> ln_f -> head Linear / GELU /
    Linear -> (B, L_out, N, 1)

Parameters are a dict under the reference's state_dict names (``specs``), so
the same tensors go to the program and here. Every product takes its operands
through ``Precision.mm``: float32 with TF32 off (the reference), or both
operands rounded to float8 e4m3 with a per-tensor scale (the control, one step
below the configuration's bf16).

Dropout (training only) multiplies by the keep masks that ``Masks`` hands
out: the program's own, recorded where it applied them and taken here in the
order the forward meets the sites, so both sides drop the same units however
the program draws them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import graph as graph_lib

TRAINABLE_LLM_TOKENS = ("lora_A", "lora_B", "ln_1", "ln_2", "ln_f", "wpe")
EMBEDDINGS = ("node", "tod", "doy", "year", "season")


@dataclass(frozen=True)
class Dims:
    n: int
    h: int
    w: int
    c_raw: int
    d_emb: int
    vocab: dict
    heads: int
    channels: int
    slope: float
    conv: tuple
    strides: tuple
    kernels: tuple
    patch: int
    tokens: int
    d: int
    layers: int
    llm_heads: int
    mlp: int
    positions: int
    lora_r: int
    lora_alpha: float
    head_hidden: int
    l_in: int
    l_out: int
    p_gat: float
    p_lora: float
    p_llm: float
    p_post: float
    p_head: float
    bf16: bool

    @classmethod
    def of(cls, config: dict) -> "Dims":
        m, t = config["model"], config["train"]
        length = t["L_in"]
        for s in m["temporal_strides"]:
            length //= s
        patch = m["patch_len"]
        if length % patch:
            patch = 2 if length % 2 == 0 else 1
        tokens = length // patch
        return cls(
            n=m["num_nodes"], h=m["grid_h"], w=m["grid_w"], c_raw=m["in_features"], d_emb=m["d_emb"],
            vocab={"node": m["num_nodes"], "tod": m["num_tod"], "doy": m["num_doy"], "year": m["num_years"],
                   "season": m["num_seasons"]},
            heads=m["spatial_heads"], channels=m["spatial_out_channels"], slope=m["gat_negative_slope"],
            conv=tuple(m["temporal_channel_list"]), strides=tuple(m["temporal_strides"]),
            kernels=tuple(m["conv_kernel_sizes"]), patch=patch, tokens=tokens, d=m["d_llm"],
            layers=m["llm_layers"], llm_heads=m["llm_heads"], mlp=m["llm_mlp_ratio"] * m["d_llm"],
            positions=m["llm_max_positions"], lora_r=m["lora_r"], lora_alpha=m["lora_alpha"],
            head_hidden=m["d_llm"] * tokens // m["head_hidden_ratio"], l_in=t["L_in"], l_out=t["L_out"],
            p_gat=m["gat_dropout"], p_lora=m["lora_dropout"], p_llm=m["llm_dropout"],
            p_post=m["post_llm_dropout"], p_head=m["head_dropout"], bf16=t["bf16"],
        )

    @property
    def c_in(self) -> int:
        return self.c_raw + self.d_emb

    @property
    def n_padded(self) -> int:
        """The node axis as the program lays it out: padded to a multiple of
        128 once it has 128 nodes or more."""
        return self.n if self.n < 128 else -(-self.n // 128) * 128


def specs(dims: Dims) -> list[tuple[str, tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter, in a fixed order."""
    out = []
    for t in EMBEDDINGS:
        out.append((f"spatio_temporal_embedding.{t}_embedding.weight", (dims.vocab[t], dims.d_emb), 0.0, 1.0))
    hc, c_in = dims.heads * dims.channels, dims.c_in
    g = "spatial_encoder.gat_conv"
    for lin in ("lin_l", "lin_r"):
        out += [(f"{g}.{lin}.weight", (hc, c_in), 0.0, math.sqrt(2.0 / (hc + c_in))),
                (f"{g}.{lin}.bias", (hc,), 0.0, 0.02)]
    out += [(f"{g}.att", (1, dims.heads, dims.channels), 0.0, 0.3), (f"{g}.bias", (hc,), 0.0, 0.02)]
    chans = (hc,) + dims.conv
    for b, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        p = f"temporal_encoder.conv_embedder.embedder.{b}"
        for j, k in enumerate(dims.kernels):
            out += [(f"{p}.convs.{j}.0.weight", (cout, cin, k), 0.0, 1.0 / math.sqrt(cin * k)),
                    (f"{p}.convs.{j}.0.bias", (cout,), 0.0, 0.02),
                    (f"{p}.convs.{j}.1.weight", (cout,), 1.0, 0.1),
                    (f"{p}.convs.{j}.1.bias", (cout,), 0.0, 0.1)]
        k3 = cout * len(dims.kernels)
        out += [(f"{p}.final_conv.weight", (cout, k3, 1), 0.0, 1.0 / math.sqrt(k3)),
                (f"{p}.final_conv.bias", (cout,), 0.0, 0.02)]
    pin = dims.patch * dims.conv[-1]
    out += [("temporal_encoder.patcher.projection.weight", (dims.d, pin), 0.0, 1.0 / math.sqrt(pin)),
            ("temporal_encoder.patcher.projection.bias", (dims.d,), 0.0, 0.02)]
    d, r = dims.d, dims.lora_r
    m = "llm_backbone.model"
    out.append((f"{m}.wpe.weight", (dims.positions, d), 0.0, 0.02))
    proj_std = 0.02 / math.sqrt(2 * dims.layers)
    for i in range(dims.layers):
        p = f"{m}.h.{i}"
        out += [(f"{p}.ln_1.weight", (d,), 1.0, 0.1), (f"{p}.ln_1.bias", (d,), 0.0, 0.02),
                (f"{p}.attn.c_attn.weight", (d, 3 * d), 0.0, 0.02), (f"{p}.attn.c_attn.bias", (3 * d,), 0.0, 0.02),
                (f"{p}.attn.c_attn.lora_A.weight", (r, d), 0.0, 1.0 / math.sqrt(d)),
                (f"{p}.attn.c_attn.lora_B.weight", (3 * d, r), 0.0, 0.02),
                (f"{p}.attn.c_proj.weight", (d, d), 0.0, proj_std), (f"{p}.attn.c_proj.bias", (d,), 0.0, 0.02),
                (f"{p}.ln_2.weight", (d,), 1.0, 0.1), (f"{p}.ln_2.bias", (d,), 0.0, 0.02),
                (f"{p}.mlp.c_fc.weight", (d, dims.mlp), 0.0, 0.02), (f"{p}.mlp.c_fc.bias", (dims.mlp,), 0.0, 0.02),
                (f"{p}.mlp.c_proj.weight", (dims.mlp, d), 0.0, proj_std),
                (f"{p}.mlp.c_proj.bias", (d,), 0.0, 0.02)]
    out += [(f"{m}.ln_f.weight", (d,), 1.0, 0.1), (f"{m}.ln_f.bias", (d,), 0.0, 0.02)]
    hin = d * dims.tokens
    out += [("prediction_head.mlp.0.weight", (dims.head_hidden, hin), 0.0, 1.0 / math.sqrt(hin)),
            ("prediction_head.mlp.0.bias", (dims.head_hidden,), 0.0, 0.02),
            ("prediction_head.mlp.3.weight", (dims.l_out, dims.head_hidden), 0.0, 1.0 / math.sqrt(dims.head_hidden)),
            ("prediction_head.mlp.3.bias", (dims.l_out,), 0.0, 0.02)]
    return out


def trainable(name: str) -> bool:
    """The reference's split: everything outside the GPT-2 backbone trains;
    inside it only LoRA, the LayerNorms and the position embedding."""
    toks = name.split(".")
    return "llm_backbone" not in toks or any(t in toks for t in TRAINABLE_LLM_TOKENS)


class Precision:
    """float32 with TF32 off, or (``fp8``) every product's operands rounded to
    float8 e4m3 with a per-tensor scale, accumulated in float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        amax = t.detach().abs().amax().clamp_min(1e-12)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x, weight, bias=None):
        y = self.q(x) @ self.q(weight).t()
        return y if bias is None else y + bias

    def conv1d(self, x, weight, bias, stride=1, padding=0):
        return F.conv1d(self.q(x), self.q(weight), bias, stride=stride, padding=padding)


class Masks:
    """Dropout keep masks for one forward, each returned as keep / (1 - p) in
    float32, in this file's layout.

    ``source`` hands out keep masks (bool) in the order the forward meets its
    sites, each in the program's layout, where the node axis is padded as
    ``Dims.n_padded`` says: ``take(shape, p)`` the next one, ``peek_shape()``
    its shape (None where any will do). The layouts taken: the GAT's
    attention, one a neighbour offset, (B*L, heads, N_p); a site over rows,
    (B*N_p, [T,] width); the attention probabilities, one dropout over
    (B*N_p, heads, T, T), or, where the program drops them pair by pair,
    T(T+1)/2 masks of (B*N_p, heads), one per (query, key <= query),
    query-major. The benchmark's source replays the masks the program applied;
    ``Drawn`` draws fresh ones (the control's readings, where both sides take
    the same draws)."""

    def __init__(self, dims: Dims, batch: int, device, source):
        self.dims, self.b, self.device, self.source = dims, batch, device, source

    def _next(self, shape: tuple[int, ...], p: float) -> torch.Tensor:
        keep = self.source.take(shape, p)
        if keep.numel() != math.prod(shape):
            raise ValueError(f"the program applied a dropout mask of shape {tuple(keep.shape)} where the "
                             f"reference expects {shape}")
        return keep.reshape(shape).to(self.device)

    def gat(self, offset: int) -> torch.Tensor:
        """(B, L, N, heads)."""
        d = self.dims
        m = self._next((self.b * d.l_in, d.heads, d.n_padded), d.p_gat)
        m = m.reshape(self.b, d.l_in, d.heads, d.n_padded)[..., : d.n].permute(0, 1, 3, 2)
        return m.float() / (1.0 - d.p_gat)

    def rows(self, width: int, p: float, tokens: bool = True) -> torch.Tensor:
        """(B*N, [T,] width)."""
        d = self.dims
        tail = (d.tokens, width) if tokens else (width,)
        m = self._next((self.b * d.n_padded,) + tail, p)
        m = m.reshape((self.b, d.n_padded) + tail)[:, : d.n].reshape((self.b * d.n,) + tail)
        return m.float() / (1.0 - p)

    def attention(self) -> torch.Tensor:
        """(B*N, heads, T, T)."""
        d = self.dims
        t, rows = d.tokens, self.b * d.n_padded
        shape = self.source.peek_shape()
        if shape is not None and len(shape) == 2:
            keep = torch.zeros(rows, d.llm_heads, t, t, dtype=torch.bool, device=self.device)
            for tq in range(t):
                for s in range(tq + 1):
                    keep[:, :, tq, s] = self._next((rows, d.llm_heads), d.p_llm)
        else:
            keep = self._next((rows, d.llm_heads, t, t), d.p_llm)
        keep = keep.reshape(self.b, d.n_padded, d.llm_heads, t, t)[:, : d.n]
        return keep.reshape(self.b * d.n, d.llm_heads, t, t).float() / (1.0 - d.p_llm)


class Drawn:
    """Keep masks drawn from ``generator``, in whatever layout is asked for."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def peek_shape(self) -> None:
        return None

    def take(self, shape: tuple[int, ...], p: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.g, device=self.g.device) >= p

    def finish(self) -> None:
        pass


class Graph:
    """The stencil as the reference works it out, on ``device``."""

    def __init__(self, config: dict, device):
        dims = Dims.of(config)
        lat, lon = graph_lib.coordinates(config["grid"], dims.h, dims.w)
        data = config["data"]
        shifts, index, valid = graph_lib.offsets(lat, lon, data["distance_threshold_km"], data["earth_radius_km"])
        self.shifts = shifts
        self.index = torch.as_tensor(index, device=device)   # (O, N)
        self.valid = torch.as_tensor(valid, device=device)   # (O, N)


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def forward(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,       # (B, L, N, C) float32
    tf: torch.Tensor,      # (B, L, 4) int
    graph: Graph,
    dims: Dims,
    prec: Precision,
    masks: Masks | None = None,
) -> torch.Tensor:
    """(B, L_out, N, 1) float32 predictions in the targets' scaled units."""
    P = params
    b, length, n, _ = x.shape
    tf = tf.long()

    # embeddings
    emb = "spatio_temporal_embedding"
    temporal = sum(P[f"{emb}.{t}_embedding.weight"][tf[..., i]] for i, t in enumerate(("tod", "doy", "year", "season")))
    combined = P[f"{emb}.node_embedding.weight"][None, None] + temporal[:, :, None]
    h = torch.cat([x, combined.expand(b, length, n, dims.d_emb)], dim=-1)          # (B, L, N, C_in)

    # GATv2 over each node's stencil neighbours + residual
    g = "spatial_encoder.gat_conv"
    heads, ch = dims.heads, dims.channels
    xl = prec.linear(h, P[f"{g}.lin_l.weight"], P[f"{g}.lin_l.bias"]).reshape(b, length, n, heads, ch)
    xr = prec.linear(h, P[f"{g}.lin_r.weight"], P[f"{g}.lin_r.bias"]).reshape(b, length, n, heads, ch)
    att = P[f"{g}.att"].reshape(heads, ch)
    valid = graph.valid[:, :, None]                                               # (O, N, 1)
    scores = []
    for o in range(len(graph.shifts)):
        xj = xl[:, :, graph.index[o]]                                             # (B, L, N, H, C)
        e = F.leaky_relu(xj + xr, dims.slope)
        s = (prec.q(e) * prec.q(att)).sum(-1)
        scores.append(torch.where(valid[o], s, torch.tensor(float("-inf"), device=s.device)))
    alpha = torch.softmax(torch.stack(scores), dim=0)                             # (O, B, L, N, H)
    out = torch.zeros_like(xl)
    for o in range(len(graph.shifts)):
        a = alpha[o] if masks is None else alpha[o] * masks.gat(o)
        out = out + prec.q(a)[..., None] * prec.q(xl[:, :, graph.index[o]])
    h = h + out.reshape(b, length, n, heads * ch) + P[f"{g}.bias"]

    # multi-scale temporal convolutions, per node
    h = h.permute(0, 2, 3, 1).reshape(b * n, dims.c_in, length)                # (B*N, C, L)
    chans = (dims.c_in,) + dims.conv
    for blk, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        p = f"temporal_encoder.conv_embedder.embedder.{blk}"
        branches = []
        for j, k in enumerate(dims.kernels):
            y = prec.conv1d(h, P[f"{p}.convs.{j}.0.weight"], P[f"{p}.convs.{j}.0.bias"], padding=(k - 1) // 2)
            y = F.group_norm(y, 1, P[f"{p}.convs.{j}.1.weight"], P[f"{p}.convs.{j}.1.bias"], 1e-5)
            branches.append(F.gelu(y))
        h = prec.conv1d(torch.cat(branches, 1), P[f"{p}.final_conv.weight"], P[f"{p}.final_conv.bias"],
                        stride=dims.strides[blk])
    h = h.transpose(1, 2).reshape(b * n, dims.tokens, dims.patch * dims.conv[-1])
    h = prec.linear(h, P["temporal_encoder.patcher.projection.weight"], P["temporal_encoder.patcher.projection.bias"])

    # GPT-2 blocks, LoRA on c_attn
    m = "llm_backbone.model"
    t, d, nh = dims.tokens, dims.d, dims.llm_heads
    hd = d // nh
    x_ = h + P[f"{m}.wpe.weight"][:t]
    if masks is not None:
        x_ = x_ * masks.rows(d, dims.p_llm)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for i in range(dims.layers):
        p = f"{m}.h.{i}"
        a = layer_norm(x_, P[f"{p}.ln_1.weight"], P[f"{p}.ln_1.bias"])
        qkv = prec.mm(a, P[f"{p}.attn.c_attn.weight"]) + P[f"{p}.attn.c_attn.bias"]
        a_drop = a if masks is None else a * masks.rows(d, dims.p_lora)
        lora = prec.mm(prec.mm(a_drop, P[f"{p}.attn.c_attn.lora_A.weight"].t()), P[f"{p}.attn.c_attn.lora_B.weight"].t())
        qkv = qkv + lora * (dims.lora_alpha / dims.lora_r)
        q, k, v = (z.reshape(-1, t, nh, hd).transpose(1, 2) for z in qkv.split(d, dim=-1))   # (M, H, T, hd)
        s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        if masks is not None:
            probs = probs * masks.attention()
        o = prec.mm(probs, v).transpose(1, 2).reshape(-1, t, d)
        o = prec.mm(o, P[f"{p}.attn.c_proj.weight"]) + P[f"{p}.attn.c_proj.bias"]
        if masks is not None:
            o = o * masks.rows(d, dims.p_llm)
        x_ = x_ + o
        mm_in = layer_norm(x_, P[f"{p}.ln_2.weight"], P[f"{p}.ln_2.bias"])
        f = F.gelu(prec.mm(mm_in, P[f"{p}.mlp.c_fc.weight"]) + P[f"{p}.mlp.c_fc.bias"], approximate="tanh")
        f = prec.mm(f, P[f"{p}.mlp.c_proj.weight"]) + P[f"{p}.mlp.c_proj.bias"]
        if masks is not None:
            f = f * masks.rows(d, dims.p_llm)
        x_ = x_ + f
    x_ = layer_norm(x_, P[f"{m}.ln_f.weight"], P[f"{m}.ln_f.bias"])
    if masks is not None:
        x_ = x_ * masks.rows(d, dims.p_post)

    # head
    z = F.gelu(prec.linear(x_.reshape(b * n, t * d), P["prediction_head.mlp.0.weight"], P["prediction_head.mlp.0.bias"]))
    if masks is not None:
        z = z * masks.rows(dims.head_hidden, dims.p_head, tokens=False)
    y = prec.linear(z, P["prediction_head.mlp.3.weight"], P["prediction_head.mlp.3.bias"])   # (B*N, L_out)
    return y.reshape(b, n, dims.l_out).transpose(1, 2)[..., None]
