"""Operations and bytes of TEC-MoLLM on a DeepSeek-V2 backbone, counted from
the configuration's shapes (``counts.py``'s rules: 2 FLOPs a multiply-add,
the grid's real nodes, elementwise passes and the attention over T tokens left
out).

A token of a DeepSeekMoE layer costs the router's product, the shared experts
and its top-k routed experts: the k experts it is routed to, not all of them.
The front end and the head are ``counts.products``'s.
"""

from __future__ import annotations

from benchmark import counts
from benchmark.counts import Product
from benchmark.reference import deepseek_v2 as rd


def products(config: dict) -> list[Product]:
    dims = rd.Dims.of(config)
    d = dims.base
    tok = d.n * d.tokens
    h, r, hid = d.llm_heads, d.lora_r, d.d
    qh, kva = dims.nope + dims.rope, dims.kv_rank + dims.rope
    out = [p for p in counts.products(config) if not p[0].startswith(("gpt2.", "head."))]
    for i in range(d.layers):
        p = f"dsv2.{i}"
        out += [
            (f"{p}.q_proj", 2.0 * tok * hid * h * qh, False),
            (f"{p}.q_proj.lora_A", 2.0 * tok * hid * r, True),
            (f"{p}.q_proj.lora_B", 2.0 * tok * r * h * qh, True),
            (f"{p}.kv_a_proj_with_mqa", 2.0 * tok * hid * kva, False),
            (f"{p}.kv_a_proj_with_mqa.lora_A", 2.0 * tok * hid * r, True),
            (f"{p}.kv_a_proj_with_mqa.lora_B", 2.0 * tok * r * kva, True),
            (f"{p}.kv_b_proj", 2.0 * tok * dims.kv_rank * h * (dims.nope + dims.v), False),
            (f"{p}.o_proj", 2.0 * tok * h * dims.v * hid, False),
        ]
        if not dims.moe(i):
            out.append((f"{p}.mlp", 3 * 2.0 * tok * hid * dims.inter, False))
            continue
        out += [
            (f"{p}.mlp.gate", 2.0 * tok * hid * dims.experts, False),
            (f"{p}.mlp.shared_experts", 3 * 2.0 * tok * hid * dims.moe_inter * dims.shared, False),
            (f"{p}.mlp.experts", 3 * 2.0 * tok * dims.top_k * hid * dims.moe_inter, False),
        ]
    return out + [p for p in counts.products(config) if p[0].startswith("head.")]


def forward_flops(config: dict) -> float:
    return sum(f for _, f, _ in products(config))


def experts_span(config: dict, windows: int, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the routed experts' products over ``windows`` windows
    scored ``batch`` at a time, in the compute dtype: 3 products of every
    routed row; each layer's stacked weights read once a batch, each gathered
    row read once and each output row written once."""
    dims = rd.Dims.of(config)
    d = dims.base
    moe_layers = sum(dims.moe(i) for i in range(d.layers))
    rows = float(windows) * d.n * d.tokens * dims.top_k * moe_layers
    flops = 3 * 2.0 * rows * d.d * dims.moe_inter
    item = 2 if config["train"]["bf16"] else 4
    weights = 3.0 * dims.experts * d.d * dims.moe_inter * moe_layers * -(-windows // batch)
    return flops, item * (weights + 2.0 * rows * d.d)
