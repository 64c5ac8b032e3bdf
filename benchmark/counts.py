"""Operations and bytes the work needs, counted from the configuration's shapes.

FLOPs are those of the matrix products and convolutions (2 per multiply-add)
over the grid's real nodes: the program's node padding is its own choice and
is not work. The attention over T <= 21 tokens (under 0.5% of a block's
products at T = 21) and the elementwise passes are left out, as the program
computes them elementwise. A training window costs its forward, the gradient
of every product's input (every product lies after the trainable embedding),
and the weight gradient of the trainable tensors only: the GPT-2 base weights
are frozen. No recompute is counted.
"""

from __future__ import annotations

from benchmark.reference import graph as graph_lib
from benchmark.reference import model as ref

# (name, forward FLOPs per window, whether its weight trains)
Product = tuple[str, float, bool]

# Published peaks (NVIDIA's data sheet, SXM part at 700 W, dense): bf16 tensor
# cores, float32 outside them, HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12, "bytes": 3.35e12},
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[kind]


def products(config: dict) -> list[Product]:
    d = ref.Dims.of(config)
    n, L = d.n, d.l_in
    hc = d.heads * d.channels
    out: list[Product] = [("gat.lin_l", 2.0 * L * n * d.c_in * hc, True), ("gat.lin_r", 2.0 * L * n * d.c_in * hc, True)]
    chans = (d.c_in,) + d.conv
    length = L
    for b, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        for k in d.kernels:
            out.append((f"temporal.{b}.conv{k}", 2.0 * n * length * cin * cout * k, True))
        length = -(-length // d.strides[b])
        out.append((f"temporal.{b}.final", 2.0 * n * length * len(d.kernels) * cout * cout, True))
    tok = n * d.tokens
    out.append(("temporal.patcher", 2.0 * tok * d.patch * d.conv[-1] * d.d, True))
    for i in range(d.layers):
        out += [
            (f"gpt2.{i}.c_attn", 2.0 * tok * d.d * 3 * d.d, False),
            (f"gpt2.{i}.lora_A", 2.0 * tok * d.d * d.lora_r, True),
            (f"gpt2.{i}.lora_B", 2.0 * tok * d.lora_r * 3 * d.d, True),
            (f"gpt2.{i}.c_proj", 2.0 * tok * d.d * d.d, False),
            (f"gpt2.{i}.c_fc", 2.0 * tok * d.d * d.mlp, False),
            (f"gpt2.{i}.mlp_proj", 2.0 * tok * d.mlp * d.d, False),
        ]
    out += [("head.fc1", 2.0 * n * d.tokens * d.d * d.head_hidden, True), ("head.fc2", 2.0 * n * d.head_hidden * d.l_out, True)]
    return out


def forward_flops(config: dict) -> float:
    return sum(f for _, f, _ in products(config))


def train_flops(config: dict) -> float:
    """Forward + input gradients + trainable weight gradients, per window."""
    return sum(f * (2.0 + trains) for _, f, trains in products(config))


def by_submodule(config: dict, train: bool = False) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, f, trains in products(config):
        key = name.split(".")[0]
        out[key] = out.get(key, 0.0) + f * ((2.0 + trains) if train else 1.0)
    return out


def gat_span(config: dict, windows: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the spatial encoder's forward over ``windows``
    windows in the compute dtype: the two projections, the attention over every
    valid (node, offset) pair (the sum, leaky ReLU and score, the exponent and
    the weighted sum: about 6 C + 4 per head), the bias and residual; bytes of
    the input read once, the output written once, the weights and the validity
    once."""
    d = ref.Dims.of(config)
    lat, lon = graph_lib.coordinates(config["grid"], d.h, d.w)
    _, _, valid = graph_lib.offsets(lat, lon, config["data"]["distance_threshold_km"], config["data"]["earth_radius_km"])
    hc = d.heads * d.channels
    slices = windows * d.l_in
    flops = 2 * 2.0 * slices * d.n * d.c_in * hc
    flops += slices * float(valid.sum()) * d.heads * (6 * d.channels + 4)
    flops += 2.0 * slices * d.n * hc
    item = 2 if config["train"]["bf16"] else 4
    weights = (2 * hc * d.c_in + 3 * hc + hc) * 4
    nbytes = slices * d.n * (d.c_in + hc) * item + weights + valid.size
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float, kind: str, bf16: bool = True) -> tuple[float, str]:
    p = peaks(kind)
    t_ops = flops / (p["bf16_flops"] if bf16 else p["fp32_flops"])
    t_bytes = nbytes / p["bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

