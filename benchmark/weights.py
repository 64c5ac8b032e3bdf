"""Seeded weights, made on the device in one draw.

One float32 normal draw from a ``torch.Generator`` on ``device`` covers every
parameter of ``reference.model.specs``; each tensor is its slice, shifted and
scaled to that parameter's mean and std. The same seed gives the same tensors,
which go to the program (through its own entries) and to the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref

WEIGHT_STREAM = 0x5EED_0001


def make(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    specs = ref.specs(ref.Dims.of(config))
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=device).manual_seed((seed ^ WEIGHT_STREAM) % 2**63)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, mean, std in specs:
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape).mul_(std).add_(mean)
        off += size
    return out
