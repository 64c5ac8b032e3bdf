"""Short causal attention (T <= 8), forward: CUDA kernel + plain version.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/short_attention.py:_call_fwd``
(``_fwd_kernel``): causal softmax attention over (M, T, D) with head-major
D = H * Dh, scores, softmax and the weighted sum in fp32, the output in the
input dtype. (The XLA path in ``models/gpt2.py`` instead multiplies q*k in the
compute dtype before the fp32 cast, so in bf16 the two differ by bf16 rounding.)

The kernel (``csrc/short_attention.cu``) gives one warp to each (row, head):
Dh = 64 is two elements a lane, the dot products are warp-shuffle sums, T is a
template parameter. q, k and v may be strided views of the fused c_attn output.
Bound by bytes on this card: 4 * M*T*D elements over 3.35 TB/s, about 130 us at
the flagship eval batch (M = 8*2944, T = 3, D = 768, bf16).

Attention dropout and the backward (``_bwd_kernel``) belong to the training
slice; asking this forward for dropout raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "short_attention"
MAX_SEQ = 8


def short_causal_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic (all fp32)."""
    m, t, d = q.shape
    hd = d // heads
    qf, kf, vf = (a.float().reshape(m, t, heads, hd) for a in (q, k, v))
    scores = torch.einsum("mqhd,mshd->mhqs", qf, kf) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("mhqs,mshd->mqhd", probs, vf)
    return out.reshape(m, t, d).to(q.dtype)


def short_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Causal attention over (M, T, D); a CPU tensor takes the plain version, a
    CUDA tensor launches the kernel or raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout in the short-attention kernel comes with its backward"
        )
    if q.device.type == "cpu":
        return short_causal_attention_reference(q, k, v, heads)
    m, t, d = q.shape
    hd = d // heads
    if not 1 <= t <= MAX_SEQ or hd * heads != d or hd not in (32, 64):
        raise ValueError(f"kernel takes T <= {MAX_SEQ} and head_dim 32 or 64, got T={t}, D={d}/{heads}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
        if a.stride() != q.stride():
            raise ValueError("q, k and v must share their strides")
    if q.stride(-1) != 1:
        raise ValueError("the feature axis must have unit stride")
    out = torch.empty((m, t, d), dtype=q.dtype, device=q.device)
    fn = _build.function(
        "short_attention_forward",
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m, t, heads, hd, q.stride(0), q.stride(1),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device),
    )
    _build.check(NAME, err)
    _build.count_launch(NAME)
    return out
