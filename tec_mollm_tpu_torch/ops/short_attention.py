"""Short causal attention (T <= 8) with attention dropout: CUDA kernels + plain versions.

Replaces the Pallas kernels ``tec_mollm_tpu/ops/short_attention.py:_call_fwd``
(``_fwd_kernel``) and ``:_call_bwd`` (``_bwd_kernel``): causal softmax attention
over (M, T, D) with head-major D = H * Dh; scores, softmax and the weighted sum
in fp32, the output in the input dtype; optional post-softmax dropout scaled by
1/(1-p). The backward recomputes the softmax and regenerates the mask. (The XLA
path in ``models/gpt2.py`` instead multiplies q*k in the compute dtype before the
fp32 cast, so in bf16 the two differ by bf16 rounding.)

Dropout keeps a weight iff ``bits >= p * 2^32`` (the JAX rule). The bits are a
counter-based hash of (seed, absolute index ``((m*H + h)*T + tq)*T + s``), not a
block-local draw order as the Pallas kernel's PRNG is, so the CUDA forward, the
CUDA backward and the plain versions here draw the same mask bit for bit. The
plain versions compute the hash in wrapping int32 tensor arithmetic
(``dropout_keep``; ``dropout_bits`` keeps the int64 form as the reference).

The kernels (``csrc/short_attention.cu``) give one warp to each (row, head):
Dh = 64 is two elements a lane, the dot products are warp-shuffle sums, T is a
template parameter. Both are bound by bytes on this card. Forward: 4 * M*T*D
elements, about 130 us at the flagship batch (M = 8*2944, T = 3, D = 768, bf16).
Backward: q, k, v, g read and dq, dk, dv written, 7 * M*T*D elements, about
227 us. The backward writes [dq | dk | dv] into one (M, T, 3D) tensor in the
layout of the c_attn projection that q, k and v are views of.

The forward is the registered op ``tec_mollm::short_attention`` (what an
exported artifact holds). ``short_causal_attention`` calls it directly when no
gradient is needed, else through a ``torch.autograd.Function`` that saves q, k,
v and the seed (not the mask) and whose backward is the backward kernel. A CPU
tensor takes the plain forward and backward; a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "short_attention"
BWD_NAME = "short_attention_bwd"
MAX_SEQ = 8
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), exact: each partial product
    stays below 2^49."""
    return (((((x >> 16) * c) & _M32) << 16) + (x & 0xFFFF) * c) & _M32


def _mix32(x):
    """The kernel's 32-bit finalizer, on Python ints or int64 tensors."""
    mul = (lambda a, c: (a * c) & _M32) if isinstance(x, int) else _mul32
    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this (uint32), as the Pallas kernel decides."""
    return min(int(rate * 2.0**32), 2**32 - 1)


def dropout_bits(seed: int, m: int, heads: int, t: int, device=None) -> torch.Tensor:
    """(M, H, T, T) uint32 dropout bits (held in int64) of the (row, head,
    query, key) positions, as the kernels draw them."""
    key = _mix32((int(seed) & _M32) ^ 0x9E3779B9)
    idx = torch.arange(m * heads * t * t, dtype=torch.int64, device=device)
    bits = _mix32(_mix32((idx & _M32) ^ key) ^ (idx >> 32))
    return bits.reshape(m, heads, t, t)


def _as_int32(u: int) -> int:
    """The int32 whose bits are the uint32 ``u``."""
    return u - 2**32 if u >= 2**31 else u


def _mix32_int32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's finalizer on int32 tensors holding uint32 bits: products
    wrap modulo 2^32 and each shift is made logical by a mask."""
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _as_int32(0x7FEB352D)
    x = x ^ ((x >> 15) & 0x1FFFF)
    x = x * _as_int32(0x846CA68B)
    return x ^ ((x >> 16) & 0xFFFF)


def dropout_keep(seed: int, rate: float, m: int, heads: int, t: int, device=None) -> torch.Tensor:
    """(M, H, T, T) bool: ``dropout_bits(...) >= dropout_threshold(rate)``,
    computed in int32 (half the bytes and a third of the operations of the
    int64 form) while the indices fit in 31 bits, where every index's high word
    is 0."""
    n = m * heads * t * t
    threshold = dropout_threshold(rate)
    if n >= 2**31:
        return dropout_bits(seed, m, heads, t, device) >= threshold
    key = _mix32((int(seed) & _M32) ^ 0x9E3779B9)
    bits = _mix32_int32(_mix32_int32(torch.arange(n, dtype=torch.int32, device=device) ^ _as_int32(key)))
    # unsigned order: flip the sign bit on both sides
    return ((bits ^ -(2**31)) >= threshold - 2**31).reshape(m, heads, t, t)


def _split_heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    m, t, d = a.shape
    return a.float().reshape(m, t, heads, d // heads)


def _softmax(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """(M, H, Tq, Ts) fp32 causal softmax of the scaled scores."""
    t = qf.shape[1]
    scores = torch.einsum("mqhd,mshd->mhqs", qf, kf) / math.sqrt(qf.shape[-1])
    causal = torch.ones(t, t, dtype=torch.bool, device=qf.device).tril()
    return torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)


def short_causal_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Plain PyTorch forward with the kernel's arithmetic (all fp32) and mask.
    Differentiable by autograd."""
    m, t, d = q.shape
    qf, kf, vf = (_split_heads(a, heads) for a in (q, k, v))
    probs = _softmax(qf, kf)
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, dropout_rate, m, heads, t, q.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.einsum("mhqs,mshd->mqhd", probs, vf)
    return out.reshape(m, t, d).to(q.dtype)


def short_causal_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Plain PyTorch backward with the kernel's arithmetic: (M, T, 3D) holding
    [dq | dk | dv] in q's dtype."""
    m, t, d = q.shape
    qf, kf, vf, gf = (_split_heads(a, heads) for a in (q, k, v, g))
    alpha = _softmax(qf, kf)  # pre-dropout
    dused = torch.einsum("mqhd,mshd->mhqs", gf, vf)
    if dropout_rate > 0.0:
        inv_keep = 1.0 / (1.0 - dropout_rate)
        keep = dropout_keep(seed, dropout_rate, m, heads, t, q.device)
        used = torch.where(keep, alpha * inv_keep, 0.0)
        dalpha = torch.where(keep, dused * inv_keep, 0.0)
    else:
        used, dalpha = alpha, dused
    dv = torch.einsum("mhqs,mqhd->mshd", used, gf)
    ds = alpha * (dalpha - (alpha * dalpha).sum(dim=-1, keepdim=True)) / math.sqrt(d // heads)
    dq = torch.einsum("mhqs,mshd->mqhd", ds, kf)
    dk = torch.einsum("mhqs,mqhd->mshd", ds, qf)
    return torch.cat([a.reshape(m, t, d) for a in (dq, dk, dv)], dim=-1).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
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


def dropout_args(rate: float, seed: int) -> list:
    on = rate > 0.0
    return [
        int(on), ctypes.c_uint32(int(seed) & _M32), ctypes.c_uint32(dropout_threshold(rate) if on else 0),
        ctypes.c_float(1.0 / (1.0 - rate) if on else 1.0),
    ]


_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]


def short_attention_forward(q, k, v, heads: int, dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; (M, T, D) contiguous, with no
    gradient path (``short_causal_attention`` is the differentiable call)."""
    _build.refuse_grad(NAME, "use short_causal_attention", q, k, v)
    _check(q, k, v, heads)
    m, t, d = q.shape
    out = torch.empty((m, t, d), dtype=q.dtype, device=q.device)
    fn = _build.function("short_attention_forward", [ctypes.c_void_p] * 4 + _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m, t, heads, d // heads, q.stride(0), q.stride(1), int(q.dtype == torch.bfloat16),
        *dropout_args(dropout_rate, seed), _build.stream_handle(q.device),
    )
    _build.check(NAME, err)
    _build.count_launch(NAME)
    return out


def short_attention_backward(q, k, v, g, heads: int, dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors; (M, T, 3D) = [dq | dk | dv],
    with no gradient path of its own (no double backward)."""
    _build.refuse_grad(BWD_NAME, "a second derivative is not implemented", q, k, v, g)
    _check(q, k, v, heads)
    m, t, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("g must match q's shape, dtype and device")
    g = g.contiguous()
    dqkv = torch.empty((m, t, 3 * d), dtype=q.dtype, device=q.device)
    fn = _build.function("short_attention_backward", [ctypes.c_void_p] * 5 + _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        m, t, heads, d // heads, q.stride(0), q.stride(1), int(q.dtype == torch.bfloat16),
        *dropout_args(dropout_rate, seed), _build.stream_handle(q.device),
    )
    _build.check(BWD_NAME, err)
    _build.count_launch(BWD_NAME)
    return dqkv


def _op_impl(q, k, v, heads, dropout_rate, seed):
    """``tec_mollm::short_attention``: the plain forward on the CPU, the
    kernel on any other device. ``torch.export`` records the op as one node,
    so an exported artifact launches the kernel on the card."""
    if q.device.type == "cpu":
        return short_causal_attention_reference(q, k, v, heads, dropout_rate, seed)
    return short_attention_forward(q, k, v, heads, dropout_rate, seed)


short_attention_op = torch.library.custom_op(
    f"{_build.NAMESPACE}::short_attention", _op_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int heads, float dropout_rate, int seed) -> Tensor",
)
# the shape function, for tracing (a meta tensor goes to _op_impl: _build.op_for)
short_attention_op.register_fake(lambda q, k, v, heads, dropout_rate, seed: q.new_empty(q.shape))


def _thirds(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return qkv.split(qkv.shape[-1] // 3, dim=-1)


class _ShortAttention(torch.autograd.Function):
    """Attention over the packed (M, T, 3D) projection; its gradient is the
    backward's (M, T, 3D) tensor as it is."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, rate: float, seed: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.rate, ctx.seed = heads, rate, seed
        return _build.op_for(short_attention_op, _op_impl, qkv)(*_thirds(qkv), heads, rate, seed)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        q, k, v = _thirds(qkv)
        if qkv.device.type == "cpu":
            dqkv = short_causal_attention_backward_reference(q, k, v, g, ctx.heads, ctx.rate, ctx.seed)
        else:
            dqkv = short_attention_backward(q, k, v, g.to(qkv.dtype), ctx.heads, ctx.rate, ctx.seed)
        return dqkv, None, None, None


def _packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The (M, T, 3D) tensor whose thirds q, k and v are (as ``qkv.split(D, -1)``
    gives them), without a copy; their concatenation when they are not such
    views. With a gradient to carry, the thirds' autograd base is that tensor;
    without one (inference mode tracks no view bases) a view over them does."""
    m, t, d = q.shape
    step = d * q.element_size()
    if (
        k.data_ptr() == q.data_ptr() + step and v.data_ptr() == q.data_ptr() + 2 * step
        and q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
    ):
        base = q._base
        if (
            base is not None and k._base is base and v._base is base and base.shape == (m, t, 3 * d)
            and base.stride() == q.stride() and base.data_ptr() == q.data_ptr()
        ):
            return base
        if not (torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v))):
            return q.as_strided((m, t, 3 * d), q.stride())
    return torch.cat([q, k, v], dim=-1)


def short_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Causal attention over (M, T, D) with attention dropout ``dropout_rate``
    drawn from ``seed``. A CPU tensor takes the plain forward and backward, a
    CUDA tensor launches the kernels or raises. A call that needs no gradient
    is one ``tec_mollm::short_attention`` op on q, k and v as they are; one
    that does goes through the autograd function, and when q, k and v are
    the thirds of one (M, T, 3D) projection their gradient is one tensor in
    its layout."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    if q.device.type != "cpu":
        _check(q, k, v, heads)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        return _ShortAttention.apply(_packed(q, k, v), heads, float(dropout_rate), int(seed))
    return _build.op_for(short_attention_op, _op_impl, q)(q, k, v, heads, float(dropout_rate), int(seed))
