"""Flash attention for long sequences (T >= 128), with attention dropout: CUDA kernel + plain versions.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/flash_attention.py:_flash_forward``
(``_attn_kernel``): causal or non-causal softmax attention over q, k, v of shape
(B, T, H, D), the JAX layout. Scores q.k in fp32 times 1/sqrt(D), causal keys
masked, fp32 softmax, the probabilities rounded to v's dtype before the product
with v, which accumulates in fp32; the output in the input dtype.

Attention dropout: the Pallas kernel has none, but JAX's ``ByteLM`` pretrains
through the einsum branch of ``models/gpt2.py``, which drops attention
probabilities (``nn.Dropout(llm_dropout)``) between the softmax and the product
with v. The port pretrains through this kernel, so the kernel and both plain
versions take ``dropout_rate`` and ``seed``: a probability is kept iff its
``dropout_bits(seed, B, H, T)`` (``ops/short_attention.py``) at the absolute
index ``((b*H + h)*T + i)*T + j`` is >= p * 2^32, and then scaled by 1/(1-p).
The forward kernel, the backward's recompute and the plain versions draw the
same mask bit for bit; at rate 0 nothing is drawn.

Two plain versions:

* ``flash_attention_reference`` has the kernel's arithmetic (fp32 scores, as
  the Pallas kernel): the CPU forward, and what the kernel is held to;
* ``reference_attention`` is a copy of JAX's ``reference_attention``
  (``tec_mollm_tpu/ops/flash_attention.py:44-58``): the scores in the input
  dtype, the softmax in fp32, the probabilities rounded to the input dtype.
  JAX's ``_flash_bwd`` differentiates that function, so the backward here
  recomputes it under autograd, and a bf16 gradient is JAX's.

The kernel (``csrc/flash_attention.cu``): in bf16, an FA2-style tensor-core
kernel (``mma.sync`` m16n8k16, K/V tiles through ``cp.async``, an online softmax
on the accumulator fragments); in fp32, a scalar kernel. It takes head dims 32,
64 and 128 and strided views (the model hands it views of the c_attn
projection). The bf16 kernel reads 16-byte chunks, so a bf16 view whose pointer
or batch, token or head stride is not a multiple of 16 bytes is copied to a
contiguous tensor before the launch (it is never sent to the plain version).
Its bound on this card is bytes: 4 * B*T*H*D elements, 0.015 ms for the
pretraining batch (64, 129, 12, 64) in bf16.

``flash_attention`` keeps the JAX routing: T >= ``FLASH_MIN_SEQ`` goes to the
``torch.autograd.Function``, shorter sequences to the plain version, as JAX
takes its XLA reference there. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from tec_mollm_tpu_torch.ops import _build
from tec_mollm_tpu_torch.ops.short_attention import dropout_args, dropout_keep

NAME = "flash_attention"
FLASH_MIN_SEQ = 128
HEAD_DIMS = (32, 64, 128)


def _keep(seed: int, rate: float, q: torch.Tensor) -> torch.Tensor:
    """(B, H, T, T) keep mask of the (batch, head, query, key) positions."""
    b, t, h, _ = q.shape
    return dropout_keep(seed, rate, b, h, t, q.device)


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    dropout_rate: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version with the Pallas kernel's arithmetic; (B, T, H, D)
    in q's dtype. Differentiable by autograd."""
    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    if causal:
        scores = scores.masked_fill(~_causal(t, q.device), torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    if dropout_rate > 0.0:
        probs = torch.where(_keep(seed, dropout_rate, q), probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    dropout_rate: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """JAX's ``reference_attention``, copied: q.k and its scaling in q's dtype,
    the softmax in fp32, the probabilities rounded to q's dtype, dropped as
    ``nn.Dropout`` drops them (in q's dtype), and the product with v in q's
    dtype. The backward of ``flash_attention`` differentiates this."""
    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(d**0.5, dtype=q.dtype)
    if causal:
        scores = scores.masked_fill(~_causal(t, q.device), float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        probs = torch.where(_keep(seed, dropout_rate, q), probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, D), got {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS or q.shape[1] == 0:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and T >= 1, got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
    if any(a.stride(-1) != 1 for a in (q, k, v)):
        raise ValueError("the feature axis of q, k and v must have unit stride")


def _aligned16(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself when its pointer and its batch, token and head strides are
    16-byte multiples (the bf16 kernel's loads), else a contiguous copy."""
    size = a.element_size()
    if a.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in a.stride()[:3]):
        return a
    return a.clone(memory_format=torch.contiguous_format)


# flash_attention_forward's C signature: q, k, v, out; b, t, h, d; the batch,
# token and head strides of q, k, v; is_bf16, causal, scale; dropout on, seed,
# threshold, 1/(1-p); stream
ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    dropout_rate: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (strided views taken); returns a
    contiguous (B, T, H, D), with no gradient path (``flash_attention`` is the
    differentiable call)."""
    _build.refuse_grad(NAME, "use flash_attention", q, k, v)
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (_aligned16(a) for a in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.function("flash_attention_forward", ARGTYPES)
    _build.check(NAME, fn(*entry_args(q, k, v, out, causal, dropout_rate, seed)))
    _build.count_launch(NAME)
    return out


def entry_args(q, k, v, out, causal: bool, dropout_rate: float, seed: int) -> tuple:
    """flash_attention_forward's C arguments for checked (B, T, H, D) views on
    one device (bf16 ones 16-byte aligned) and the (B, T, H, D) output buffer,
    in ARGTYPES' order: the one place that marshals them."""
    b, t, h, d = q.shape
    strides = [s for a in (q, k, v) for s in a.stride()[:3]]
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h, d, *strides,
        int(q.dtype == torch.bfloat16), int(bool(causal)), ctypes.c_float(1.0 / d**0.5),
        *dropout_args(dropout_rate, seed), _build.stream_handle(q.device),
    )


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or, on the CPU, the plain version); backward
    by recomputing JAX's ``reference_attention`` under autograd, with the same
    dropout mask, as the JAX ``_flash_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, rate: float, seed: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.rate, ctx.seed = causal, rate, seed
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal, rate, seed)
        return flash_attention_forward(q, k, v, causal, rate, seed)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = reference_attention(*inputs, ctx.causal, ctx.rate, ctx.seed)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    dropout_rate: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """Attention over (B, T, H, D) with attention dropout ``dropout_rate``
    drawn from ``seed``; differentiable. T >= ``FLASH_MIN_SEQ`` takes the
    kernel on a CUDA tensor (or raises) and the plain version on a CPU tensor;
    a shorter sequence takes the plain version, as the JAX routing does."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    if q.shape[1] < FLASH_MIN_SEQ:
        return flash_attention_reference(q, k, v, causal, dropout_rate, seed)
    return _FlashAttention.apply(q, k, v, bool(causal), float(dropout_rate), int(seed))
