"""Flash attention for long sequences (T >= 128): CUDA kernel + plain version.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/flash_attention.py:_flash_forward``
(``_attn_kernel``): causal or non-causal softmax attention over q, k, v of shape
(B, T, H, D), the JAX layout. Scores q.k in fp32 times 1/sqrt(D), causal keys
masked, fp32 softmax, the probabilities rounded to v's dtype before the product
with v, which accumulates in fp32; the output in the input dtype.

The kernel (``csrc/flash_attention.cu``) takes one (b*h, 64-query tile) per
block and streams K and V through shared memory with an online softmax; it
rounds the unnormalised probabilities and divides at the end, where the Pallas
kernel rounds the normalised ones (about one bf16 ulp apart). It takes bf16 and
fp32, head dims 32, 64 and 128, and strided views (the model hands it views of
the c_attn projection). Its bound on this card is bytes: 4 * B*T*H*D elements,
0.015 ms for the pretraining batch (64, 129, 12, 64) in bf16.

``flash_attention`` keeps the JAX routing: T >= ``FLASH_MIN_SEQ`` goes to the
``torch.autograd.Function``, shorter sequences to the plain version, as JAX
takes its XLA reference there. The function saves q, k and v; its backward
recomputes the plain version under autograd, as the JAX ``_flash_bwd``
differentiates ``reference_attention`` (``tec_mollm_tpu/ops/flash_attention.py:146-149``).
JAX's reference rounds the scores to the input dtype, so in bf16 the two
backwards differ by that rounding; in fp32 they are the same. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "flash_attention"
FLASH_MIN_SEQ = 128
HEAD_DIMS = (32, 64, 128)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain PyTorch version with the Pallas kernel's arithmetic; (B, T, H, D)
    in q's dtype. Differentiable by autograd."""
    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    if causal:
        keep = torch.ones(t, k.shape[1], dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


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


_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; (B, T, H, D) contiguous, with no
    gradient path (``flash_attention`` is the differentiable call)."""
    _build.refuse_grad(NAME, "use flash_attention", q, k, v)
    _check(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = [s for a in (q, k, v) for s in a.stride()[:3]]
    fn = _build.function("flash_attention_forward", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h, d, *strides,
        int(q.dtype == torch.bfloat16), int(bool(causal)), ctypes.c_float(1.0 / d**0.5),
        _build.stream_handle(q.device),
    )
    _build.check(NAME, err)
    _build.count_launch(NAME)
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or, on the CPU, the plain version); backward
    by recomputing the plain version under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal)
        return flash_attention_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = flash_attention_reference(*inputs, ctx.causal)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Attention over (B, T, H, D); differentiable. T >= ``FLASH_MIN_SEQ``
    takes the kernel on a CUDA tensor (or raises) and the plain version on a
    CPU tensor; a shorter sequence takes the plain version, as the JAX routing
    does."""
    if q.shape[1] < FLASH_MIN_SEQ:
        return flash_attention_reference(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, bool(causal))
