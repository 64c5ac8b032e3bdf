"""The GPT-2 backbone's residual add and LayerNorm on eval calls: CUDA kernel + plain mirror.

``csrc/add_layernorm.cu`` computes, for bf16 rows of width d, the residual
add followed by the lean LayerNorm, reading x and the residual branch once
and writing the new residual stream and the normalised rows once (its source
note gives the design and the bound). It replaces no TPU kernel: the JAX
package leaves LayerNorm to XLA. Per row::

    s = bf16(x + delta)                              (s = x without a residual)
    mean = sum(s) / d, var = sum(s^2) / d - mean^2   (fp32, from the rounded s)
    h = bf16(bf16(bf16((s - mean) * rsqrt(var + eps)) * bf16(w)) + bf16(b))

``add_layernorm_mirror`` is that arithmetic in PyTorch: the plain add, then
``lean_layernorm``. The op ``tec_mollm::add_layernorm`` (what an exported
artifact holds) runs the mirror on a CPU tensor and launches the kernel on
the card; it returns s and h stacked, (2, *x.shape), or h alone as (1,
*x.shape) without a residual.
"""

from __future__ import annotations

import ctypes

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "add_layernorm"
# the widths csrc/add_layernorm.cu is built for: multiples of 8 (16-byte
# pieces of bf16) up to 32 lanes x 8 pieces x 8
PIECE = 8
MAX_WIDTH = 2048

# add_layernorm_forward's C signature: x, delta, w, b, s, h, rows, d, eps, stream
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def lean_layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """fp32 statistics from E[x^2] - mu^2, the affine in x's dtype (the JAX
    forecast model's LayerNorm)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
    norm = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return norm * w.to(x.dtype) + b.to(x.dtype)


def add_layernorm_takes(d: int, dtype: torch.dtype) -> str | None:
    """None when the kernel takes rows of width ``d`` in ``dtype``, else why
    the plain add and LayerNorm run them."""
    if dtype != torch.bfloat16:
        return f"the kernel takes bf16 rows, got {dtype}"
    if d % PIECE or not PIECE <= d <= MAX_WIDTH:
        return f"the kernel takes widths of {PIECE} to {MAX_WIDTH} in multiples of {PIECE}, got {d}"
    return None


def add_layernorm_mirror(x: torch.Tensor, delta: torch.Tensor | None, w: torch.Tensor, b: torch.Tensor,
                         eps: float = 1e-5):
    """The kernel's arithmetic in plain PyTorch: (s, h) with s = x + delta and
    h = lean_layernorm(s), or h = lean_layernorm(x) alone without delta."""
    s = x if delta is None else x + delta
    h = lean_layernorm(s, w, b, eps)
    return h if delta is None else (s, h)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it is contiguous from a 16-byte aligned pointer (the
    kernel's 16-byte loads), else a contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(x: torch.Tensor, delta: torch.Tensor | None, w: torch.Tensor, b: torch.Tensor, eps: float):
    """Check the tensors and launch the kernel into a (2 or 1, *x.shape)
    output; raises on what it does not take and when the library does not
    build or the launch fails."""
    if x.dim() == 0:
        raise ValueError("x must have a last dimension to normalise")
    d = x.shape[-1]
    reason = add_layernorm_takes(d, x.dtype)
    if reason is not None:
        raise (TypeError if x.dtype != torch.bfloat16 else ValueError)(reason)
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"delta must match x ({tuple(x.shape)}, {x.dtype}), got {tuple(delta.shape)}, {delta.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.shape != (d,) or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be ({d},) fp32 or bf16, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("delta", delta), ("w", w), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    out = torch.empty((1 if delta is None else 2, *x.shape), dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    # bf16 affines widen exactly to fp32; the kernel rounds them back
    x, w, b = _aligned(x), _aligned(w.float()), _aligned(b.float())
    delta = None if delta is None else _aligned(delta)
    fn = _build.function("add_layernorm_forward", ARGTYPES)
    _build.check(NAME, fn(
        x.data_ptr(), None if delta is None else delta.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if delta is None else out[0].data_ptr(), out[-1].data_ptr(), rows, d, eps,
        _build.stream_handle(x.device),
    ))
    _build.count_launch(NAME)
    return out


def _op_impl(x, delta, w, b, eps):
    """``tec_mollm::add_layernorm``: the mirror on the CPU, the kernel on any
    other device; s and h stacked, or h alone."""
    if x.device.type == "cpu":
        out = add_layernorm_mirror(x, delta, w, b, eps)
        return out[None] if delta is None else torch.stack(out)
    return _launch(x, delta, w, b, eps)


add_layernorm_op = torch.library.custom_op(
    f"{_build.NAMESPACE}::add_layernorm", _op_impl, mutates_args=(),
    schema="(Tensor x, Tensor? delta, Tensor w, Tensor b, float eps) -> Tensor",
)
# the shape function, for tracing (a meta tensor goes to _op_impl: _build.op_for)
add_layernorm_op.register_fake(
    lambda x, delta, w, b, eps: x.new_empty((1 if delta is None else 2, *x.shape))
)


def add_layernorm(x: torch.Tensor, delta: torch.Tensor | None, w: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-5):
    """``lean_layernorm(x + delta)`` for bf16 rows: (s, h) with s = x + delta,
    or h alone where ``delta`` is None, through ``tec_mollm::add_layernorm``.
    A CPU tensor takes the mirror; a CUDA tensor launches the kernel or
    raises. It has no backward: a call that would need one raises."""
    _build.refuse_grad(
        NAME, "call it under torch.no_grad() (the model trains through the plain LayerNorms)",
        *(t for t in (x, delta, w, b) if t is not None),
    )
    out = _build.op_for(add_layernorm_op, _op_impl, x)(x, delta, w, b, eps)
    return out[0] if delta is None else (out[0], out[1])
