"""Fused LayerNorm -> c_fc -> tanh-GELU -> c_proj -> + residual: CUDA kernel + plain version.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/fused_mlp.py:_fused_forward``
(``_kernel``)::

    out = x + (gelu_tanh(LN(x) @ w1 + b1) @ w2 + b2)

with two-pass fp32 LN statistics, the LN output cast to x's dtype, fp32
accumulation, and the GELU output cast to x's dtype before the second product.
x is (rows, d); w1 (d, dh) and w2 (dh, d) in the (in, out) layout.

The kernel (``csrc/fused_mlp.cu``) is three launches in one call: a one-pass
LayerNorm into a bf16 (rows, d) scratch, then two persistent, warp-specialised
Hopper GEMMs (TMA loads into a ring of shared-memory stages with mbarriers,
``wgmma`` on two consumer warpgroups): GEMM1 + bias + tanh-GELU into a
(rows, dh) bf16 scratch, GEMM2 + bias + residual into the output. It takes
bf16 x; the weights are used as they are when they are already bf16 (w1, w2)
and fp32 (LN and bias vectors) on x's device, and converted otherwise. Its
bound on this card is operations: 4 * rows * d * dh FLOP over 989 TFLOP/s,
about 0.67 ms for the flagship eval batch (rows = 8*2944*3, d = 768,
dh = 3072).

The forward is the registered op ``tec_mollm::fused_ln_mlp`` (what an exported
artifact holds); ``fused_ln_mlp`` calls it directly when no gradient is
needed, else through a ``torch.autograd.Function`` whose backward recomputes
the plain version under autograd, as the JAX ``_fused_bwd`` differentiates
``reference_ln_mlp`` (``tec_mollm_tpu/ops/fused_mlp.py:108-113``); the TPU
package has no backward kernel for it either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tec_mollm_tpu_torch.ops import _build

NAME = "fused_mlp"


def fused_ln_mlp_reference(
    x: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic: operands rounded to
    x's dtype, products and epilogues in fp32."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    h = h.to(dt).float() @ w1.to(dt).float() + b1.float()
    h = F.gelu(h, approximate="tanh").to(dt).float()
    h = h @ w2.to(dt).float() + b2.float()
    return (xf + h).to(dt)


def _operand(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """``t`` itself when it already has the kernel's type and device, is
    contiguous and starts at a 16-byte aligned address (TMA's rule); else a
    copy that has all of these."""
    t = t.to(device=device, dtype=dtype)
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def fused_ln_mlp_forward(
    x: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, with no gradient path (``fused_ln_mlp``
    is the differentiable call)."""
    _build.refuse_grad(NAME, "use fused_ln_mlp", x, ln_w, ln_b, w1, b1, w2, b2)
    rows, d = x.shape
    dh = w1.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused MLP kernel takes bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if tuple(w1.shape) != (d, dh) or tuple(w2.shape) != (dh, d):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not fit d={d}")
    if d % 128 or dh % 128 or d > 1536 or rows == 0:
        raise ValueError(f"kernel takes d, dh multiples of 128 and d <= 1536, got {d}, {dh}")

    ln_w, ln_b, b1, b2 = (_operand(t, torch.float32, x.device) for t in (ln_w, ln_b, b1, b2))
    w1, w2 = (_operand(t, torch.bfloat16, x.device) for t in (w1, w2))
    x = _operand(x, torch.bfloat16, x.device)
    x_norm = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
    hidden = torch.empty((rows, dh), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    fn = _build.function(
        "fused_ln_mlp_forward",
        [ctypes.c_void_p] * 10 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), x_norm.data_ptr(), hidden.data_ptr(), out.data_ptr(),
        rows, d, dh, float(eps), _build.stream_handle(x.device),
    )
    _build.check(NAME, err)
    _build.count_launch(NAME)
    return out


def _op_impl(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    """``tec_mollm::fused_ln_mlp``: the plain version on the CPU, the kernel
    on any other device. ``torch.export`` records the op as one node, so an
    exported artifact launches the kernel on the card."""
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    return fused_ln_mlp_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps)


fused_ln_mlp_op = torch.library.custom_op(
    f"{_build.NAMESPACE}::fused_ln_mlp", _op_impl, mutates_args=(),
    schema="(Tensor x, Tensor ln_w, Tensor ln_b, Tensor w1, Tensor b1, Tensor w2, Tensor b2, float eps) -> Tensor",
)
# the shape function, for tracing (a meta tensor goes to _op_impl: _build.op_for)
fused_ln_mlp_op.register_fake(lambda x, ln_w, ln_b, w1, b1, w2, b2, eps: x.new_empty(x.shape))


class _FusedLNMLP(torch.autograd.Function):
    """Forward through the registered op; backward by recomputing the plain
    version under autograd, as the JAX ``_fused_bwd`` differentiates
    ``reference_ln_mlp``."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return _build.op_for(fused_ln_mlp_op, _op_impl, x)(x, ln_w, ln_b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_ln_mlp_reference(*inputs, ctx.eps)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_ln_mlp(
    x: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + MLP(LN(x)) over (rows, d). A CPU tensor takes the plain version, a
    CUDA tensor launches the kernel or raises. A call that needs no gradient
    is one ``tec_mollm::fused_ln_mlp`` op; one that does goes through the
    autograd function."""
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedLNMLP.apply(*args, float(eps))
    return _build.op_for(fused_ln_mlp_op, _op_impl, x)(*args, float(eps))
