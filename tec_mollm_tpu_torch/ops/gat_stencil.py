"""Stencil GATv2 attention over the lane-major layout: CUDA kernel + plain version.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/gat_stencil.py:gat_stencil_attention``
(``_kernel``). For each graph slice m and node n, over the O static node shifts::

    score_h[o] = att_h . leaky_relu(xl[m, h, :, n + shift_o] + xr[m, h, :, n])
    alpha_h    = softmax over the offsets o with valid[o, n]
    out[m, h, :, n] = sum_o alpha_h[o] * xl[m, h, :, n + shift_o]

Shapes: xl, xr, out (M, H*C, N); valid (O, N) bool; att (H, C).

The kernel (``csrc/gat_stencil.cu``) runs one thread per (m, n) with every
channel in registers, so xl and xr are read once and the output written once.
On this card it is bound by bytes: 3 * M*H*C*N elements over 3.35 TB/s, about
45 us for the flagship eval batch (M = 8*48, N = 2944, bf16).

Unlike the Pallas body, the denominator is floored at the smallest normal
float32, as the model's plain path does: a node with no valid offset (the lanes
added by ``pad_nodes_to``) gives 0, not NaN.
"""

from __future__ import annotations

import ctypes

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "gat_stencil"
_NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny


def gat_stencil_reference(
    xl: torch.Tensor,
    xr: torch.Tensor,
    valid: torch.Tensor,
    att: torch.Tensor,
    shifts: tuple[int, ...],
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic (fp32, result in xl's
    dtype). Shifted reads wrap around the node axis; ``valid`` masks them."""
    m, hc, n = xl.shape
    h, c = att.shape
    xlf = xl.float().reshape(m, h, c, n)
    xrf = xr.float().reshape(m, h, c, n)
    a = att.float().reshape(1, h, c, 1)
    ok = valid.bool()

    def rolled(shift: int) -> torch.Tensor:
        return torch.roll(xlf, -shift, dims=-1) if shift else xlf

    scores = []
    for o, shift in enumerate(shifts):
        e = rolled(shift) + xrf
        e = torch.where(e >= 0, e, negative_slope * e)
        scores.append(torch.where(ok[o], (e * a).sum(dim=2), _NEG))  # (m, h, n)
    mx = torch.stack(scores).amax(dim=0)
    weights = [torch.where(ok[o], torch.exp(s - mx), 0.0) for o, s in enumerate(scores)]
    denom = torch.clamp_min(sum(weights), _TINY)
    out = torch.zeros_like(xlf)
    for o, shift in enumerate(shifts):
        out = out + (weights[o] / denom)[:, :, None, :] * rolled(shift)
    return out.reshape(m, hc, n).to(xl.dtype)


def gat_stencil_attention(
    xl: torch.Tensor,
    xr: torch.Tensor,
    valid: torch.Tensor,
    att: torch.Tensor,
    shifts: tuple[int, ...],
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Forward stencil attention; (M, H*C, N) in xl's dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises. Like the
    Pallas kernel it has no backward: a call that would need one raises, on
    every device."""
    _build.refuse_grad(
        "gat_stencil_attention", "call it under torch.no_grad() (the model trains through "
        "GATv2Stencil's plain path)", xl, xr, att,
    )
    if xl.device.type == "cpu":
        return gat_stencil_reference(xl, xr, valid, att, shifts, negative_slope)
    m, hc, n = xl.shape
    h, c = att.shape
    if (h, c) != (2, 11) or h * c != hc:
        raise ValueError(f"the stencil kernel is built for 2 heads x 11 channels, got {h}x{c}")
    if xl.dtype not in (torch.bfloat16, torch.float32) or xr.dtype != xl.dtype:
        raise TypeError(f"xl/xr must share bf16 or fp32, got {xl.dtype}/{xr.dtype}")
    if xr.shape != xl.shape or tuple(valid.shape) != (len(shifts), n):
        raise ValueError(
            f"shapes disagree: xl {tuple(xl.shape)} xr {tuple(xr.shape)} "
            f"valid {tuple(valid.shape)} for {len(shifts)} shifts"
        )
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    for name, t in (("xl", xl), ("xr", xr), ("valid", valid)):
        if t.device != xl.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xl.device}")
    att32 = att.detach().to(device=xl.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(xl)
    fn = _build.function(
        "gat_stencil_forward",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    shift_arr = (ctypes.c_int * len(shifts))(*(int(s) for s in shifts))
    err = fn(
        xl.data_ptr(), xr.data_ptr(), valid.data_ptr(),
        ctypes.cast(shift_arr, ctypes.c_void_p), att32.data_ptr(), out.data_ptr(),
        m, h, c, n, len(shifts), float(negative_slope),
        int(xl.dtype == torch.bfloat16), _build.stream_handle(xl.device),
    )
    _build.check(NAME, err)
    _build.count_launch(NAME)
    return out
