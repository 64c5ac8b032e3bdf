"""Stencil GATv2 attention over the lane-major layout: CUDA kernel + plain version.

Replaces the Pallas kernel ``tec_mollm_tpu/ops/gat_stencil.py:gat_stencil_attention``
(``_kernel``). For each graph slice m and node n, over the O static node shifts::

    score_h[o] = att_h . leaky_relu(xl[m, h, :, n + shift_o] + xr[m, h, :, n])
    alpha_h    = softmax over the offsets o with valid[o, n]
    out[m, h, :, n] = sum_o alpha_h[o] * xl[m, h, :, n + shift_o]

Shapes: xl, xr, out (M, H*C, N); valid (O, N) bool; att (H, C).

The kernel (``csrc/gat_stencil.cu``) is bound by bytes on this card: xl and xr
read once and the output written once, 3 * M*H*C*N elements, 0.0446 ms at
3.35 TB/s for the flagship eval batch (M = 8*48, N = 2944, bf16). What holds it
above that is its instruction stream, not its bytes (``PERF.md``). A block owns
a tile of 256 nodes and walks consecutive slices; each slice's xl window (the
tile plus a halo of 72 or 144 nodes on each side, whichever holds every shift)
and xr tile come into shared memory by 16-byte ``cp.async`` while the slice
before is computed, so each value comes from device memory about once. The
window is converted once to node-major fp32 records, a neighbour's 11 channels
beside the head's projection att . xl (with leaky_relu(e) = k1 e + k2 |e| that
leaves a channel one add and one multiply-add of the score); the softmax is
online over the offsets, and each record is read once, in three 16-byte loads.
That tiled kernel is built for the model's 2 heads x 11 channels, at most 64
offsets and shifts up to 144 nodes (``tiled_takes``). Any other layout or
stencil, all of which the Pallas kernel takes, launches the file's general
kernel: a thread per (slice, head, node) reading its neighbours from device
memory, with the same arithmetic and masks.

Unlike the Pallas body, the denominator is floored at the smallest normal
float32, as the model's plain path does: a node with no valid offset (the lanes
added by ``pad_nodes_to``) gives 0, not NaN. And the kernel counts a neighbour
outside [0, N) as invalid, where the Pallas roll and the plain version wrap
around the node axis; the two agree on every mask the graph builder makes,
since it marks no such neighbour valid.

The forward is the registered op ``tec_mollm::gat_stencil`` (what an exported
artifact holds): the plain version on a CPU tensor, the launch on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tec_mollm_tpu_torch.ops import _build

NAME = "gat_stencil"
_NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny

# What csrc/gat_stencil.cu's tiled kernel takes: up to MAX_OFFSETS offsets (a
# node's validity bits are one uint64 there), each shift at most MAX_SHIFT nodes
# (its largest halo: the 300 km stencil's), and 2 heads x 11 channels. Any other
# stencil or layout launches its general kernel instead, counted as
# GENERAL_NAME.
MAX_OFFSETS = 64
MAX_SHIFT = 144
_HEADS, _CHANNELS = 2, 11
GENERAL_NAME = "gat_stencil_general"
_INT32 = 2**31 - 1


def tiled_takes(shifts, heads: int = _HEADS, channels: int = _CHANNELS) -> str | None:
    """None when the tiled kernel takes this stencil and head layout, else why
    the general kernel runs it: more than MAX_OFFSETS offsets, a shift beyond
    MAX_SHIFT nodes, or another layout than 2 heads x 11 channels."""
    shifts = tuple(int(s) for s in shifts)
    if not 1 <= len(shifts) <= MAX_OFFSETS:
        return f"the tiled kernel takes 1 to {MAX_OFFSETS} offsets, got {len(shifts)}"
    if max(map(abs, shifts)) > MAX_SHIFT:
        return f"the tiled kernel takes shifts up to {MAX_SHIFT} nodes, got {max(map(abs, shifts))}"
    if (heads, channels) != (_HEADS, _CHANNELS):
        return f"the tiled kernel is built for {_HEADS} heads x {_CHANNELS} channels, got {heads}x{channels}"
    return None


def check_stencil(shifts) -> tuple[int, ...]:
    """The shifts as a tuple of ints; raises for a stencil no kernel takes: one
    without an offset, or a shift that is not a 32-bit int."""
    shifts = tuple(int(s) for s in shifts)
    if not shifts:
        raise ValueError("the stencil kernel takes at least one offset, got none")
    if max(map(abs, shifts)) > _INT32:
        raise ValueError(f"the stencil kernel takes shifts up to {_INT32} nodes, got {max(map(abs, shifts))}")
    return shifts


# gat_stencil_forward's C signature: xl, xr, valid, shifts (host), shifts (device),
# att, out; m, heads, channels, n, n_offsets; negative slope; is_bf16, general;
# stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=16)
def _shift_array(shifts: tuple[int, ...]) -> ctypes.Array:
    return (ctypes.c_int * len(shifts))(*shifts)


@functools.lru_cache(maxsize=16)
def _device_shifts(shifts: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The shifts as int32 on ``device``, where the general kernel reads them."""
    return torch.tensor(shifts, dtype=torch.int32, device=device)


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


def entry_args(xl, xr, valid, att32, shifts: tuple[int, ...], out, negative_slope: float) -> tuple:
    """gat_stencil_forward's arguments for checked tensors on one device (att32
    the (H, C) fp32 attention vector, contiguous there; out the result's
    buffer), in ARGTYPES' order: the tiled kernel where ``tiled_takes``, else
    the general one."""
    m, _, n = xl.shape
    heads, channels = att32.shape
    general = tiled_takes(shifts, heads, channels) is not None
    return (
        xl.data_ptr(), xr.data_ptr(), valid.data_ptr(),
        None if general else ctypes.cast(_shift_array(shifts), ctypes.c_void_p),
        _device_shifts(shifts, xl.device).data_ptr() if general else None,
        att32.data_ptr(), out.data_ptr(),
        m, heads, channels, n, len(shifts), float(negative_slope),
        int(xl.dtype == torch.bfloat16), int(general), _build.stream_handle(xl.device),
    )


def _launch(
    xl: torch.Tensor,
    xr: torch.Tensor,
    valid: torch.Tensor,
    att: torch.Tensor,
    shifts: tuple[int, ...],
    negative_slope: float,
) -> torch.Tensor:
    """Check the tensors and launch the kernel (the tiled form where
    ``tiled_takes``, else the general one); raises on what it does not take
    and when the library does not build or the launch fails."""
    m, hc, n = xl.shape
    h, c = att.shape
    if h * c != hc:
        raise ValueError(f"att ({h}x{c}) does not fit {hc} channels")
    shifts = check_stencil(shifts)
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
    fn = _build.function("gat_stencil_forward", ARGTYPES)
    _build.check(NAME, fn(*entry_args(xl, xr, valid, att32, shifts, out, negative_slope)))
    _build.count_launch(NAME if tiled_takes(shifts, h, c) is None else GENERAL_NAME)
    return out


def _op_impl(xl, xr, valid, att, shifts, negative_slope):
    """``tec_mollm::gat_stencil``: the plain version on the CPU, the kernel on
    any other device. ``torch.export`` records the op as one node, so an
    exported artifact launches the kernel on the card."""
    if xl.device.type == "cpu":
        return gat_stencil_reference(xl, xr, valid, att, tuple(shifts), negative_slope)
    return _launch(xl, xr, valid, att, tuple(shifts), negative_slope)


gat_stencil_op = torch.library.custom_op(
    f"{_build.NAMESPACE}::gat_stencil", _op_impl, mutates_args=(),
    schema="(Tensor xl, Tensor xr, Tensor valid, Tensor att, int[] shifts, float negative_slope) -> Tensor",
)
# the shape function, for tracing (a meta tensor goes to _op_impl: _build.op_for)
gat_stencil_op.register_fake(lambda xl, xr, valid, att, shifts, negative_slope: torch.empty_like(xl))


def gat_stencil_attention(
    xl: torch.Tensor,
    xr: torch.Tensor,
    valid: torch.Tensor,
    att: torch.Tensor,
    shifts: tuple[int, ...],
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Forward stencil attention; (M, H*C, N) in xl's dtype, through
    ``tec_mollm::gat_stencil``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises. Like the Pallas kernel it has no
    backward: a call that would need one raises, on every device."""
    _build.refuse_grad(
        "gat_stencil_attention", "call it under torch.no_grad() (the model trains through "
        "GATv2Stencil's plain path)", xl, xr, att,
    )
    call = _build.op_for(gat_stencil_op, _op_impl, xl)
    return call(xl, xr, valid, att, [int(s) for s in shifts], float(negative_slope))
