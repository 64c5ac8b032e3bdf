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
kernel, sized at launch from the stencil's span and C (``general_plan``
mirrors its choice): a block owns one head of a tile of 256, 128 or 64 nodes
and walks consecutive slices; each slice's window (the rows the tile's
offsets reach) and xr tile come into shared memory by ``cp.async`` while the
slice before is computed, and are converted once to node-major fp32 records
beside the projection; one online-softmax pass in log2 units reads each
neighbour's record once, over only the offsets a warp needs (validity bits
kept per node in shared memory). A span too wide for the smallest tile's
window reads the offsets outside it from device memory in the same kernel.
``gat_stencil_general_mirror`` is its decomposition in plain PyTorch (the
tests hold it to the reference).

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
from typing import NamedTuple

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


# csrc/gat_stencil.cu's general form: the tiles it tries, largest first; the
# dynamic shared memory a block may take (two blocks an SM); the float4 counts
# of a narrow head's record (C <= 4 q - 1; wider heads are "wide", q = 0); the
# offsets whose validity bits a block keeps in shared memory
GENERAL_TILES = (256, 128, 64)
GENERAL_BUDGET = 110 * 1024
NARROW_Q = (2, 3, 4, 5, 6, 8)
RESIDENT_OFFSETS = 512
# bytes of a validity word (32 offsets)
WORD_BYTES = 4
# gat_stencil_general_plan's C signature: shifts (host), n_offsets, channels,
# n, is_bf16, out (9 int64)
PLAN_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LOG2E = 1.4426950408889634
# log2 units a score may pass a node's running max before the kernel rescales
# the sums of every node of the warp (kLazy)
_LAZY = 8.0


class GeneralPlan(NamedTuple):
    """The general kernel's sizes for one call (general_plan in
    csrc/gat_stencil.cu, whose gat_stencil_general_plan returns the same
    fields in this order)."""

    q: int  # float4 chunks of a narrow head's record; 0 for a wide head
    tile: int  # nodes of a block
    wlen: int  # window elements; 0: every neighbour from device memory
    lo: int  # window element 0 is node n0 + lo
    rec: int  # floats of a window record
    res_offsets: int  # offsets whose bits and shifts stay in shared memory
    window_offsets: int  # offsets read from the window
    bytes: int  # dynamic shared memory of a block
    reach: int  # offsets that can reach a node (|shift| < N)


def general_plan(shifts, channels: int, n: int, itemsize: int) -> GeneralPlan:
    """The general kernel's tile, window and shared memory for ``shifts`` on
    ``n`` nodes of ``channels`` channels a head in an element type of
    ``itemsize`` bytes: the largest tile of GENERAL_TILES whose window (the
    tile plus the span of the shifts with |shift| < n, in 16-byte chunks) fits
    GENERAL_BUDGET with the rest of the block's shared memory; else the
    smallest tile and the widest window that fits, centred on shift 0 where
    the span allows, the offsets outside it read from device memory (none
    inside when not even the tile fits)."""
    e = 16 // itemsize
    shifts = [int(s) for s in shifts]
    q = next((q for q in NARROW_Q if 4 * q - 1 >= channels), 0)
    chunks = q or (channels + 4) // 4
    chunks += chunks % 2 == 0  # an odd count: neighbouring records start in distinct bank quads
    rec = 4 * chunks
    res = min(len(shifts), RESIDENT_OFFSETS)
    res_words = -(-res // (8 * WORD_BYTES))
    reach = [s for s in shifts if -n < s < n]

    def r16(b: int) -> int:
        return -(-b // 16) * 16

    def layout(tile: int, wlen: int) -> int:
        # W; the staging rows (wlen + e and tile + e elements); validity words
        # a node and a warp; shifts and their window offsets
        return (wlen * rec * 4 + r16(channels * (wlen + e) * itemsize)
                + (r16(channels * (tile + e) * itemsize) if q else 0)
                + res_words * tile * WORD_BYTES + r16(res_words * (tile // 32) * WORD_BYTES) + 2 * r16(res * 4))

    def finish(tile: int, wlen: int, lo: int) -> GeneralPlan:
        inside = sum(1 for s in reach if 0 <= s - lo <= wlen - tile)
        return GeneralPlan(q, tile, wlen, lo, rec, res, inside, layout(tile, wlen), len(reach))

    if not reach:
        return finish(GENERAL_TILES[-1], 0, 0)
    lo, hi = min(reach), max(reach)
    lo_al = lo // e * e
    span = -(-hi // e) * e - lo_al
    for tile in GENERAL_TILES:
        if tile > GENERAL_TILES[-1] and tile // 2 >= n:
            continue  # half the tile would be idle
        if layout(tile, tile + span) <= GENERAL_BUDGET:
            return finish(tile, tile + span, lo_al)
    tile = GENERAL_TILES[-1]
    cap = (GENERAL_BUDGET - layout(tile, 0)) // (rec * 4 + channels * itemsize) // e * e
    if cap < tile + e:
        return finish(tile, 0, 0)
    extra = cap - tile - e
    lo_w = max(lo, -(extra // 2))
    if lo_w + extra > hi:
        lo_w = max(lo, hi - extra)
    return finish(tile, cap, lo_w // e * e)


def gat_stencil_general_mirror(
    xl: torch.Tensor,
    xr: torch.Tensor,
    valid: torch.Tensor,
    att: torch.Tensor,
    shifts: tuple[int, ...],
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """The general kernel's decomposition in plain PyTorch, tile by tile as
    ``general_plan`` cuts the node axis: a neighbour comes from the tile's
    window (zero outside [0, N)) when its offset lies in it, else straight
    from xl; a score is P[neighbour] + k2 att . |l + r| in log2 units, with P
    = k1 att . l and leaky_relu(e) = (k1 e + k2 |e|) / log2(e) (the node's own
    k1 att . r cancels in the softmax); the softmax is online over the
    offsets in order, the running sums rescaled only where a score passes its
    node's running max by more than _LAZY on some node of the warp (32
    consecutive nodes of the tile); a neighbour outside [0, N) is invalid; the
    denominator is floored at the smallest normal float32. fp32, the result in
    xl's dtype. Equal to ``gat_stencil_reference`` up to fp32 rounding wherever
    the mask marks no out-of-range neighbour valid."""
    m, hc, n = xl.shape
    h, c = att.shape
    shifts = tuple(int(s) for s in shifts)
    plan = general_plan(shifts, c, n, xl.element_size())
    k1 = 0.5 * (1.0 + negative_slope) * _LOG2E
    k2 = 0.5 * (1.0 - negative_slope) * _LOG2E
    xlf = xl.float().reshape(m, h, c, n)
    xrf = xr.float().reshape(m, h, c, n)
    a = att.float().reshape(1, h, c, 1)
    proj = k1 * (a * xlf).sum(dim=2)  # (m, h, n)
    ok_all = valid.bool()
    out = torch.empty_like(xlf)
    for n0 in range(0, n, plan.tile):
        nodes = torch.arange(n0, min(n0 + plan.tile, n))
        t = nodes - n0
        wnodes = n0 + plan.lo + torch.arange(plan.wlen)
        inside = (wnodes >= 0) & (wnodes < n)
        wclamp = wnodes.clamp(0, n - 1)
        win = torch.where(inside, xlf[..., wclamp], 0.0)
        win_p = torch.where(inside, proj[..., wclamp], 0.0)
        r = xrf[..., nodes]
        pad = -len(nodes) % 32

        def warp_any(x: torch.Tensor) -> torch.Tensor:  # (m, h, nodes) bool: any over each warp's nodes
            g = torch.nn.functional.pad(x, (0, pad)).reshape(m, h, -1, 32).any(dim=-1, keepdim=True)
            return g.expand(-1, -1, -1, 32).reshape(m, h, -1)[..., : len(nodes)]

        mx = torch.full((m, h, len(nodes)), _NEG)
        den = torch.zeros(m, h, len(nodes))
        acc = torch.zeros(m, h, c, len(nodes))
        for o, s in enumerate(shifts):
            j = nodes + s
            ok = ok_all[o, nodes] & (j >= 0) & (j < n)
            idx = s - plan.lo
            if -n < s < n and 0 <= idx <= plan.wlen - plan.tile:
                lv, p = win[..., idx + t], win_p[..., idx + t]
            else:
                lv = torch.where(ok, xlf[..., j.clamp(0, n - 1)], 0.0)
                p = k1 * (a * lv).sum(dim=2)
            sc = torch.where(ok, p + k2 * (a * (lv + r).abs()).sum(dim=2), _NEG)
            mx_new = torch.where(warp_any(sc > mx + _LAZY), torch.maximum(mx, sc), mx)
            f = torch.exp2(mx - mx_new)
            mx = mx_new
            w = torch.where(ok, torch.exp2(sc - mx), 0.0)
            den = den * f + w
            acc = acc * f[:, :, None] + w[:, :, None] * lv
        out[..., nodes] = acc / torch.clamp_min(den, _TINY)[:, :, None]
    return out.reshape(m, hc, n).to(xl.dtype)


def entry_args(xl, xr, valid, att32, shifts: tuple[int, ...], out, negative_slope: float) -> tuple:
    """gat_stencil_forward's arguments for checked tensors on one device (att32
    the (H, C) fp32 attention vector, contiguous there; out the result's
    buffer), in ARGTYPES' order: the tiled kernel where ``tiled_takes``, else
    the general one (which sizes itself from the host shifts and reads them
    from the device)."""
    m, _, n = xl.shape
    heads, channels = att32.shape
    general = tiled_takes(shifts, heads, channels) is not None
    return (
        xl.data_ptr(), xr.data_ptr(), valid.data_ptr(),
        ctypes.cast(_shift_array(shifts), ctypes.c_void_p),
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
