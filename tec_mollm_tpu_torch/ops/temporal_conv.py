"""The temporal encoder's two multi-scale conv blocks on eval calls: CUDA kernel + plain mirror.

``csrc/temporal_conv.cu`` computes what ``models/temporal.py``'s unfused
``MultiScaleConvBlock`` pair computes, for a tile of sequences at a time,
with no intermediate in device memory (its source note gives the design and
the bound). It replaces no TPU kernel: the JAX package leaves the block to
XLA. Per sequence (x: L = 48 steps of C_in <= 24 channels)::

    block 1: h_j = conv_{k_j}(x) + b_j           (64 channels, k_j = 3, 5, 7, SAME)
             a_j = GELU(GroupNorm(h_j))[even steps]     (fp32 statistics, two passes)
             y1  = sum_j F1_j a_j + f1                  (the stride-2 1x1 conv: 24 x 64)
    block 2: the same on y1, 64 -> 128 channels, 24 -> 12 steps -> out (12, 128)

Products take bf16 operands and accumulate in fp32; a_j, y1 and the output
are rounded to bf16 (``temporal_conv_mirror`` is that arithmetic in PyTorch,
and in fp32 it is the unfused block's). The kernel takes one shape family:
``temporal_takes`` says why any other runs the plain path.

Its weights come packed (``pack_blocks``): one buffer in the order and
layout in which the kernel streams them through shared memory
(``chunk_shapes``), and the biases and GroupNorm affines in fp32. The op
``tec_mollm::temporal_conv`` (what an exported artifact holds) runs the mirror
on a CPU tensor and launches the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from tec_mollm_tpu_torch.ops import _build

NAME = "temporal_conv"
# the one shape family csrc/temporal_conv.cu is built for
LENGTH = 48
MAX_IN_CHANNELS = 24  # the input's channels padded to 24 (48-byte rows)
CHANNELS = (64, 128)
KERNEL_SIZES = (3, 5, 7)
STRIDES = (2, 2)
EPS = 1e-5
OUT_LENGTH = LENGTH // (STRIDES[0] * STRIDES[1])

_C1, _C2 = CHANNELS
_LD = _C1 + 8  # rows of 64 input channels, plus 8 elements (distinct banks)

# temporal_conv_forward's C signature: x, n_seq, nodes, sb, sn, sl, cin, wpack,
# wbytes, params, out, stream
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + [ctypes.c_int64] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def temporal_takes(in_channels: int, channels, kernel_sizes, strides, length: int,
                   dtype: torch.dtype) -> str | None:
    """None when the kernel takes a conv embedder of these widths on an input
    of ``length`` steps in ``dtype``, else why the plain path runs it."""
    if dtype != torch.bfloat16:
        return f"the kernel computes in bf16 on the tensor cores, got {dtype}"
    if not 1 <= in_channels <= MAX_IN_CHANNELS:
        return f"the kernel takes 1 to {MAX_IN_CHANNELS} input channels, got {in_channels}"
    if tuple(channels) != CHANNELS:
        return f"the kernel is built for channels {CHANNELS}, got {tuple(channels)}"
    if tuple(kernel_sizes) != KERNEL_SIZES:
        return f"the kernel is built for kernel sizes {KERNEL_SIZES}, got {tuple(kernel_sizes)}"
    if tuple(strides) != STRIDES:
        return f"the kernel is built for strides {STRIDES}, got {tuple(strides)}"
    if length != LENGTH:
        return f"the kernel is built for {LENGTH} input steps, got {length}"
    return None


def _k1(k: int) -> int:
    """Block 1's depth for k taps: k x 24 channels, rounded up to 16."""
    return -(-k * MAX_IN_CHANNELS // 16) * 16


def chunk_shapes() -> list[tuple[int, int]]:
    """(rows, row length) of each chunk of the packed weights, in the order
    the kernel streams them: block 1's branch kernels (64 x (k1 + 8), taps
    major, 24 channels a tap), its 1x1 conv whole (64 x (192 + 8)); block 2's
    taps branch by branch (128 x 72 each), its 1x1 conv in slices of 64 input
    channels (128 x 72 each). Every row has 8 elements past its data (zeros)
    and block 1's kernel rows run past k x 24 to a multiple of 16 (zeros);
    csrc/temporal_conv.cu's chunk_bytes is the same."""
    branches = len(KERNEL_SIZES)
    shapes = [(_C1, _k1(k) + 8) for k in KERNEL_SIZES] + [(_C1, branches * _C1 + 8)]
    shapes += [(_C2, _LD)] * sum(KERNEL_SIZES)
    return shapes + [(_C2, _LD)] * (branches * _C2 // _C1)


WEIGHT_ELEMENTS = sum(r * c for r, c in chunk_shapes())
# the conv biases, GroupNorm scales and shifts of each branch, and the 1x1 bias, of both blocks
PARAMS = sum(c * (3 * len(KERNEL_SIZES) + 1) for c in CHANNELS)


def pack_blocks(blocks, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed weights in ``dtype``, fp32 parameters) of the two
    ``MultiScaleConvBlock``s, on their device: the layout of
    ``chunk_shapes``, and the conv biases, GroupNorm scales and shifts of
    block 1's branches, its 1x1 bias, then block 2's the same."""
    (b1, b2), cp = blocks, MAX_IN_CHANNELS
    chunks, params = [], []
    for conv, _, _ in b1.convs:
        w = conv.weight.detach()  # (64, C_in, k)
        k = w.shape[-1]
        w = F.pad(w.permute(0, 2, 1), (0, cp - w.shape[1])).reshape(_C1, k * cp)
        chunks.append(F.pad(w, (0, _k1(k) + 8 - k * cp)))
    chunks.append(F.pad(b1.final_conv.weight.detach()[..., 0], (0, 8)))
    for conv, _, _ in b2.convs:
        w = conv.weight.detach()  # (128, 64, k)
        chunks += [F.pad(w[:, :, t], (0, 8)) for t in range(w.shape[-1])]
    fc = b2.final_conv.weight.detach()[..., 0]  # (128, 384)
    chunks += [F.pad(part, (0, 8)) for part in fc.split(_C1, dim=1)]
    for b in (b1, b2):
        for part in (lambda s: s[0].bias, lambda s: s[1].weight, lambda s: s[1].bias):
            params += [part(s).detach() for s in b.convs]
        params.append(b.final_conv.bias.detach())
    wpack = torch.cat([c.reshape(-1) for c in chunks]).to(dtype)
    return wpack, torch.cat(params).float()


def _unpack(wpack: torch.Tensor, params: torch.Tensor):
    """The packed tensors as fp32 views: the chunks in stream order without
    their padding columns, and the parameters per block as (conv biases,
    scales, shifts, 1x1 bias)."""
    shapes = chunk_shapes()
    sizes = [r * c for r, c in shapes]
    if wpack.numel() != WEIGHT_ELEMENTS:
        raise ValueError(f"packed weights of {wpack.numel()} elements, the layout has {WEIGHT_ELEMENTS}")
    chunks = [c.reshape(s)[:, :-8].float() for c, s in zip(wpack.split(sizes), shapes)]
    per_block = []
    for c in CHANNELS:
        n = len(KERNEL_SIZES) * c
        b, g, s, f = params[:n], params[n:2 * n], params[2 * n:3 * n], params[3 * n:3 * n + c]
        per_block.append(tuple(t.float().reshape(-1, c) for t in (b, g, s)) + (f.float(),))
        params = params[3 * n + c:]
    return chunks, per_block


def _branch_act(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """GroupNorm (one group, two-pass fp32 statistics over a sequence's
    (steps, channels)) as h * scale + shift, then exact GELU, at the even
    steps only, rounded to ``dt``; h: (S, steps, channels) fp32."""
    mean = h.mean(dim=(1, 2), keepdim=True)
    var = (h - mean).square().mean(dim=(1, 2), keepdim=True)
    scale = torch.rsqrt(var + EPS) * gamma
    shift = beta - mean * scale
    return F.gelu(h[:, ::2] * scale + shift).to(dt).float()


def temporal_conv_mirror(x: torch.Tensor, wpack: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x (..., 48, C_in) ->
    (prod(...), 12, 128) in the packed weights' dtype. Products of values in
    that dtype accumulate in fp32 with the bias; the activations, block 1's
    output and the result are rounded to the dtype. Each branch runs over its
    own taps, its input read as the kernel reads it (the Toeplitz rows of
    24 padded channels, the depth's zero columns included)."""
    dt = wpack.dtype
    chunks, ((cb1, g1, s1, f1), (cb2, g2, s2, f2)) = _unpack(wpack, params)
    branches = len(KERNEL_SIZES)
    length, cin = x.shape[-2:]
    xs = x.reshape(-1, length, cin).float().to(dt).float()
    cp = MAX_IN_CHANNELS
    # 3 zero rows before, the rows the widest depth runs past after
    xs = F.pad(xs, (0, cp - cin, 3, 4)).reshape(xs.shape[0], -1)
    acts = []
    for j, k in enumerate(KERNEL_SIZES):
        start = 3 - (k - 1) // 2  # the window of step p starts at row p + start
        windows = xs.unfold(1, _k1(k), cp)[:, start:start + length]  # (S, L, k1)
        acts.append(_branch_act(windows @ chunks[j].T + cb1[j], g1[j], s1[j], dt))
    y1 = (torch.cat(acts, dim=-1) @ chunks[branches].T + f1).to(dt).float()  # (S, 24, 64)
    yp, half = F.pad(y1, (0, 0, 3, 3)), y1.shape[1]
    acts, c = [], branches + 1
    for j, k in enumerate(KERNEL_SIZES):
        start = 3 - (k - 1) // 2
        h = cb2[j] + sum(yp[:, start + t:start + t + half] @ chunks[c + t].T for t in range(k))
        acts.append(_branch_act(h, g2[j], s2[j], dt))
        c += k
    return (torch.cat(acts, dim=-1) @ torch.cat(chunks[c:], dim=1).T + f2).to(dt)


def _launch(x: torch.Tensor, wpack: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Check the tensors and launch the kernel; raises on what it does not
    take and when the library does not build or the launch fails."""
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be (S, L, C) or (B, N, L, C), got {tuple(x.shape)}")
    length, cin = x.shape[-2:]
    if x.dtype != torch.bfloat16 or wpack.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x and weights, got {x.dtype} and {wpack.dtype}")
    if length != LENGTH or not 1 <= cin <= MAX_IN_CHANNELS:
        raise ValueError(f"the kernel takes {LENGTH} steps of 1 to {MAX_IN_CHANNELS} channels, got {length} x {cin}")
    if params.dtype != torch.float32:
        raise TypeError(f"params must be fp32, got {params.dtype}")
    if wpack.numel() != WEIGHT_ELEMENTS or params.numel() != PARAMS:
        raise ValueError(
            f"the packed weights and parameters hold {WEIGHT_ELEMENTS} and {PARAMS} elements (pack_blocks), "
            f"got {wpack.numel()} and {params.numel()}"
        )
    for name, t in (("wpack", wpack), ("params", params)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    b, n = x4.shape[:2]
    out = torch.empty(b * n, OUT_LENGTH, _C2, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.function("temporal_conv_forward", ARGTYPES)
    _build.check(NAME, fn(
        x4.data_ptr(), b * n, n, x4.stride(0), x4.stride(1), x4.stride(2), cin,
        wpack.data_ptr(), wpack.numel() * wpack.element_size(), params.data_ptr(), out.data_ptr(),
        _build.stream_handle(x.device),
    ))
    _build.count_launch(NAME)
    return out


def _op_impl(x, wpack, params):
    """``tec_mollm::temporal_conv``: the mirror on the CPU, the kernel on any
    other device."""
    if x.device.type == "cpu":
        return temporal_conv_mirror(x, wpack, params)
    return _launch(x, wpack, params)


temporal_conv_op = torch.library.custom_op(
    f"{_build.NAMESPACE}::temporal_conv", _op_impl, mutates_args=(),
    schema="(Tensor x, Tensor wpack, Tensor params) -> Tensor",
)
# the shape function, for tracing (a meta tensor goes to _op_impl: _build.op_for)
temporal_conv_op.register_fake(
    lambda x, wpack, params: x.new_empty(math.prod(x.shape[:-2]), OUT_LENGTH, _C2, dtype=wpack.dtype)
)


def temporal_conv(x: torch.Tensor, wpack: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The conv embedder's two blocks: x (..., 48, C_in) -> (prod(...), 12, 128),
    through ``tec_mollm::temporal_conv``, on weights packed by ``pack_blocks``.
    A CPU tensor takes the mirror; a CUDA tensor launches the kernel or
    raises. It has no backward: a call that would need one raises."""
    _build.refuse_grad(
        "temporal_conv", "call it under torch.no_grad() (the model trains through the plain blocks)",
        x, wpack, params,
    )
    return _build.op_for(temporal_conv_op, _op_impl, x)(x, wpack, params)
