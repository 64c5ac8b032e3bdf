"""Temporal encoder: multi-scale strided 1-D convolutions + latent patching.

* ``MultiScaleConvBlock``: three parallel Conv1d with k in {3, 5, 7} and padding
  (k-1)//2, each followed by GroupNorm(1 group, eps 1e-5, fp32 statistics) and
  exact GELU; the branches are concatenated on channels and a 1x1 Conv1d with
  the block's stride reads every stride-th position. Default 22 -> 64 (stride
  2) -> 128 (stride 2), so L 48 -> 24 -> 12.
* ``LatentPatchingProjection``: 'b (p l) d -> b p (l d)' then Linear to d_llm.

The conv block has the JAX block's three other execution paths (the ablation
arms), each on the same parameters as the unfused block, so every arm loads
the same state_dict:

* ``fuse_branches``: the branch kernels zero-padded to the largest tap count
  and concatenated on output channels, one conv for the three branches;
* ``im2col``: one unfold of the input into (L, kmax * C_in) windows and one
  GEMM with that stacked kernel;
* ``lean_gn``: the GroupNorm statistics over the full length (single pass in
  fp32), then normalize, affine (in the compute dtype) and GELU only at the
  positions the strided 1x1 conv reads, and the three-branch concat replaced
  by summed per-branch matrix products. It takes precedence over the others,
  and ``im2col`` over ``fuse_branches``, as in the JAX block.

On eval calls on the card, ``TemporalEncoder`` runs the default block pair
as one CUDA kernel (``ops/temporal_conv.py``: no intermediate in device
memory, fp32 two-pass GroupNorm statistics, exact GELU) wherever
``TemporalEncoder.kernel_refusal`` finds nothing against it; training, the
arms and the shapes the kernel does not take run the blocks below.

Module names follow the reference's state_dict
(``conv_embedder.embedder.{b}.convs.{j}.{0,1}``, ``final_conv``,
``patcher.projection``). The public layout is the JAX package's (B, L, C).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.ops.temporal_conv import pack_blocks, temporal_conv, temporal_takes
from tec_mollm_tpu_torch.utils.profiler import count

# the devices whose tensors take the kernel on eval calls (its op runs the
# plain mirror on a CPU tensor, which a test reaches by adding "cpu")
KERNEL_DEVICES = ("cuda",)


def lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (2 std) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


class MultiScaleConvBlock(nn.Module):
    def __init__(
        self, in_channels: int, out_channels: int, stride: int,
        kernel_sizes: Sequence[int] = (3, 5, 7),
        fuse_branches: bool = False,
        lean_gn: bool = False,
        im2col: bool = False,
    ):
        super().__init__()
        self.stride = stride
        self.fuse_branches, self.lean_gn, self.im2col = fuse_branches, lean_gn, im2col
        self.convs = nn.ModuleList(
            nn.Sequential(
                nn.Conv1d(in_channels, out_channels, k, padding=(k - 1) // 2),
                nn.GroupNorm(1, out_channels, eps=1e-5),
                nn.GELU(),
            )
            for k in kernel_sizes
        )
        self.final_conv = nn.Conv1d(out_channels * len(kernel_sizes), out_channels, 1, stride=stride)

    def reset_parameters(self, g: torch.Generator) -> None:
        for conv in [seq[0] for seq in self.convs] + [self.final_conv]:
            cout, cin, k = conv.weight.shape
            lecun_normal_(conv.weight, cin * k, g)
            nn.init.zeros_(conv.bias)
        for seq in self.convs:
            nn.init.ones_(seq[1].weight)
            nn.init.zeros_(seq[1].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C_in, L) channels-first -> (B, C_out, ceil(L / stride))."""
        if self.lean_gn:
            return self._lean(x)
        dt = x.dtype
        if self.im2col:
            h = self._im2col_convs(x)
        elif self.fuse_branches:
            w, b = self._stacked_kernel(dt)
            h = F.conv1d(x, w, b, padding=w.shape[-1] // 2)
        else:
            h = torch.cat([F.conv1d(x, c.weight.to(dt), c.bias.to(dt), padding=c.padding)
                           for c, _, _ in self.convs], dim=1)
        branches = []
        for part, (_, norm, _) in zip(h.chunk(len(self.convs), dim=1), self.convs):
            part = F.group_norm(part.float(), 1, norm.weight.float(), norm.bias.float(), norm.eps)
            branches.append(F.gelu(part.to(dt)))
        fc = self.final_conv
        return F.conv1d(torch.cat(branches, dim=1), fc.weight.to(dt), fc.bias.to(dt), stride=self.stride)

    def _stacked_kernel(self, dt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(3 * C_out, C_in, kmax), (3 * C_out,): the branch kernels padded
        symmetrically with zero taps to kmax (a k-tap SAME conv is a kmax-tap
        one with zeros outside its taps), concatenated on output channels."""
        kmax = max(c.kernel_size[0] for c, _, _ in self.convs)
        pad = [(kmax - c.kernel_size[0]) // 2 for c, _, _ in self.convs]
        w = torch.cat([F.pad(c.weight, (p, p)) for (c, _, _), p in zip(self.convs, pad)])
        return w.to(dt), torch.cat([c.bias for c, _, _ in self.convs]).to(dt)

    def _im2col_convs(self, x: torch.Tensor) -> torch.Tensor:
        """The three branch convs as one unfold of x (B, C_in, L) into
        (B, L, kmax * C_in) windows and one GEMM with the stacked kernel as a
        (kmax * C_in, 3 * C_out) matrix; (B, 3 * C_out, L)."""
        w, b = self._stacked_kernel(x.dtype)
        kmax = w.shape[-1]
        windows = F.pad(x, (kmax // 2, kmax // 2)).unfold(2, kmax, 1)    # (B, C_in, L, kmax)
        windows = windows.permute(0, 2, 3, 1).flatten(2)                 # (B, L, kmax * C_in), tap-major
        big = w.permute(2, 1, 0).reshape(-1, w.shape[0])                 # (kmax * C_in, 3 * C_out)
        return (windows @ big + b).transpose(1, 2)

    def _lean(self, x: torch.Tensor) -> torch.Tensor:
        """GroupNorm statistics over the full length, in fp32 from
        E[h^2] - mu^2; normalize, affine and GELU only at every stride-th
        position; per-branch partial products with the final kernel summed."""
        dt = x.dtype
        fc = self.final_conv
        c = fc.out_channels
        out = None
        for i, (conv, norm, _) in enumerate(self.convs):
            h = F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt), padding=conv.padding)
            hf = h.float()
            mean = hf.mean(dim=(1, 2), keepdim=True)
            var = hf.square().mean(dim=(1, 2), keepdim=True) - mean.square()
            act = ((h[:, :, :: self.stride].float() - mean) * torch.rsqrt(var + norm.eps)).to(dt)
            act = F.gelu(act * norm.weight.to(dt)[:, None] + norm.bias.to(dt)[:, None])
            part = fc.weight[:, i * c : (i + 1) * c, 0].to(dt) @ act       # (B, C_out, ceil(L / stride))
            out = part if out is None else out + part
        return out + fc.bias.to(dt)[:, None]


class _ConvEmbedder(nn.Module):
    def __init__(self, cfg: ModelConfig, **arms):
        super().__init__()
        chans = (cfg.spatial_channels,) + tuple(cfg.temporal_channel_list)
        self.embedder = nn.ModuleList(
            MultiScaleConvBlock(cin, cout, s, cfg.conv_kernel_sizes, **arms)
            for cin, cout, s in zip(chans[:-1], chans[1:], cfg.temporal_strides)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.embedder:
            x = block(x)
        return x


class LatentPatchingProjection(nn.Module):
    def __init__(self, patch_len: int, latent: int, d_llm: int):
        super().__init__()
        self.patch_len = patch_len
        self.projection = nn.Linear(patch_len * latent, d_llm)

    def reset_parameters(self, g: torch.Generator) -> None:
        lecun_normal_(self.projection.weight, self.projection.in_features, g)
        nn.init.zeros_(self.projection.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D) -> (B, L // patch_len, d_llm), patch-position-major."""
        b, length, d = x.shape
        x = x.reshape(b, length // self.patch_len, self.patch_len * d)
        w = self.projection
        return F.linear(x, w.weight.to(x.dtype), w.bias.to(x.dtype))


class TemporalEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, fuse_branches: bool = False, lean_gn: bool = False, im2col: bool = False):
        super().__init__()
        self.conv_embedder = _ConvEmbedder(cfg, fuse_branches=fuse_branches, lean_gn=lean_gn, im2col=im2col)
        self.patcher = LatentPatchingProjection(
            cfg.effective_patch_len, cfg.temporal_channel_list[-1], cfg.d_llm
        )
        self.arm = next((a for a, on in (("fuse_branches", fuse_branches), ("lean_gn", lean_gn),
                                         ("im2col", im2col)) if on), None)
        self.widths = (tuple(cfg.temporal_channel_list), tuple(cfg.conv_kernel_sizes), tuple(cfg.temporal_strides))
        self._packed = None  # (key, packed weights, fp32 parameters) of the kernel

    def kernel_refusal(self, x: torch.Tensor) -> str | None:
        """None when this call runs the kernel, else why the plain blocks run
        it: the kernel takes eval calls on the card that need no gradient,
        on the default (unfused) blocks, at the widths, length and dtype that
        ``temporal_takes`` accepts."""
        if x.device.type not in KERNEL_DEVICES:
            return f"a {x.device.type} tensor: the kernel runs on the card"
        if self.training:
            return "train mode: the training forward and its backward stay with autograd"
        if self.arm is not None:
            return f"the {self.arm} arm runs its own path"
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in self.conv_embedder.parameters())):
            return "an input requires grad under grad mode: the kernel has no backward"
        return temporal_takes(x.shape[-1], *self.widths, x.shape[-2], x.dtype)

    def _packed_weights(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The kernel's packed weights, packed again only when a parameter
        changed (its version or storage) or under tracing, which packs in the
        traced graph."""
        blocks = self.conv_embedder.embedder
        tensors = list(blocks.parameters())
        if torch.compiler.is_compiling() or any(type(t) not in (torch.Tensor, nn.Parameter) for t in tensors):
            return pack_blocks(blocks, dtype)
        key = (dtype, tuple((t.data_ptr(), t._version) for t in tensors))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, *pack_blocks(blocks, dtype))
        return self._packed[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L_in, C), e.g. (B, L_in, C) or the (B, N, L_in, C) view of
        the spatial encoder's output -> (prod(...), num_patches, d_llm)."""
        if self.kernel_refusal(x) is None:
            count("temporal.kernel")
            h = temporal_conv(x, *self._packed_weights(x.dtype))
        else:
            length, c = x.shape[-2:]
            h = self.conv_embedder(x.reshape(-1, length, c).transpose(1, 2)).transpose(1, 2)
        return self.patcher(h)
