"""Temporal encoder: multi-scale strided 1-D convolutions + latent patching.

* ``MultiScaleConvBlock``: three parallel Conv1d with k in {3, 5, 7} and padding
  (k-1)//2, each followed by GroupNorm(1 group, eps 1e-5, fp32 statistics) and
  exact GELU; the branches are concatenated on channels and a 1x1 Conv1d with
  the block's stride reads every stride-th position. Default 22 -> 64 (stride
  2) -> 128 (stride 2), so L 48 -> 24 -> 12.
* ``LatentPatchingProjection``: 'b (p l) d -> b p (l d)' then Linear to d_llm.

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


def lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (2 std) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


class MultiScaleConvBlock(nn.Module):
    def __init__(
        self, in_channels: int, out_channels: int, stride: int,
        kernel_sizes: Sequence[int] = (3, 5, 7),
    ):
        super().__init__()
        self.stride = stride
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
        """x: (B, C_in, L) channels-first -> (B, C_out, L // stride)."""
        dt = x.dtype
        branches = []
        for conv, norm, _ in self.convs:
            h = F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt), padding=conv.padding)
            h = F.group_norm(h.float(), 1, norm.weight.float(), norm.bias.float(), norm.eps)
            branches.append(F.gelu(h.to(dt)))
        fc = self.final_conv
        return F.conv1d(torch.cat(branches, dim=1), fc.weight.to(dt), fc.bias.to(dt), stride=self.stride)


class _ConvEmbedder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        chans = (cfg.spatial_channels,) + tuple(cfg.temporal_channel_list)
        self.embedder = nn.ModuleList(
            MultiScaleConvBlock(cin, cout, s, cfg.conv_kernel_sizes)
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
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.conv_embedder = _ConvEmbedder(cfg)
        self.patcher = LatentPatchingProjection(
            cfg.effective_patch_len, cfg.temporal_channel_list[-1], cfg.d_llm
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L_in, C) -> (B, num_patches, d_llm)."""
        h = self.conv_embedder(x.transpose(1, 2))
        return self.patcher(h.transpose(1, 2))
