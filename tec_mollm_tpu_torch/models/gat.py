"""GATv2 on the regular-grid graph through node shifts (stencil form), + residual.

Semantics of torch_geometric's GATv2Conv(heads=2, concat=True, self loops,
negative_slope=0.2) as the reference's SpatialEncoder uses it: for each edge
j -> i, e_ij = att_h . leaky_relu(lin_l(x_j) + lin_r(x_i)); alpha = softmax_j;
out_i = sum_j alpha_ij lin_l(x_j), heads concatenated, + bias.

On the 41x71 grid the 150 km neighbourhood is a fixed set of node shifts with a
per-offset validity mask (``graph.build_grid_stencil``), so the neighbour gather
is a shift of the node axis. After the two projections the features move to
(M, H*C, N), the layout of the stencil kernel (``ops/gat_stencil.py``), which
the eval path launches on the card (``TECMoLLM.gat_kernel``, the JAX model's
``gat_pallas``). Training (attention dropout) takes the plain path below.

Graphs without a stencil (irregular node sets) take ``GATv2``: the neighbours
come from a padded (N, D) table with a mask, gathered by ``index_select``, and
the softmax runs over D. Both classes hold the same parameters (``lin_l``,
``lin_r``, ``att``, ``bias``), so one state_dict loads into either mode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.ops.gat_stencil import gat_stencil_attention


def _glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(t, -bound, bound, generator=g)


class _GATv2Params(nn.Module):
    """The parameters both GATv2 modes share, under the reference's names."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        heads: int = 2,
        negative_slope: float = 0.2,
        dropout: float = 0.1,
    ):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope, self.dropout = negative_slope, dropout
        hc = heads * out_channels
        self.lin_l = nn.Linear(in_channels, hc)
        self.lin_r = nn.Linear(in_channels, hc)
        self.att = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(hc))

    def reset_parameters(self, g: torch.Generator) -> None:
        hc, cin = self.lin_l.weight.shape
        for lin in (self.lin_l, self.lin_r):
            _glorot_uniform_(lin.weight, cin, hc, g)
            nn.init.zeros_(lin.bias)
        _glorot_uniform_(self.att, 1, hc, g)  # flax's (1, H*C) fans
        nn.init.zeros_(self.bias)


class GATv2(_GATv2Params):
    """Padded-gather GATv2: (..., N, F) -> (..., N, H*C), neighbours from an
    (N, D) table that includes the self loop, ``mask`` marking the real ones."""

    def forward(
        self,
        x: torch.Tensor,          # (..., N, F)
        neighbors: torch.Tensor,  # (N, D) int
        mask: torch.Tensor,       # (N, D) bool
    ) -> torch.Tensor:
        h, c = self.heads, self.out_channels
        dt = x.dtype
        n, d = neighbors.shape
        node_axis = x.dim() - 2
        xl = F.linear(x, self.lin_l.weight.to(dt), self.lin_l.bias.to(dt))
        xr = F.linear(x, self.lin_r.weight.to(dt), self.lin_r.bias.to(dt))
        xl = xl.reshape(*x.shape[:-1], h, c)
        xr = xr.reshape(*x.shape[:-1], h, c)
        xl_nbr = xl.index_select(node_axis, neighbors.reshape(-1).long())
        xl_nbr = xl_nbr.reshape(*x.shape[:-2], n, d, h, c)            # (..., N, D, h, c)
        scores = F.leaky_relu(xl_nbr + xr.unsqueeze(-3), self.negative_slope)
        scores = torch.einsum("...dhc,hc->...dh", scores, self.att.reshape(h, c).to(dt))
        mask_b = mask[..., None]                                       # (N, D, 1)
        neg = torch.tensor(torch.finfo(torch.float32).min, dtype=scores.dtype, device=x.device)
        alpha = torch.softmax(torch.where(mask_b, scores, neg), dim=-2)  # over the D neighbours
        alpha = torch.where(mask_b, alpha, 0.0)
        alpha = F.dropout(alpha, self.dropout, self.training)
        out = torch.einsum("...dh,...dhc->...hc", alpha, xl_nbr)
        return out.reshape(*x.shape[:-1], h * c) + self.bias.to(dt)


class GATv2Stencil(_GATv2Params):
    """Stencil GATv2 on a regular grid: (..., N, F) -> (..., N, H*C), the
    neighbours at static node shifts with an (O, N) validity."""

    def _project(self, lin: nn.Linear, x3: torch.Tensor) -> torch.Tensor:
        """(M, N, F) -> (M, H*C, N): the node axis last, as the kernel reads it."""
        dt = x3.dtype
        return torch.matmul(lin.weight.to(dt), x3.transpose(1, 2)) + lin.bias.to(dt)[:, None]

    def forward(
        self,
        x: torch.Tensor,              # (..., N, F)
        shifts: tuple[int, ...],
        valid: torch.Tensor,          # (O, N) bool
        use_kernel: bool = False,
    ) -> torch.Tensor:
        lead, n = x.shape[:-2], x.shape[-2]
        h, c = self.heads, self.out_channels
        x3 = x.reshape(-1, n, x.shape[-1])
        xl = self._project(self.lin_l, x3)
        xr = self._project(self.lin_r, x3)
        att = self.att.reshape(h, c)
        if use_kernel and not self.training:
            out = gat_stencil_attention(xl, xr, valid, att, shifts, self.negative_slope)
        else:
            out = self._plain(xl, xr, valid, att, shifts)
        out = out.transpose(1, 2).reshape(*lead, n, h * c)
        return out + self.bias.to(x.dtype)

    def _plain(self, xl, xr, valid, att, shifts) -> torch.Tensor:
        """Two-pass stencil softmax in the compute dtype (the JAX model's XLA path)."""
        m, hc, n = xl.shape
        h, c = self.heads, self.out_channels
        dt = xl.dtype
        xl4 = xl.reshape(m, h, c, n)
        xr4 = xr.reshape(m, h, c, n)
        att4 = att.to(dt).reshape(1, h, c, 1)

        def shifted(o: int) -> torch.Tensor:
            # value at node n becomes xl[n + shift]; wrapped reads are invalid
            return torch.roll(xl4, -shifts[o], dims=-1)

        neg = torch.tensor(torch.finfo(torch.float32).min, dtype=dt, device=xl.device)
        masked = []
        for o in range(len(shifts)):
            e = F.leaky_relu(shifted(o) + xr4, self.negative_slope)
            masked.append(torch.where(valid[o], (e * att4).sum(dim=2), neg))  # (m, h, n)
        mx = masked[0]
        for s in masked[1:]:
            mx = torch.maximum(mx, s)
        weights = [torch.where(valid[o], torch.exp(s - mx), 0.0) for o, s in enumerate(masked)]
        # nodes with no valid offset (lanes added by pad_nodes_to) would divide
        # 0/0; the floor makes them 0 and keeps their gradient finite
        denom = torch.clamp_min(sum(weights), torch.finfo(dt).tiny)
        out = torch.zeros_like(xl4)
        for o in range(len(shifts)):
            alpha = F.dropout(weights[o] / denom, self.dropout, self.training)
            out = out + alpha[:, :, None, :] * shifted(o)
        return out.reshape(m, hc, n)


class SpatialEncoder(nn.Module):
    """x + GATv2(x); heads * out_channels equals the input width (22).

    Two modes with identical parameters, as the JAX SpatialEncoder's:
      * stencil (``stencil_shifts`` set): ``neighbors`` is the (O, N) validity
        and ``mask`` is None;
      * padded gather (``stencil_shifts=None``): ``neighbors`` is the (N, D)
        table and ``mask`` its (N, D) validity.
    """

    def __init__(self, cfg: ModelConfig, stencil_shifts: tuple[int, ...] | None = None):
        super().__init__()
        self.stencil_shifts = stencil_shifts
        cls = GATv2 if stencil_shifts is None else GATv2Stencil
        self.gat_conv = cls(
            cfg.spatial_in_channels, cfg.spatial_out_channels, cfg.spatial_heads,
            cfg.gat_negative_slope, cfg.gat_dropout,
        )

    def forward(self, x, neighbors, mask=None, use_kernel: bool = False) -> torch.Tensor:
        if self.stencil_shifts is None:
            return x + self.gat_conv(x, neighbors, mask)
        return x + self.gat_conv(x, self.stencil_shifts, neighbors, use_kernel)
