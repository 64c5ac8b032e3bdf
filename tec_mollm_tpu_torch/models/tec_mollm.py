"""TEC-MoLLM, the full model.

    x (B,L,N,6) --embed--> (B,L,N,22) --[pad N]--> GATv2 + residual
      --> (B*N, L, 22) --multi-scale conv--> (B*N, 12, 128) --patch--> (B*N, 3, 768)
      --> GPT-2 (3 LoRA blocks) --> dropout --> head --> (B, L_out, N, Q) fp32

Module names are the reference's state_dict names, so its checkpoints and the
JAX package's parameters (``models/convert.py``) load without renaming.
Parameters stay fp32; ``dtype`` is the compute dtype each layer casts to, as the
JAX model's ``dtype`` is. ``model.eval()`` is the JAX ``deterministic=True``.

The graph comes in one of two modes (``graph_inputs``): the stencil of a regular
grid (``stencil_shifts`` set; ``neighbors`` is the (O, N) validity) or the
padded neighbour table of any graph (``stencil_shifts=None``; ``neighbors`` and
``neighbor_mask`` are (N, D)). The parameters are the same in both.
"""

from __future__ import annotations

import torch
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.graph.builder import GraphData
from tec_mollm_tpu_torch.models.embeddings import SpatioTemporalEmbedding
from tec_mollm_tpu_torch.models.gat import SpatialEncoder
from tec_mollm_tpu_torch.models.gpt2 import LLMBackbone
from tec_mollm_tpu_torch.models.head import PredictionHead
from tec_mollm_tpu_torch.models.temporal import TemporalEncoder
from tec_mollm_tpu_torch.ops.gat_stencil import tiled_takes


def graph_inputs(
    graph: GraphData, device: torch.device | str, use_stencil: bool = True
) -> tuple[tuple[int, ...] | None, tuple[torch.Tensor, torch.Tensor | None]]:
    """(stencil shifts or None, (neighbors, neighbor_mask) on ``device``).

    The stencil mode on a graph that has one (then ``neighbors`` is the (O, N)
    bool validity and there is no mask), the padded-gather mode otherwise: the
    (N, D) int64 table and its (N, D) bool mask."""
    if use_stencil and graph.has_stencil:
        shifts = tuple(int(s) for s in graph.stencil_shifts)
        return shifts, (torch.as_tensor(graph.stencil_valid, dtype=torch.bool, device=device), None)
    neighbors = torch.as_tensor(graph.neighbors, dtype=torch.int64, device=device)
    return None, (neighbors, torch.as_tensor(graph.neighbor_mask, dtype=torch.bool, device=device))


def opt_in_kernel_refusal(
    cfg: ModelConfig, dtype: torch.dtype, fused_attn: bool, use_fused_mlp: bool
) -> str | None:
    """Why the opt-in kernels cannot run this model on the card, or None: the
    fused MLP takes bf16 and d_llm <= 1536 in multiples of 128
    (``ops/fused_mlp.py``), the short attention head dims 32 and 64
    (``ops/short_attention.py``). Callers that know the device is CUDA ask it
    before loading weights."""
    d, dh = cfg.d_llm, cfg.llm_mlp_ratio * cfg.d_llm
    if use_fused_mlp and (dtype != torch.bfloat16 or d > 1536 or d % 128 or dh % 128):
        return (
            f"use_fused_mlp needs bf16 compute and d_llm <= 1536 in multiples of 128 on the card, "
            f"got {dtype} and d_llm {d}"
        )
    head_dim = d // cfg.llm_heads
    if fused_attn and head_dim not in (32, 64):
        return f"fused_attn needs a head dim of 32 or 64 on the card, got {d}/{cfg.llm_heads} = {head_dim}"
    return None


def gat_route(cfg: ModelConfig, stencil_shifts: tuple[int, ...] | None, gat_kernel: bool = True) -> str:
    """The GAT route of a model, as the service and the trainer report it: the
    kernel on every eval call of a stencil model (its tiled form for the
    model's 2 x 11 layout and stencils, its general form for any other), the
    plain path in padded-gather mode, as in the JAX model."""
    if stencil_shifts is None:
        return "plain: padded-gather graph (no stencil)"
    if not gat_kernel:
        return "plain: gat_kernel=False"
    reason = tiled_takes(stencil_shifts, cfg.spatial_heads, cfg.spatial_out_channels)
    return "kernel" if reason is None else f"kernel, general form: {reason}"


class TECMoLLM(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig,
        stencil_shifts: tuple[int, ...] | None = None,
        dtype: torch.dtype = torch.float32,
        fused_attn: bool = False,
        use_fused_mlp: bool = False,
        use_flash: bool = False,
        # the JAX model's `gat_pallas`: the stencil kernel on eval calls
        gat_kernel: bool = True,
        # torch.utils.checkpoint around each GPT-2 block in training
        remat_llm: bool = False,
        pad_nodes_to: int = 128,
        # the initialisers' seed; None skips them, for a caller that loads
        # every tensor (the eval path: the draws take seconds at full width)
        seed: int | None = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.stencil_shifts = None if stencil_shifts is None else tuple(int(s) for s in stencil_shifts)
        self.dtype = dtype
        self.gat_kernel = self.stencil_shifts is not None and gat_kernel
        self.gat_route = gat_route(cfg, self.stencil_shifts, gat_kernel)
        self.pad_nodes_to = pad_nodes_to
        self.spatio_temporal_embedding = SpatioTemporalEmbedding(cfg)
        self.spatial_encoder = SpatialEncoder(cfg, self.stencil_shifts)
        self.temporal_encoder = TemporalEncoder(cfg)
        self.llm_backbone = LLMBackbone(
            cfg, fused_attn=fused_attn, use_fused_mlp=use_fused_mlp, use_flash=use_flash, remat=remat_llm
        )
        self.post_llm_dropout = nn.Dropout(cfg.post_llm_dropout)
        self.prediction_head = PredictionHead(cfg)
        if seed is not None:
            self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``g``."""
        self.spatio_temporal_embedding.reset_parameters(g)
        self.spatial_encoder.gat_conv.reset_parameters(g)
        for block in self.temporal_encoder.conv_embedder.embedder:
            block.reset_parameters(g)
        self.temporal_encoder.patcher.reset_parameters(g)
        self.llm_backbone.model.reset_parameters(g)
        self.prediction_head.reset_parameters(g)

    def forward(
        self,
        x: torch.Tensor,              # (B, L, N, C_in) float
        time_features: torch.Tensor,  # (B, L, 4) int
        neighbors: torch.Tensor,      # (O, N) bool stencil validity, or the (N, D) table
        neighbor_mask: torch.Tensor | None = None,  # (N, D) bool; None in stencil mode
    ) -> torch.Tensor:
        cfg = self.cfg
        b, l, n, _ = x.shape

        # RevIN (opt-in): the TEC channel normalised per (window, node)
        if cfg.revin:
            x0 = x[..., 0]
            mu = x0.mean(dim=1, keepdim=True)                                   # (B,1,N)
            sd = torch.sqrt(x0.var(dim=1, unbiased=False, keepdim=True) + 1e-5)
            x = torch.cat([((x0 - mu) / sd)[..., None], x[..., 1:]], dim=-1)

        h = self.spatio_temporal_embedding(x.to(self.dtype), time_features)

        stencil = self.stencil_shifts is not None
        if stencil and neighbors.dtype != torch.bool:
            raise ValueError(
                "this model runs the stencil GAT: pass the graph's (O, N) stencil validity; "
                "a graph without a stencil needs TECMoLLM(stencil_shifts=None)"
            )
        if not stencil and neighbor_mask is None:
            raise ValueError("the padded-gather GAT needs the (N, D) neighbor_mask")

        # pad the node axis: zero features, no valid neighbour; sliced off below
        n_orig = n
        if self.pad_nodes_to and n >= self.pad_nodes_to:
            n_pad = (-n) % self.pad_nodes_to
            if n_pad:
                h = nn.functional.pad(h, (0, 0, 0, n_pad))
                if stencil:
                    neighbors = nn.functional.pad(neighbors, (0, n_pad))
                else:
                    neighbors = nn.functional.pad(neighbors, (0, 0, 0, n_pad))
                    neighbor_mask = nn.functional.pad(neighbor_mask, (0, 0, 0, n_pad))
                n += n_pad

        h = self.spatial_encoder(h, neighbors, neighbor_mask, use_kernel=self.gat_kernel)

        c = h.shape[-1]
        h = h.transpose(1, 2).reshape(b * n, l, c)             # (B*N, L, C)
        h = self.temporal_encoder(h)                           # (B*N, P, d_llm)
        h = self.post_llm_dropout(self.llm_backbone(h))
        preds = self.prediction_head(h)                        # (B*N, L_out*Q)

        preds = preds.reshape(b, n, cfg.prediction_horizon, cfg.num_outputs)
        preds = preds.transpose(1, 2).float()
        if n != n_orig:
            preds = preds[:, :, :n_orig]
        if cfg.quantiles:
            preds = preds.sort(dim=-1).values  # non-crossing levels
        if cfg.revin:
            preds = preds * sd[..., None].float() + mu[..., None].float()
        return preds
