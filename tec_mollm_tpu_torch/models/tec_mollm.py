"""TEC-MoLLM, the full model.

    x (B,L,N,6) --embed--> (B,L,N,22) --[pad N]--> GATv2 stencil + residual
      --> (B*N, L, 22) --multi-scale conv--> (B*N, 12, 128) --patch--> (B*N, 3, 768)
      --> GPT-2 (3 LoRA blocks) --> dropout --> head --> (B, L_out, N, Q) fp32

Module names are the reference's state_dict names, so its checkpoints and the
JAX package's parameters (``models/convert.py``) load without renaming.
Parameters stay fp32; ``dtype`` is the compute dtype each layer casts to, as the
JAX model's ``dtype`` is. ``model.eval()`` is the JAX ``deterministic=True``.
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


def graph_inputs(graph: GraphData, device: torch.device | str) -> tuple[tuple[int, ...], torch.Tensor]:
    """(stencil shifts, (O, N) bool validity on ``device``) for the stencil GAT."""
    if not graph.has_stencil:
        raise NotImplementedError(
            "the port runs the stencil GAT only; this graph has no stencil "
            "(the padded-gather GATv2 for irregular graphs is not ported yet)"
        )
    shifts = tuple(int(s) for s in graph.stencil_shifts)
    return shifts, torch.as_tensor(graph.stencil_valid, dtype=torch.bool, device=device)


class TECMoLLM(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig,
        stencil_shifts: tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        fused_attn: bool = False,
        use_fused_mlp: bool = False,
        use_flash: bool = False,
        # the JAX model's `gat_pallas`: the stencil kernel on eval calls
        gat_kernel: bool = True,
        pad_nodes_to: int = 128,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.stencil_shifts = tuple(int(s) for s in stencil_shifts)
        self.dtype = dtype
        self.gat_kernel = gat_kernel
        self.pad_nodes_to = pad_nodes_to
        self.spatio_temporal_embedding = SpatioTemporalEmbedding(cfg)
        self.spatial_encoder = SpatialEncoder(cfg)
        self.temporal_encoder = TemporalEncoder(cfg)
        self.llm_backbone = LLMBackbone(
            cfg, fused_attn=fused_attn, use_fused_mlp=use_fused_mlp, use_flash=use_flash
        )
        self.post_llm_dropout = nn.Dropout(cfg.post_llm_dropout)
        self.prediction_head = PredictionHead(cfg)
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
        valid: torch.Tensor,          # (O, N) bool stencil validity
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

        # pad the node axis: zero features, no valid offsets; sliced off below
        n_orig = n
        if self.pad_nodes_to and n >= self.pad_nodes_to:
            n_pad = (-n) % self.pad_nodes_to
            if n_pad:
                h = nn.functional.pad(h, (0, 0, 0, n_pad))
                valid = nn.functional.pad(valid, (0, n_pad))
                n += n_pad

        h = self.spatial_encoder(h, self.stencil_shifts, valid, use_kernel=self.gat_kernel)

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
