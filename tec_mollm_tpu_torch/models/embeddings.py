"""Spatio-temporal embedding: five tables of width d_emb.

node(num_nodes), tod(12), doy(366), year(num_years), season(4);
temporal = tod + doy + year + season per (batch, step); combined = node +
temporal broadcast over nodes; output = concat([x, combined], -1).
Tables start N(0, 1) except year, which starts at zero so that a year never
seen in training reads "no year information".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig

TABLES = ("node", "tod", "doy", "year", "season")


class SpatioTemporalEmbedding(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        vocab = {
            "node": cfg.num_nodes, "tod": cfg.num_tod, "doy": cfg.num_doy,
            "year": cfg.num_years, "season": cfg.num_seasons,
        }
        for name in TABLES:
            setattr(self, f"{name}_embedding", nn.Embedding(vocab[name], cfg.d_emb))

    def reset_parameters(self, g: torch.Generator) -> None:
        for name in TABLES:
            w = getattr(self, f"{name}_embedding").weight
            if name == "year":
                nn.init.zeros_(w)
            else:
                nn.init.normal_(w, 0.0, 1.0, generator=g)

    def forward(self, x: torch.Tensor, time_features: torch.Tensor) -> torch.Tensor:
        """x: (B, L, N, C_in) in the compute dtype; time_features: (B, L, 4) int
        -> (B, L, N, C_in + d_emb)."""
        dt = x.dtype
        tf = time_features.long()

        def lookup(name: str, idx: torch.Tensor) -> torch.Tensor:
            return F.embedding(idx, getattr(self, f"{name}_embedding").weight.to(dt))

        node = self.node_embedding.weight.to(dt)  # (N, d)
        temporal = (
            lookup("tod", tf[..., 0]) + lookup("doy", tf[..., 1])
            + lookup("year", tf[..., 2]) + lookup("season", tf[..., 3])
        )  # (B, L, d)
        combined = node[None, None] + temporal[:, :, None]
        return torch.cat([x, combined], dim=-1)
