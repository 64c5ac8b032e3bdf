"""The JAX package's parameter tree -> the port's ``state_dict``.

The input is the Flax tree flattened to "/"-joined paths of numpy arrays (e.g.
``flax.traverse_util.flatten_dict(params, sep="/")``, done by the caller). The
output names are the reference's state_dict names, in torch layouts:

* Flax Dense kernels are (in, out); torch Linear weights are (out, in).
* Flax Conv kernels are (k, C_in, C_out); torch Conv1d weights are (C_out, C_in, k).
* GPT-2's Conv1D weights stay (in, out); peft's lora_A is (r, in), lora_B (out, r).
* The GAT ``att`` is (1, H*C) in Flax and (1, H, C) in the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models.embeddings import TABLES


class _Converter:
    """Reads "/"-joined Flax paths and collects torch names -> fp32 arrays."""

    def __init__(self, flat: Mapping[str, np.ndarray]):
        self.flat = flat
        self.sd: dict[str, np.ndarray] = {}

    def get(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"{path} missing from the parameter tree")
        return np.asarray(self.flat[path], dtype=np.float32)

    def pair(self, dst: str, weight: np.ndarray, bias: np.ndarray) -> None:
        self.sd[f"{dst}.weight"] = weight
        self.sd[f"{dst}.bias"] = bias

    def linear(self, dst: str, src: str) -> None:
        self.pair(dst, self.get(f"{src}/kernel").T, self.get(f"{src}/bias"))

    def conv1d(self, dst: str, src: str) -> None:
        self.pair(dst, self.get(f"{src}/kernel").transpose(2, 1, 0), self.get(f"{src}/bias"))

    def conv1d_hf(self, dst: str, src: str) -> None:  # GPT-2 Conv1D: (in, out) kept
        self.pair(dst, self.get(f"{src}/kernel"), self.get(f"{src}/bias"))

    def layernorm(self, dst: str, src: str) -> None:
        self.pair(dst, self.get(f"{src}/scale"), self.get(f"{src}/bias"))

    def gpt2(self, dst: str, src: str, cfg: ModelConfig) -> None:
        """The GPT-2 backbone; LoRA tensors where ``cfg.lora_r > 0``."""
        self.sd[f"{dst}.wpe.weight"] = self.get(f"{src}/wpe")
        for i in range(cfg.llm_layers):
            d, s = f"{dst}.h.{i}", f"{src}/h_{i}"
            self.layernorm(f"{d}.ln_1", f"{s}/ln_1")
            self.conv1d_hf(f"{d}.attn.c_attn", f"{s}/attn/c_attn")
            if cfg.lora_r > 0:
                self.sd[f"{d}.attn.c_attn.lora_A.weight"] = self.get(f"{s}/attn/c_attn/lora_A").T
                self.sd[f"{d}.attn.c_attn.lora_B.weight"] = self.get(f"{s}/attn/c_attn/lora_B").T
            self.conv1d_hf(f"{d}.attn.c_proj", f"{s}/attn/c_proj")
            self.layernorm(f"{d}.ln_2", f"{s}/ln_2")
            self.conv1d_hf(f"{d}.mlp.c_fc", f"{s}/mlp/c_fc")
            self.conv1d_hf(f"{d}.mlp.c_proj", f"{s}/mlp/c_proj")
        self.layernorm(f"{dst}.ln_f", f"{src}/ln_f")

    def tensors(self) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in self.sd.items()}


def params_to_state_dict(
    flat: Mapping[str, np.ndarray], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """The forecast model's tree -> ``TECMoLLM.state_dict()``."""
    c = _Converter(flat)
    sd, get, linear, conv1d, layernorm = c.sd, c.get, c.linear, c.conv1d, c.layernorm

    for name in TABLES:
        sd[f"spatio_temporal_embedding.{name}_embedding.weight"] = get(f"embedding/{name}/embedding")

    gat = "spatial_encoder.gat_conv"
    linear(f"{gat}.lin_l", "spatial/gat/lin_l")
    linear(f"{gat}.lin_r", "spatial/gat/lin_r")
    sd[f"{gat}.att"] = get("spatial/gat/att").reshape(1, cfg.spatial_heads, cfg.spatial_out_channels)
    sd[f"{gat}.bias"] = get("spatial/gat/bias")

    for b in range(len(cfg.temporal_channel_list)):
        dst, src = f"temporal_encoder.conv_embedder.embedder.{b}", f"temporal/block_{b}"
        for j, k in enumerate(cfg.conv_kernel_sizes):
            conv1d(f"{dst}.convs.{j}.0", f"{src}/conv_k{k}")
            layernorm(f"{dst}.convs.{j}.1", f"{src}/norm_k{k}")
        conv1d(f"{dst}.final_conv", f"{src}/final_conv")
    linear("temporal_encoder.patcher.projection", "temporal/patcher/projection")

    c.gpt2("llm_backbone.model", "llm", cfg)

    linear("prediction_head.mlp.0", "head/fc1")
    linear("prediction_head.mlp.3", "head/fc2")
    return c.tensors()


def byte_lm_params_to_state_dict(
    flat: Mapping[str, np.ndarray], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """The byte LM's tree (``wte``, ``backbone/...``; no LoRA at ``lora_r = 0``)
    -> ``ByteLM.state_dict()``."""
    c = _Converter(flat)
    c.sd["wte"] = c.get("wte")
    c.gpt2("backbone", "backbone", cfg)
    return c.tensors()
