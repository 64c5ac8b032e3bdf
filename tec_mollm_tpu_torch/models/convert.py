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


def params_to_state_dict(
    flat: Mapping[str, np.ndarray], cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    def get(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"{path} missing from the parameter tree")
        return np.asarray(flat[path], dtype=np.float32)

    sd: dict[str, np.ndarray] = {}

    def linear(dst: str, src: str) -> None:
        sd[f"{dst}.weight"] = get(f"{src}/kernel").T
        sd[f"{dst}.bias"] = get(f"{src}/bias")

    def conv1d(dst: str, src: str) -> None:
        sd[f"{dst}.weight"] = get(f"{src}/kernel").transpose(2, 1, 0)
        sd[f"{dst}.bias"] = get(f"{src}/bias")

    def conv1d_hf(dst: str, src: str) -> None:  # GPT-2 Conv1D: (in, out) kept
        sd[f"{dst}.weight"] = get(f"{src}/kernel")
        sd[f"{dst}.bias"] = get(f"{src}/bias")

    def layernorm(dst: str, src: str) -> None:
        sd[f"{dst}.weight"] = get(f"{src}/scale")
        sd[f"{dst}.bias"] = get(f"{src}/bias")

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

    llm = "llm_backbone.model"
    sd[f"{llm}.wpe.weight"] = get("llm/wpe")
    for i in range(cfg.llm_layers):
        dst, src = f"{llm}.h.{i}", f"llm/h_{i}"
        layernorm(f"{dst}.ln_1", f"{src}/ln_1")
        conv1d_hf(f"{dst}.attn.c_attn", f"{src}/attn/c_attn")
        sd[f"{dst}.attn.c_attn.lora_A.weight"] = get(f"{src}/attn/c_attn/lora_A").T
        sd[f"{dst}.attn.c_attn.lora_B.weight"] = get(f"{src}/attn/c_attn/lora_B").T
        conv1d_hf(f"{dst}.attn.c_proj", f"{src}/attn/c_proj")
        layernorm(f"{dst}.ln_2", f"{src}/ln_2")
        conv1d_hf(f"{dst}.mlp.c_fc", f"{src}/mlp/c_fc")
        conv1d_hf(f"{dst}.mlp.c_proj", f"{src}/mlp/c_proj")
    layernorm(f"{llm}.ln_f", "llm/ln_f")

    linear("prediction_head.mlp.0", "head/fc1")
    linear("prediction_head.mlp.3", "head/fc2")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
