"""Export the port's GPT-2 backbone as an HF GPT-2 checkpoint.

The counterpart of ``tec_mollm_tpu/models/hf_export.py`` and the inverse of
``models/hf_import.py``: a byte LM pretrained here is saved the way a real
``AutoModel.from_pretrained('gpt2')`` checkpoint arrives, as fp32 tensors under
HF's GPT2Model keys in ``pytorch_model.bin`` with a descriptive ``config.json``.
The backbone's parameter names are already HF's, and GPT-2's Conv1D layout
(in, out) is ``LoRADense.weight``'s, so nothing is renamed or transposed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch
from torch import nn

_BLOCK_PARTS = ("ln_1", "attn.c_attn", "attn.c_proj", "ln_2", "mlp.c_fc", "mlp.c_proj")


def backbone_state_dict_to_hf(backbone: nn.Module, wte: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """A ``GPT2Backbone`` without LoRA -> the flat HF GPT2Model state dict in
    fp32 on the CPU, with ``wte.weight`` when ``wte`` is given."""
    src = backbone.state_dict()
    if any(".lora_" in k for k in src):
        raise ValueError("the backbone has LoRA adapters; a plain GPT-2 checkpoint has none (lora_r = 0)")

    def arr(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(device="cpu", dtype=torch.float32).contiguous().clone()

    sd = {"wpe.weight": arr(src["wpe.weight"])}
    if wte is not None:
        sd["wte.weight"] = arr(wte)
    for i in range(len(backbone.h)):
        for part in _BLOCK_PARTS:
            for leaf in ("weight", "bias"):
                sd[f"h.{i}.{part}.{leaf}"] = arr(src[f"h.{i}.{part}.{leaf}"])
    for leaf in ("weight", "bias"):
        sd[f"ln_f.{leaf}"] = arr(src[f"ln_f.{leaf}"])
    return sd


def save_hf_checkpoint(
    state_dict: Mapping[str, torch.Tensor],
    out_dir: str,
    meta: dict[str, Any] | None = None,
) -> str:
    """Write ``pytorch_model.bin`` and a descriptive ``config.json`` into
    ``out_dir``, the layout ``hf_import.load_torch_checkpoint`` resolves."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pytorch_model.bin")
    torch.save(dict(state_dict), path)
    wpe = state_dict["wpe.weight"]
    cfg = {
        "model_type": "gpt2",
        "n_embd": int(wpe.shape[1]),
        "n_positions": int(wpe.shape[0]),
        "n_layer": sum(1 for k in state_dict if k.endswith(".ln_1.weight")),
        **(meta or {}),
    }
    if "wte.weight" in state_dict:
        # the byte LM's 256-row wte: without vocab_size, transformers would build
        # the default 50257-token embedding and fail to load it
        cfg["vocab_size"] = int(state_dict["wte.weight"].shape[0])
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return path
