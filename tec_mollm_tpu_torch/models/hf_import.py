"""Load HF GPT-2 checkpoints into the port's forecast model.

The counterpart of ``tec_mollm_tpu/models/hf_import.py`` (``normalize_keys``,
``load_torch_checkpoint``, ``merge_gpt2_params`` and
``load_gpt2_into_model_params``). HF GPT-2's Conv1D weights are (in, out), as
the port's ``LoRADense.weight`` is, and peft's ``lora_A`` (r, in) and ``lora_B``
(out, r) are the port's ``nn.Linear`` layouts, so nothing is transposed.
Wrapper prefixes (DDP's ``module.``, ``torch.compile``'s ``_orig_mod.``, peft's
``base_model.model.``, HF's ``transformer.``) are stripped, and peft's
``base_layer`` / ``default`` infixes dropped. ``wte`` is not read: the forecast
model feeds ``inputs_embeds``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch
from torch import nn

_STRIP_PREFIXES = ("module.", "_orig_mod.", "base_model.model.", "transformer.")


def normalize_keys(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Strip wrapper prefixes and drop peft's adapter infixes."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for prefix in _STRIP_PREFIXES:
            while key.startswith(prefix):
                key = key[len(prefix):]
        # peft writes c_attn.lora_A.default.weight and keeps the frozen base at
        # c_attn.base_layer.weight
        key = key.replace(".base_layer.", ".")
        key = key.replace(".default.weight", ".weight")
        out[key] = torch.as_tensor(value)
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A state_dict from a .pt/.bin/.pth file, a safetensors file, or an HF
    model directory (``pytorch_model.bin`` or ``model.safetensors``)."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            candidate = os.path.join(path, name)
            if os.path.exists(candidate):
                path = candidate
                break
        else:
            raise FileNotFoundError(f"No model weights found in directory {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def gpt2_state_dict(model: nn.Module, state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` (of a ``TECMoLLM``) with a GPT-2 checkpoint's
    tensors in place of the backbone's, each on its entry's device and dtype;
    ``model`` itself is not changed. ``wpe`` is cut to the model's positions.
    LoRA adapters are read when the checkpoint has them; otherwise they keep
    their values (a fresh lora_B is 0, so the adapter starts as the identity)."""
    sd = normalize_keys(state_dict)
    prefix = "llm_backbone.model."
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, param in model.llm_backbone.model.named_parameters():
        if ".lora_" in name and name not in sd:
            continue
        if name not in sd:
            raise KeyError(f"{name} missing from checkpoint (have e.g. {list(sd)[:5]})")
        value = sd[name]
        if name == "wpe.weight":
            value = value[: param.shape[0]]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint {tuple(value.shape)} vs model {tuple(param.shape)}")
        out[prefix + name] = value.to(device=param.device, dtype=param.dtype)
    return out


def load_gpt2_into_model(model: nn.Module, state_dict: Mapping[str, Any]) -> nn.Module:
    """Overlay a GPT-2 checkpoint onto ``model.llm_backbone.model`` (a
    ``TECMoLLM``) in place (``gpt2_state_dict``). Returns ``model``."""
    with torch.no_grad():
        model.load_state_dict(gpt2_state_dict(model, state_dict))
    return model
