"""Reference checkpoints -> the port's ``TECMoLLM`` state_dict.

The port's modules carry the reference's state_dict names, so a checkpoint of
the reference's training loads after the key fixups that the JAX package's
``models/ref_import.py`` applies on its way to Flax:

* DDP's ``module.`` and ``torch.compile``'s ``_orig_mod.`` prefixes are
  stripped (``hf_import.normalize_keys``);
* inside ``llm_backbone.model.``, peft's ``base_model.model.`` wrapper and its
  ``base_layer`` / ``default`` infixes go (the same function, applied to the
  backbone's own names);
* GPT-2's ``wte`` and its attention-mask buffers are dropped (the forecast
  model feeds ``inputs_embeds``), and ``wpe`` is cut to the model's positions;
* the node table is cut to ``cfg.num_nodes`` rows: the reference sizes it from
  its config but indexes only the rows of the data grid.

The port's own ``best_params.pt`` is such a state_dict already, so one loader
serves both (``load_reference_checkpoint``), and the JAX package's importer
reads the port's file the same way.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models.hf_import import load_torch_checkpoint, normalize_keys

_BACKBONE = "llm_backbone.model."
_NODE_TABLE = "spatio_temporal_embedding.node_embedding.weight"
# GPT-2 tensors that the forecast model has no parameter for
_UNUSED_BACKBONE = re.compile(r"^(wte\.weight|h\.\d+\.attn\.(bias|masked_bias))$")


def reference_state_dict_to_port(state_dict: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A reference (or port) state_dict -> ``TECMoLLM(cfg).state_dict()``'s
    names; the values are not copied or cast. Raises ``ValueError`` when the
    node table has fewer rows than ``cfg.num_nodes``."""
    sd = normalize_keys(state_dict)
    out = {k: v for k, v in sd.items() if not k.startswith(_BACKBONE)}
    backbone = normalize_keys({k[len(_BACKBONE):]: v for k, v in sd.items() if k.startswith(_BACKBONE)})
    for name, value in backbone.items():
        if _UNUSED_BACKBONE.match(name):
            continue
        out[_BACKBONE + name] = value[: cfg.llm_max_positions] if name == "wpe.weight" else value
    if _NODE_TABLE in out:
        node = out[_NODE_TABLE]
        if node.shape[0] < cfg.num_nodes:
            raise ValueError(f"reference node table has {node.shape[0]} rows < num_nodes {cfg.num_nodes}")
        out[_NODE_TABLE] = node[: cfg.num_nodes]
    return out


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file of the reference's training, or the port's
    ``best_params.pt`` -> the port's state_dict."""
    return reference_state_dict_to_port(load_torch_checkpoint(path), cfg)
