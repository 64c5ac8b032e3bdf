"""Which parameters split over the model group (``parallel/partitioning.py``
of the JAX package, in PyTorch).

With ``model_parallel > 1`` the GPT-2 backbone and the prediction head split
Megatron-style, rule for rule as JAX's ``_spec_for_path``:

  * attn ``c_attn`` weight (d, 3d), its bias and ``lora_B``: column-parallel
    (``lora_A`` replicated: small, contracted on the input);
  * attn ``c_proj`` weight (d, d): row-parallel;
  * mlp ``c_fc`` weight (d, 4d) and its bias: column-parallel;
  * mlp ``c_proj`` weight (4d, d): row-parallel;
  * head ``fc1`` (``prediction_head.mlp.0``) weight and bias: column-parallel;
    head ``fc2`` (``prediction_head.mlp.3``) weight: row-parallel;

and everything else is replicated. A tensor whose split dimension does not
divide by ``model_parallel`` stays replicated (JAX's guard).

JAX returns a ``PartitionSpec`` over a Flax path for GSPMD. Here
``param_split`` takes a ``state_dict`` name (the reference's names, which the
port keeps) and the tensor's shape in the port's layout, and returns the
kind of split; ``split_dim`` says which torch dimension it cuts (GPT-2's
Conv1D weights keep Flax's (in, out), torch ``Linear`` weights are (out,
in), peft's ``lora_B`` is (out, r)). ``parallel/tensor_parallel.py`` does the
slicing and the collectives.
"""

from __future__ import annotations

from typing import Sequence

LLM_MODULE = "llm_backbone"
HEAD_MODULE = "prediction_head"
FC1, FC2 = "0", "3"  # prediction_head.mlp.{0,3}: the JAX head's fc1 and fc2


def _leaf(tokens: list[str]) -> tuple[str, str]:
    """(owner module, JAX leaf name) of a state_dict name: ``X.weight`` is
    X's kernel, ``X.lora_A.weight`` X's lora_A."""
    if len(tokens) >= 3 and tokens[-2] in ("lora_A", "lora_B"):
        return tokens[-3], tokens[-2]
    return (tokens[-2] if len(tokens) >= 2 else ""), {"weight": "kernel"}.get(tokens[-1], tokens[-1])


def _rule(name: str) -> str:
    tokens = name.split(".")
    owner, leaf = _leaf(tokens)
    if LLM_MODULE in tokens:
        if owner == "c_attn":
            if leaf in ("kernel", "lora_B", "bias"):
                return "column"
            return "replicated"  # lora_A
        if "attn" in tokens and owner == "c_proj" and leaf == "kernel":
            return "row"
        if owner == "c_fc" and leaf in ("kernel", "bias"):
            return "column"
        if "mlp" in tokens and owner == "c_proj" and leaf == "kernel":
            return "row"
        return "replicated"
    if HEAD_MODULE in tokens:
        if owner == FC1 and leaf in ("kernel", "bias"):
            return "column"
        if owner == FC2 and leaf == "kernel":
            return "row"
    return "replicated"


def split_dim(name: str, kind: str) -> int:
    """The torch dimension a ``column`` or ``row`` split of ``name`` cuts."""
    tokens = name.split(".")
    owner, leaf = _leaf(tokens)
    if leaf in ("bias", "lora_B"):
        return 0
    if HEAD_MODULE in tokens:  # torch Linear (out, in)
        return 0 if kind == "column" else 1
    return 1 if kind == "column" else 0  # GPT-2 Conv1D (in, out)


def param_split(name: str, shape: Sequence[int], model_parallel: int) -> str:
    """``"column"``, ``"row"`` or ``"replicated"`` for the parameter ``name``
    of shape ``shape`` (the port's layout) at ``model_parallel``: JAX's
    ``param_pspecs`` for one leaf, from a name and a shape instead of a pytree
    path and a sharding object."""
    if model_parallel <= 1:
        return "replicated"
    kind = _rule(name)
    if kind == "replicated":
        return kind
    dim = split_dim(name, kind)
    if dim >= len(shape) or shape[dim] % model_parallel:
        return "replicated"
    return kind
