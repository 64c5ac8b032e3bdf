"""Tensor parallelism: Megatron column/row splits of the GPT-2 backbone and
the prediction head over the model group.

The JAX package shards the parameters (``param_shardings``) and lets GSPMD
insert the collectives. Here each rank of a model group holds its slice of
every split tensor (``shard_model_``) and the layers run Megatron's two
operators at the region boundaries:

* ``copy_to_model_group``: the identity forward, an all-reduce of the
  gradient backward; at the input of each column-parallel layer, so every
  replicated tensor before it (LayerNorms, embeddings, GAT, convolutions)
  gets the whole gradient on every rank;
* ``reduce_from_model_group``: an all-reduce forward, the identity backward;
  at the output of each row-parallel layer, whose bias is added once after it.

Where the port departs from GSPMD's layout:

* ``c_attn`` splits by head: JAX's ``P(None, "model")`` on the (d, 3d) kernel
  gives rank 0 ``[q, half of k]`` and lets GSPMD compute the global math; an
  explicit split must give each rank q, k and v of its own ``heads / mp``
  heads (its bias and ``lora_B`` rows likewise). When ``llm_heads % mp`` is
  not 0 the attention stays replicated (JAX's guard tests only ``3d % mp``).
* ``lora_A`` of a split ``c_attn`` is replicated but contracted with the
  rank's own ``lora_B`` rows, so each rank holds a partial gradient: the
  train step sums it over the model group (``partial_grad_names``).
* Dropout inside a split region (attention probabilities, the head's hidden
  layer) draws a per-rank mask (``split_dropout``), as Megatron's RNG tracker
  does; every other mask is the same on every rank of the group.
* Checkpoints hold whole tensors in the reference layout
  (``gather_full_state_dict``; ``shard_state_dict`` is its inverse), so a
  file written at any ``mp`` loads at any other and serves on one card. The
  port's optimizer is never flattened, so JAX's refusal of a tp > 1
  checkpoint under ``flatten_optimizer`` has no counterpart.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.parallel.mesh import model_group, model_rank, model_world
from tec_mollm_tpu_torch.parallel.partitioning import param_split, split_dim

# a split: (kind, torch dim, whether the dim holds [q | k | v] thirds)
Split = tuple[str, int, bool]


def _summed(t: torch.Tensor, group: Any) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, gradient all-reduced over the model group backward
    (``x`` itself without a model group)."""
    group = model_group()
    return x if group is None else _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor) -> torch.Tensor:
    """Sum over the model group forward, identity backward (``x`` itself
    without a model group)."""
    group = model_group()
    return x if group is None else _ReduceFromModelGroup.apply(x, group)


def fold_model_rank(seed: int) -> int:
    """``seed`` with this rank's model rank folded in (31 bits, the kernels'
    seed range)."""
    return int(np.random.SeedSequence([seed, model_rank()]).generate_state(1, np.uint32)[0] >> 1)


def split_dropout(x: torch.Tensor, p: float, training: bool, split: bool) -> torch.Tensor:
    """Dropout of ``x``: ``F.dropout`` outside a split region; inside one
    (``split``) a mask of this rank's own, drawn from a generator seeded by
    one draw of the default generator (the same draw on every rank of the
    group, so the replicated masks after it stay equal) with the model rank
    folded in."""
    if not split or not training or p == 0.0:
        return F.dropout(x, p, training)
    seed = fold_model_rank(int(torch.randint(0, 2**31 - 1, ())))
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=g)
    return x * keep * (1.0 / (1.0 - p))


# ---------------------------------------------------------------------------
# the layout


def tp_plan(shapes: Mapping[str, Sequence[int]], heads: int, mp: int) -> dict[str, Split]:
    """name -> (kind, dim, thirds) of every tensor that splits at ``mp``:
    ``param_split``'s, except the attention (``c_attn`` and its ``c_proj``),
    which stays replicated unless ``heads % mp == 0``."""
    plan = {}
    for name, shape in shapes.items():
        kind = param_split(name, tuple(shape), mp)
        if kind == "replicated" or (".attn." in name and heads % mp):
            continue
        plan[name] = (kind, split_dim(name, kind), ".c_attn." in name)
    return plan


def check_splittable(cfg: Any, mp: int) -> None:
    """Raise where a model of ``cfg`` (a ``ModelConfig``) cannot be split
    ``mp`` ways: the DeepSeek-V2 backbone has no tensor-parallel form."""
    if mp > 1 and cfg.deepseek_v2 is not None:
        raise ValueError(
            f"model_parallel={mp}: the DeepSeek-V2 backbone has no tensor-parallel form (its experts and "
            "latent attention are not split); run it on one process a replica"
        )


@functools.lru_cache(maxsize=8)
def model_plan(cfg: Any, mp: int) -> dict[str, Split]:
    """``tp_plan`` of a ``TECMoLLM`` of ``cfg`` (a ``ModelConfig``), from the
    shapes of a model built on the meta device."""
    from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM

    check_splittable(cfg, mp)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in TECMoLLM(cfg, seed=None).state_dict().items()}
    return tp_plan(shapes, cfg.llm_heads, mp)


def _slice(t: torch.Tensor, split: Split, rank: int, mp: int) -> torch.Tensor:
    _, dim, thirds = split
    if thirds:
        parts = t.unflatten(dim, (3, -1))
        width = parts.shape[dim + 1] // mp
        return parts.narrow(dim + 1, rank * width, width).flatten(dim, dim + 1).contiguous()
    width = t.shape[dim] // mp
    return t.narrow(dim, rank * width, width).contiguous()


def _join(parts: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    _, dim, thirds = split
    if thirds:
        return torch.cat([p.unflatten(dim, (3, -1)) for p in parts], dim=dim + 1).flatten(dim, dim + 1)
    return torch.cat(list(parts), dim=dim)


def shard_state_dict(
    full: Mapping[str, torch.Tensor], model_rank: int, mp: int, cfg: Any
) -> dict[str, torch.Tensor]:
    """Model rank ``model_rank``'s part of a whole ``state_dict`` (or of any
    dict keyed by parameter names) of a ``TECMoLLM`` of ``cfg``; the tensors
    that do not split are passed through."""
    if mp == 1:
        return dict(full)
    plan = model_plan(cfg, mp)
    return {k: _slice(v, plan[k], model_rank, mp) if k in plan else v for k, v in full.items()}


def _all_gather(t: torch.Tensor, mp: int, group: Any) -> list[torch.Tensor]:
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mp)]
    dist.all_gather(parts, src, group=group)  # a copy: bit-exact in any dtype
    return parts


def gather_full_state_dict(
    model_or_tensors: nn.Module | Mapping[str, torch.Tensor] | Sequence[Mapping[str, torch.Tensor]],
    cfg: Any = None,
    mp: int | None = None,
) -> dict[str, torch.Tensor]:
    """The whole tensors, in the reference layout, of a split model: the
    inverse of ``shard_state_dict``.

    ``model_or_tensors`` is a model ``shard_model_`` split (its state_dict,
    gathered over the model group), this rank's dict keyed by parameter
    names (gathered over the model group; ``cfg`` and ``mp`` given), or
    every model rank's dicts in rank order (joined here, no collective).
    Every rank of the group calls it and gets the whole tensors."""
    if isinstance(model_or_tensors, nn.Module):
        model = model_or_tensors
        cfg, mp = model.cfg, getattr(model, "model_parallel", 1)
        tensors: Any = model.state_dict()
    else:
        tensors = model_or_tensors
    if isinstance(tensors, Mapping):
        mp = mp or 1
        if mp == 1:
            return dict(tensors)
        if mp != model_world():
            raise RuntimeError(f"tensors split {mp} ways, but the model group holds {model_world()} ranks")
        plan = model_plan(cfg, mp)
        group = model_group()
        return {k: _join(_all_gather(v, mp, group), plan[k]) if k in plan else v for k, v in tensors.items()}
    shards = list(tensors)
    if len(shards) == 1:
        return dict(shards[0])
    plan = model_plan(cfg, len(shards))
    return {k: _join([s[k] for s in shards], plan[k]) if k in plan else v for k, v in shards[0].items()}


def shard_model_(model: nn.Module, model_rank: int, mp: int) -> nn.Module:
    """Slice a whole ``TECMoLLM``'s split parameters to model rank
    ``model_rank``'s part, in place (each ``Parameter`` keeps its identity),
    and switch its layers to their parallel forms: ``c_attn`` column and
    attention ``c_proj`` row over ``heads / mp`` local heads, ``c_fc`` column
    and MLP ``c_proj`` row, the head's ``fc1`` column and ``fc2`` row. Run it
    before the optimizer and the EMA are made. ``mp = 1`` leaves the model as
    it is. Returns ``model``."""
    if mp == 1:
        return model
    if getattr(model, "model_parallel", 1) != 1:
        raise RuntimeError("the model is split already")
    from tec_mollm_tpu_torch.models.gpt2 import GPT2Attention, GPT2Block

    cfg = model.cfg
    check_splittable(cfg, mp)
    plan = tp_plan({k: tuple(v.shape) for k, v in model.state_dict().items()}, cfg.llm_heads, mp)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in plan:
                p.data = _slice(p.data, plan[name], model_rank, mp)
    for name, module in model.named_modules():
        if isinstance(module, GPT2Attention) and f"{name}.c_attn.weight" in plan:
            module.heads //= mp
            module.split = True
            module.c_attn.parallel, module.c_proj.parallel = "column", "row"
        elif isinstance(module, GPT2Block) and f"{name}.mlp.c_fc.weight" in plan:
            if module.use_fused_mlp:
                raise ValueError("the fused MLP kernel takes the whole c_fc and c_proj: it serves one process")
            module.mlp.c_fc.parallel, module.mlp.c_proj.parallel = "column", "row"
    if "prediction_head.mlp.0.weight" in plan:
        model.prediction_head.split = True
    model.model_parallel = mp
    return model


def split_names(model: nn.Module) -> set[str]:
    """The parameters of ``model`` that hold a slice on this rank."""
    mp = getattr(model, "model_parallel", 1)
    return set(model_plan(model.cfg, mp)) if mp > 1 else set()


def partial_grad_names(model: nn.Module) -> set[str]:
    """Replicated parameters whose gradient each rank holds in part: the
    ``lora_A`` of a column-parallel ``c_attn``, contracted with the rank's
    own ``lora_B`` rows. The train step sums their gradients over the model
    group."""
    names = set()
    for name, module in model.named_modules():
        if getattr(module, "parallel", None) == "column" and getattr(module, "rank", 0) > 0:
            names.add(f"{name}.lora_A.weight")
    return names
