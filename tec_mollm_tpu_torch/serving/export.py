"""Ahead-of-time export of the forecast forward with ``torch.export``.

The JAX package lowers its jitted forward to a StableHLO artifact
(``serving/export.py`` there); the port exports the eval-mode model with
``torch.export.export`` into an ``ExportedProgram`` saved as ``.pt2``:

  * the weights and the graph tables are held by the program, so serving it
    needs no model code, checkpoint or config: ``load_forecaster`` imports
    ``tec_mollm_tpu_torch.ops`` (which registers the forward kernels' ops)
    and nothing else of the package;
  * the forward kernels are registered custom ops (``tec_mollm::gat_stencil``,
    ``::short_attention``, ``::fused_ln_mlp``), so the program holds them as
    nodes and launches the kernels on the card: a stencil graph gives one GAT
    node and no ``aten.roll``, a fused config adds one attention and one MLP
    node per GPT-2 block. A graph without a stencil exports its plain gather,
    as the JAX package's XLA path does;
  * the batch dimension is symbolic by default, or fixed by ``batch_size``;
  * ``platforms`` names the devices the artifact serves on, from "cuda" and
    "cpu"; the export traces on the first, and ``load_forecaster`` moves the
    program to another of them (the ops dispatch by device at run time).

Artifact layout: ``<path>`` is the saved program, with a sibling
``<path>.json`` of metadata (the JAX package's keys: checkpoint, platforms,
batch, L_in, L_out, num_nodes, in_features, dtype; and the GAT route) that
``ForecastService(artifact=...)`` cross-checks against its config.

    ep = export_forecaster(cfg, state_dict, graph)
    save_exported(ep, "model.pt2", meta=artifact_meta(cfg, graph, "best_params.pt", ("cuda",)))
    fn = load_forecaster("model.pt2", "cuda")     # callable
    preds = fn(x, time_features)                  # (B, L_out, N, Q) fp32
"""

from __future__ import annotations

import collections
import json
import logging
import os
from typing import Any, Callable, Mapping

import torch
from torch import nn

logger = logging.getLogger(__name__)

PLATFORMS = ("cuda", "cpu")


def check_platforms(platforms) -> tuple[str, ...]:
    """The platforms as a tuple of the port's device types; raises for an
    empty list, a TPU (the JAX package's artifacts serve there) or an
    unknown name."""
    platforms = tuple(str(p) for p in platforms)
    if not platforms:
        raise ValueError("an artifact needs at least one platform")
    if "tpu" in platforms:
        raise ValueError(
            "platform 'tpu': the PyTorch port exports for 'cuda' and 'cpu'; a TPU artifact is the "
            "JAX package's (scripts/export_model.py)"
        )
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platform(s) {unknown}; the port exports for {list(PLATFORMS)}")
    return platforms


class Forecaster(nn.Module):
    """(x, time_features) -> forecasts: the eval-mode model with the graph
    tables as buffers, the signature the artifact exports."""

    def __init__(self, model: nn.Module, graph_pair: tuple[torch.Tensor, torch.Tensor | None]):
        super().__init__()
        self.model = model
        neighbors, mask = graph_pair
        self.register_buffer("neighbors", neighbors)
        self.register_buffer("neighbor_mask", mask)

    def forward(self, x: torch.Tensor, time_features: torch.Tensor) -> torch.Tensor:
        return self.model(x, time_features, self.neighbors, self.neighbor_mask)


def export_forecaster(
    cfg,
    state_dict: Mapping[str, torch.Tensor],
    graph,
    batch_size: int | None = None,
    platforms=PLATFORMS,
    fused_attn: bool = False,
    use_fused_mlp: bool = False,
) -> torch.export.ExportedProgram:
    """Export the deterministic forecast forward of ``state_dict`` on
    ``graph``, built as ``ForecastService`` builds its model (compute dtype
    from ``cfg.train.bf16``; ``fused_attn`` and ``use_fused_mlp`` as given),
    traced on ``platforms[0]``. ``batch_size=None`` makes the batch symbolic
    (any B at call time); an int pins it."""
    from tec_mollm_tpu_torch.device import resolve_device
    from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs, opt_in_kernel_refusal

    cfg = cfg.resolved()
    platforms = check_platforms(platforms)
    device = resolve_device(platforms[0])
    dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
    if device.type == "cuda":
        reason = opt_in_kernel_refusal(cfg.model, dtype, fused_attn, use_fused_mlp)
        if reason is not None:
            raise ValueError(reason)
    shifts, graph_pair = graph_inputs(graph, device)
    model = TECMoLLM(cfg.model, shifts, dtype=dtype, fused_attn=fused_attn, use_fused_mlp=use_fused_mlp, seed=None)
    model.load_state_dict(state_dict)
    # frozen: the GAT op has no backward and refuses inputs that need one
    forecaster = Forecaster(model, graph_pair).to(device).eval().requires_grad_(False)
    m = cfg.model
    b = 2 if batch_size is None else batch_size
    x = torch.zeros(b, cfg.train.L_in, m.num_nodes, m.in_features, dtype=dtype, device=device)
    tf = torch.zeros(b, cfg.train.L_in, 4, dtype=torch.int32, device=device)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=4096)
        dynamic = {"x": {0: batch}, "time_features": {0: batch}}
    with torch.no_grad():
        return torch.export.export(forecaster, (x, tf), dynamic_shapes=dynamic)


def artifact_ops(ep: torch.export.ExportedProgram) -> dict[str, int]:
    """Call nodes of the program's graph by operator name (e.g.
    ``tec_mollm.gat_stencil``, ``aten.roll``): what tests and the smoke hold
    an artifact to."""
    counts: collections.Counter = collections.Counter()
    for node in ep.graph.nodes:
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload):
            counts[node.target._schema.name.replace("::", ".")] += 1
    return dict(counts)


def artifact_meta(cfg, graph, checkpoint: str, platforms, batch_size: int | None = None) -> dict:
    """The sibling ``.json``: the JAX package's keys, plus the GAT route of
    the exported model."""
    from tec_mollm_tpu_torch.models.tec_mollm import gat_route

    cfg = cfg.resolved()
    shifts = tuple(int(s) for s in graph.stencil_shifts) if graph.has_stencil else None
    return {
        "checkpoint": checkpoint,
        "platforms": list(check_platforms(platforms)),
        "batch": batch_size or "symbolic",
        "L_in": cfg.train.L_in,
        "L_out": cfg.train.L_out,
        "num_nodes": cfg.model.num_nodes,
        "in_features": cfg.model.in_features,
        "dtype": "bfloat16" if cfg.train.bf16 else "float32",
        "gat_route": gat_route(cfg.model, shifts),
    }


def save_exported(ep: torch.export.ExportedProgram, path: str, meta: dict[str, Any] | None = None) -> None:
    """Write the metadata and then the program, each by an atomic rename:
    a program on disk implies its metadata, so a crash between the writes
    leaves no artifact whose cross-checks would silently not run."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if meta is not None:
        mtmp = f"{path}.json.tmp{os.getpid()}"
        with open(mtmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(mtmp, path + ".json")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.export.save(ep, f)
    os.replace(tmp, path)
    logger.info("exported %d bytes -> %s", os.path.getsize(path), path)


def load_exported(path: str, device: str | torch.device | None = None) -> torch.export.ExportedProgram:
    """The saved program, moved to ``device`` when given. Imports the port's
    ops package (which registers the kernels' ops) and no model code."""
    from torch.export.passes import move_to_device_pass

    import tec_mollm_tpu_torch.ops  # noqa: F401 — registers torch.ops.tec_mollm.*

    with open(path, "rb") as f:
        ep = torch.export.load(f)
    if device is not None:
        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def load_forecaster(path: str, device: str | torch.device | None = None) -> Callable[..., torch.Tensor]:
    """A callable (x, time_features) -> forecasts from a saved artifact, on
    ``device`` when given."""
    return load_exported(path, device).module()
