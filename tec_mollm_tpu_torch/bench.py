"""Benchmark the port: train windows/s at L_in=48 / L_out=12 on one GPU.

    python -m tec_mollm_tpu_torch.bench [--batch-size B] [--accum A] [--steps S]
        [--warmup W] [--quick] [--cpu] [--no-bf16] [--preset NAME] [--eval]
        [--fused-attn] [--fused-mlp] [--no-remat] [--remat-policy P]
        [--fuse-conv] [--two-pass-ln]

The counterpart of the JAX package's root ``bench.py``: the full flagship train
step (forward, backward, clip, AdamW on the trainable partition, bf16 compute
with the frozen weights stored in bf16) on synthetic data over the real 41x71
graph. The default preset runs B = 8 x accumulation 1; ``--eval`` times the
deterministic forward at the preset's ``eval_batch_size``. ``--fused-attn`` and
``--fused-mlp`` are the model's kernel arms. The JAX bench's ablation flags:
``--remat-policy`` (full, dots_saveable, nothing_saveable) recomputes the
GPT-2 blocks under that policy (remat is on with the flag or the preset's
``remat_llm``; ``--no-remat`` turns it off), ``--fuse-conv`` runs each conv
block's three branches as one conv, ``--two-pass-ln`` the two-pass fp32
LayerNorm in place of the lean one. Steps are timed in chunks of up to
5 after the warm-up, each chunk ending in ``torch.cuda.synchronize()``, and the
fastest chunk is reported as ONE JSON line::

    {"metric": "...", "value": N, "unit": "windows/s/chip", "device": "..."}

``--quick`` runs the tiny config for 3 steps; ``--cpu`` runs on the CPU, whose
numbers are no device metric. Without ``--cpu`` and without CUDA it raises.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the bench is data
parallel over the local cards, as the JAX bench takes every local device
without a flag: each rank joins the group (``init_distributed``: NCCL, gloo
with ``--cpu``), trains its own microbatches through
``DistributedDataParallel`` (mp = 1), so the macro batch is ``batch * accum
* world``, and rank 0 prints the line with ``windows_per_step`` (the macro
batch), ``value`` (windows/s per card) and ``total_windows_per_sec``::

    torchrun --nproc_per_node 4 -m tec_mollm_tpu_torch.bench

Without a process group it is the single-card bench above.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from tec_mollm_tpu_torch.config import PRESETS, Config, tiny_config
from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.parallel import mesh
from tec_mollm_tpu_torch.training import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)


def bench_config(
    preset: str = "default",
    quick: bool = False,
    batch_size: int | None = None,
    accum: int | None = None,
    bf16: bool = True,
    eval_mode: bool = False,
    remat_policy: str | None = None,
    no_remat: bool = False,
) -> Config:
    """The measured configuration: the default preset's train step at B = 8 x
    accumulation 1, other presets at their own policy, eval at the preset's
    eval_batch_size x 1 (the JAX bench's choices). Remat is the preset's,
    forced on by a ``remat_policy`` and off by ``no_remat``; the policy is
    ``remat_policy`` or the preset's."""
    cfg = tiny_config() if quick else PRESETS[preset]()
    flagship = preset == "default" and not quick
    train = dataclasses.replace(
        cfg.train,
        batch_size=batch_size if batch_size is not None
        else cfg.train.eval_batch_size if eval_mode else 8 if flagship else cfg.train.batch_size,
        accumulation_steps=accum if accum is not None
        else 1 if flagship or eval_mode else cfg.train.accumulation_steps,
        bf16=bf16,
        remat_llm=(cfg.train.remat_llm or remat_policy is not None) and not no_remat,
        remat_policy=remat_policy or cfg.train.remat_policy,
    )
    return dataclasses.replace(cfg, train=train)


@dataclasses.dataclass
class BenchRun:
    device: torch.device
    state: TrainState
    batch: dict[str, torch.Tensor]
    step: Callable[[], dict[str, torch.Tensor]]  # one train step (or eval forward)
    world: int = 1  # data-parallel ranks, each stepping its own batch

    @property
    def windows_per_step(self) -> int:
        """The macro batch: every rank's windows."""
        return int(self.batch["x"].shape[0]) * self.world

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def setup(
    cfg: Config,
    device: torch.device,
    fused_attn: bool = False,
    fused_mlp: bool = False,
    eval_mode: bool = False,
    seed: int = 0,
    **arms,
) -> BenchRun:
    """Model (seeded random weights), train state, one synthetic macro batch on
    ``device`` and the step to time. ``arms`` are the model's ablation
    arguments (``fuse_conv``, ``lean_gn``, ``im2col_conv``, ``lean_ln``); remat
    follows ``cfg.train``. With a process group the train step runs
    through DDP and each rank takes its strided share of a macro batch of
    ``batch_size * accumulation_steps * world`` windows."""
    m = cfg.model
    graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w), distance_threshold_km=cfg.data.distance_threshold_km)
    shifts, graph_pair = graph_inputs(graph, device)
    dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
    model = TECMoLLM(
        m, shifts, dtype=dtype, fused_attn=fused_attn, use_fused_mlp=fused_mlp, remat_llm=cfg.train.remat_llm,
        remat_policy=cfg.train.remat_policy, seed=seed, **arms,
    ).to(device)
    state, _ = create_train_state(model, cfg, frozen_dtype=torch.bfloat16 if cfg.train.bf16 else None)

    world, rank = mesh.world_size(), mesh.rank()
    macro = cfg.train.batch_size * cfg.train.accumulation_steps * world
    split = synthetic_processed_split(macro + 1, cfg.train.L_in, cfg.train.L_out, m.num_nodes, seed=seed)
    ds = SlidingWindowDataset(split, cfg.train.L_in, cfg.train.L_out)
    rows = (np.arange(macro) % len(ds))[rank::world]
    batch = {k: torch.from_numpy(v).to(device) for k, v in ds.gather_batch(rows).items()}

    if eval_mode:
        eval_step = make_eval_step(model, cfg)

        def step():
            return {"loss": eval_step(batch, graph_pair)[0]}
    else:
        trained = model
        if mesh.is_initialized():
            cuda = device.type == "cuda"
            trained = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[device] if cuda else None, output_device=device if cuda else None)
        train_step = make_train_step(trained, cfg)

        def step():
            return train_step(state, batch, graph_pair)[1]

    return BenchRun(device, state, batch, step, world)


def time_steps(run: BenchRun, steps: int, warmup: int) -> tuple[float, int]:
    """(fastest chunk's seconds, steps per chunk) after ``warmup`` steps."""
    for _ in range(warmup):
        run.step()
    run.sync()
    chunk = max(1, min(5, steps))
    best = float("inf")
    for _ in range(max(1, steps // chunk)):
        t0 = time.perf_counter()
        for _ in range(chunk):
            run.step()
        run.sync()
        best = min(best, time.perf_counter() - t0)
    return best, chunk


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=None, help="microbatch per step (default: the preset's; 8 for default)")
    p.add_argument("--accum", type=int, default=None, help="gradient accumulation steps (default: the preset's)")
    p.add_argument("--steps", type=int, default=20, help="timed optimizer updates")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--quick", action="store_true", help="tiny model, 3 steps")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--no-bf16", action="store_true", help="fp32 compute and fp32 frozen weights")
    p.add_argument("--preset", default="default", choices=sorted(PRESETS))
    p.add_argument("--eval", action="store_true", help="time the deterministic eval forward instead")
    p.add_argument("--fused-attn", action="store_true", help="the short-attention kernels")
    p.add_argument("--fused-mlp", action="store_true", help="the fused LN->MLP kernel (eval forward)")
    p.add_argument("--no-remat", action="store_true", help="disable LLM remat")
    p.add_argument("--remat-policy", default=None, choices=["full", "dots_saveable", "nothing_saveable"],
                   help="recompute the GPT-2 blocks under this policy (models/gpt2.REMAT_POLICIES)")
    p.add_argument("--fuse-conv", action="store_true", help="fuse the 3 multi-scale conv branches into one conv")
    p.add_argument("--two-pass-ln", action="store_true", help="disable lean_ln (two-pass fp32 LayerNorm)")
    args = p.parse_args(argv)

    # under torchrun: one rank a card, data parallel (the JAX bench's mp = 1)
    owned = "WORLD_SIZE" in os.environ and not mesh.is_initialized()
    if owned:
        device = mesh.init_distributed(device="cpu" if args.cpu else None)
    else:
        device = mesh.local_device() or resolve_device("cpu" if args.cpu else None)
    try:
        cfg = bench_config(args.preset, args.quick, args.batch_size, args.accum, not args.no_bf16, args.eval,
                           args.remat_policy, args.no_remat)
        run = setup(cfg, device, args.fused_attn, args.fused_mlp, args.eval,
                    fuse_conv=args.fuse_conv, lean_ln=not args.two_pass_ln)
        best, chunk = time_steps(run, 3 if args.quick else args.steps, args.warmup)
        best = mesh.max_over_ranks(best)  # the slowest rank's chunk
        kind = "eval" if args.eval else "train"
        total = chunk * run.windows_per_step / best
        if mesh.rank() == 0:
            line = {
                "metric": f"{kind}_windows_per_sec_per_chip",
                "value": round(total / run.world, 3),
                "unit": "windows/s/chip",
                "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            }
            if mesh.is_initialized():
                line.update(world=run.world, windows_per_step=run.windows_per_step,
                            total_windows_per_sec=round(total, 3))
            print(json.dumps(line))
    finally:
        if owned:
            mesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
