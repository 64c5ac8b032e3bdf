#!/usr/bin/env python3
"""Drive the PyTorch port (tec_mollm_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

It needs one card. Phases 12 and 13 start this script again as the ranks of
a torchrun group (``--ddp-rank JOB``); a user never passes that flag.

Each CUDA kernel is held to its plain PyTorch version by the ``cuda`` cases of
its own test file, run on the card with ``python -m pytest <file> -m cuda
--noconftest``: csrc/gat_stencil.cu by tests/test_torch_gat_stencil_card.py,
short_attention.cu by tests/test_torch_short_attention_card.py, fused_mlp.cu
by tests/test_torch_fused_mlp_card.py, flash_attention.cu by
tests/test_torch_flash_attention_card.py, temporal_conv.cu by
tests/test_torch_temporal_kernel.py, add_layernorm.cu by
tests/test_torch_add_layernorm.py and sarima.cu by tests/test_torch_sarima.py.
They and this script's kernel table take their shapes and inputs from
card_cases.py. This script runs what needs the whole program, and times the
kernels at their main-path shapes after holding each to its plain version
there.

Launch checks name the kernels their phase is about (``launched``): another
kernel's launches never change their verdict. A phase that builds the model
without the opt-in GPT-2 kernels names those too (OPT_IN), at 0.

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile the kernels from csrc/ (one nvcc per source, in parallel),
     with the registers, spills and shared memory of each kernel instance;
  3. kernels: the kernel table (kernel_cases, KernelCase), one row for each
     row of PERF.md's kernel table, at the shapes the main path gives each
     kernel: first its output against its plain version's (check_case: within
     card_cases.TOL, the SARIMA kernels within SARIMA_RTOL of the largest
     magnitude), then its time through the wrapper (CUDA events around back-to-back
     calls, see time_ms), through its bare C entry, on the device's clock
     (kernel_device_ms), its bound on this card and by what, its plain
     version's time and a library call's where one computes the same
     function;
  4. serve: a synthetic processed dir at the 41x71 grid, ForecastService on the
     flagship Config() with seeded random weights at max_batch=8 in bf16,
     forecast requests over HTTP on localhost (some concurrent, so the batcher
     coalesces), first on the default path and then with fused_attn and
     use_fused_mlp; launch counts are zeroed before and read after each run;
     forecasts are checked for shape and finiteness, against an fp32 forward of
     the plain path, and the two paths against each other (no timings: the
     cell flagship-serve measures this path);
  5. train: the port's bench train step (tec_mollm_tpu_torch/bench.py) on
     Config() at B = 8 x accumulation 1, bf16 with bf16 frozen weights,
     fused_attn=True and every dropout at 0.1: 2 warm-up and 10 timed steps,
     train windows/s, step ms, one step's profile, launch counts (both
     attention kernels 3 a step). Loss and gradient norm must be finite, the
     frozen tensors bit-identical and every trainable tensor changed. Then,
     with every dropout at 0, one step's gradients through the kernels in bf16
     against an fp32 step on the plain path, within GRAD_TOL;
  6. trainer: the training CLI (python -m tec_mollm_tpu_torch.train, called
     in-process) at flagship width on Config() (B = 2 x accumulation 6, bf16,
     the model built without the opt-in kernels), over the processed dir of
     phase 4 with TRAINER_WINDOWS stride-1 train and val windows (4 macro steps
     an epoch, 8 validation batches). Run A trains TRAINER_EPOCHS epochs with a
     checkpoint every 2 macro steps: 2 finite history records, config.json,
     latest.pt, latest.meta.json and best_params.pt, and the GAT kernel's tiled
     form launched once per validation forward (16), its general form never,
     the temporal conv kernel once per validation forward. Run B is stopped by
     a SIGTERM to this process after 2 macro steps (fit's handler checkpoints
     and stops), then --resume: it must restart at step 2 of epoch 0, make run
     A's 8 updates, and its per-epoch losses lie within RESUME_RTOL of run A's.
     A third trainer gives, after a warm-up epoch, an epoch timed without
     checkpoints, its macro steps on batches already on the card, one profiled
     epoch (busy share, under the profiler and over the unprofiled wall), the
     validation ms a batch, the validation loss through the GAT kernel against
     the same validation on the plain GAT (within VAL_RTOL), the latest.pt save
     ms and size and the restore ms. Run A's best_params.pt is served on the
     test split with the stencil graph (the tiled kernel, GAT launches) and
     with a graph.npz without stencil arrays (the padded gather, no GAT launch,
     within SERVE_TOL_SCALED of the stencil's forecasts); a 1 head x 22
     channel config must serve finite forecasts through the kernel's general
     form, its route giving the reason, within SERVE_TOL_SCALED of the same
     service with the GAT on its plain path;
  7. pretrain: the surrogate GPT-2 pretraining (tec_mollm_tpu_torch/pretrain.py)
     at its full width and batch: ByteLM on pretrain_model_config(ModelConfig())
     (d 768, 3 blocks, 12 heads, no LoRA), bf16 compute, B = 64 x seq_len 128
     (T = 129 through the flash kernel), the corpus gathered from the repository,
     llm_dropout 0.1: 2 warm-up and 20 timed steps, step ms, bytes/s, peak
     memory, losses and the val loss before and after; flash_attention must
     run once per block and forward, with the attention dropout of llm_dropout
     in training and none in the val forward. The first loss must lie within 20% of
     ln 256 and the last below it. With every dropout at 0, one step's
     gradients through the kernel in bf16 against an fp32 step on the plain
     path, within GRAD_TOL. Then the backbone is exported as an HF checkpoint,
     loaded through hf_import into the flagship TECMoLLM (LoRA r 32): its
     backbone tensors must equal the exported ones bit for bit, lora_B stay 0,
     and one eval forecast on the card be finite.
  8. eval (run inside phase 4's processed dir, before phase 7): the test CLI
     (python -m tec_mollm_tpu_torch.test, called in-process) with --checkpoint
     latest on phase 6's workdir: the newest best_params.pt at flagship width,
     bf16, eval batch 16 over the 91 test windows, with a rollout of
     EVAL_ROLLOUT_STEPS steps over EVAL_ROLLOUT_WINDOWS windows. Both CSV rows
     finite, rollout_results.csv written, and the GAT kernel's tiled form
     launched exactly once per eval batch and once per rollout chunk, its
     general form never. The same evaluation on the plain GAT within VAL_RTOL
     on MAE and RMSE; the rollout timed and profiled (no timing of the scoring
     loop: the cell flagship-forecast measures it). The weights
     resaved as a reference .pth with DDP's module. prefixes score an
     identical CSV. A seeded operational_config() checkpoint (quantiles
     0.1/0.5/0.9, RevIN): --split val --conformal fit writes conformal.npz and
     its calibrated 80% interval covers 0.80 within COVERAGE_TOL of the val
     windows it was fit on; --conformal auto --conformal-mode adaptive writes
     the three quantile_metrics CSVs; the predict CLI writes
     forecast_quantiles_conformal for windows 0 and 5, and a ForecastService
     on the checkpoint returns the same bands within BANDS_TOL_TECU.
  9. preprocess (after phase 6): the preprocess CLI (python -m
     tec_mollm_tpu_torch.data.preprocess, called in-process) on the 41x71 grid
     with PREPROCESS_STEPS synthetic steps, and again with an outage of
     PREPROCESS_DROP steps under --cadence-policy segment: the CLI's wall, the
     files and their bytes, the *_raw.npz bytes and the stride-1 windows (more
     than one eval batch in each split; the outage drops some, and only the
     segmented archive has segment ids).
 10. device data: the train CLI at phase 6's policy and cut on that archive
     (strides that leave about TRAINER_WINDOWS windows), on the host pipeline
     and with --device-data: first-epoch losses within DEVICE_DATA_RTOL of each
     other, exactly one launch of the GAT kernel's tiled form per validation
     batch and none of its general form, a gathered fp32 batch within 1e-6 of
     the host mirror; the device-resident bytes, and each mode's warm epoch
     (windows/s, busy share of a profiled epoch over the unprofiled wall, HtoD
     copy ms).
 11. export: phase 6's run A best_params.pt through the export CLI (python -m
     tec_mollm_tpu_torch.export), on the default path and at the fused config
     (fused_attn, use_fused_mlp, bf16), each with a symbolic batch and at
     --batch-size 8, and a default artifact traced on the CPU for both
     platforms and moved to the card: its export and load wall and .pt2 size;
     its op nodes (tec_mollm.gat_stencil once, tec_mollm.temporal_conv once
     and tec_mollm.add_layernorm 2 L + 1 times, L + 1 in a fused one, where
     traced on the card, tec_mollm.short_attention and
     tec_mollm.fused_ln_mlp once per block in a fused one, no aten.roll); 16
     HTTP requests through ForecastService(artifact=...) against the
     checkpoint service of the same flags, within EXPORT_TOL_SCALED, with
     exactly one GAT and one temporal conv launch per forward where its op is
     in the artifact (and 3 attention and 3 MLP launches per fused forward);
     full-batch forward ms and request p50/p95 beside the checkpoint
     service's; and python -m tec_mollm_tpu_torch.serve --artifact --bench
     SERVE_CLI_BENCH, one GAT and one temporal conv launch per forward.
 12. data parallel (after phase 8), at phase 6's width and cut: (a) torchrun
     --standalone --nproc_per_node 1 runs this script as a rank, which joins
     the NCCL group and calls the train CLI (train.main) with --multihost and
     phase 6's run-A flags (bf16, dropout 0.1, a checkpoint every 2 macro
     steps): per-epoch losses within RESUME_RTOL of run A's, the GAT kernel's
     tiled form launched once per validation batch and its general form
     never; then a second DDP trainer's warm epoch, staged macro step and busy
     share (epoch_timings, its profile of the card's activity alone) beside
     phase 6's, and its staged step through DDP and without it in turns
     (ddp_vs_bare_step). (b) DDP_RANKS ranks on the one card over gloo
     (init_distributed(backend="gloo")), Config() in fp32 without dropout at
     batch 1 a rank, against one process at batch 2 (the same global macro
     batch): per-epoch train and val losses within DDP_RTOL, validation MAE by
     horizon within DDP_MAE_RTOL, identical on every rank, and each rank's GAT
     launches equal to its validation batches (no launch lost to a rank).
     Then run_evaluation and get_model_predictions on the ranks'
     best_params.pt: every rank the same metrics and predictions, equal to one
     process on the same checkpoint within DDP_EVAL_TOL, the predictions in
     window order, and the GAT launches its shards need. Each rank writes its
     launch counts to a JSON file, and the launches line sums them.
 13. tensor parallel (after phase 12), at phase 6's width and cut: (a)
     TP_RANKS gloo ranks on the one card (dp 1 x mp TP_RANKS: the GPT-2
     backbone and head split Megatron-style over the model group), Config()
     in fp32 without dropout through the train CLI's functions with
     --model-parallel, against phase 12's one process at the same global
     batch: per-epoch losses within TP_RTOL, validation MAE by horizon within
     DDP_MAE_RTOL, each rank's c_attn slice (768, 1152), every rank the same
     numbers, the GAT kernel once per validation and eval batch on every rank;
     their best_params.pt holds whole tensors, and run_evaluation on it gives
     every rank the same metrics and predictions, within DDP_EVAL_TOL of one
     process on the same file. (b) Their epoch-boundary latest resumes at mp 1
     in one process with every parameter bit-identical; a mid-epoch latest of
     theirs is refused at mp 1. (c) python -m tec_mollm_tpu_torch.bench under
     torchrun --nproc_per_node 1 (NCCL, DDP at world 1) beside the bare bench.
     (d) (a) over NCCL, one card a rank, where the host has TP_RANKS cards;
     on one card it logs why it did not run. Each rank writes its launch
     counts; the launches line sums them.
 14. ablation (after phase 13): (a) the SARIMA baseline (models/sarima.py) on
     a seeded simulated AR-dominated SARIMA series of (SARIMA_T, 2911)
     (sarima_inputs): one fit step's loss and gradient timed back to back,
     the full fit of SARIMA_FIT_STEPS steps through the kernels (its wall, ms
     a step, one launch of each pass a step; the fitted phi's node mean
     within SARIMA_PHI_TOL of the truth, as the JAX test asks) and a forecast
     batch; SARIMA_PROFILE_STEPS warm fit steps timed, and as many profiled
     (the device's busy share); then the test CLI with --baseline sarima on
     phase 8's checkpoint and data: a finite SARIMA row beside the model's and
     the HA's, the fit's launches and one forecast launch a batch of
     SARIMA_BATCH. (b) phase 5's train step (B = 8, bf16, fused_attn) with
     every dropout at 0, the same weights and batch under each of ARMS (the
     default, fuse_conv, lean_gn, im2col_conv, the two-pass LayerNorm, remat
     'full' and 'dots_saveable'): one step's loss and gradients against the
     default's within GRAD_TOL, then step ms and peak memory over ARM_STEPS
     steps.
 15. DeepSeek-V2-Lite (after phase 7): the configuration of the cell
     DSV2_CELL (benchmark/configs/dsv2_lite.json, every dropout at 0) on a
     seeded processed dir at the 41x71 grid: Trainer's first two macro steps
     of B 1 x 8 from the benchmark's seeded weights
     (benchmark/drivers/forecast_moe.seeded_weights), each step's loss within
     DSV2_LOSS_GAP of the plain reference's (benchmark/reference/
     deepseek_v2.py, float32, TF32 off) on the same rows and on the program's
     weights of that step; then the train CLI for one epoch on the
     configuration file, and the test CLI (EvalExecutor) and the serve CLI
     (ForecastService, 4 requests) on the run it wrote.
The phases run in the order 1-6, 9-11, 8, 12, 13, 14, 7, 15; the total time is
printed. The last line is {"ok": true, "device": {...}}; the line before it
holds the kernel table and each kernel's launches over the main-path runs.
Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Callable, NamedTuple

import numpy as np

from card_cases import (BATCH, DROPOUT, DROPOUT_SEED, FLASH_CASES, FLASH_HEADS, GAT, GAT_CASES, GAT_GENERAL_CASES,
                        LN_ROWS, MLP_ROWS, PADDED_NODES, SARIMA_BATCH, SARIMA_FORECAST_LARGE, SARIMA_RTOL,
                        SARIMA_SEASON, SARIMA_T, SARIMA_TRUTH, TOL, attention_inputs, flash_bare_entry, flash_views,
                        forecast_bare_entry, gat_bare_entry, gat_inputs, launched, ln_bare_entry, ln_inputs,
                        mlp_inputs, sarima_bare_entry, sarima_inputs, sarima_windows, temporal_bare_entry)

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}
# served forecasts, in scaled units: bf16 through 3 GPT-2 blocks against an fp32
# forward, and the fused kernels against the default path (two-pass vs lean LN,
# fp32 vs bf16 q*k products)
SERVE_TOL_SCALED = 0.1
# launch-count names of the GPT-2 kernels that a model runs only when its flags
# ask (fused_attn, use_fused_mlp, use_flash): a phase that builds the model
# without them checks that each launched 0 times
OPT_IN = ("short_attention", "short_attention_bwd", "fused_mlp", "flash_attention")
# back-to-back calls in one CUDA-event timing and the timings whose median is
# kept, timesteps of the synthetic test split, forecast requests and the
# threads that send the concurrent ones
REPS, TIMING_RUNS, STEPS, REQUESTS, THREADS = 20, 5, 150, 16, 6
# train phase: warm-up and timed steps of the flagship train step, and the
# windows of the gradient check
TRAIN_WARMUP, TRAIN_STEPS, GRAD_BATCH = 2, 10, 2
# gradient check: the largest per-tensor max|kernel bf16 - plain fp32| /
# max|plain fp32| over the trainable tensors. bf16 alone moves the worst tensor
# by a few percent (the bf16 plain path, printed beside it); a wrong attention
# backward moves lora_A/lora_B and everything below the blocks by order 1.
GRAD_TOL = 0.1
# pretrain phase: the pretraining script's batch and length, warm-up and timed
# steps, its peak rate reached after PRETRAIN_LR_WARMUP updates (the script
# warms up over 100 of 3000), and the rows of its gradient check
PRETRAIN_BATCH, PRETRAIN_SEQ, PRETRAIN_WARMUP, PRETRAIN_STEPS = 64, 128, 2, 20
PRETRAIN_LR, PRETRAIN_LR_WARMUP, PRETRAIN_GRAD_ROWS = 3e-4, 5, 8
# target scaler of the synthetic processed dir: TECU = scaled * SCALE + MEAN
TARGET_MEAN, TARGET_SCALE = 25.0, 12.0
# trainer phase: stride-1 windows of the train and val splits (at the default
# batch 2 x accumulation 6: 4 macro steps an epoch and 8 validation batches),
# epochs, macro steps between checkpoints and before the stop of run B, and
# the relative distance allowed between run A's and the resumed run's
# per-epoch losses (CUDA's atomics make bit equality unlikely; the CPU test
# asks for it)
TRAINER_WINDOWS = {"train": 48, "val": 16}
TRAINER_EPOCHS, TRAINER_CKPT_EVERY, TRAINER_STOP_AFTER, RESUME_RTOL = 2, 2, 2, 1e-3
# one validation through the GAT kernel against the same validation with the
# GAT on its plain path, both bf16: the relative distance allowed between their
# losses (one-ulp bf16 differences of the GAT output, averaged over 16 windows
# x 12 steps x 2911 nodes)
VAL_RTOL = 1e-2
# eval phase: the test CLI's rollout (steps, windows), the distance allowed
# between the conformal 80% interval's coverage on the split its offsets were
# fit on and 0.80, and between predict's and the service's calibrated bands in
# TECU (both bf16 through the kernel, at the same batch shape)
EVAL_ROLLOUT_STEPS, EVAL_ROLLOUT_WINDOWS = 24, 8
COVERAGE_TOL, BANDS_TOL_TECU = 0.02, 0.1
# preprocess phase: synthetic steps of the archive at the 41x71 grid (train,
# val and test each hold more than one eval batch of stride-1 windows) and the
# outage (start, count) of its gapped twin
PREPROCESS_STEPS, PREPROCESS_DROP = 1500, (200, 6)
# device-data phase: the relative distance allowed between the first-epoch
# losses of --device-data and the host pipeline (the same bf16 batches; CUDA's
# atomics in the backward make bit equality unlikely)
DEVICE_DATA_RTOL = 1e-3
# data-parallel phase: the ranks of the gloo run on the one card, and the
# relative distance allowed between their per-epoch losses and those of one
# process at the same global macro batch (fp32, no dropout: the JAX package's
# own 2-process bound), and between their validation MAE by horizon; their
# eval metrics against one process on the same checkpoint (MAE and RMSE
# relative, r and R^2 absolute), and their gathered predictions (scaled units)
DDP_RANKS, DDP_RTOL, DDP_MAE_RTOL, DDP_EVAL_TOL = 2, 2e-4, 2e-3, 1e-5
# the phase's time limit for one torchrun call
DDP_TIMEOUT_S = 400
# tensor-parallel phase: the ranks of the model group (dp 1 x mp TP_RANKS), and
# the relative distance allowed between their per-epoch losses and those of
# one process at the same global macro batch (fp32, no dropout: the JAX
# package's own tp bound); MAE and eval tolerances are the data-parallel ones
TP_RANKS, TP_RTOL = 2, 2e-4
# export phase: an artifact's forecasts against the checkpoint service of the
# same flags, in scaled units (the same kernels and arithmetic), and the serve
# CLI's --bench requests
EXPORT_TOL_SCALED, SERVE_CLI_BENCH = 1e-3, 4
# ablation phase, SARIMA: Adam steps of a fit; the fitted phi's node mean must
# lie within SARIMA_PHI_TOL of its truth (SARIMA_TRUTH), as the JAX package's
# recovery test asks
SARIMA_FIT_STEPS, SARIMA_PHI_TOL = 400, 0.15
# kernel_device_ms: the calls a kernel's device time is read over
DEVICE_REPS = 200
SARIMA_PROFILE_STEPS = 20
# ablation phase, the arms of phase 5's train step: the model's arguments and
# remat policy of each, its warm-up and timed steps
ARMS = {
    "default": ({}, None), "fuse_conv": ({"fuse_conv": True}, None), "lean_gn": ({"lean_gn": True}, None),
    "im2col_conv": ({"im2col_conv": True}, None), "two_pass_ln": ({"lean_ln": False}, None),
    "remat_full": ({}, "full"), "dots_saveable": ({}, "dots_saveable"),
}
ARM_WARMUP, ARM_STEPS = 2, 5
# DeepSeek-V2-Lite phase: the benchmark's cell whose configuration it runs, the
# seed of that cell's weights, the (train, val, test) windows of its processed
# dir, and the distance allowed between a Trainer step's loss and the
# reference's (the train cells' loss limit, benchmark/workloads/scale_up-train.json)
DSV2_CELL, DSV2_WEIGHT_SEED, DSV2_WINDOWS, DSV2_LOSS_GAP = "dsv2_lite-forecast", 20261018, (16, 2, 32), 0.035
# every dropout of ModelConfig at 0 (the gradient checks, the fp32 ranks, the
# arms and the DeepSeek-V2-Lite steps)
NO_DROPOUT = dict(gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, runs: int = TIMING_RUNS) -> float:
    """Device time of one call: the median over `runs` timings of CUDA events
    around `reps` back-to-back calls, divided by `reps`, after two warm-up
    calls. Back to back, the host issues the next call while the device runs
    this one, so a call's own host cost (Python, the launch) shows only where
    it exceeds its device time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, flop_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(log_text: str, source: str) -> list[dict]:
    """Registers, spills and shared memory of each kernel instance, from
    nvcc's -Xptxas -v log of csrc/<source>."""
    section = log_text.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    out, cur = [], None
    for line in section.splitlines():
        if "Compiling entry function" in line:
            cur = {"entry": line.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["stack_bytes"] = int(line.split("bytes stack frame")[0].split()[-1])
            cur["spill_store_bytes"] = int(line.split("bytes spill stores")[0].split(",")[-1])
            cur["spill_load_bytes"] = int(line.split("bytes spill loads")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
            if "bytes smem" in line:
                cur["static_smem_bytes"] = int(line.split("bytes smem")[0].split(",")[-1])
    return out


def ptxas_summary(log_text: str) -> list[str]:
    """One line per source from nvcc's -Xptxas -v log: kernels, registers, spills."""
    out, name, regs, spills = [], None, [], 0

    def flush():
        if name is not None:
            span = f"{min(regs)}-{max(regs)}" if regs else "?"
            out.append(f"{name}: {len(regs)} kernels, {span} registers, {spills} bytes spilled")

    for line in log_text.splitlines():
        line = line.strip()
        if line.startswith("== "):
            flush()
            name, regs, spills = line[3:], [], 0
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
        elif "spill stores" in line:
            spills += int(line.split("bytes spill stores")[0].split(",")[-1])
    flush()
    return out


def device_rows(events) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of the kernels and copies among profiler
    averages, largest first. A host op's device time repeats its kernels'
    times, and so does a user annotation on the device's timeline (such as
    ``Optimizer.step#AdamW.step``, which spans the optimizer's kernels)."""
    from torch.autograd import DeviceType

    rows = [
        (float(e.self_device_time_total) / 1e3, e.count, e.key)
        for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    return sorted(rows, reverse=True)


def profile_call(fn, top: int = 12, cpu_ops: bool = True) -> dict:
    """torch.profiler over one call of ``fn``: device time by kernel, the
    device's busy share of the call's wall time (kernels and copies run on one
    stream, so their times add without overlap), and the host's kernel
    launches (cudaLaunchKernel and cuLaunchKernel calls: count and host ms).
    ``cpu_ops=False`` leaves the host's operators out of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = device_rows(events)
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        raise RuntimeError("the profiler recorded no device time for a call on the card")
    launch_calls = [e for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "host_launches": sum(e.count for e in launch_calls),
        "host_launch_ms": sum(float(e.self_cpu_time_total) for e in launch_calls) / 1e3,
        "top": [{"ms": ms, "calls": c, "name": k[:120]} for ms, c, k in rows[:top]],
    }


def kernel_device_ms(fn, reps: int, kernels: tuple[str, ...]) -> tuple[float | None, int]:
    """One call's device time of the CUDA kernels whose names hold one of
    ``kernels`` (the first launched once a call), and the calls it was taken
    over: torch.profiler's CUDA kernel events (CUPTI) over ``reps`` calls of
    ``fn`` after two warm-up calls, summed and divided by the calls the trace
    saw. The host's cost of a call does not enter it. Late in a long process
    the trace can miss the first launches it should see, so many are traced;
    (None, 0) where it saw none: a time not measured, not a failed kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in device_rows(prof.key_averages()) if any(k in r[2] for k in kernels)]
    calls = sum(c for _, c, name in rows if kernels[0] in name)
    return (sum(ms for ms, _, _ in rows) / calls if calls else None), calls


class KernelCase(NamedTuple):
    """A row of the kernel table: a kernel (its launch-count name) at one
    shape, its wrapper's call (None where the wrapper never takes this form
    at this shape), its bare C entry (None where it has none), its plain
    version, a library call that computes the same function (or None), the
    bytes and operations the call needs, the peak FLOP/s of its arithmetic,
    and the CUDA kernels it launches (kernel_device_ms's ``kernels``);
    ``want``, the plain version the output is held to where it is not
    ``plain``, and ``rtol_of_max``, where set, the output's distance from it
    over its largest magnitude (instead of TOL["bf16"] elementwise)."""

    name: str
    label: str
    shape: str
    wrapper: Callable | None
    bare: Callable | None
    plain: Callable
    library: Callable | None
    bytes: float
    flops: float
    peak: float
    kernels: tuple[str, ...]
    plain_reps: int = REPS
    want: Callable | None = None
    rtol_of_max: float | None = None


def gat_case(graph, name: str, label: str, case: tuple, seed: int) -> KernelCase:
    """The stencil GAT's ``name`` form at a case of GAT_CASES (with the
    flagship's heads and channels) or GAT_GENERAL_CASES, in bf16; "forced"
    through the bare entry alone."""
    import torch

    from tec_mollm_tpu_torch import ops

    m, _, n, heads, channels = case
    xl, xr, valid, valid_plain, att, shifts = gat_inputs(graph, case, torch.bfloat16, torch.device("cuda"), seed)
    forced = label == "forced"
    hc = heads * channels
    return KernelCase(
        name, label, f"xl,xr ({m},{hc},{n}) bf16, {heads}x{channels}, {len(shifts)} offsets",
        wrapper=None if forced else (lambda: ops.gat_stencil_attention(xl, xr, valid, att, shifts)),
        bare=gat_bare_entry(xl, xr, valid, att, shifts, general=forced),
        plain=lambda: ops.gat_stencil_reference(xl, xr, valid_plain, att, shifts), library=None,
        bytes=3 * m * hc * n * 2 + valid.numel() + att.numel() * 4,
        # per valid (node, offset) pair and slice: add, leaky-relu, multiply-add
        # per channel for the score, exp, and a multiply-add per channel for the sum
        flops=m * int(valid_plain.sum()) * (hc * 5 + 2 * hc + 4),
        peak=PEAK_FLOPS["fp32"], kernels=(f"{name}_kernel",))


def attention_cases(seed: int) -> list[KernelCase]:
    """The short causal attention's forward and backward at the serve batch,
    with the training call's dropout; SDPA (its backward) the library call."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config

    heads = Config().resolved().model.llm_heads
    q, k, v, g = attention_inputs(torch.device("cuda"), seed)
    rows, t, d = q.shape
    hd = d // heads
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (a.reshape(rows, t, heads, hd).transpose(1, 2) for a in (q, k, v))
    g4 = g.reshape(rows, t, heads, hd).transpose(1, 2)
    leaves = [a.detach().requires_grad_() for a in (q4, k4, v4)]
    lib_out = sdpa(*leaves, is_causal=True, dropout_p=DROPOUT)
    pairs = t * (t + 1) // 2
    fwd = KernelCase(
        "short_attention", "path", f"q,k,v ({rows},{t},{d}) bf16, {heads} heads, dropout {DROPOUT}",
        wrapper=lambda: ops.short_attention_forward(q, k, v, heads, DROPOUT, DROPOUT_SEED), bare=None,
        plain=lambda: ops.short_causal_attention_reference(q, k, v, heads, DROPOUT, DROPOUT_SEED),
        library=lambda: sdpa(q4, k4, v4, is_causal=True, dropout_p=DROPOUT),
        bytes=4 * rows * t * d * 2, flops=rows * heads * pairs * hd * 4, peak=PEAK_FLOPS["fp32"],
        kernels=("short_attention_kernel",))
    bwd = KernelCase(
        "short_attention_bwd", "path",
        f"q,k,v,g ({rows},{t},{d}) -> dqkv ({rows},{t},{3 * d}), {heads} heads, dropout {DROPOUT}",
        wrapper=lambda: ops.short_attention_backward(q, k, v, g, heads, DROPOUT, DROPOUT_SEED), bare=None,
        plain=lambda: ops.short_causal_attention_backward_reference(q, k, v, g, heads, DROPOUT, DROPOUT_SEED),
        library=lambda: torch.autograd.grad(lib_out, leaves, g4, retain_graph=True),
        # per causal (query, key) pair and head: q.k, g.v, and the dv, dq, dk
        # multiply-adds, 2 * Dh each
        bytes=7 * rows * t * d * 2, flops=rows * heads * pairs * hd * 10, peak=PEAK_FLOPS["fp32"],
        kernels=("short_attention_bwd_kernel",))
    return [fwd, bwd]


def mlp_case(seed: int) -> KernelCase:
    """The fused LN -> MLP -> residual at the serve batch's rows."""
    import torch

    from tec_mollm_tpu_torch import ops

    rows = MLP_ROWS["path"]
    x, *weights = mlp_inputs(rows, torch.device("cuda"), seed)
    d, dh = weights[2].shape
    return KernelCase(
        "fused_mlp", "path", f"x ({rows},{d}) bf16, w1 ({d},{dh}), w2 ({dh},{d}) bf16",
        wrapper=lambda: ops.fused_ln_mlp(x, *weights), bare=None,
        plain=lambda: ops.fused_ln_mlp_reference(x, *weights), library=None,
        bytes=2 * rows * d * 2 + 2 * d * dh * 2 + (3 * d + dh) * 4, flops=4 * rows * d * dh,
        peak=PEAK_FLOPS["bf16_tensor"], kernels=("layer_norm_kernel", "gemm_kernel"))


def flash_case(seed: int) -> KernelCase:
    """Flash attention at the byte LM's pretraining batch without dropout,
    the function SDPA computes."""
    import torch

    from tec_mollm_tpu_torch import ops

    b, t, causal, hd, _ = FLASH_CASES["path"]
    q, k, v = flash_views(b, t, hd, torch.bfloat16, torch.device("cuda"), seed)
    q4, k4, v4 = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = t * (t + 1) // 2 if causal else t * t
    return KernelCase(
        "flash_attention", "path",
        f"q,k,v ({b},{t},{FLASH_HEADS},{hd}) bf16 views of ({b},{t},{3 * FLASH_HEADS * hd}), causal {causal}",
        wrapper=lambda: ops.flash_attention_forward(q, k, v, causal), bare=flash_bare_entry(q, k, v, causal),
        plain=lambda: ops.flash_attention_reference(q, k, v, causal),
        library=lambda: sdpa(q4, k4, v4, is_causal=causal),
        # q, k, v read and the output written once; q.k and p.v, 2 * Dh each
        bytes=4 * b * t * FLASH_HEADS * hd * 2, flops=b * FLASH_HEADS * pairs * hd * 4,
        peak=PEAK_FLOPS["bf16_tensor"], kernels=("flash_attention",))


def temporal_case() -> KernelCase:
    """The temporal encoder's conv blocks at the flagship eval batch (16
    windows x 2,944 padded nodes, as EvalExecutor runs it), on the (B, N, L,
    C) view of a (B, L, N, C) tensor as the model hands it; the plain blocks
    are the unfused MultiScaleConvBlock pair the model runs without it."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models.temporal import TemporalEncoder

    tc = importlib.import_module("tec_mollm_tpu_torch.ops.temporal_conv")  # ops.temporal_conv is the function
    cfg = Config().resolved().model
    dev = torch.device("cuda")
    enc = TemporalEncoder(cfg).to(dev).eval()
    wpack, params = tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16)
    b, n, length, cin = 2 * BATCH, PADDED_NODES, cfg.temporal_seq_len, cfg.spatial_channels
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(b, length, n, cin, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    rows = b * n
    c1, c2 = tc.CHANNELS
    taps = sum(tc.KERNEL_SIZES)

    @torch.no_grad()
    def plain():
        return enc.conv_embedder(x.reshape(-1, length, cin).transpose(1, 2)).transpose(1, 2)

    return KernelCase(
        "temporal_conv", "eval", f"x ({b},{n},{length},{cin}) bf16 view -> ({rows},{tc.OUT_LENGTH},{c2})",
        wrapper=lambda: ops.temporal_conv(x, wpack, params), bare=temporal_bare_entry(x, wpack, params),
        plain=plain, library=None,
        # the products' operations at each branch's own taps (benchmark/counts.py's
        # temporal.* terms), the input read and the output written once
        bytes=rows * (length * cin + tc.OUT_LENGTH * c2) * 2,
        flops=2 * rows * (length * cin * c1 * taps + length // 2 * 3 * c1 * c1
                          + length // 2 * c1 * c2 * taps + length // 4 * 3 * c2 * c2),
        peak=PEAK_FLOPS["bf16_tensor"], kernels=("temporal_conv_kernel",), plain_reps=5,
        want=lambda: tc.temporal_conv_mirror(x, wpack, params))


def ln_cases(seed: int) -> list[KernelCase]:
    """The add + LayerNorm with a residual at the eval and serve batches'
    residual streams; the plain version is the path the backbone runs
    without it (the add, then lean_layernorm), the library call the add and
    F.layer_norm on the bf16-cast affine."""
    import torch

    from tec_mollm_tpu_torch import ops

    cases = []
    for label in ("eval", "path"):
        rows = LN_ROWS[label]
        x, delta, w, b = ln_inputs(rows, torch.device("cuda"), seed)
        d = x.shape[-1]
        w16, b16 = w.bfloat16(), b.bfloat16()
        cases.append(KernelCase(
            "add_layernorm", label, f"x, delta ({rows},{d}) bf16, w, b ({d},) fp32 -> s, h ({rows},{d})",
            wrapper=lambda x=x, delta=delta, w=w, b=b: ops.add_layernorm(x, delta, w, b),
            bare=ln_bare_entry(x, delta, w, b),
            plain=lambda x=x, delta=delta, w=w, b=b: ops.add_layernorm_mirror(x, delta, w, b),
            library=lambda x=x, delta=delta, w16=w16, b16=b16, d=d: torch.nn.functional.layer_norm(
                x + delta, (d,), w16, b16, 1e-5),
            # x and delta read, s and h written once, the affine read once; per
            # element the add, two sums, the subtract and multiply, the affine
            bytes=4 * rows * d * 2 + 2 * d * 4, flops=8 * rows * d, peak=PEAK_FLOPS["fp32"],
            kernels=("add_layernorm_kernel",)))
    return cases


def sarima_cases(seed: int) -> list[KernelCase]:
    """The SARIMA fit's two kernels on the flagship series (sarima_inputs) and
    its forecast at SARIMA_BATCH and at SARIMA_FORECAST_LARGE windows; bytes:
    each input read once, each output written once."""
    import torch

    from tec_mollm_tpu_torch.ops import sarima as sops

    dev = torch.device("cuda")
    inp = sarima_inputs(seed, dev)
    y, coeffs, s, scale, horizon, L_in = (inp[k] for k in ("y", "coeffs", "season", "scale", "horizon", "L_in"))
    steps, n = y.shape
    e = sops.css_forward(y, coeffs, s)[0]
    arr = steps * n * 4
    fp32 = PEAK_FLOPS["fp32"]
    cases = [
        KernelCase(sops.FORWARD, "path", f"y ({steps},{n}) fp32, coeffs (4,{n}) -> e, partial",
                   wrapper=lambda: sops.css_forward(y, coeffs, s), bare=sarima_bare_entry(y, coeffs, s),
                   plain=lambda: sops.css_forward_reference(y, coeffs, s), library=None,
                   bytes=2 * arr + 20 * n, flops=14 * steps * n, peak=fp32, kernels=("css_forward_kernel",),
                   plain_reps=1, rtol_of_max=SARIMA_RTOL),
        KernelCase(sops.BACKWARD, "path", f"y, e ({steps},{n}) fp32, coeffs (4,{n}) -> grad (4,{n})",
                   wrapper=lambda: sops.css_backward(y, e, coeffs, s, scale),
                   bare=sarima_bare_entry(y, coeffs, s, e, scale),
                   plain=lambda: sops.css_backward_reference(y, e, coeffs, s, scale), library=None,
                   bytes=2 * arr + 32 * n, flops=20 * steps * n, peak=fp32, kernels=("css_backward_kernel",),
                   plain_reps=1, rtol_of_max=SARIMA_RTOL),
    ]
    for label, windows in (("path", SARIMA_BATCH), ("large", SARIMA_FORECAST_LARGE)):
        wins = sarima_windows(inp["series"], windows, L_in, dev)
        cases.append(KernelCase(
            sops.FORECAST, label, f"windows ({windows},{L_in},{n}) fp32 -> ({windows},{horizon},{n})",
            wrapper=lambda wins=wins: sops.forecast(wins, coeffs, horizon, s),
            bare=forecast_bare_entry(wins, coeffs, horizon, s),
            plain=lambda wins=wins: sops.forecast_reference(wins, coeffs, horizon, s), library=None,
            bytes=windows * (L_in + horizon) * n * 4 + 16 * n, flops=windows * n * 16 * (L_in + horizon),
            peak=fp32, kernels=("forecast_",), plain_reps=1, rtol_of_max=SARIMA_RTOL))
    return cases


def kernel_cases(graph, seed: int):
    """The kernel table's rows, one kernel's at a time (its inputs freed
    before the next's): a row for each of PERF.md's."""
    from tec_mollm_tpu_torch.config import Config

    cfg = Config().resolved().model
    hc = (cfg.spatial_heads, cfg.spatial_out_channels)
    for label in ("path", "eval"):
        yield gat_case(graph, "gat_stencil", label, (*GAT_CASES[label], *hc), seed)
    for label in ("path", "r450", "n2911", "forced"):
        yield gat_case(graph, "gat_stencil_general", label, GAT_GENERAL_CASES[label], seed)
    yield from attention_cases(seed)
    yield mlp_case(seed)
    yield flash_case(seed)
    yield temporal_case()
    yield from ln_cases(seed)
    yield from sarima_cases(seed)


def check_case(c: KernelCase) -> None:
    """The wrapper's output (the bare entry's where the wrapper does not
    take the case) against its plain version's; raises on a miss."""
    import torch

    with torch.no_grad():
        got, want = (c.wrapper or c.bare)(), (c.want or c.plain)()
    got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.float(), w.float()
        if c.rtol_of_max is None:
            atol, rtol = TOL["bf16"]
            miss = not bool(torch.isclose(g, w, rtol=rtol, atol=atol).all())
        else:
            miss = not float((g - w).abs().max()) <= c.rtol_of_max * float(w.abs().max())
        if miss or not bool(g.isfinite().all()):
            raise RuntimeError(f"kernel {c.name}[{c.label}]: output {i} differs from its plain version's by "
                               f"{float((g - w).abs().max()):.4e} at most")


def kernel_table(cases) -> list[dict]:
    """Each case's output checked (check_case), then its columns: its time
    through the wrapper and the bare entry, on the device's clock (the bare
    entry's where it has one), its bound and by what, its plain version's and
    the library call's times (ms)."""
    rows = []
    for c in cases:
        check_case(c)
        bound_ms, bound_by = bound(c.bytes, c.flops, c.peak)
        row = {"name": c.name, "label": c.label, "shape": c.shape,
               "ms": time_ms(c.wrapper, REPS) if c.wrapper else None,
               "bare_ms": time_ms(c.bare, REPS) if c.bare else None}
        row["device_ms"], row["device_calls"] = kernel_device_ms(c.bare or c.wrapper, DEVICE_REPS, c.kernels)
        row.update(bound_ms=bound_ms, bound_by=bound_by, plain_ms=time_ms(c.plain, c.plain_reps),
                   library_ms=time_ms(c.library, REPS) if c.library else None)

        def ms(key: str) -> str:
            return "-" if row[key] is None else f"{row[key]:.4f}"

        log(f"kernel {c.name}[{c.label}]: {c.shape}: wrapper {ms('ms')} ms, bare {ms('bare_ms')}, device "
            f"{ms('device_ms')} (over {row['device_calls']} of {DEVICE_REPS} calls), bound {bound_ms:.4f} "
            f"({bound_by}), plain {ms('plain_ms')}, library {ms('library_ms')}")
        rows.append(row)
    return rows


def write_processed_dir(path: str, graph, cfg, seed: int, steps: int) -> None:
    """A processed dir as the preprocess CLI writes it: the test split of
    `steps` timesteps, train and val splits of TRAINER_WINDOWS stride-1
    windows, graph.npz, target_scaler.npz and scaler.npz (the features': the
    rollout maps its forecasts back through it)."""
    from tec_mollm_tpu_torch.data.scaler import StandardScaler

    rng = np.random.default_rng(seed)
    n = cfg.model.num_nodes
    window = cfg.train.L_in + cfg.train.L_out - 1
    lengths = {"test": steps, "train": TRAINER_WINDOWS["train"] + window, "val": TRAINER_WINDOWS["val"] + window}
    for split, length in lengths.items():
        t = np.arange(length)
        # scaled TEC-like series: a diurnal cycle (12 steps a day) plus noise
        diurnal = np.sin(2 * np.pi * t / 12.0)[:, None]
        tec = (diurnal + 0.3 * rng.standard_normal((length, n))).astype(np.float32)
        x = np.concatenate(
            [tec[..., None], 0.5 * rng.standard_normal((length, n, cfg.model.in_features - 1))], axis=-1
        ).astype(np.float32)
        horizon = cfg.train.L_out
        y = np.stack([np.roll(tec, -h - 1, axis=0) for h in range(horizon)], axis=-1).astype(np.float32)
        tf = np.stack([t % 12, (t // 12) % 366, np.full_like(t, 11), ((t // 12) // 91) % 4], axis=-1)
        np.savez(os.path.join(path, f"{split}_set.npz"), X=x, Y=y, time_features=tf.astype(np.int32))
    graph.save(os.path.join(path, "graph.npz"))
    StandardScaler(mean=np.array([TARGET_MEAN]), scale=np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))
    others = cfg.model.in_features - 1
    StandardScaler(mean=np.r_[TARGET_MEAN, np.zeros(others)], scale=np.r_[TARGET_SCALE, np.ones(others)]).save(
        os.path.join(path, "scaler.npz"))


def drive_http(service, requests: list[list[int]], threads: int) -> tuple[dict, float]:
    """POST every request to a localhost server around `service`; returns
    ({tuple(indices): forecast}, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from tec_mollm_tpu_torch.serving import make_server

    httpd = make_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def post(idx: list[int]):
        body = json.dumps({"indices": idx, "split": "test"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/forecast", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return tuple(idx), np.asarray(out["forecast"], dtype=np.float64)

    try:
        t0 = time.perf_counter()
        serial, concurrent = requests[:4], requests[4:]
        results = [post(i) for i in serial]
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results += list(pool.map(post, concurrent))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    return dict(results), wall


def serve_phase(args, graph, data_dir: str) -> dict:
    """Phase 4: forecast requests over HTTP to ForecastService on the default
    path and with the opt-in kernels (no timings: the cell flagship-serve
    measures this path)."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
    from tec_mollm_tpu_torch.serving import ForecastService

    cfg = Config().resolved()  # bf16 compute, the flagship widths
    write_processed_dir(data_dir, graph, cfg, args.seed, STEPS)
    shifts, _ = graph_inputs(graph, "cpu")
    state = TECMoLLM(cfg.model, shifts, seed=args.seed).state_dict()

    rng = np.random.default_rng(args.seed)
    n_windows = STEPS - cfg.train.L_in - cfg.train.L_out + 1
    requests = [rng.integers(0, n_windows, size=int(rng.integers(1, 4))).tolist() for _ in range(REQUESTS)]
    paths = {}
    for path, flags in (("default", {}), ("fused", {"fused_attn": True, "use_fused_mlp": True})):
        service = ForecastService(cfg, data_dir, state_dict=state, max_batch=BATCH, **flags)
        try:
            ops.reset_counts()
            forecasts, _ = drive_http(service, requests, THREADS)
            counts = ops.launch_counts()
            forwards = service.stats().get("batches")
        finally:
            service.close()
        for idx, f in forecasts.items():
            if f.shape != (len(idx), cfg.train.L_out, cfg.model.num_nodes) or not np.isfinite(f).all():
                raise RuntimeError(f"{path}: forecast for {idx} has shape {f.shape} or is not finite")
        paths[path] = {"forecasts": forecasts, "launches": counts, "forwards": forwards}
        log(f"serve[{path}]: {len(requests)} requests in {forwards} device batches; launches {counts}")

    need = {"default": ("gat_stencil", "temporal_conv"),
            "fused": ("gat_stencil", "temporal_conv", "short_attention", "fused_mlp")}
    for path, names in need.items():
        missing = [k for k, v in launched(paths[path]["launches"], *names).items() if not v]
        if missing:
            raise RuntimeError(f"serve[{path}] never launched {missing}")
    if any(launched(paths["default"]["launches"], *OPT_IN).values()):
        raise RuntimeError(f"serve[default] launched an opt-in kernel: {paths['default']['launches']}")

    # the two paths against each other, and against an fp32 forward of the plain path
    a, b = paths["default"]["forecasts"], paths["fused"]["forecasts"]
    diff_paths = max(float(np.abs(a[k] - b[k]).max()) for k in a) / TARGET_SCALE
    first = requests[0]
    ref_model = TECMoLLM(cfg.model, shifts, dtype=torch.float32, gat_kernel=False)
    ref_model.load_state_dict(state)
    ref_model = ref_model.to("cuda").eval()
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset

    ds = SlidingWindowDataset.from_dir(data_dir, "test", cfg.train.L_in, cfg.train.L_out)
    batch = ds.gather_batch(np.asarray(first))
    _, graph_pair = graph_inputs(graph, "cuda")
    with torch.inference_mode():
        ref = ref_model(
            torch.from_numpy(batch["x"]).cuda(), torch.from_numpy(batch["time_features"]).cuda(), *graph_pair
        )[..., 0].cpu().numpy().astype(np.float64)
    ref = np.clip(ref * TARGET_SCALE + TARGET_MEAN, 0.0, 200.0)
    diff_ref = float(np.abs(a[tuple(first)] - ref).max()) / TARGET_SCALE
    log(
        f"serve check: fused vs default max |diff| {diff_paths:.4e}, default (bf16, kernels) vs "
        f"fp32 plain path {diff_ref:.4e} (scaled units; tol {SERVE_TOL_SCALED})"
    )
    if not (diff_paths <= SERVE_TOL_SCALED and diff_ref <= SERVE_TOL_SCALED):
        raise RuntimeError("served forecasts disagree beyond the stated tolerance")
    for p in paths.values():
        del p["forecasts"]
    return {**paths, "max_abs_diff_fused_vs_default_scaled": diff_paths,
            "max_abs_diff_default_vs_fp32_plain_scaled": diff_ref, "tol_scaled": SERVE_TOL_SCALED}


def grad_check(args, cfg) -> dict:
    """One step's gradients with every dropout at 0, at GRAD_BATCH windows:
    through the kernels in bf16 (frozen weights in bf16), against an fp32 step
    on the plain path. The bf16 plain path against the same fp32 step is the
    yardstick of what bf16 alone costs. lora_B is redrawn (it starts at zero,
    which would zero lora_A's gradient)."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
    from tec_mollm_tpu_torch.training import create_train_state, make_sum_loss_fn

    dev = torch.device("cuda")
    m = dataclasses.replace(cfg.model, **NO_DROPOUT)
    cfg = dataclasses.replace(cfg, model=m, train=dataclasses.replace(cfg.train, batch_size=GRAD_BATCH, accumulation_steps=1))
    shifts, graph_pair = graph_inputs(build_graph(*grid_coordinates(m.grid_h, m.grid_w)), dev)
    base = TECMoLLM(m, shifts, seed=args.seed).state_dict()
    gen = torch.Generator().manual_seed(args.seed + 1)
    for name in base:
        if name.endswith("lora_B.weight"):
            base[name] = torch.randn(base[name].shape, generator=gen) * 0.02
    split = synthetic_processed_split(GRAD_BATCH + 1, cfg.train.L_in, cfg.train.L_out, m.num_nodes, seed=args.seed)
    ds = SlidingWindowDataset(split, cfg.train.L_in, cfg.train.L_out)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in ds.gather_batch(np.arange(GRAD_BATCH)).items()}

    def gradients(dtype, fused: bool):
        model = TECMoLLM(m, shifts, dtype=dtype, fused_attn=fused).to(dev)
        model.load_state_dict(base)
        state, _ = create_train_state(model, cfg, frozen_dtype=torch.bfloat16 if dtype == torch.bfloat16 else None)
        model.train()
        wsum, count = make_sum_loss_fn(model, cfg)(batch, graph_pair)
        loss = wsum / count
        loss.backward()
        return {n: p.grad.float() for n, p in state.trainable().items()}, float(loss.detach())

    ops.reset_counts()
    kernel, loss_kernel = gradients(torch.bfloat16, True)
    counts = ops.launch_counts()
    ref, loss_ref = gradients(torch.float32, False)
    plain16, loss_plain16 = gradients(torch.bfloat16, False)

    def worst(a: dict, b: dict) -> tuple[float, str]:
        return max((float((a[n] - b[n]).abs().max() / (b[n].abs().max() + 1e-12)), n) for n in b)

    (rel_kernel, name_kernel), (rel_plain16, name_plain16) = worst(kernel, ref), worst(plain16, ref)
    rel_same_dtype = worst(kernel, plain16)[0]
    out = {
        "batch": GRAD_BATCH, "tensors": len(ref), "launches": counts,
        "loss_kernel_bf16": loss_kernel, "loss_plain_fp32": loss_ref, "loss_plain_bf16": loss_plain16,
        "max_rel_diff_kernel_bf16_vs_plain_fp32": rel_kernel, "worst_tensor_kernel": name_kernel,
        "max_rel_diff_plain_bf16_vs_plain_fp32": rel_plain16, "worst_tensor_plain_bf16": name_plain16,
        "max_rel_diff_kernel_bf16_vs_plain_bf16": rel_same_dtype,
        "tol": GRAD_TOL,
    }
    log(
        f"grad check (dropout 0, B={GRAD_BATCH}, {len(ref)} trainable tensors): loss kernel bf16 {loss_kernel:.6f}, "
        f"plain fp32 {loss_ref:.6f}, plain bf16 {loss_plain16:.6f}; largest per-tensor relative difference "
        f"from fp32: kernels bf16 {rel_kernel:.4e} ({name_kernel}), plain bf16 {rel_plain16:.4e} "
        f"({name_plain16}); kernels against the plain path, both bf16: {rel_same_dtype:.4e}; tol {GRAD_TOL}; "
        f"launches {counts}"
    )
    if counts.get("short_attention_bwd", 0) != m.llm_layers:
        raise RuntimeError(f"grad check: the backward kernel ran {counts} times, not once a block")
    if not rel_kernel <= GRAD_TOL:
        raise RuntimeError(f"grad check: kernel-path gradients differ by {rel_kernel:.4e} > {GRAD_TOL}")
    return out


def train_phase(args) -> dict:
    """The port's bench train step at flagship width: Config() at B = 8 x
    accumulation 1, bf16 with the frozen weights in bf16, fused_attn=True,
    every dropout at its default 0.1."""
    import torch

    from tec_mollm_tpu_torch import bench, ops

    cfg = bench.bench_config("default")
    run = bench.setup(cfg, torch.device("cuda"), fused_attn=True, seed=args.seed)
    frozen0 = {n: p.clone() for n, p in run.state.frozen().items()}
    trainable0 = {n: p.clone() for n, p in run.state.trainable().items()}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    metrics = [run.step() for _ in range(TRAIN_WARMUP)]
    run.sync()
    t0 = time.perf_counter()
    metrics += [run.step() for _ in range(TRAIN_STEPS)]
    run.sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_call(run.step, top=25)
    steps = TRAIN_WARMUP + TRAIN_STEPS + 1
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    frozen_same = all(torch.equal(p, frozen0[n]) for n, p in run.state.frozen().items())
    unchanged = [n for n, p in run.state.trainable().items() if torch.equal(p, trainable0[n])]
    out = {
        "batch": run.windows_per_step, "accumulation": cfg.train.accumulation_steps, "steps_timed": TRAIN_STEPS,
        "warmup": TRAIN_WARMUP, "step_ms": wall / TRAIN_STEPS * 1e3,
        "windows_per_s": run.windows_per_step * TRAIN_STEPS / wall, "peak_memory_gb": peak_gb,
        "launches": counts, "launches_per_step": {k: v / (TRAIN_WARMUP + TRAIN_STEPS) for k, v in counts.items()},
        "losses": losses, "grad_norms": norms, "frozen_tensors": len(frozen0), "trainable_tensors": len(trainable0),
        "frozen_bit_identical": frozen_same, "trainable_unchanged": unchanged, "profile": prof,
    }
    log(
        f"train: Config() B={run.windows_per_step} x accum {cfg.train.accumulation_steps}, bf16 (frozen bf16), "
        f"fused_attn, dropout 0.1: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: step {out['step_ms']:.2f} ms, "
        f"{out['windows_per_s']:.2f} train windows/s; peak memory {peak_gb:.2f} GB; launches {counts}"
    )
    log(f"train: losses {[round(x, 5) for x in losses]}; grad norms {[round(x, 4) for x in norms]}")
    log(
        f"profile[train step]: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {prof['device_busy_share']:.2%})"
    )
    for row in prof["top"][:10]:
        log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")
    log(f"train: {steps} steps; frozen tensors ({len(frozen0)}) bit-identical: {frozen_same}; "
        f"trainable tensors unchanged: {len(unchanged)} of {len(trainable0)}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise RuntimeError("train: a loss or gradient norm is not finite")
    if not frozen_same or unchanged:
        raise RuntimeError(f"train: frozen tensors moved ({not frozen_same}) or trainable ones did not ({unchanged})")
    n = TRAIN_WARMUP + TRAIN_STEPS
    for name in ("short_attention", "short_attention_bwd"):
        if counts.get(name, 0) != cfg.model.llm_layers * n:
            raise RuntimeError(f"train: {name} launched {counts.get(name, 0)} times in {n} steps")
    out["grad_check"] = grad_check(args, cfg)
    return out


def serve_requests(service, requests: list[list[int]]) -> tuple[dict, dict]:
    """({tuple(indices): forecast in TECU}, launch counts) of `requests` sent
    to `service` one after another, counted from zero."""
    from tec_mollm_tpu_torch import ops

    ops.reset_counts()
    out = {tuple(idx): np.asarray(service.forecast(idx)["forecast"], dtype=np.float64) for idx in requests}
    return out, ops.launch_counts()


def epoch_timings(trainer, cpu_ops: bool = True) -> dict:
    """A trainer's epoch times: a warm-up epoch (first calls), then an epoch
    timed without checkpoints (a default run saves none mid-epoch), its macro
    steps on batches already on the card, and one profiled epoch; the device
    time the profiler records over the unprofiled epoch's wall time is the
    busy share without the profiler's own host cost. ``cpu_ops=False``
    records the card's activity alone (kernels, copies, runtime calls),
    which the profiler summarises in a fraction of the time."""
    import torch

    t_start = time.perf_counter()
    trainer.train_epoch(checkpoints=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = trainer.train_epoch(checkpoints=False)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    staged = [trainer._put(b) for b in trainer.train_loader]
    step_ms = []
    for _ in range(2):
        for b in staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, _ = trainer._train_step(trainer.state, b, trainer.graph)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    del staged
    t_profile = time.perf_counter()
    prof = profile_call(lambda: trainer.train_epoch(checkpoints=False), top=100_000, cpu_ops=cpu_ops)
    t_end = time.perf_counter()
    copies = {
        kind: sum(r["ms"] for r in prof["top"] if r["name"].startswith(f"Memcpy {kind}"))
        for kind in ("HtoD", "DtoH")
    }
    prof["top"] = prof["top"][:12]
    return {"timed": timed, "epoch_ms": epoch_ms, "step_ms_all": step_ms, "staged_step_ms": statistics.median(step_ms),
            "profile": prof, "copies_ms": copies, "busy_unprofiled": prof["device_ms"] / epoch_ms,
            "wall_s": {"epochs_and_steps": t_profile - t_start, "profiled_epoch": t_end - t_profile}}


def trainer_phase(args, graph, data_dir: str, train_windows_per_s: float) -> dict:
    """The training CLI at flagship width (see the module docstring, phase 6):
    run A trains TRAINER_EPOCHS epochs; run B stops after TRAINER_STOP_AFTER
    macro steps through fit's SIGTERM handler and resumes; the best checkpoint
    is served with the stencil graph and with a graph without a stencil; a
    config the GAT kernel does not take serves on the plain path."""
    import signal
    import shutil

    import torch

    from tec_mollm_tpu_torch import ops, train
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models import TECMoLLM
    from tec_mollm_tpu_torch.serving import ForecastService

    cfg = Config().resolved()
    macro = cfg.train.batch_size * cfg.train.accumulation_steps
    steps_per_epoch = -(-TRAINER_WINDOWS["train"] // macro)
    val_batches = -(-TRAINER_WINDOWS["val"] // cfg.train.batch_size)
    work = os.path.join(data_dir, "work")

    def argv(run: str, *extra: str) -> list[str]:
        return ["--data-dir", data_dir, "--workdir", work, "--run-name", run, "--train-stride", "1",
                "--val-stride", "1", "--epochs", str(TRAINER_EPOCHS),
                "--checkpoint-every-steps", str(TRAINER_CKPT_EVERY), "--seed", str(args.seed), *extra]

    def saved_step(run: str) -> int:
        blob = torch.load(os.path.join(work, "checkpoints", run, "latest.pt"), map_location="cpu", weights_only=True)
        return int(blob["step"])

    # --- run A: the CLI in-process, every launch counted ---
    ops.reset_counts()
    t0 = time.perf_counter()
    hist_a = train.main(argv("a"))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts_a = ops.launch_counts()
    run_a = os.path.join(work, "checkpoints", "a")
    files_a = sorted(os.listdir(run_a))
    want_files = ["best_params.pt", "config.json", "latest.meta.json", "latest.pt"]
    losses_a = [(r["train_loss"], r["val_loss"]) for r in hist_a]
    log(
        f"trainer[A]: Config() B={cfg.train.batch_size} x accum {cfg.train.accumulation_steps}, bf16, "
        f"{TRAINER_WINDOWS['train']} train / {TRAINER_WINDOWS['val']} val windows, {len(hist_a)} epochs in "
        f"{wall_a:.1f} s; (train, val) losses {losses_a}; launches {counts_a}; files {files_a}"
    )
    if len(hist_a) != TRAINER_EPOCHS or not np.isfinite(np.asarray(losses_a)).all():
        raise RuntimeError(f"trainer[A]: history {hist_a}")
    if files_a != want_files:
        raise RuntimeError(f"trainer[A]: checkpoint dir holds {files_a}, want {want_files}")
    want_a = {"gat_stencil": TRAINER_EPOCHS * val_batches, "gat_stencil_general": 0,
              "temporal_conv": TRAINER_EPOCHS * val_batches, **dict.fromkeys(OPT_IN, 0)}
    if launched(counts_a, *want_a) != want_a:
        raise RuntimeError(f"trainer[A]: launches {counts_a}, want {want_a} (one a validation forward)")

    # --- run B: stopped by SIGTERM after TRAINER_STOP_AFTER macro steps, then --resume ---
    args_b = train.parse_args(argv("b"))
    trainer_b = train.build_trainer(args_b, train.build_config(args_b))
    step, part_losses = trainer_b._train_step, []

    def step_then_signal(*a):
        state, metrics = step(*a)
        part_losses.append(float(metrics["loss"]))
        if len(part_losses) == TRAINER_STOP_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)  # fit's handler sets the stop flag
        return state, metrics

    trainer_b._train_step = step_then_signal
    if train.run(trainer_b, args_b, trainer_b.cfg):
        raise RuntimeError("trainer[B]: the stopped run wrote a history record")
    with open(os.path.join(work, "checkpoints", "b", "latest.meta.json")) as f:
        meta_b = json.load(f)
    del trainer_b
    ops.reset_counts()
    hist_b = train.main(argv("b", "--resume"))
    counts_b = ops.launch_counts()
    updates_a, updates_b = saved_step("a"), saved_step("b")
    # run B's epoch 0 loss: its first part's steps and the resumed steps
    resumed = hist_b[0]["updates"]
    first_b = (sum(part_losses) + hist_b[0]["train_loss"] * resumed) / (len(part_losses) + resumed)
    pairs = [(first_b, hist_a[0]["train_loss"])] + [(b["train_loss"], a["train_loss"]) for a, b in zip(hist_a[1:], hist_b[1:])]
    pairs += [(b["val_loss"], a["val_loss"]) for a, b in zip(hist_a, hist_b)]
    rel = max(abs(b - a) / abs(a) for b, a in pairs)
    log(
        f"trainer[B]: stopped at epoch {meta_b['epoch']} step {meta_b['step_in_epoch']} (losses {part_losses}); "
        f"resumed: {[(r['epoch'], r['updates']) for r in hist_b]} (epoch, updates); updates A {updates_a}, "
        f"B {updates_b}; largest relative loss difference from A {rel:.3e} (tol {RESUME_RTOL}); launches {counts_b}"
    )
    if (meta_b["epoch"], meta_b["step_in_epoch"]) != (0, TRAINER_STOP_AFTER):
        raise RuntimeError(f"trainer[B]: stopped at {meta_b}, want epoch 0 step {TRAINER_STOP_AFTER}")
    if resumed != steps_per_epoch - TRAINER_STOP_AFTER or len(hist_b) != TRAINER_EPOCHS:
        raise RuntimeError(f"trainer[B]: the resumed run did not start at step {TRAINER_STOP_AFTER}: {hist_b}")
    if updates_a != updates_b or updates_a != TRAINER_EPOCHS * steps_per_epoch:
        raise RuntimeError(f"trainer[B]: {updates_b} updates, run A {updates_a}")
    if not rel <= RESUME_RTOL:
        raise RuntimeError(f"trainer[B]: losses differ from run A by {rel:.3e} > {RESUME_RTOL}")

    # --- one more trainer: epoch times (epoch_timings), validation, save and restore ---
    args_c = train.parse_args(argv("c"))
    trainer_c = train.build_trainer(args_c, train.build_config(args_c))
    timing = epoch_timings(trainer_c)
    timed, epoch_ms, step_ms, staged_step_ms, prof, copies, busy_unprofiled = (timing[k] for k in (
        "timed", "epoch_ms", "step_ms_all", "staged_step_ms", "profile", "copies_ms", "busy_unprofiled"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val_kernel = trainer_c.validate()
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3 / val_batches
    # the same validation with the GAT on its plain path: same weights, same batches
    ops.reset_counts()
    trainer_c.model.gat_kernel = False
    val_plain = trainer_c.validate()
    trainer_c.model.gat_kernel = True
    if any(launched(ops.launch_counts(), *GAT).values()):
        raise RuntimeError(f"trainer: the plain validation launched {ops.launch_counts()}")
    val_rel = abs(val_kernel[0] - val_plain[0]) / abs(val_plain[0])
    mae_diff = float(np.abs(np.asarray(val_kernel[1]["mae_by_horizon"]) - np.asarray(val_plain[1]["mae_by_horizon"])).max())
    t0 = time.perf_counter()
    trainer_c._save_latest(step_in_epoch=0)
    save_ms = (time.perf_counter() - t0) * 1e3
    latest_mb = os.path.getsize(trainer_c.ckpt.path("latest")) / 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer_c.ckpt.restore_state(trainer_c.state, "latest")
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    del trainer_c
    epoch_wps = [r["windows_per_sec"] for r in hist_a]
    log(
        f"trainer: windows/s by epoch (run A, a checkpoint every {TRAINER_CKPT_EVERY} macro steps) "
        f"{[round(w, 2) for w in epoch_wps]}; a warm epoch without checkpoints {epoch_ms:.1f} ms = "
        f"{timed['windows_per_sec']:.2f} windows/s; its macro step on batches already on the card "
        f"{staged_step_ms:.1f} ms (median of {len(step_ms)}) = {macro / staged_step_ms * 1e3:.2f} windows/s; "
        f"the train phase's bare step {train_windows_per_s:.2f}; validation {val_ms:.2f} ms a batch of "
        f"{cfg.train.batch_size}; latest.pt save {save_ms:.1f} ms, {latest_mb:.1f} MB; resume (restore) "
        f"{resume_ms:.1f} ms"
    )
    log(
        f"trainer validation, GAT kernel vs plain on the same weights: val loss {val_kernel[0]:.6f} vs "
        f"{val_plain[0]:.6f} (relative {val_rel:.3e}, tol {VAL_RTOL}); max |MAE by horizon diff| {mae_diff:.3e} TECU"
    )
    log(
        f"profile[trainer epoch]: {steps_per_epoch} macro steps, no checkpoint; wall {prof['wall_ms']:.2f} ms "
        f"(under the profiler), device {prof['device_ms']:.2f} ms (busy {prof['device_busy_share']:.2%}; over the "
        f"unprofiled epoch's wall {busy_unprofiled:.2%}); copies HtoD {copies['HtoD']:.2f} ms, DtoH "
        f"{copies['DtoH']:.2f} ms; {prof['host_launches']} kernel launches taking {prof['host_launch_ms']:.2f} ms "
        f"of host time"
    )
    for row in prof["top"][:10]:
        log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")
    if not val_rel <= VAL_RTOL:
        raise RuntimeError(f"trainer: validation through the GAT kernel differs from the plain path by {val_rel:.3e}")

    # --- serve run A's best checkpoint: the stencil graph, a graph without one ---
    best = os.path.join(run_a, "best_params.pt")
    rng = np.random.default_rng(args.seed + 2)
    n_windows = STEPS - cfg.train.L_in - cfg.train.L_out + 1
    requests = [rng.integers(0, n_windows, size=int(rng.integers(1, 4))).tolist() for _ in range(4)]
    padded_dir = os.path.join(data_dir, "padded_graph")
    os.makedirs(padded_dir)
    for name in ("test_set.npz", "target_scaler.npz"):
        shutil.copy(os.path.join(data_dir, name), padded_dir)
    dataclasses.replace(graph, stencil_shifts=None, stencil_valid=None).save(os.path.join(padded_dir, "graph.npz"))
    served = {}
    for label, d in (("stencil", data_dir), ("padded", padded_dir)):
        service = ForecastService(cfg, d, checkpoint=best, max_batch=BATCH, batch_window_ms=0)
        try:
            forecasts, counts = serve_requests(service, requests)
            route = service.stats()["gat_route"]
        finally:
            service.close()
        served[label] = {"forecasts": forecasts, "launches": counts, "route": route}
    diff = max(float(np.abs(served["stencil"]["forecasts"][k] - served["padded"]["forecasts"][k]).max())
               for k in served["stencil"]["forecasts"]) / TARGET_SCALE
    finite = all(np.isfinite(f).all() for s in served.values() for f in s["forecasts"].values())
    log(
        f"trainer serve: best_params.pt, {len(requests)} requests; stencil route {served['stencil']['route']!r}, "
        f"launches {served['stencil']['launches']}; padded route {served['padded']['route']!r}, launches "
        f"{served['padded']['launches']}; max |stencil - padded| {diff:.4e} scaled (tol {SERVE_TOL_SCALED}); "
        f"finite {finite}"
    )
    stencil_gat = launched(served["stencil"]["launches"], *GAT)
    if not finite or served["stencil"]["route"] != "kernel" or not stencil_gat["gat_stencil"] or stencil_gat[
            "gat_stencil_general"]:
        raise RuntimeError(f"trainer serve: stencil service {served['stencil']['route']}, {served['stencil']['launches']}")
    if any(launched(served["padded"]["launches"], *GAT).values()) or not diff <= SERVE_TOL_SCALED:
        raise RuntimeError(f"trainer serve: padded graph launched {served['padded']['launches']} or differs by {diff}")

    # --- a config the JAX package takes and the tiled kernel does not: 1 head x
    # 22 channels, through the kernel's general form, against its plain path ---
    m = dataclasses.replace(cfg.model, spatial_heads=1, spatial_out_channels=22)
    cfg_122 = dataclasses.replace(cfg, model=m)
    state = TECMoLLM(m, tuple(int(s) for s in graph.stencil_shifts), seed=args.seed).state_dict()
    service = ForecastService(cfg_122, data_dir, state_dict=state, max_batch=BATCH, batch_window_ms=0)
    try:
        forecasts, counts_122 = serve_requests(service, requests)
        route_122 = service.stats()["gat_route"]
        service.model.gat_kernel = False
        plain_122, counts_plain = serve_requests(service, requests)
    finally:
        service.close()
    finite_122 = all(np.isfinite(f).all() for f in forecasts.values())
    diff_122 = max(float(np.abs(forecasts[k] - plain_122[k]).max()) for k in forecasts) / TARGET_SCALE
    log(
        f"trainer serve (1 head x 22 channels): route {route_122!r}; launches {counts_122}; finite {finite_122}; "
        f"max |kernel - plain GAT| {diff_122:.4e} scaled (tol {SERVE_TOL_SCALED}); plain launches {counts_plain}"
    )
    gat_122 = launched(counts_122, *GAT)
    if (not route_122.startswith("kernel, general form: ") or "1x22" not in route_122
            or gat_122["gat_stencil"] or not gat_122["gat_stencil_general"] or any(launched(counts_plain, *GAT).values())
            or not finite_122 or not diff_122 <= SERVE_TOL_SCALED):
        raise RuntimeError(f"general form: route {route_122!r}, launches {counts_122}, finite {finite_122}, "
                           f"diff {diff_122}")

    for s in served.values():
        del s["forecasts"]
    return {
        "history_a": hist_a, "history_b": hist_b, "stop_meta_b": meta_b, "part_losses_b": part_losses,
        "updates": {"a": updates_a, "b": updates_b}, "max_rel_loss_diff_b_vs_a": rel, "rtol": RESUME_RTOL,
        "wall_s_a": wall_a, "launches": counts_a, "launches_resumed_b": counts_b,
        "windows_per_s_by_epoch": epoch_wps, "train_phase_windows_per_s": train_windows_per_s,
        "val_ms_per_batch": val_ms, "latest_save_ms": save_ms, "latest_mb": latest_mb, "resume_ms": resume_ms,
        "profile_epoch": prof, "profile_epoch_copies_ms": copies, "serve": served, "serve_max_abs_diff_padded_scaled": diff,
        "route_1x22": route_122, "launches_1x22": counts_122, "max_abs_diff_1x22_plain_scaled": diff_122,
        "epoch_ms_no_checkpoint": epoch_ms, "windows_per_s_no_checkpoint": timed["windows_per_sec"],
        "staged_macro_step_ms": staged_step_ms, "staged_macro_step_ms_all": step_ms,
        "device_busy_share_unprofiled_wall": busy_unprofiled,
        "val_loss_kernel": val_kernel[0], "val_loss_plain": val_plain[0], "val_rel_diff": val_rel,
        "val_mae_by_horizon_max_diff": mae_diff,
    }


def preprocess_phase(args, data_dir: str) -> dict:
    """The preprocess CLI at the 41 x 71 grid (phase 9): PREPROCESS_STEPS
    synthetic steps, then the same with an outage under the segment cadence
    policy; the CLI's wall time, the files it writes and the raw series'
    bytes."""
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.preprocess import main as preprocess

    train_cfg = Config().resolved().train
    out = {}
    for label, extra in (("plain", []), ("gap", ["--synthetic-drop", *map(str, PREPROCESS_DROP),
                                                  "--cadence-policy", "segment"])):
        path = os.path.join(data_dir, f"archive_{label}")
        t0 = time.perf_counter()
        sizes = preprocess(["--synthetic", str(PREPROCESS_STEPS), "--out", path, *extra])
        wall = time.perf_counter() - t0
        files = {n: os.path.getsize(os.path.join(path, n)) for n in sorted(os.listdir(path))}
        raw_bytes = sum(v for n, v in files.items() if n.endswith("_raw.npz"))
        windows = {
            split: len(SlidingWindowDataset.from_dir(path, split, train_cfg.L_in, train_cfg.L_out))
            for split in ("train", "val", "test")
        }
        with np.load(os.path.join(path, "train_raw.npz")) as raw:
            segmented = "segment_id" in raw.files
        out[label] = {"dir": path, "wall_s": wall, "sizes": sizes, "files": files, "raw_npz_bytes": raw_bytes,
                      "stride1_windows": windows, "segment_id": segmented}
        log(
            f"preprocess[{label}]: --synthetic {PREPROCESS_STEPS} {' '.join(extra)} on 41x71: CLI {wall:.2f} s; "
            f"timesteps {sizes}; stride-1 windows {windows}; *_raw.npz {raw_bytes / 1e6:.2f} MB of "
            f"{sum(files.values()) / 1e6:.1f} MB written; files {files}"
        )
        if segmented != (label == "gap") or min(windows.values()) <= 16:
            raise RuntimeError(f"preprocess[{label}]: segment ids {segmented}, windows {windows}")
    if not sum(out["gap"]["stride1_windows"].values()) < sum(out["plain"]["stride1_windows"].values()):
        raise RuntimeError("preprocess: the outage dropped no window")
    return out


def device_data_phase(args, archive: str) -> dict:
    """The train CLI on the preprocessed archive (phase 10), host pipeline and
    --device-data, at phase 6's policy and cut (B = 2 x 6, 2 epochs, about
    TRAINER_WINDOWS train and val windows by stride): first-epoch losses
    within DEVICE_DATA_RTOL, one GAT launch per validation batch and nothing
    else, a gathered fp32 batch within 1e-6 of the host mirror; then each
    mode's warm epoch (windows/s, busy share of a profiled epoch over the
    unprofiled wall) on a fresh trainer."""
    import torch

    from tec_mollm_tpu_torch import ops, train
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset

    cfg = Config().resolved()
    L_in, L_out = cfg.train.L_in, cfg.train.L_out
    strides = {
        split: max(1, len(SlidingWindowDataset.from_dir(archive, split, L_in, L_out)) // TRAINER_WINDOWS[split])
        for split in ("train", "val")
    }
    val_windows = len(SlidingWindowDataset.from_dir(archive, "val", L_in, L_out, stride=strides["val"]))
    val_batches = -(-val_windows // cfg.train.batch_size)
    work = os.path.join(archive, "work")

    def argv(run: str, *extra: str) -> list[str]:
        return ["--data-dir", archive, "--workdir", work, "--run-name", run, "--epochs", str(TRAINER_EPOCHS),
                "--train-stride", str(strides["train"]), "--val-stride", str(strides["val"]),
                "--seed", str(args.seed), *extra]

    runs = {}
    for mode, extra in (("host", []), ("device", ["--device-data"])):
        ops.reset_counts()
        t0 = time.perf_counter()
        hist = train.main(argv(mode, *extra))
        torch.cuda.synchronize()
        runs[mode] = {"history": hist, "wall_s": time.perf_counter() - t0, "launches": ops.launch_counts()}
    rel = max(
        abs(runs["device"]["history"][0][k] - runs["host"]["history"][0][k]) / abs(runs["host"]["history"][0][k])
        for k in ("train_loss", "val_loss")
    )
    want_launches = {"gat_stencil": TRAINER_EPOCHS * val_batches, "gat_stencil_general": 0,
                     **dict.fromkeys(OPT_IN, 0)}

    # a gathered batch against the host mirror, fp32
    dev_ds = DeviceResidentDataset(archive, "train", L_in, L_out, stride=strides["train"])
    val_ds = DeviceResidentDataset(archive, "val", L_in, L_out, stride=strides["val"])
    split = dev_ds.device_split("cuda", torch.float32)
    idxs = np.arange(min(cfg.train.batch_size * cfg.train.accumulation_steps, len(dev_ds)))
    got = split.gather(torch.as_tensor(dev_ds.sample_indices[idxs], device="cuda"))
    want = dev_ds.gather_batch(idxs)
    gather_err = max(float((got[k].cpu() - torch.from_numpy(want[k])).abs().max()) for k in ("x", "y"))
    tf_same = bool(torch.equal(got["time_features"].cpu(), torch.from_numpy(want["time_features"])))
    resident_bytes = dev_ds.nbytes() + val_ds.nbytes()
    del split, got

    # each mode's warm epoch on a fresh trainer: a warm-up epoch, a timed one, a profiled one
    timing = {}
    for mode, extra in (("host", []), ("device", ["--device-data"])):
        a = train.parse_args(argv(f"{mode}_t", *extra))
        trainer = train.build_trainer(a, train.build_config(a))
        trainer.train_epoch(checkpoints=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_epoch(checkpoints=False)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_call(lambda: trainer.train_epoch(checkpoints=False), top=100_000)
        copies = sum(r["ms"] for r in prof["top"] if r["name"].startswith("Memcpy HtoD"))
        prof["top"] = prof["top"][:8]
        timing[mode] = {"epoch_ms": epoch_ms, "windows_per_s": stats["windows_per_sec"],
                        "busy_share_unprofiled_wall": prof["device_ms"] / epoch_ms, "htod_ms": copies,
                        "profile": prof}
        del trainer
    log(
        f"device data: train CLI on {archive} (strides {strides}, {len(dev_ds)} train / {val_windows} val windows, "
        f"B={cfg.train.batch_size} x accum {cfg.train.accumulation_steps}, {TRAINER_EPOCHS} epochs): host "
        f"{runs['host']['wall_s']:.1f} s, --device-data {runs['device']['wall_s']:.1f} s; first-epoch (train, val) "
        f"losses host {[round(runs['host']['history'][0][k], 6) for k in ('train_loss', 'val_loss')]}, device "
        f"{[round(runs['device']['history'][0][k], 6) for k in ('train_loss', 'val_loss')]} (largest relative "
        f"difference {rel:.3e}, tol {DEVICE_DATA_RTOL}); launches host {runs['host']['launches']}, device "
        f"{runs['device']['launches']} (want {want_launches})"
    )
    log(
        f"device data: resident {resident_bytes / 1e6:.2f} MB (train + val raw series and time features); a "
        f"gathered fp32 batch of {len(idxs)} vs the host mirror max |diff| {gather_err:.3e} (tol 1e-6), time "
        f"features identical {tf_same}; warm epoch host {timing['host']['windows_per_s']:.2f} windows/s (busy "
        f"{timing['host']['busy_share_unprofiled_wall']:.2%}, HtoD {timing['host']['htod_ms']:.2f} ms), device "
        f"{timing['device']['windows_per_s']:.2f} windows/s (busy {timing['device']['busy_share_unprofiled_wall']:.2%}, "
        f"HtoD {timing['device']['htod_ms']:.2f} ms)"
    )
    if not rel <= DEVICE_DATA_RTOL or not gather_err <= 1e-6 or not tf_same:
        raise RuntimeError(f"device data: losses {rel:.3e}, gather {gather_err:.3e}, time features {tf_same}")
    for mode, r in runs.items():
        if launched(r["launches"], *want_launches) != want_launches or len(r["history"]) != TRAINER_EPOCHS:
            raise RuntimeError(f"device data[{mode}]: launches {r['launches']}, want {want_launches}; {r['history']}")
    return {
        "strides": strides, "train_windows": len(dev_ds), "val_windows": val_windows, "val_batches": val_batches,
        "runs": runs, "max_rel_first_epoch_loss_diff": rel, "rtol": DEVICE_DATA_RTOL,
        "resident_bytes": resident_bytes, "gather_max_abs_err": gather_err, "timing": timing,
        "launches": runs["device"]["launches"],
    }


def export_phase(args, data_dir: str) -> dict:
    """Export phase 6's run A best_params.pt with the export CLI (phase 11):
    the default path and the fused config, each with a symbolic batch and at
    --batch-size 8; plus a default artifact traced on the CPU for both
    platforms and served on the card. Each artifact's op nodes (GAT 1, and 3
    attention and 3 MLP in a fused one; no aten.roll), its export and load
    wall and size; 16 HTTP requests through ForecastService(artifact=...)
    against the checkpoint service of the same flags (within
    EXPORT_TOL_SCALED), with exactly one GAT launch per forward and 3
    attention and 3 MLP per fused forward; and the serve CLI's --artifact
    --bench."""
    import contextlib
    import io

    import torch

    from tec_mollm_tpu_torch import export as export_cli
    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch import serve as serve_cli
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.serving import ForecastService
    from tec_mollm_tpu_torch.serving.export import artifact_ops, load_exported

    cfg = Config().resolved()
    layers = cfg.model.llm_layers
    best = os.path.join(data_dir, "work", "checkpoints", "a", "best_params.pt")
    out_dir = os.path.join(data_dir, "exports")
    rng = np.random.default_rng(args.seed + 3)
    n_windows = STEPS - cfg.train.L_in - cfg.train.L_out + 1
    requests = [rng.integers(0, n_windows, size=int(rng.integers(1, 4))).tolist() for _ in range(REQUESTS)]
    fused_flags = {"fused_attn": True, "use_fused_mlp": True}

    def serve_http(service) -> dict:
        ops.reset_counts()
        forecasts, wall = drive_http(service, requests, THREADS)
        counts = ops.launch_counts()
        stats = service.stats()
        full = service.datasets["test"].gather_batch(np.arange(BATCH))
        fwd = []
        for _ in range(5):
            t0 = time.perf_counter()
            service._run_padded(full, BATCH)
            fwd.append(time.perf_counter() - t0)
        return {"forecasts": forecasts, "launches": counts, "stats": stats, "wall_s": wall,
                "batch_forward_ms": statistics.median(fwd) * 1e3}

    # the checkpoint services the artifacts are held to, one per flag set
    reference = {}
    for path, flags in (("default", {}), ("fused", fused_flags)):
        service = ForecastService(cfg, data_dir, checkpoint=best, max_batch=BATCH, **flags)
        try:
            reference[path] = serve_http(service)
        finally:
            service.close()
    # traced on the CPU, an artifact holds the plain conv blocks and
    # LayerNorms (the temporal and add + LayerNorm kernels take CUDA tensors):
    # its reference runs the same
    from tec_mollm_tpu_torch.models import gpt2, temporal

    devices, temporal.KERNEL_DEVICES, gpt2.KERNEL_DEVICES = temporal.KERNEL_DEVICES, (), ()
    service = ForecastService(cfg, data_dir, checkpoint=best, max_batch=BATCH)
    try:
        reference["plain_blocks"] = serve_http(service)
    finally:
        service.close()
        temporal.KERNEL_DEVICES = gpt2.KERNEL_DEVICES = devices

    cases = {
        "default": ([], "default"), "default_b8": (["--batch-size", str(BATCH)], "default"),
        "fused": (["--fused"], "fused"), "fused_b8": (["--fused", "--batch-size", str(BATCH)], "fused"),
        "cpu_traced": (["--cpu", "--platforms", "cpu", "cuda"], "plain_blocks"),
    }
    results, failures = {}, []
    for label, (extra, ref) in cases.items():
        t0 = time.perf_counter()
        art = export_cli.main(["--data-dir", data_dir, "--checkpoint", best, "--out",
                               os.path.join(out_dir, f"{label}.pt2"), *extra])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ep = load_exported(art, "cuda")
        load_s = time.perf_counter() - t0
        node_ops = artifact_ops(ep)
        del ep
        custom = {k: v for k, v in node_ops.items() if k.startswith("tec_mollm.")}
        fused = layers if ref == "fused" else 0
        # traced on the card: the temporal and add + LayerNorm ops (2 L + 1,
        # or L + 1 beside the fused MLP); on the CPU: the plain blocks and norms
        temporal_op = int(label != "cpu_traced")
        norms = temporal_op * (layers + 1 if ref == "fused" else 2 * layers + 1)
        per_forward = {"gat_stencil": 1, "gat_stencil_general": 0, "short_attention": fused, "fused_mlp": fused,
                       "temporal_conv": temporal_op, "add_layernorm": norms}
        want_nodes = {"tec_mollm.gat_stencil": 1, "tec_mollm.short_attention": fused,
                      "tec_mollm.fused_ln_mlp": fused, "tec_mollm.temporal_conv": temporal_op,
                      "tec_mollm.add_layernorm": norms}
        service = ForecastService(cfg, data_dir, artifact=art, max_batch=BATCH)
        try:
            served = serve_http(service)
            health = service.health()
        finally:
            service.close()
        forwards = served["stats"]["batches"]
        want = {k: v * forwards for k, v in per_forward.items()}
        diff = max(float(np.abs(served["forecasts"][k] - reference[ref]["forecasts"][k]).max())
                   for k in reference[ref]["forecasts"]) / TARGET_SCALE
        finite = all(np.isfinite(f).all() for f in served["forecasts"].values())
        results[label] = {
            "export_s": export_s, "pt2_bytes": os.path.getsize(art), "load_s": load_s, "custom_op_nodes": custom,
            "roll_nodes": node_ops.get("aten.roll", 0), "launches": served["launches"], "forwards": forwards,
            "max_abs_diff_vs_checkpoint_scaled": diff, "batch_forward_ms": served["batch_forward_ms"],
            "p50_ms": served["stats"].get("p50_ms"), "p95_ms": served["stats"].get("p95_ms"),
            "wall_s": served["wall_s"], "source": health["source"], "gat_route": health["gat_route"],
            "max_batch": health["max_batch"],
        }
        log(
            f"export[{label}]: {' '.join(extra) or 'symbolic batch'}: export {export_s:.2f} s, .pt2 "
            f"{os.path.getsize(art) / 1e6:.1f} MB, load {load_s:.2f} s; custom-op nodes {custom}, aten.roll "
            f"{node_ops.get('aten.roll', 0)}; {len(requests)} requests in {served['wall_s']:.3f} s, p50 "
            f"{served['stats'].get('p50_ms')} ms, p95 {served['stats'].get('p95_ms')} ms (checkpoint service "
            f"{reference[ref]['stats'].get('p50_ms')} / {reference[ref]['stats'].get('p95_ms')} ms); full batch of "
            f"{BATCH} {served['batch_forward_ms']:.2f} ms (checkpoint {reference[ref]['batch_forward_ms']:.2f} ms); "
            f"{forwards} forwards, launches {served['launches']} (want {want}); max |artifact - checkpoint| "
            f"{diff:.3e} scaled (tol {EXPORT_TOL_SCALED}); finite {finite}"
        )
        if {k: custom.get(k, 0) for k in want_nodes} != want_nodes or node_ops.get("aten.roll", 0):
            failures.append(f"{label}: op nodes {custom}, roll {node_ops.get('aten.roll', 0)}, want {want_nodes}")
        if launched(served["launches"], *want) != want or not forwards:
            failures.append(f"{label}: launches {served['launches']} in {forwards} forwards, want {want}")
        if not diff <= EXPORT_TOL_SCALED or not finite or health["source"] != "artifact":
            failures.append(f"{label}: artifact vs checkpoint {diff}, finite {finite}, source {health['source']}")

    # the serve CLI on the default artifact: a warm-up and SERVE_CLI_BENCH requests, one GAT launch each
    ops.reset_counts()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        serve_cli.main(["--data-dir", data_dir, "--checkpoint", best, "--artifact",
                        os.path.join(out_dir, "default.pt2"), "--bench", str(SERVE_CLI_BENCH)])
    cli_counts = ops.launch_counts()
    cli_stats = json.loads(stdout.getvalue().strip().splitlines()[-1])
    log(f"serve --artifact --bench {SERVE_CLI_BENCH}: {cli_stats}; launches {cli_counts}")
    want_cli = {"gat_stencil": SERVE_CLI_BENCH + 1, "gat_stencil_general": 0, "temporal_conv": SERVE_CLI_BENCH + 1}
    if launched(cli_counts, *want_cli) != want_cli or cli_stats.get("source") != "artifact":
        failures.append(f"serve CLI: launches {cli_counts}, stats {cli_stats}")
    if failures:
        raise RuntimeError(f"export phase: {failures}")
    launches: dict[str, int] = {}
    for r in results.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for p in reference.values():
        del p["forecasts"]
    torch.cuda.synchronize()
    return {"artifacts": results, "checkpoint_services": reference, "serve_cli": cli_stats,
            "serve_cli_launches": cli_counts, "launches": launches, "tol_scaled": EXPORT_TOL_SCALED}


def torchrun(job: dict, nproc: int, path: str) -> list[dict]:
    """Run this script as ``nproc`` ranks of ``job`` under torchrun
    (``--ddp-rank``, see ddp_rank) and return each rank's record. The ranks
    run in a session of their own, killed whole if the call outlives
    DDP_TIMEOUT_S; a rank that fails fails the phase."""
    import signal

    with open(path, "w") as f:
        json.dump(job, f)
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           os.path.abspath(__file__), "--ddp-rank", path]
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        output, _ = proc.communicate(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        output, _ = proc.communicate()
        raise RuntimeError(f"torchrun outlived {DDP_TIMEOUT_S} s:\n{output[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun exited {proc.returncode}:\n{output[-6000:]}")
    records = []
    for r in range(nproc):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def ddp_rank(job_path: str) -> int:
    """One rank of phase 12 or 13 under torchrun: join the group (NCCL, or
    the job's backend; the job's model_parallel), train through the train
    CLI's functions with --multihost, count this process's launches, then, as
    the job asks, phase 13's extras (tensor_parallel_rank), time the warm
    epoch of a second DDP trainer and evaluate the best checkpoint; write
    <out>/rank<r>.json (and .npz)."""
    import torch

    from tec_mollm_tpu_torch import ops, parallel, train
    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.graph import GraphData
    from tec_mollm_tpu_torch.utils.logging import setup_logging

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(job_path) as f:
        job = json.load(f)
    parallel.init_distributed(backend=job.get("backend"), model_parallel=job.get("model_parallel", 1))
    rank = parallel.rank()
    setup_logging(process_index=rank)
    out: dict = {"rank": rank, "world": parallel.world_size(), "device": str(parallel.local_device()),
                 "backend": torch.distributed.get_backend()}
    arrays = {}
    try:
        argv = job["argv"] + ["--multihost"]
        ops.reset_counts()
        t0 = time.perf_counter()
        if job.get("cli"):
            out["history"] = train.main(argv)
        else:
            targs = train.parse_args(argv)
            trainer = train.build_trainer(targs, train.build_config(targs))
            out["history"] = train.run(trainer, targs, trainer.cfg)
            out["val_batches"] = len(trainer.val_loader)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = ops.launch_counts()
        if not job.get("cli"):
            val_loss, metrics = trainer.validate()
            out["validate"] = {"val_loss": val_loss, **metrics}
            if job.get("tensor_parallel"):
                tensor_parallel_rank(trainer, job, out, arrays)
            del trainer
        if job.get("timing"):
            t0 = time.perf_counter()
            targs = train.parse_args(job["timing_argv"] + ["--multihost"])
            timed_trainer = train.build_trainer(targs, train.build_config(targs))
            build_s = time.perf_counter() - t0
            timing = epoch_timings(timed_trainer, cpu_ops=False)
            out["timing"] = {k: timing[k] for k in ("epoch_ms", "staged_step_ms", "busy_unprofiled", "copies_ms",
                                                    "wall_s")}
            out["timing"]["wall_s"]["build_trainer"] = build_s
            out["timing"]["ddp_vs_bare_step_ms"] = ddp_vs_bare_step(timed_trainer)
            out["timing"]["windows_per_s"] = timing["timed"]["windows_per_sec"]
            out["timing"]["profile"] = timing["profile"]
        if job.get("eval"):
            t_eval = time.perf_counter()
            cfg, ckpt, data_dir = train.build_config(train.parse_args(job["argv"])), job["eval"]["checkpoint"], \
                job["eval"]["data_dir"]
            ops.reset_counts()
            dev = parallel.local_device()
            ev = harness.run_evaluation(cfg, data_dir, ckpt, output_dir=job["eval"]["output_dir"],
                                        batch_size=job["eval"]["batch_size"], device=dev)
            val = SlidingWindowDataset.from_dir(data_dir, "val", cfg.train.L_in, cfg.train.L_out, stride=1)
            graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
            trues, preds = harness.get_model_predictions(
                cfg, harness.load_params_for_eval(cfg, ckpt), val, graph, batch_size=job["eval"]["batch_size"],
                device=dev)
            torch.cuda.synchronize()
            out["launches_eval"] = ops.launch_counts()
            out["eval"] = ev["results"]
            out["eval_wall_s"] = time.perf_counter() - t_eval
            arrays.update(preds=preds, trues=trues)
    finally:
        parallel.destroy()
    os.makedirs(job["out"], exist_ok=True)
    if arrays:
        np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **arrays)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def tensor_parallel_rank(trainer, job: dict, out: dict, arrays: dict) -> None:
    """Phase 13's extras on a rank of a split trainer: its c_attn slice's
    shape, the whole parameters after the fit (rank 0's ``param:<name>``), a copy of
    the epoch-boundary checkpoint (run ``<run>_epoch``) for the resume at
    mp 1, then the last macro step of one more epoch, whose checkpoint
    (every TRAINER_CKPT_EVERY steps) makes ``latest`` a mid-epoch checkpoint
    of this layout."""
    import shutil

    import torch

    from tec_mollm_tpu_torch import parallel

    out["c_attn_shape"] = list(trainer.model.llm_backbone.model.h[0].attn.c_attn.weight.shape)
    whole = trainer.full_state_dict()  # collective: every rank gathers
    if parallel.rank() == 0:
        for k, v in whole.items():
            arrays[f"param:{k}"] = v.detach().to("cpu", torch.float32, copy=True).numpy()  # not the live tensor
        shutil.copytree(trainer.ckpt.dir, trainer.ckpt.dir + "_epoch")
    parallel.barrier("tp_epoch_copy")
    steps = len(trainer.train_loader)
    trainer.epoch += 1
    stats = trainer.train_epoch(start_step=steps - 1)
    torch.cuda.synchronize()
    out["mid_epoch"] = {"steps_in_epoch": stats["steps_in_epoch"], "epoch": trainer.epoch}


def ddp_vs_bare_step(trainer) -> dict:
    """DDP's cost on one card: the median macro step of a DDP trainer on
    batches already on the card, through DDP and through the same model
    without it (make_train_step on the bare module, whose DDP hooks stay
    idle without DDP's forward), in turns ddp, bare, bare, ddp."""
    import torch

    from tec_mollm_tpu_torch.training.train_state import make_train_step

    steps = {"ddp": trainer._train_step, "bare": make_train_step(trainer.model, trainer.cfg)}
    staged = [trainer._put(b) for b in trainer.train_loader]
    ms: dict = {"ddp": [], "bare": []}
    for name in ("ddp", "bare", "bare", "ddp"):
        for b in staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, _ = steps[name](trainer.state, b, trainer.graph)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in ms.items()}


def eval_gap(got: dict, want: dict) -> tuple[float, float]:
    """(largest relative MAE / RMSE distance, largest absolute R^2 / r
    distance) between two run_evaluation results, over both rows."""
    rel = max(abs(got[m][k] - want[m][k]) / abs(want[m][k]) for m in want for k in ("mae_avg", "rmse_avg"))
    rel = max([rel] + [float(np.max(np.abs(np.asarray(got[m]["mae_by_horizon"]) - want[m]["mae_by_horizon"])
                                     / np.abs(want[m]["mae_by_horizon"]))) for m in want])
    absolute = max(abs(got[m][k] - want[m][k]) for m in want for k in ("r2_score_avg", "pearson_r_avg"))
    return rel, absolute


def data_parallel_phase(args, data_dir: str, trainer: dict) -> dict:
    """Data parallelism at phase 6's width and cut (see the module docstring,
    phase 12): (a) the train CLI under torchrun with --multihost, NCCL at
    world 1, against phase 6's run A; (b) DDP_RANKS gloo ranks on the one card
    against one process at the same global macro batch, then the evaluation
    library on the ranks against one process on the same checkpoint."""
    import torch

    from tec_mollm_tpu_torch import ops, train
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.graph import GraphData

    phase_t0 = time.perf_counter()
    cfg = Config().resolved()
    work = os.path.join(data_dir, "work")
    ddp_dir = os.path.join(data_dir, "ddp")
    os.makedirs(ddp_dir)
    common = ["--data-dir", data_dir, "--workdir", work, "--train-stride", "1", "--val-stride", "1",
              "--epochs", str(TRAINER_EPOCHS), "--seed", str(args.seed)]
    val_batches = -(-TRAINER_WINDOWS["val"] // cfg.train.batch_size)

    # --- (a) NCCL, world 1: phase 6's run A flags (bf16, dropout 0.1) ---
    job_a = {"cli": True, "out": os.path.join(ddp_dir, "a"), "timing": True,
             "argv": common + ["--run-name", "ddp_a", "--checkpoint-every-steps", str(TRAINER_CKPT_EVERY)],
             "timing_argv": common + ["--run-name", "ddp_a_timing"]}
    walls = {}
    t0 = time.perf_counter()
    (a,) = torchrun(job_a, 1, os.path.join(ddp_dir, "a.json"))
    walls["a"] = time.perf_counter() - t0
    hist_a = trainer["history_a"]
    pairs = [(g[k], w[k]) for g, w in zip(a["history"], hist_a) for k in ("train_loss", "val_loss")]
    rel_a = max(abs(g - w) / abs(w) for g, w in pairs)
    ta = a["timing"]
    log(
        f"ddp[a]: torchrun --nproc_per_node 1, train CLI --multihost on {a['backend']} ({a['device']}), "
        f"{len(a['history'])} epochs in {a['wall_s']:.1f} s; (train, val) losses "
        f"{[(r['train_loss'], r['val_loss']) for r in a['history']]}, largest relative difference from phase 6's "
        f"run A {rel_a:.3e} (tol {RESUME_RTOL}); launches {a['launches']}"
    )
    log(
        f"ddp[a]: windows/s by epoch {[round(r['windows_per_sec'], 2) for r in a['history']]} (run A "
        f"{[round(w, 2) for w in trainer['windows_per_s_by_epoch']]}); a warm DDP epoch without checkpoints "
        f"{ta['epoch_ms']:.1f} ms = {ta['windows_per_s']:.2f} windows/s (phase 6: "
        f"{trainer['windows_per_s_no_checkpoint']:.2f}); staged macro step {ta['staged_step_ms']:.1f} ms (phase 6: "
        f"{trainer['staged_macro_step_ms']:.1f}); busy {ta['busy_unprofiled']:.2%} over the unprofiled wall "
        f"(phase 6: {trainer['device_busy_share_unprofiled_wall']:.2%}); {ta['profile']['host_launches']} kernel "
        f"launches an epoch; in the rank's process, the staged macro step through DDP "
        f"{ta['ddp_vs_bare_step_ms']['ddp']:.1f} ms and without it {ta['ddp_vs_bare_step_ms']['bare']:.1f} ms "
        f"(medians of 8, in turns)"
    )
    if a["backend"] != "nccl" or len(a["history"]) != TRAINER_EPOCHS or not rel_a <= RESUME_RTOL:
        raise RuntimeError(f"ddp[a]: backend {a['backend']}, history {a['history']}, distance {rel_a}")
    want_a = {"gat_stencil": TRAINER_EPOCHS * val_batches, "gat_stencil_general": 0, **dict.fromkeys(OPT_IN, 0)}
    if launched(a["launches"], *want_a) != want_a:
        raise RuntimeError(f"ddp[a]: launches {a['launches']}, want {want_a}")

    # --- (b) DDP_RANKS gloo ranks on the one card, fp32 and no dropout, against one process ---
    m = dataclasses.replace(cfg.model, **NO_DROPOUT)
    fp32 = dataclasses.replace(cfg, model=m, train=dataclasses.replace(cfg.train, bf16=False))
    cfg_path = os.path.join(ddp_dir, "fp32.json")
    with open(cfg_path, "w") as f:
        f.write(fp32.to_json())
    per_rank = cfg.train.batch_size // DDP_RANKS
    argv_b = common + ["--config", cfg_path]
    ckpt = os.path.join(work, "checkpoints", "ddp_b", "best_params.pt")
    eval_batch = 16
    job_b = {"backend": "gloo", "out": os.path.join(ddp_dir, "b"), "argv": argv_b + [
        "--run-name", "ddp_b", "--batch-size", str(per_rank)],
        "eval": {"checkpoint": ckpt, "data_dir": data_dir, "batch_size": eval_batch,
                 "output_dir": os.path.join(ddp_dir, "b_results")}}
    t0 = time.perf_counter()
    ranks = torchrun(job_b, DDP_RANKS, os.path.join(ddp_dir, "b.json"))
    walls["b"] = time.perf_counter() - t0
    # one process, the same global macro batch
    t0 = time.perf_counter()
    ops.reset_counts()
    targs = train.parse_args(argv_b + ["--run-name", "ddp_b1", "--batch-size", str(per_rank * DDP_RANKS)])
    one = train.build_trainer(targs, train.build_config(targs))
    hist_1 = train.run(one, targs, one.cfg)
    val_1 = one.validate()
    del one
    counts_1 = ops.launch_counts()
    walls["b_one_process"] = time.perf_counter() - t0
    pairs = [(g[k], w[k]) for r in ranks for g, w in zip(r["history"], hist_1) for k in ("train_loss", "val_loss")]
    rel_b = max(abs(g - w) / abs(w) for g, w in pairs)
    mae_b = max(float(np.max(np.abs(np.asarray(r["validate"]["mae_by_horizon"]) - val_1[1]["mae_by_horizon"])
                             / np.abs(val_1[1]["mae_by_horizon"]))) for r in ranks)
    gat_b = [r["launches"].get("gat_stencil", 0) for r in ranks]
    want_gat = [TRAINER_EPOCHS * r["val_batches"] for r in ranks]
    log(
        f"ddp[b]: {DDP_RANKS} ranks on {ranks[0]['backend']} ({[r['device'] for r in ranks]}), Config() fp32 "
        f"without dropout at batch {per_rank} x accumulation {cfg.train.accumulation_steps} a rank, in "
        f"{max(r['wall_s'] for r in ranks):.1f} s; (train, val) losses {[(h['train_loss'], h['val_loss']) for h in ranks[0]['history']]} "
        f"against one process at batch {per_rank * DDP_RANKS}: {[(h['train_loss'], h['val_loss']) for h in hist_1]}; "
        f"largest relative difference {rel_b:.3e} (tol {DDP_RTOL}); validation MAE by horizon {mae_b:.3e} "
        f"(tol {DDP_MAE_RTOL}); GAT launches by rank {gat_b} (want {want_gat}: {TRAINER_EPOCHS} epochs x each "
        f"rank's validation batches, {sum(want_gat)} in all; one process {counts_1})"
    )
    losses = [[(h["train_loss"], h["val_loss"]) for h in r["history"]] for r in ranks]
    if any(got != losses[0] for got in losses) or any(r["validate"] != ranks[0]["validate"] for r in ranks):
        raise RuntimeError(f"ddp[b]: the ranks report different losses {losses}")
    if not (rel_b <= DDP_RTOL and mae_b <= DDP_MAE_RTOL):
        raise RuntimeError(f"ddp[b]: losses {rel_b:.3e} or MAE {mae_b:.3e} from one process")
    if gat_b != want_gat or any(
            any(launched(r["launches"], "gat_stencil_general", *OPT_IN).values()) for r in ranks):
        raise RuntimeError(f"ddp[b]: launches {[r['launches'] for r in ranks]}, want gat_stencil {want_gat}")
    if counts_1.get("gat_stencil", 0) != TRAINER_EPOCHS * val_batches + val_batches:
        raise RuntimeError(f"ddp[b]: the one-process run launched {counts_1}")

    # --- evaluation of the ranks' best checkpoint: the ranks against one process ---
    t0 = time.perf_counter()
    ev_1 = harness.run_evaluation(fp32, data_dir, ckpt, output_dir=os.path.join(ddp_dir, "b1_results"),
                                  batch_size=eval_batch)["results"]
    val_ds = SlidingWindowDataset.from_dir(data_dir, "val", cfg.train.L_in, cfg.train.L_out, stride=1)
    trues_1, preds_1 = harness.get_model_predictions(
        fp32, harness.load_params_for_eval(fp32, ckpt), val_ds, GraphData.load(os.path.join(data_dir, "graph.npz")),
        batch_size=eval_batch)
    walls["b_eval_one_process"] = time.perf_counter() - t0
    rank_arrays = []
    for r in range(DDP_RANKS):
        with np.load(os.path.join(job_b["out"], f"rank{r}.npz")) as d:
            rank_arrays.append(dict(d))
    same = all(r["eval"] == ranks[0]["eval"] for r in ranks) and all(
        np.array_equal(a["preds"], rank_arrays[0]["preds"]) for a in rank_arrays)
    rel_ev, abs_ev = eval_gap(ranks[0]["eval"], ev_1)
    pred_diff = float(np.abs(rank_arrays[0]["preds"] - preds_1).max())
    true_same = np.array_equal(rank_arrays[0]["trues"], trues_1)
    test_windows = len(SlidingWindowDataset.from_dir(data_dir, "test", cfg.train.L_in, cfg.train.L_out, stride=1))
    per = eval_batch // DDP_RANKS

    def batches_a_rank(windows: int) -> int:  # a rank's strided shard, padded, in batches of per
        return -(-(-(-windows // DDP_RANKS)) // per)

    want_eval = batches_a_rank(test_windows) + batches_a_rank(len(val_ds))
    gat_eval = [r["launches_eval"].get("gat_stencil", 0) for r in ranks]
    log(
        f"ddp[b] eval: run_evaluation ({test_windows} test windows, batch {eval_batch} = {DDP_RANKS} x {per}) and "
        f"get_model_predictions ({len(val_ds)} val windows) on the ranks' best_params.pt; the ranks agree "
        f"{same}; against one process: MAE/RMSE relative {rel_ev:.3e}, R2/r absolute {abs_ev:.3e} (tol "
        f"{DDP_EVAL_TOL}); predictions max |diff| {pred_diff:.3e} scaled, in window order {pred_diff <= DDP_EVAL_TOL}, "
        f"targets identical {true_same}; GAT launches by rank {gat_eval} (want {want_eval} each)"
    )
    if not (same and true_same and rel_ev <= DDP_EVAL_TOL and abs_ev <= DDP_EVAL_TOL and pred_diff <= DDP_EVAL_TOL):
        raise RuntimeError("ddp[b] eval: the ranks disagree with each other or with one process")
    if gat_eval != [want_eval] * DDP_RANKS:
        raise RuntimeError(f"ddp[b] eval: launches {[r['launches_eval'] for r in ranks]}")

    launches: dict[str, int] = {}
    for counts in [a["launches"]] + [r["launches"] for r in ranks] + [r["launches_eval"] for r in ranks]:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_s = time.perf_counter() - phase_t0
    log(f"ddp: phase {phase_s:.1f} s (walls {({k: round(v, 1) for k, v in walls.items()})}; rank a's timing "
        f"{({k: round(v, 1) for k, v in a['timing']['wall_s'].items()})}, ranks' eval "
        f"{[round(r['eval_wall_s'], 1) for r in ranks]}); launches over its ranks {launches}")
    return {
        "phase_s": phase_s, "walls_s": walls, "launches": launches, "a": a, "a_max_rel_loss_diff_vs_run_a": rel_a,
        "b_ranks": ranks, "b_one_process_history": hist_1, "b_max_rel_loss_diff": rel_b,
        "b_val_mae_by_horizon_max_rel_diff": mae_b, "b_gat_launches_by_rank": gat_b,
        "b_one_process_validate": {"val_loss": val_1[0], **val_1[1]}, "b_argv": argv_b, "b_config": fp32,
        "b_eval_one_process": ev_1, "b_eval_rel_diff": rel_ev, "b_eval_abs_diff_r": abs_ev,
        "b_pred_max_abs_diff": pred_diff, "b_eval_gat_launches_by_rank": gat_eval,
    }


def tp_job(argv: list[str], out: str, backend: str, eval_spec: dict) -> dict:
    """A phase 13 torchrun job: the trainer split over a model group of
    TP_RANKS, then the evaluation library on its best checkpoint."""
    return {"backend": backend, "model_parallel": TP_RANKS, "tensor_parallel": True, "out": out,
            "argv": argv + ["--model-parallel", str(TP_RANKS)], "eval": eval_spec}


def check_tp_ranks(name: str, ranks: list[dict], hist_1: list[dict], val_1: dict, want_val: int,
                   want_eval: int) -> dict:
    """Hold the split ranks to one process (losses within TP_RTOL, validation
    MAE by horizon within DDP_MAE_RTOL), to each other (the same numbers on
    every rank), and count their GAT launches; raise on any miss."""
    pairs = [(g[k], w[k]) for r in ranks for g, w in zip(r["history"], hist_1) for k in ("train_loss", "val_loss")]
    rel = max(abs(g - w) / abs(w) for g, w in pairs)
    mae = max(float(np.max(np.abs(np.asarray(r["validate"]["mae_by_horizon"]) - val_1["mae_by_horizon"])
                            / np.abs(val_1["mae_by_horizon"]))) for r in ranks)
    gat = [r["launches"].get("gat_stencil", 0) for r in ranks]
    gat_eval = [r["launches_eval"].get("gat_stencil", 0) for r in ranks]
    log(
        f"tp[{name}]: {len(ranks)} ranks dp 1 x mp {TP_RANKS} on {ranks[0]['backend']} "
        f"({[r['device'] for r in ranks]}) in {max(r['wall_s'] for r in ranks):.1f} s; c_attn slices "
        f"{[r['c_attn_shape'] for r in ranks]}; (train, val) losses "
        f"{[(h['train_loss'], h['val_loss']) for h in ranks[0]['history']]} against one process "
        f"{[(h['train_loss'], h['val_loss']) for h in hist_1]}: largest relative difference {rel:.3e} (tol "
        f"{TP_RTOL}); validation MAE by horizon {mae:.3e} (tol {DDP_MAE_RTOL}); GAT launches by rank {gat} "
        f"(want {want_val} each) and in evaluation {gat_eval} (want {want_eval} each); windows/s by epoch "
        f"{[round(h['windows_per_sec'], 2) for h in ranks[0]['history']]} against one process "
        f"{[round(h['windows_per_sec'], 2) for h in hist_1]}"
    )
    losses = [[(h["train_loss"], h["val_loss"]) for h in r["history"]] for r in ranks]
    if any(got != losses[0] for got in losses) or any(r["validate"] != ranks[0]["validate"] for r in ranks):
        raise RuntimeError(f"tp[{name}]: the ranks report different losses {losses}")
    if not (rel <= TP_RTOL and mae <= DDP_MAE_RTOL):
        raise RuntimeError(f"tp[{name}]: losses {rel:.3e} or MAE {mae:.3e} from one process")
    if any(r["c_attn_shape"] != [768, 3 * 768 // TP_RANKS] for r in ranks):
        raise RuntimeError(f"tp[{name}]: c_attn slices {[r['c_attn_shape'] for r in ranks]}")
    if gat != [want_val] * len(ranks) or gat_eval != [want_eval] * len(ranks) or any(
            any(launched(r["launches"], "gat_stencil_general", *OPT_IN).values()) for r in ranks):
        raise RuntimeError(f"tp[{name}]: launches {[(r['launches'], r['launches_eval']) for r in ranks]}")
    return {"max_rel_loss_diff": rel, "val_mae_by_horizon_max_rel_diff": mae, "gat_launches_by_rank": gat,
            "eval_gat_launches_by_rank": gat_eval,
            "windows_per_s_by_epoch": [h["windows_per_sec"] for h in ranks[0]["history"]],
            "one_process_windows_per_s_by_epoch": [h["windows_per_sec"] for h in hist_1]}


def tensor_parallel_phase(args, data_dir: str, ddp: dict) -> dict:
    """Tensor parallelism at phase 6's width and cut (see the module docstring,
    phase 13): (a) TP_RANKS gloo ranks on the one card, dp 1 x mp TP_RANKS,
    against phase 12's one process at the same global batch, then the
    evaluation library on the ranks against one process on the same
    checkpoint; (b) that checkpoint resumed at mp 1 in this process; (c) the
    bench under torchrun at NCCL world 1 beside the bare bench; (d) (a) over
    NCCL when the host has TP_RANKS cards."""
    import contextlib
    import io
    import signal

    import torch

    from tec_mollm_tpu_torch import bench, train
    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.models import TECMoLLM

    phase_t0 = time.perf_counter()
    tp_dir = os.path.join(data_dir, "tp")
    os.makedirs(tp_dir)
    fp32 = ddp["b_config"]
    hist_1, val_1 = ddp["b_one_process_history"], ddp["b_one_process_validate"]
    work = os.path.join(data_dir, "work")
    argv = ddp["b_argv"] + ["--checkpoint-every-steps", str(TRAINER_CKPT_EVERY)]
    eval_batch = 16
    test_windows = len(SlidingWindowDataset.from_dir(data_dir, "test", fp32.train.L_in, fp32.train.L_out, stride=1))
    val_windows = len(SlidingWindowDataset.from_dir(data_dir, "val", fp32.train.L_in, fp32.train.L_out, stride=1))
    # dp 1: every rank validates and evaluates every batch
    want_val = TRAINER_EPOCHS * -(-val_windows // fp32.train.batch_size)
    want_eval = -(-test_windows // eval_batch) + -(-val_windows // eval_batch)
    walls = {}

    # --- (a) TP_RANKS gloo ranks on the one card, dp 1 x mp TP_RANKS ---
    ckpt = os.path.join(work, "checkpoints", "tp_a", "best_params.pt")
    eval_spec = {"checkpoint": ckpt, "data_dir": data_dir, "batch_size": eval_batch,
                 "output_dir": os.path.join(tp_dir, "a_results")}
    job_a = tp_job(argv + ["--run-name", "tp_a"], os.path.join(tp_dir, "a"), "gloo", eval_spec)
    t0 = time.perf_counter()
    ranks = torchrun(job_a, TP_RANKS, os.path.join(tp_dir, "a.json"))
    walls["a"] = time.perf_counter() - t0
    a = check_tp_ranks("a", ranks, hist_1, val_1, want_val, want_eval)

    # the ranks' best checkpoint: whole tensors, and one process scores it as the ranks did
    t0 = time.perf_counter()
    best = torch.load(ckpt, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        want_shapes = {k: tuple(v.shape) for k, v in TECMoLLM(fp32.model, seed=None).state_dict().items()}
    whole = {k: tuple(v.shape) for k, v in best.items()} == want_shapes
    ev_1 = harness.run_evaluation(fp32, data_dir, ckpt, output_dir=os.path.join(tp_dir, "one_results"),
                                  batch_size=eval_batch)["results"]
    same = all(r["eval"] == ranks[0]["eval"] for r in ranks)
    rel_ev, abs_ev = eval_gap(ranks[0]["eval"], ev_1)
    rank_arrays = []
    for r in range(TP_RANKS):
        with np.load(os.path.join(job_a["out"], f"rank{r}.npz")) as d:
            rank_arrays.append(dict(d))
    preds_same = all(np.array_equal(x["preds"], rank_arrays[0]["preds"]) for x in rank_arrays)
    walls["a_eval_one_process"] = time.perf_counter() - t0
    log(
        f"tp[a] eval: best_params.pt holds whole tensors {whole} ({len(best)} tensors, c_attn "
        f"{tuple(best['llm_backbone.model.h.0.attn.c_attn.weight'].shape)}); run_evaluation ({test_windows} test "
        f"windows, batch {eval_batch}) on the ranks: the same metrics and predictions on every rank "
        f"{same and preds_same}; against one process on the checkpoint: MAE/RMSE relative {rel_ev:.3e}, R2/r "
        f"absolute {abs_ev:.3e} (tol {DDP_EVAL_TOL})"
    )
    if not (whole and same and preds_same and rel_ev <= DDP_EVAL_TOL and abs_ev <= DDP_EVAL_TOL):
        raise RuntimeError("tp[a] eval: the ranks disagree with each other or with one process")

    # --- (b) the epoch-boundary checkpoint resumed at mp 1 here; the mid-epoch one refused ---
    t0 = time.perf_counter()
    targs = train.parse_args(argv + ["--run-name", "tp_a_epoch"])
    one = train.build_trainer(targs, train.build_config(targs))
    one.fit(resume=True)  # the saved epoch was the last: restores and trains nothing
    bits = all(np.array_equal(v.float().cpu().numpy(), rank_arrays[0][f"param:{k}"])
               for k, v in one.model.state_dict().items())
    resumed = (one.epoch, one.state.step)
    del one
    targs = train.parse_args(argv + ["--run-name", "tp_a"])
    refusal = None
    try:
        train.build_trainer(targs, train.build_config(targs)).fit(resume=True)
    except RuntimeError as e:
        refusal = str(e)
    walls["b"] = time.perf_counter() - t0
    log(
        f"tp[b]: the ranks' epoch-boundary latest resumed at mp 1 in one process at epoch {resumed[0]}, step "
        f"{resumed[1]}: every parameter bit-identical to the ranks' gathered ones {bits}; their mid-epoch latest "
        f"({ranks[0]['mid_epoch']}) refused at mp 1: {refusal is not None and 'model_parallel' in refusal}"
    )
    if not bits or refusal is None or "model_parallel: saved 2 vs current 1" not in refusal:
        raise RuntimeError(f"tp[b]: bit-identical {bits}, refusal {refusal}")

    # --- (c) the bench under torchrun, NCCL at world 1, beside the bare bench ---
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench.main(["--steps", "10"])
    bare = json.loads(text.getvalue().strip().splitlines()[-1])
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
           "tec_mollm_tpu_torch.bench", "--steps", "10"]
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        raise RuntimeError(f"tp[c]: the bench under torchrun exited {proc.returncode}:\n{stderr[-4000:]}")
    ddp_line = json.loads(stdout.strip().splitlines()[-1])
    walls["c"] = time.perf_counter() - t0
    log(
        f"tp[c]: python -m tec_mollm_tpu_torch.bench --steps 10: bare {bare['value']} windows/s; under torchrun "
        f"--nproc_per_node 1 (NCCL, DDP, world {ddp_line.get('world')}) {ddp_line['value']} windows/s a card, "
        f"{ddp_line.get('total_windows_per_sec')} in all, {ddp_line.get('windows_per_step')} windows a step"
    )
    if ddp_line.get("world") != 1 or ddp_line.get("windows_per_step") != 8 or not ddp_line["value"] > 0:
        raise RuntimeError(f"tp[c]: bench line {ddp_line}")

    # --- (d) NCCL across TP_RANKS cards, where the host has them ---
    d = None
    if torch.cuda.device_count() >= TP_RANKS:
        t0 = time.perf_counter()
        job_d = tp_job(argv + ["--run-name", "tp_d"], os.path.join(tp_dir, "d"), "nccl",
                       {**eval_spec, "checkpoint": os.path.join(work, "checkpoints", "tp_d", "best_params.pt"),
                        "output_dir": os.path.join(tp_dir, "d_results")})
        d = check_tp_ranks("d", torchrun(job_d, TP_RANKS, os.path.join(tp_dir, "d.json")), hist_1, val_1,
                           want_val, want_eval)
        walls["d"] = time.perf_counter() - t0
    else:
        log(f"tp[d]: not run: NCCL takes one process a card and this host has {torch.cuda.device_count()} "
            f"card(s), fewer than the {TP_RANKS} ranks of the model group")

    launches: dict[str, int] = {}
    for counts in [r["launches"] for r in ranks] + [r["launches_eval"] for r in ranks]:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_s = time.perf_counter() - phase_t0
    log(f"tp: phase {phase_s:.1f} s (walls {({k: round(v, 1) for k, v in walls.items()})}; ranks' eval "
        f"{[round(r['eval_wall_s'], 1) for r in ranks]}); launches over its ranks {launches}")
    return {
        "phase_s": phase_s, "walls_s": walls, "launches": launches, "a": a, "a_ranks": ranks,
        "a_eval_one_process": ev_1, "a_eval_rel_diff": rel_ev, "a_eval_abs_diff_r": abs_ev,
        "b_bit_identical": bits, "b_refusal": refusal, "c_bench_bare": bare, "c_bench_torchrun": ddp_line, "d": d,
    }


def read_csv(path: str) -> tuple[list[str], dict[str, np.ndarray]]:
    """(header, {first column: the row's numbers}) of a results CSV."""
    with open(path) as f:
        header, *rows = [line.split(",") for line in f.read().splitlines()]
    return header, {r[0]: np.asarray(r[1:], dtype=np.float64) for r in rows}


def eval_phase(args, graph, data_dir: str) -> dict:
    """Evaluation at flagship width (see the module docstring, phase 8): the
    test CLI on phase 6's newest best_params.pt with a rollout, the same
    weights as a reference .pth, and a seeded operational-preset checkpoint
    through conformal fit, adaptive conformal, predict and the service."""
    import torch

    from tec_mollm_tpu_torch import ops, predict, test
    from tec_mollm_tpu_torch.config import operational_config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.models import TECMoLLM
    from tec_mollm_tpu_torch.serving import ForecastService

    phase_t0 = time.perf_counter()
    work, out = os.path.join(data_dir, "work"), os.path.join(data_dir, "eval")
    common = ["--data-dir", data_dir, "--workdir", work]
    cfg, ckpt = harness.resolve_cli_config(None, "latest", work)
    cfg = cfg.resolved()
    batch, L_out = cfg.train.eval_batch_size, cfg.train.L_out
    test_ds = SlidingWindowDataset.from_dir(data_dir, "test", cfg.train.L_in, L_out)
    eval_batches = -(-len(test_ds) // batch)
    chunks = -(-EVAL_ROLLOUT_STEPS // L_out)
    launches: dict[str, int] = {}  # over the phase's main-path runs

    def counted(fn):
        """(fn(), its launch counts from zero, its wall seconds)."""
        ops.reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return result, counts, wall

    # --- 1. the point model: phase 6's newest best_params.pt, with a rollout ---
    point_dir = os.path.join(out, "point")
    point, counts_point, wall_point = counted(lambda: test.main(common + [
        "--checkpoint", "latest", "--rollout-steps", str(EVAL_ROLLOUT_STEPS),
        "--rollout-windows", str(EVAL_ROLLOUT_WINDOWS), "--output-dir", point_dir]))
    header, rows = read_csv(os.path.join(point_dir, "evaluation_results.csv"))
    want_counts = {"gat_stencil": eval_batches + chunks, "gat_stencil_general": 0, **dict.fromkeys(OPT_IN, 0)}
    finite = all(np.isfinite(r).all() for r in rows.values())
    log(
        f"eval[point]: {ckpt} ({cfg.model.num_nodes} nodes, bf16 {cfg.train.bf16}), {len(test_ds)} test windows in "
        f"{eval_batches} batches of {batch}, rollout {EVAL_ROLLOUT_STEPS} steps x {point['rollout']['num_windows']} "
        f"windows ({chunks} chunks): CLI {wall_point:.2f} s; launches {counts_point} (want {want_counts}); "
        f"MAE {point['results']['TEC-MoLLM']['mae_avg']:.4f} vs HA {point['results']['HistoricalAverage']['mae_avg']:.4f} "
        f"TECU; rollout MAE {point['rollout']['mae_avg']:.4f}; finite {finite}"
    )
    if list(rows) != ["TEC-MoLLM", "HistoricalAverage"] or not finite or len(test_ds) < 64:
        raise RuntimeError(f"eval[point]: rows {list(rows)}, finite {finite}, {len(test_ds)} windows")
    if (not os.path.exists(os.path.join(point_dir, "rollout_results.csv"))
            or launched(counts_point, *want_counts) != want_counts):
        raise RuntimeError(f"eval[point]: launches {counts_point}, want {want_counts}, or no rollout_results.csv")

    # the same evaluation with the GAT on its plain path: same weights, same batches
    kernel_executor = harness.EvalExecutor

    class PlainGAT(kernel_executor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.model.gat_kernel = False

    ops.reset_counts()
    harness.EvalExecutor = PlainGAT
    try:
        plain = harness.run_evaluation(cfg, data_dir, ckpt, output_dir=os.path.join(out, "plain"), batch_size=batch)
    finally:
        harness.EvalExecutor = kernel_executor
    plain_counts = ops.launch_counts()
    k_m, p_m = point["results"]["TEC-MoLLM"], plain["results"]["TEC-MoLLM"]
    rel = max(float(np.max(np.abs(np.asarray(k_m[k]) - p_m[k]) / np.abs(p_m[k])))
              for k in ("mae_avg", "rmse_avg", "mae_by_horizon", "rmse_by_horizon"))
    log(f"eval[point] through the GAT kernel vs the plain GAT: MAE/RMSE largest relative difference {rel:.3e} "
        f"(tol {VAL_RTOL}); plain launches {plain_counts}")
    if any(launched(plain_counts, *GAT).values()) or not rel <= VAL_RTOL:
        raise RuntimeError(f"eval[point]: kernel vs plain GAT {rel:.3e}, plain launches {plain_counts}")

    # --- the rollout timed, then profiled ---
    rollout_dir = os.path.join(out, "rollout")
    harness.run_rollout_eval(cfg, data_dir, ckpt, EVAL_ROLLOUT_STEPS, EVAL_ROLLOUT_WINDOWS, output_dir=rollout_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    harness.run_rollout_eval(cfg, data_dir, ckpt, EVAL_ROLLOUT_STEPS, EVAL_ROLLOUT_WINDOWS, output_dir=rollout_dir)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    prof_rollout = profile_call(lambda: harness.run_rollout_eval(
        cfg, data_dir, ckpt, EVAL_ROLLOUT_STEPS, EVAL_ROLLOUT_WINDOWS, output_dir=rollout_dir), top=100_000)
    # the kernels' time alone: the call also copies the weights to the card
    rollout_kernel_ms = sum(r["ms"] for r in prof_rollout["top"] if not r["name"].startswith("Memcpy"))
    prof_rollout["top"] = prof_rollout["top"][:12]
    timing = {
        "rollout_s": rollout_s, "rollout_kernel_ms_per_chunk": rollout_kernel_ms / chunks,
        "profile_rollout": prof_rollout,
    }
    log(
        f"eval timing: rollout eval {rollout_s * 1e3:.1f} ms (checkpoint load and model build included), its "
        f"kernels {timing['rollout_kernel_ms_per_chunk']:.2f} ms a chunk of {point['rollout']['num_windows']} windows"
    )

    # --- 2. the same weights as a reference .pth: DDP prefixes, no config.json beside ---
    ref_dir = os.path.join(data_dir, "reference")
    os.makedirs(ref_dir)
    pth = os.path.join(ref_dir, "best_model.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    torch.save({"module." + k: v for k, v in saved.items()}, pth)
    pth_dir = os.path.join(out, "pth")
    _, counts_pth, _ = counted(lambda: test.main(common + [
        "--config", os.path.join(os.path.dirname(ckpt), "config.json"), "--checkpoint", pth, "--output-dir", pth_dir]))
    with open(os.path.join(point_dir, "evaluation_results.csv")) as f, \
            open(os.path.join(pth_dir, "evaluation_results.csv")) as g:
        same_csv = f.read() == g.read()
    log(f"eval[.pth]: module.-prefixed copy of the weights scored: CSV identical to the point run's {same_csv}; "
        f"launches {counts_pth}")
    if not same_csv:
        raise RuntimeError("eval[.pth]: the reference-format checkpoint scored differently")

    # --- 3. the operational preset: quantiles 0.1/0.5/0.9 with RevIN ---
    op = operational_config()
    op_run = os.path.join(work, "checkpoints", "op")
    os.makedirs(op_run)
    op_ckpt = os.path.join(op_run, "best_params.pt")
    torch.save(TECMoLLM(op.model, tuple(int(s) for s in graph.stencil_shifts), seed=args.seed).state_dict(), op_ckpt)
    with open(os.path.join(op_run, "config.json"), "w") as f:
        f.write(op.to_json())
    op_args = common + ["--run-name", "op"]
    fit, counts_fit, wall_fit = counted(lambda: test.main(op_args + [
        "--split", "val", "--conformal", "fit", "--output-dir", os.path.join(out, "op_fit")]))
    qm = fit["results"]["TEC-MoLLM"]
    coverage, raw_cov = qm["quantile_metrics_conformal"]["interval_coverage"], qm["quantile_metrics"]["interval_coverage"]
    has_npz = os.path.exists(os.path.join(op_run, "conformal.npz"))
    adaptive_dir = os.path.join(out, "op_adaptive")
    ada, counts_ada, wall_ada = counted(lambda: test.main(op_args + [
        "--conformal", "auto", "--conformal-mode", "adaptive", "--output-dir", adaptive_dir]))
    q_csvs = sorted(n for n in os.listdir(adaptive_dir) if n.startswith("quantile_metrics"))
    pred_dir = os.path.join(out, "op_predict")
    pred, counts_pred, _ = counted(lambda: predict.main(op_args + ["--indices", "0", "5", "--output-dir", pred_dir]))

    def serve():
        # at the request's batch, so that the service and predict run the same shapes
        service = ForecastService(op, data_dir, checkpoint="latest", workdir=work, run_name="op", max_batch=2,
                                  batch_window_ms=0)
        try:
            return service.forecast([0, 5])
        finally:
            service.close()

    served, counts_serve, _ = counted(serve)
    bands_diff = (float(np.abs(np.asarray(served["forecast_quantiles_conformal"])
                               - pred["forecast_quantiles_conformal"]).max())
                  if "forecast_quantiles_conformal" in served and "forecast_quantiles_conformal" in pred else None)
    ada_q = ada["results"]["TEC-MoLLM"]
    log(
        f"eval[operational]: conformal fit on {TRAINER_WINDOWS['val']} val windows (CLI {wall_fit:.2f} s): calibrated "
        f"80% interval coverage {coverage:.4f} on that split (raw head {raw_cov:.4f}; tol {COVERAGE_TOL}); "
        f"conformal.npz {has_npz}; launches {counts_fit}"
    )
    log(
        f"eval[operational]: adaptive on {len(test_ds)} test windows (CLI {wall_ada:.2f} s): coverage raw "
        f"{ada_q['quantile_metrics']['interval_coverage']:.4f}, split conformal "
        f"{ada_q['quantile_metrics_conformal']['interval_coverage']:.4f}, adaptive "
        f"{ada_q['quantile_metrics_adaptive']['interval_coverage']:.4f}; files {q_csvs}; launches {counts_ada}"
    )
    log(f"eval[operational]: predict [0, 5] launches {counts_pred}; service launches {counts_serve}; service vs "
        f"predict conformal bands max |diff| {bands_diff} TECU (tol {BANDS_TOL_TECU})")
    if not has_npz or not abs(coverage - 0.8) <= COVERAGE_TOL:
        raise RuntimeError(f"eval[operational]: coverage {coverage} on the fitted split, conformal.npz {has_npz}")
    if q_csvs != ["quantile_metrics.csv", "quantile_metrics_adaptive.csv", "quantile_metrics_conformal.csv"]:
        raise RuntimeError(f"eval[operational]: adaptive run wrote {q_csvs}")
    if bands_diff is None or not bands_diff <= BANDS_TOL_TECU:
        raise RuntimeError(f"eval[operational]: service vs predict conformal bands {bands_diff}")
    gat = launched(launches, *GAT)
    if not gat["gat_stencil"] or gat["gat_stencil_general"]:
        raise RuntimeError(f"eval: launches {launches}, want the GAT kernel's tiled form alone")
    phase_s = time.perf_counter() - phase_t0
    log(f"eval phase: {phase_s:.1f} s; launches over its CLI and service runs {launches}")
    return {
        "phase_s": phase_s,
        "checkpoint": ckpt, "test_windows": len(test_ds), "eval_batches": eval_batches, "rollout_chunks": chunks,
        "launches": launches, "launches_point": counts_point, "cli_s_point": wall_point,
        "results_point": point["results"], "rollout_point": point["rollout"], "plain_gat_max_rel_diff": rel,
        **timing, "pth_csv_identical": same_csv, "launches_pth": counts_pth,
        "op_fit_coverage": coverage, "op_fit_raw_coverage": raw_cov, "op_fit_cli_s": wall_fit,
        "op_adaptive": {k: ada_q[k]["interval_coverage"] for k in (
            "quantile_metrics", "quantile_metrics_conformal", "quantile_metrics_adaptive")},
        "op_adaptive_cli_s": wall_ada, "op_service_vs_predict_bands_tecu": bands_diff,
        "launches_op": {"fit": counts_fit, "adaptive": counts_ada, "predict": counts_pred, "serve": counts_serve},
    }


def pretrain_grad_check(args, cfg, tokens) -> dict:
    """One pretraining step's gradients with every dropout at 0: ByteLM through
    the flash kernel in bf16 against an fp32 step on the plain (einsum) path,
    with the bf16 plain path as the yardstick of what bf16 alone costs."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.models import ByteLM, next_byte_loss

    cfg = dataclasses.replace(cfg, llm_dropout=0.0)
    base = ByteLM(cfg, seed=args.seed + 1).state_dict()

    def gradients(dtype, flash: bool):
        model = ByteLM(cfg, dtype=dtype, use_flash=flash).to("cuda")
        model.load_state_dict(base)
        model.train()
        loss = next_byte_loss(model(tokens), tokens)
        loss.backward()
        return {n: p.grad.float() for n, p in model.named_parameters()}, float(loss.detach())

    ops.reset_counts()
    kernel, loss_kernel = gradients(torch.bfloat16, True)
    counts = ops.launch_counts()
    ref, loss_ref = gradients(torch.float32, False)
    plain16, loss_plain16 = gradients(torch.bfloat16, False)

    def worst(a: dict, b: dict) -> tuple[float, str]:
        return max((float((a[n] - b[n]).abs().max() / (b[n].abs().max() + 1e-12)), n) for n in b)

    (rel_kernel, name_kernel), (rel_plain16, name_plain16) = worst(kernel, ref), worst(plain16, ref)
    out = {
        "rows": int(tokens.shape[0]), "tensors": len(ref), "launches": counts,
        "loss_kernel_bf16": loss_kernel, "loss_plain_fp32": loss_ref, "loss_plain_bf16": loss_plain16,
        "max_rel_diff_kernel_bf16_vs_plain_fp32": rel_kernel, "worst_tensor_kernel": name_kernel,
        "max_rel_diff_plain_bf16_vs_plain_fp32": rel_plain16, "worst_tensor_plain_bf16": name_plain16,
        "max_rel_diff_kernel_bf16_vs_plain_bf16": worst(kernel, plain16)[0], "tol": GRAD_TOL,
    }
    log(
        f"pretrain grad check (dropout 0, {out['rows']} rows, {len(ref)} tensors): loss kernel bf16 "
        f"{loss_kernel:.6f}, plain fp32 {loss_ref:.6f}, plain bf16 {loss_plain16:.6f}; largest per-tensor "
        f"relative difference from fp32: kernel bf16 {rel_kernel:.4e} ({name_kernel}), plain bf16 "
        f"{rel_plain16:.4e} ({name_plain16}); kernel against plain, both bf16: "
        f"{out['max_rel_diff_kernel_bf16_vs_plain_bf16']:.4e}; tol {GRAD_TOL}; launches {counts}"
    )
    if counts.get("flash_attention", 0) != cfg.llm_layers:
        raise RuntimeError(f"pretrain grad check: flash_attention ran {counts}, not once a block")
    if not rel_kernel <= GRAD_TOL:
        raise RuntimeError(f"pretrain grad check: kernel-path gradients differ by {rel_kernel:.4e} > {GRAD_TOL}")
    return out


def hf_roundtrip(args, graph, lm) -> dict:
    """Export the byte LM's backbone as an HF checkpoint, load it through
    hf_import into the flagship TECMoLLM (LoRA r 32) and run one eval forecast."""
    import torch

    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
    from tec_mollm_tpu_torch.models.hf_export import backbone_state_dict_to_hf, save_hf_checkpoint
    from tec_mollm_tpu_torch.models.hf_import import load_gpt2_into_model, load_torch_checkpoint

    sd = backbone_state_dict_to_hf(lm.backbone, wte=lm.wte)
    with tempfile.TemporaryDirectory(prefix="tec_hf_") as out:
        save_hf_checkpoint(sd, out, meta={"surrogate": "byte-lm"})
        files = sorted(os.listdir(out))
        loaded = load_torch_checkpoint(out)
    cfg = Config().resolved()
    shifts, graph_pair = graph_inputs(graph, "cuda")
    model = TECMoLLM(cfg.model, shifts, dtype=torch.bfloat16, seed=args.seed).to("cuda")
    load_gpt2_into_model(model, loaded)
    backbone = dict(model.llm_backbone.model.named_parameters())
    differ = [n for n, p in backbone.items() if ".lora_" not in n and not torch.equal(p.detach().cpu(), sd[n])]
    lora_b_zero = all(not p.any() for n, p in backbone.items() if n.endswith("lora_B.weight"))
    split = synthetic_processed_split(3, cfg.train.L_in, cfg.train.L_out, cfg.model.num_nodes, seed=args.seed)
    batch = SlidingWindowDataset(split, cfg.train.L_in, cfg.train.L_out).gather_batch(np.arange(2))
    with torch.inference_mode():
        preds = model.eval()(
            torch.from_numpy(batch["x"]).cuda(), torch.from_numpy(batch["time_features"]).cuda(), *graph_pair
        )
    out = {
        "files": files, "tensors": len(sd), "backbone_tensors_differing": differ,
        "lora_r": cfg.model.lora_r, "lora_B_zero": lora_b_zero,
        "forecast_shape": list(preds.shape), "forecast_finite": bool(torch.isfinite(preds).all()),
    }
    log(
        f"hf export -> import: {files}, {len(sd)} tensors; flagship TECMoLLM (LoRA r {cfg.model.lora_r}) "
        f"backbone tensors differing from the export: {differ}; lora_B all zero: {lora_b_zero}; "
        f"eval forecast {list(preds.shape)} finite: {out['forecast_finite']}"
    )
    if differ or not lora_b_zero or not out["forecast_finite"]:
        raise RuntimeError(f"hf round trip failed: {out}")
    return out


def pretrain_phase(args, graph) -> dict:
    """The surrogate GPT-2 pretraining at the script's full width and batch,
    through the flash kernel (see the module docstring, phase 7)."""
    import math

    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import ModelConfig
    from tec_mollm_tpu_torch.models import ByteLM, gpt2, pretrain_model_config
    from tec_mollm_tpu_torch.models.byte_lm import byte_batches, gather_text_corpus
    from tec_mollm_tpu_torch.training import create_pretrain_state, make_pretrain_step, val_loss, warmup_cosine_decay

    corpus = gather_text_corpus([os.path.dirname(os.path.abspath(__file__))])
    batches, val_batch = byte_batches(corpus, PRETRAIN_BATCH, PRETRAIN_SEQ, seed=args.seed)
    cfg = pretrain_model_config(ModelConfig())
    model = ByteLM(cfg, dtype=torch.bfloat16, use_flash=True, seed=args.seed).to("cuda")
    state = create_pretrain_state(model, seed=args.seed)
    n = PRETRAIN_WARMUP + PRETRAIN_STEPS
    step = make_pretrain_step(warmup_cosine_decay(0.0, PRETRAIN_LR, PRETRAIN_LR_WARMUP, n, PRETRAIN_LR * 0.01))
    data = [torch.from_numpy(next(batches)).cuda() for _ in range(n)]
    val_tokens = torch.from_numpy(val_batch).cuda()

    # the attention dropout rate of every flash call, training and val
    rates: dict[str, list] = {"train": [], "val": []}
    flash = gpt2.flash_attention

    def recording(phase: str):
        def call(*a, **kw):
            rates[phase].append(kw.get("dropout_rate", 0.0))
            return flash(*a, **kw)
        return call

    try:
        gpt2.flash_attention = recording("val")
        ops.reset_counts()
        val_before = float(val_loss(model, val_tokens))
        val_counts = ops.launch_counts()
        gpt2.flash_attention = recording("train")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        metrics = [step(state, t) for t in data[:PRETRAIN_WARMUP]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics += [step(state, t) for t in data[PRETRAIN_WARMUP:]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        gpt2.flash_attention = flash
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    val_after = float(val_loss(model, val_tokens))
    prof = profile_call(lambda: step(state, data[-1]), top=25)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    out = {
        "corpus_mb": len(corpus) / 1e6, "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "batch": PRETRAIN_BATCH, "seq_len": PRETRAIN_SEQ, "warmup": PRETRAIN_WARMUP, "steps_timed": PRETRAIN_STEPS,
        "step_ms": wall / PRETRAIN_STEPS * 1e3,
        "predicted_bytes_per_s": PRETRAIN_BATCH * PRETRAIN_SEQ * PRETRAIN_STEPS / wall,
        "peak_memory_gb": peak_gb, "launches": counts,
        "launches_per_step": {k: v / n for k, v in counts.items()}, "launches_val_forward": val_counts,
        "losses": losses, "grad_norms": norms, "val_loss_before": val_before, "val_loss_after": val_after,
        "profile": prof,
    }
    log(
        f"pretrain: ByteLM d {cfg.d_llm} x {cfg.llm_layers} blocks, {out['params_m']:.1f} M params, bf16, "
        f"B={PRETRAIN_BATCH} x T={PRETRAIN_SEQ + 1}, use_flash, llm_dropout {cfg.llm_dropout}, corpus "
        f"{out['corpus_mb']:.2f} MB: {PRETRAIN_STEPS} steps after {PRETRAIN_WARMUP} warm-up: step "
        f"{out['step_ms']:.2f} ms, {out['predicted_bytes_per_s']:.0f} predicted bytes/s; peak memory "
        f"{peak_gb:.2f} GB; launches {counts}"
    )
    log(f"pretrain: losses {[round(x, 4) for x in losses]}; grad norms {[round(x, 3) for x in norms]}")
    log(f"pretrain: val loss {val_before:.4f} -> {val_after:.4f} nats/byte; val forward launches {val_counts}")
    log(
        f"profile[pretrain step]: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy {prof['device_busy_share']:.2%})"
    )
    for row in prof["top"][:10]:
        log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")
    if counts.get("flash_attention", 0) != cfg.llm_layers * n or val_counts.get("flash_attention", 0) != cfg.llm_layers:
        raise RuntimeError(f"pretrain: flash_attention ran {counts} in {n} steps, {val_counts} in one val forward")
    out["flash_dropout_rates"] = {k: sorted(set(v)) for k, v in rates.items()}
    log(f"pretrain: flash calls' attention dropout: train {out['flash_dropout_rates']['train']} over "
        f"{len(rates['train'])} calls, val {out['flash_dropout_rates']['val']} over {len(rates['val'])} calls")
    if rates["train"] != [cfg.llm_dropout] * (cfg.llm_layers * n) or rates["val"] != [0.0] * cfg.llm_layers:
        raise RuntimeError(f"pretrain: flash calls' dropout rates {out['flash_dropout_rates']}, want "
                           f"{cfg.llm_dropout} in training and 0 in the val forward")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise RuntimeError("pretrain: a loss or gradient norm is not finite")
    if abs(losses[0] - math.log(256)) > 0.2 * math.log(256) or not losses[-1] < losses[0]:
        raise RuntimeError(f"pretrain: first loss {losses[0]} not within 20% of ln 256, or the last not below it")
    out["grad_check"] = pretrain_grad_check(args, cfg, data[0][:PRETRAIN_GRAD_ROWS])
    out["hf_roundtrip"] = hf_roundtrip(args, graph, model)
    return out


def sarima_fit(inputs: dict) -> dict:
    """Phase 14 (a)'s main path on sarima_inputs' series: one fit step's loss
    and gradient timed back to back, the full fit of SARIMA_FIT_STEPS steps
    through the kernels and one forecast batch, launches counted from zero;
    then SARIMA_PROFILE_STEPS warm fit steps timed and as many profiled.
    What failed goes under "failures"."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.models import sarima
    from tec_mollm_tpu_torch.ops import sarima as sops

    s, y, n = inputs["season"], inputs["y"], inputs["y"].shape[1]
    step_ms = time_ms(lambda: sops.css_loss_and_grad(inputs["raw"], y, s), REPS)
    failures = []
    ops.reset_counts()
    t0 = time.perf_counter()
    params = sarima.fit_sarima(inputs["series"], season=s, steps=SARIMA_FIT_STEPS, device=torch.device("cuda"))
    fit_wall = time.perf_counter() - t0
    preds = sarima.forecast_windows(params, inputs["wins"], inputs["horizon"], season=s)
    torch.cuda.synchronize()
    fit_counts = ops.launch_counts()
    phi_mean = float(params.phi.mean())
    log(
        f"sarima: fit of {SARIMA_FIT_STEPS} Adam steps on ({SARIMA_T}, {n}): {fit_wall:.3f} s, "
        f"{fit_wall / SARIMA_FIT_STEPS * 1e3:.3f} ms a step (loss and gradient alone, back to back, {step_ms:.4f} "
        f"ms a call, {step_ms / (fit_wall / SARIMA_FIT_STEPS * 1e3):.2%} of the step); phi mean {phi_mean:.4f} "
        f"(truth {SARIMA_TRUTH[0]} +- {SARIMA_PHI_TOL}); launches {fit_counts}"
    )
    want = {sops.FORWARD: SARIMA_FIT_STEPS, sops.BACKWARD: SARIMA_FIT_STEPS, sops.FORECAST: 1}
    if launched(fit_counts, *want) != want:
        failures.append(f"fit launches {fit_counts}, want {want}")
    if not abs(phi_mean - SARIMA_TRUTH[0]) <= SARIMA_PHI_TOL or not bool(preds.isfinite().all()):
        failures.append(f"fit: phi mean {phi_mean}, or a forecast not finite")
    # what sets a fit step's pace: its warm wall, and the device's busy share
    # of a profiled run of as many steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sarima.adam_fit(y, s, SARIMA_PROFILE_STEPS)
    torch.cuda.synchronize()
    warm_step_ms = (time.perf_counter() - t0) * 1e3 / SARIMA_PROFILE_STEPS
    prof = profile_call(lambda: sarima.adam_fit(y, s, SARIMA_PROFILE_STEPS), top=8, cpu_ops=False)
    seen = {k: sum(r["calls"] for r in prof["top"] if k in r["name"]) for k in ("css_forward", "css_backward")}
    # the profiler's own host cost stretches the traced wall: the device time
    # a step over the untraced warm step is the share without it (a step is
    # one forward launch; the trace may miss the first steps of the run)
    device_step_ms = prof["device_ms"] / max(seen["css_forward"], 1)
    log(
        f"sarima: {SARIMA_PROFILE_STEPS} warm fit steps {warm_step_ms:.4f} ms a step, {device_step_ms:.4f} ms of it "
        f"on the device ({device_step_ms / warm_step_ms:.2%}); profiled: wall {prof['wall_ms']:.3f} ms, device "
        f"{prof['device_ms']:.3f} ms, busy {prof['device_busy_share']:.2%}; kernel launches the profiler saw "
        f"{seen} (of {SARIMA_PROFILE_STEPS} each); top "
        + "; ".join(f"{r['name'][:60]} x{r['calls']} {r['ms']:.3f} ms" for r in prof["top"])
    )
    return {"loss_and_grad_ms": step_ms, "fit_wall_s": fit_wall, "fit_ms_a_step": fit_wall / SARIMA_FIT_STEPS * 1e3,
            "phi_mean": phi_mean, "fit_launches": fit_counts, "warm_step_ms": warm_step_ms,
            "device_step_ms": device_step_ms, "warm_step_busy_share": device_step_ms / warm_step_ms,
            "fit_profile": prof, "failures": failures}


def sarima_phase(args, data_dir: str) -> dict:
    """The SARIMA baseline at flagship width (phase 14 (a)): the full fit
    through the kernels (sarima_fit), and the test CLI with --baseline sarima
    on phase 8's checkpoint and data."""
    import torch

    from tec_mollm_tpu_torch import ops, test
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.ops import sarima as sops

    phase_t0 = time.perf_counter()
    cfg = Config().resolved()
    s, L_in, L_out = SARIMA_SEASON, cfg.train.L_in, cfg.train.L_out
    fit = sarima_fit(sarima_inputs(args.seed, torch.device("cuda")))
    failures = fit.pop("failures")
    launches = dict(fit["fit_launches"])

    work, out = os.path.join(data_dir, "work"), os.path.join(data_dir, "eval", "sarima")
    ops.reset_counts()
    t0 = time.perf_counter()
    res = test.main(["--data-dir", data_dir, "--workdir", work, "--checkpoint", "latest", "--baseline", "sarima",
                     "--sarima-season", str(s), "--output-dir", out])
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    cli_counts = ops.launch_counts()
    for k, v in cli_counts.items():
        launches[k] = launches.get(k, 0) + v
    _, rows = read_csv(os.path.join(out, "evaluation_results.csv"))
    batches = -(-len(SlidingWindowDataset.from_dir(data_dir, "test", L_in, L_out)) // SARIMA_BATCH)
    cli_steps = inspect.signature(harness.evaluate_sarima_streaming).parameters["fit_steps"].default
    finite = all(np.isfinite(r).all() for r in rows.values())
    sar = res["results"]["SARIMA"]
    log(
        f"sarima[test CLI --baseline sarima]: {cli_wall:.2f} s; rows {list(rows)}, finite {finite}; SARIMA MAE "
        f"{sar['mae_avg']:.4f} RMSE {sar['rmse_avg']:.4f} TECU against HA MAE "
        f"{res['results']['HistoricalAverage']['mae_avg']:.4f}; launches {cli_counts}"
    )
    if list(rows) != ["TEC-MoLLM", "HistoricalAverage", "SARIMA"] or not finite:
        failures.append(f"test CLI rows {list(rows)}, finite {finite}")
    want = {sops.FORWARD: cli_steps, sops.BACKWARD: cli_steps, sops.FORECAST: batches}
    if launched(cli_counts, *want) != want:
        failures.append(f"test CLI launches {cli_counts}, want {want}")
    if failures:
        raise RuntimeError(f"sarima: {failures}")
    return {
        "launches": launches, **fit, "cli_wall_s": cli_wall, "cli_launches": cli_counts,
        "cli_results": res["results"], "wall_s": time.perf_counter() - phase_t0,
    }


def arms_phase(args) -> dict:
    """Phase 5's flagship train step (the bench's, B = 8, bf16, fused_attn)
    with every dropout at 0, the same seeded weights (lora_B redrawn) and the
    same batch under each of ARMS (phase 14 (b)): the loss and gradients of
    one step against the default arm's within GRAD_TOL, then ARM_STEPS steps
    after ARM_WARMUP: step ms and peak memory."""
    import torch

    from tec_mollm_tpu_torch import bench, ops
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.models import graph_inputs
    from tec_mollm_tpu_torch.training import make_sum_loss_fn

    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {"arms": {}}
    launches: dict[str, int] = {}
    ref = None
    for name, (kw, policy) in ARMS.items():
        cfg = bench.bench_config("default", remat_policy=policy)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **NO_DROPOUT))
        if ref is None:
            m = cfg.model
            _, graph_pair = graph_inputs(build_graph(*grid_coordinates(m.grid_h, m.grid_w)), dev)
        run = bench.setup(cfg, dev, fused_attn=True, seed=args.seed, **kw)
        model = run.state.model
        gen = torch.Generator().manual_seed(args.seed + 1)
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith("lora_B.weight"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        model.train()
        ops.reset_counts()
        wsum, count = make_sum_loss_fn(model, cfg)(run.batch, graph_pair)
        loss = wsum / count
        loss.backward()
        grads = {n: p.grad.float().clone() for n, p in run.state.trainable().items()}
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ARM_WARMUP):
            run.step()
        run.sync()
        t0 = time.perf_counter()
        for _ in range(ARM_STEPS):
            run.step()
        run.sync()
        step_ms = (time.perf_counter() - t0) / ARM_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, v in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        rec = {"loss": float(loss.detach()), "step_ms": step_ms, "peak_memory_gb": peak,
               "remat": cfg.train.remat_llm, "remat_policy": cfg.train.remat_policy, "kwargs": kw}
        if ref is None:
            ref = (rec["loss"], grads)
        else:
            worst = max((float((grads[n] - g).abs().max() / (g.abs().max() + 1e-12)), n) for n, g in ref[1].items())
            rec["max_rel_grad_diff"], rec["worst_tensor"] = worst
            rec["loss_rel_diff"] = abs(rec["loss"] - ref[0]) / abs(ref[0])
        out["arms"][name] = rec
        log(
            f"arm[{name}]: loss {rec['loss']:.6f}"
            + ("" if name == "default" else
               f" (rel {rec['loss_rel_diff']:.3e} of the default's), largest per-tensor gradient difference "
               f"{rec['max_rel_grad_diff']:.3e} ({rec['worst_tensor']}), tol {GRAD_TOL}")
            + f"; step {step_ms:.2f} ms, peak memory {peak:.3f} GB"
        )
        del run, model, grads, loss, wsum
        torch.cuda.empty_cache()
    bad = [k for k, r in out["arms"].items() if k != "default" and not (
        r["max_rel_grad_diff"] <= GRAD_TOL and r["loss_rel_diff"] <= GRAD_TOL and np.isfinite(r["loss"]))]
    if bad:
        raise RuntimeError(f"arms: loss or gradients off the default step's: {bad}")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - phase_t0
    return out


def ablation_phase(args, data_dir: str) -> dict:
    """Phase 14 (after phase 13): (a) the SARIMA baseline, (b) the arms."""
    t0 = time.perf_counter()
    out = {"sarima": sarima_phase(args, data_dir), "arms": arms_phase(args)}
    launches: dict[str, int] = {}
    for part in out.values():
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14: sarima {out['sarima']['wall_s']:.1f} s, arms {out['arms']['wall_s']:.1f} s, "
        f"total {out['wall_s']:.1f} s")
    return out


def dsv2_processed_dir(path: str, cfg) -> None:
    """A seeded processed dir at the configuration's grid: DSV2_WINDOWS
    windows of train, val and test, graph.npz and target_scaler.npz."""
    from tec_mollm_tpu_torch.data import StandardScaler
    from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates

    os.makedirs(path, exist_ok=True)
    m = cfg.model
    for seed, (split, n) in enumerate(zip(("train", "val", "test"), DSV2_WINDOWS)):
        np.savez(os.path.join(path, f"{split}_set.npz"),
                 **synthetic_processed_split(n, cfg.train.L_in, cfg.train.L_out, m.num_nodes, seed=seed))
    build_graph(*grid_coordinates(m.grid_h, m.grid_w)).save(os.path.join(path, "graph.npz"))
    StandardScaler(np.array([TARGET_MEAN]), np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))


def dsv2_reference_loss(params: dict, batch: dict, config: dict, device) -> float:
    """The plain reference's Huber loss (float32) on a batch, at ``params``."""
    import torch

    from benchmark.reference import deepseek_v2 as rd
    from benchmark.reference import model as ref

    dims = rd.Dims.of(config)
    delta = config["train"]["huber_delta"]
    with torch.no_grad():
        x, tf, y = (torch.as_tensor(batch[k], device=device) for k in ("x", "time_features", "y"))
        pred = rd.forward(params, x.float(), tf.long(), ref.Graph(config, device), dims, ref.Precision())
        err = (pred - y.float().transpose(1, 2)[..., None]).abs()
        quad = err.clamp(max=delta)
        return float((0.5 * quad * quad + delta * (err - quad)).mean())


def dsv2_trainer_steps(cfg, config: dict, proc: str, work: str, device) -> dict:
    """Trainer's first two macro steps from the cell's seeded weights, each
    step's loss beside the reference's on the same rows and on the program's
    weights of that step."""
    import torch

    from benchmark import harness
    from benchmark.drivers import forecast_moe
    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.graph import GraphData
    from tec_mollm_tpu_torch.training.trainer import Trainer

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t = cfg.train
    ds = SlidingWindowDataset.from_dir(proc, "train", t.L_in, t.L_out, stride=1)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, None, GraphData.load(os.path.join(proc, "graph.npz")), None, workdir=work,
                      run_name="steps", device=device)
    cell, _, traffic = harness.load(DSV2_CELL)
    weights = forecast_moe.seeded_weights(harness.Ctx(DSV2_CELL, cell, config, traffic, DSV2_WEIGHT_SEED, device,
                                                      work))
    trainer.set_params(weights)
    built = time.perf_counter() - t0
    steps = []
    for k, batch in enumerate(trainer.train_loader.iter_from(0)):
        if k == 2:
            break
        params = dict(weights)
        params.update({n: p.detach().float() for n, p in trainer.state.trainable().items()})
        want = dsv2_reference_loss(params, batch, config, device)
        sync()
        s0 = time.perf_counter()
        _, out = trainer._train_step(trainer.state, trainer._put(batch), trainer.graph)
        got = float(out["loss"].detach())
        sync()
        steps.append({"loss": got, "reference_loss": want, "gap": abs(got - want) / abs(want),
                      "grad_norm": float(out["grad_norm"]), "step_s": time.perf_counter() - s0})
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del trainer, weights
    return {"steps": steps, "build_s": built, "peak_bytes": peak}


def dsv2_clis(config_path: str, proc: str, work: str, cpu: bool) -> dict:
    """The train CLI for one epoch on the configuration file, then the test
    and serve CLIs on the run it wrote; each one's wall."""
    import contextlib
    import io

    from tec_mollm_tpu_torch import serve as serve_cli
    from tec_mollm_tpu_torch import test as test_cli
    from tec_mollm_tpu_torch import train as train_cli

    out = {}
    flag = ["--cpu"] if cpu else []
    t0 = time.perf_counter()
    history = train_cli.main(flag + ["--config", config_path, "--data-dir", proc, "--workdir", work, "--run-name",
                                     "cli", "--epochs", "1"])
    out["train"] = {"s": time.perf_counter() - t0, "history": history}
    results = os.path.join(work, "results")
    t0 = time.perf_counter()
    test_cli.main(flag + ["--data-dir", proc, "--workdir", work, "--checkpoint", "latest", "--output-dir", results])
    with open(os.path.join(results, "evaluation_results.csv")) as f:
        out["test"] = {"s": time.perf_counter() - t0, "csv": f.read().splitlines()[:4]}
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(flag + ["--data-dir", proc, "--workdir", work, "--bench", "4"])
    out["serve"] = {"s": time.perf_counter() - t0, "bench": json.loads(buf.getvalue().strip().splitlines()[-1])}
    return out


def dsv2_phase(device: str = "cuda", overrides: dict | None = None) -> dict:
    """Phase 15: TEC-MoLLM on the DeepSeek-V2-Lite backbone at its published
    widths through the port's entry points (see the module docstring).
    ``device="cpu"`` with ``overrides`` of sizes (benchmark/tests/tiny.json)
    rehearses it on the CPU."""
    import torch

    from benchmark import harness
    from tec_mollm_tpu_torch.config import Config

    t0 = time.perf_counter()
    dev = torch.device(device)
    _, config, _ = harness.load(DSV2_CELL, overrides)
    config = harness.merge(config, {"model": NO_DROPOUT, "train": {"epochs": 1, "train_stride": 1}})
    cfg = Config.from_dict({k: config[k] for k in ("model", "train", "data")}).resolved()
    out = {}
    with tempfile.TemporaryDirectory(prefix="tec_dsv2_") as work:
        proc = os.path.join(work, "proc")
        dsv2_processed_dir(proc, cfg)
        config_path = os.path.join(work, "dsv2_lite.json")
        with open(config_path, "w") as f:
            f.write(cfg.to_json())
        out["trainer"] = dsv2_trainer_steps(cfg, config, proc, os.path.join(work, "steps"), dev)
        out.update(dsv2_clis(config_path, proc, os.path.join(work, "cli"), dev.type == "cpu"))
    out["wall_s"] = time.perf_counter() - t0
    steps = out["trainer"]["steps"]
    gaps = ", ".join(format(s["gap"], ".3e") for s in steps)
    log(
        f"dsv2: Trainer steps' losses {[round(s['loss'], 6) for s in steps]} against the reference's "
        f"{[round(s['reference_loss'], 6) for s in steps]} (relative gaps {gaps}, limit {DSV2_LOSS_GAP}); "
        f"train CLI {out['train']['s']:.1f} s, test CLI {out['test']['s']:.1f} s, "
        f"serve CLI {out['serve']['s']:.1f} s ({out['serve']['bench']}); phase {out['wall_s']:.1f} s"
    )
    if not all(s["gap"] < DSV2_LOSS_GAP for s in steps):
        raise RuntimeError(f"dsv2: Trainer losses off the reference's: {steps}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    p.add_argument("--ddp-rank", default=None, metavar="JOB",
                   help="run as one rank of phase 12 or 13 under torchrun (the script starts these itself)")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.ddp_rank:
        return ddp_rank(args.ddp_rank)
    try:
        from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
        from tec_mollm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the tec_mollm_tpu_torch package is not importable: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    results: dict = {}
    card = gpu_line()
    log(f"device: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    results["device"] = {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    lib = _build.build()
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {lib} in {results['build_s']:.1f} s")
    ptxas = (lib.parent / "ptxas.log").read_text() if (lib.parent / "ptxas.log").exists() else ""
    for line in ptxas_summary(ptxas):
        log(f"  {line}")
    results["ptxas"] = ptxas
    for source in ("gat_stencil.cu", "sarima.cu", "temporal_conv.cu"):
        for k in ptxas_entries(ptxas, source):
            log(f"  {source} {k['entry']}: {k.get('registers')} registers, {k.get('spill_store_bytes')} bytes "
                f"spilled, {k.get('static_smem_bytes')} bytes static smem")

    lat, lon = grid_coordinates(41, 71)
    graph = build_graph(lat, lon, distance_threshold_km=150.0)
    table = kernel_table(kernel_cases(graph, args.seed))
    results["kernels"] = table
    with tempfile.TemporaryDirectory(prefix="tec_smoke_") as data_dir:
        results["serve"] = serve = serve_phase(args, graph, data_dir)
        results["train"] = train = train_phase(args)
        results["trainer"] = trainer = trainer_phase(args, graph, data_dir, train["windows_per_s"])
        results["preprocess"] = prep = preprocess_phase(args, data_dir)
        results["device_data"] = device_data = device_data_phase(args, prep["plain"]["dir"])
        results["export"] = export = export_phase(args, data_dir)
        results["eval"] = evaluation = eval_phase(args, graph, data_dir)
        results["data_parallel"] = ddp = data_parallel_phase(args, data_dir, trainer)
        results["tensor_parallel"] = tp = tensor_parallel_phase(args, data_dir, ddp)
        results["ablation"] = ablation = ablation_phase(args, data_dir)
    results["pretrain"] = pretrain = pretrain_phase(args, graph)
    results["dsv2"] = dsv2_phase()
    # each kernel's launches over the main-path runs, each counted from zero
    # (a rank's in its own process)
    runs = {
        "serve": collections.Counter(serve["default"]["launches"]) + collections.Counter(serve["fused"]["launches"]),
        "train_step": train["launches"], "trainer_run_a": trainer["launches"], "trainer_1x22": trainer["launches_1x22"],
        "device_data": device_data["launches"], "export": export["launches"], "eval": evaluation["launches"],
        "ddp": ddp["launches"], "tp": tp["launches"], "ablation": ablation["launches"], "pretrain": pretrain["launches"],
    }
    names = list(dict.fromkeys(row["name"] for row in table))
    results["launches"] = {run: launched(counts, *names) for run, counts in runs.items()}
    totals = {name: sum(counts[name] for counts in results["launches"].values()) for name in names}
    missing = [name for name, total in totals.items() if not total]
    if missing:
        raise RuntimeError(f"kernels never launched on a main path: {missing}")
    results["card"] = card
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": table, "launches": results["launches"]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
