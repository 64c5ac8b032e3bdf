#!/usr/bin/env python3
"""Drive the PyTorch port (tec_mollm_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

It needs one card. Phases 12 and 13 start this script again as the ranks of
a torchrun group (``--ddp-rank JOB``); a user never passes that flag.

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile the kernels from csrc/ (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at the
     shapes the flagship batch of 8 gives it, with its error, its time (CUDA
     events around back-to-back calls, see time_ms), the plain version's time,
     a library call's time where one computes the same function, and its bound
     on this card. The stencil GAT's tiled kernel runs at GAT_CASES in fp32 and
     bf16 (the flagship eval batch, the eval step's, the trainer's validation
     batch, the 300 km stencil, the unpadded node axis, 70,000 slices) and its
     general form at GAT_GENERAL_CASES (1 head x 22 channels, the 450 km
     stencil's 81 offsets, 4 x 16 on the unpadded axis, the flagship 2 x 11
     forced through it beside the tiled form, a span past its window, shifts
     past N); padded lanes must be exactly 0, each call must launch its form,
     the general form must give the same bits twice and the plan of
     ops/gat_stencil.py:general_plan (gat_plan), and the bare C entry is
     timed beside the wrapper, with each case's share of its bound. The short attention runs with dropout p = 0.1 (the training
     call) and 0; its keep mask is read back through the kernel's output and
     must equal the plain hash bit for bit, keep 0.9 +- 0.001 of the draws and
     change with the seed. Its backward is checked in fp32 and bf16 at p = 0
     and 0.1. The fused MLP runs at 70656 rows (the serve batch), 8832 (one
     window) and 1000 (ragged), and with x scaled by 2^-6 (the branch alone);
     the cuBLAS time of its two products alone is printed as an anchor. Flash
     attention runs at the byte LM's (64, 129, 12, 64) causal on views of a
     c_attn output in fp32 and bf16, in bf16 with dropout p = 0.1 (its mask read
     back as the short kernel's is) and on a view that is not 16-byte aligned,
     at head dims 32 and 128, at T = 300 non-causal and at T = 1024 causal
     (B = 8), with SDPA as the library call, and its bare C entry timed beside
     the wrapper (flash_bare_entry). The temporal encoder's conv kernel
     (csrc/temporal_conv.cu) runs at TEMPORAL_CASES against its mirror (the same
     bits twice, one launch a call), timed through the wrapper, bare and on the
     device's clock at the eval batch beside the plain blocks (check_temporal);
  4. serve: a synthetic processed dir at the 41x71 grid, ForecastService on the
     flagship Config() with seeded random weights at max_batch=8 in bf16,
     forecast requests over HTTP on localhost (some concurrent, so the batcher
     coalesces), first on the default path and then with fused_attn and
     use_fused_mlp; launch counts are zeroed before and read after each run;
     forecasts are checked for shape and finiteness, against an fp32 forward of
     the plain path, and the two paths against each other;
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
     latest.pt, latest.meta.json and best_params.pt, and the GAT kernel launched
     once per validation forward (16), the temporal conv kernel as often and no
     other kernel. Run B is stopped by
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
     finite, rollout_results.csv written, and the GAT kernel launched exactly
     once per eval batch and once per rollout chunk, no other kernel than the
     temporal conv kernel (see gat_launches). The same
     evaluation on the plain GAT within VAL_RTOL on MAE and RMSE; the eval loop
     timed on a warm executor (windows/s, ms a batch) and profiled (busy share
     over the unprofiled wall); the rollout timed and profiled. The weights
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
     other, exactly one GAT launch per validation batch and no other kernel
     than the temporal conv kernel, a
     gathered fp32 batch within 1e-6 of the host mirror; the device-resident
     bytes, and each mode's warm epoch (windows/s, busy share of a profiled
     epoch over the unprofiled wall, HtoD copy ms).
 11. export: phase 6's run A best_params.pt through the export CLI (python -m
     tec_mollm_tpu_torch.export), on the default path and at the fused config
     (fused_attn, use_fused_mlp, bf16), each with a symbolic batch and at
     --batch-size 8, and a default artifact traced on the CPU for both
     platforms and moved to the card: its export and load wall and .pt2 size;
     its op nodes (tec_mollm.gat_stencil once, tec_mollm.short_attention and
     tec_mollm.fused_ln_mlp once per block in a fused one, no aten.roll); 16
     HTTP requests through ForecastService(artifact=...) against the
     checkpoint service of the same flags, within EXPORT_TOL_SCALED, with
     exactly one GAT launch per forward (and 3 attention and 3 MLP launches
     per fused forward); full-batch forward ms and request p50/p95 beside the
     checkpoint service's; and python -m tec_mollm_tpu_torch.serve --artifact
     --bench SERVE_CLI_BENCH, one GAT launch per forward.
 12. data parallel (after phase 8), at phase 6's width and cut: (a) torchrun
     --standalone --nproc_per_node 1 runs this script as a rank, which joins
     the NCCL group and calls the train CLI (train.main) with --multihost and
     phase 6's run-A flags (bf16, dropout 0.1, a checkpoint every 2 macro
     steps): per-epoch losses within RESUME_RTOL of run A's, the GAT kernel
     launched once per validation batch and nothing else; then a second DDP
     trainer's warm epoch, staged macro step and busy share (epoch_timings,
     its profile of the card's activity alone) beside phase 6's, and its
     staged step through DDP and without it in turns (ddp_vs_bare_step). (b)
     DDP_RANKS ranks on the one card over gloo (init_distributed(backend=
     "gloo")), Config() in fp32 without dropout at batch 1 a rank, against
     one process at batch 2 (the same global macro batch): per-epoch train
     and val losses within DDP_RTOL, validation MAE by horizon within
     DDP_MAE_RTOL, identical on every rank, and each rank's GAT launches
     equal to its validation batches (no launch lost to a rank). Then
     run_evaluation and get_model_predictions on the ranks' best_params.pt:
     every rank the same metrics and predictions, equal to one process on
     the same checkpoint within DDP_EVAL_TOL, the predictions in window
     order, and the GAT launches its shards need. Each rank writes its
     launch counts to a JSON file, and the kernels line sums them.
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
     counts; the kernels line sums them.
 14. ablation (after phase 13): (a) the SARIMA baseline (models/sarima.py) on
     a seeded simulated AR-dominated SARIMA series of (SARIMA_T, 2911): its
     three kernels (csrc/sarima.cu: the CSS innovations, their adjoint, the
     forecast of SARIMA_BATCH windows) against their plain versions at random
     coefficients within SARIMA_RTOL, 3 Adam steps through the kernels
     against the plain versions within SARIMA_ADAM_ATOL; the fit's two
     kernels also at SARIMA_EDGES (short T, few nodes at season 1, season 23,
     T below season + 1) within SARIMA_RTOL, and two launches on the same
     inputs bit-identical; the forecast at SARIMA_FORECAST_EDGES (the eval
     CLI's last partial batch, one window, a node count below a warp at
     season 1, the shortest window, season 23, seasons 302 and 528) within
     SARIMA_RTOL, twice for the same bits (the flagship's too), its launch
     plan that of ops/sarima.py:forecast_plan (forecast_plan_of); each kernel
     timed beside its plain version and its bytes bound (and through their
     bare C entries, sarima_bare_entry and forecast_bare_entry; the forecast
     also on the device's own clock, kernel_device_ms, and at
     SARIMA_FORECAST_LARGE windows; the kernels' registers and spills from
     the build's ptxas log), and one fit step's loss and gradient (back to
     back, its share of a fit step's wall); then
     the full fit of SARIMA_FIT_STEPS steps through the kernels (its wall, ms
     a step, one launch of each pass a step; the fitted phi's node mean within
     SARIMA_PHI_TOL of the truth, as the JAX test asks) and a forecast batch;
     SARIMA_PROFILE_STEPS warm fit steps timed, and as many profiled (the
     device's busy share);
     then the test CLI with --baseline sarima on phase 8's checkpoint and
     data: a finite SARIMA row beside the model's and the HA's, the fit's
     launches and one forecast launch a batch of SARIMA_BATCH. (b) phase 5's
     train step (B = 8, bf16, fused_attn) with every dropout at 0, the same
     weights and batch under each of ARMS (the default, fuse_conv, lean_gn,
     im2col_conv, the two-pass LayerNorm, remat 'full' and 'dots_saveable'):
     one step's loss and gradients against the default's within GRAD_TOL,
     then step ms and peak memory over ARM_STEPS steps.
The phases run in the order 1-6, 9-11, 8, 12, 13, 14, 7; the total time is printed. The
last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON. Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
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

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}

# kernel vs plain version on the card: |kernel - plain| <= ATOL + RTOL * |plain|.
# Both compute in fp32 and round the output to the tensor's dtype; they differ
# in the order of fp32 sums (and, in the fused MLP, in the bf16 rounding of the
# hidden activations), so a bf16 output may differ by one bf16 ulp (2^-8 relative).
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-5, 1e-5)}
# served forecasts, in scaled units: bf16 through 3 GPT-2 blocks against an fp32
# forward, and the fused kernels against the default path (two-pass vs lean LN,
# fp32 vs bf16 q*k products)
SERVE_TOL_SCALED = 0.1
# attention dropout of the training path (ModelConfig.llm_dropout) and the seed
# of the kernel checks; the kept share of ~1.7 M draws must lie within
# KEPT_TOL of 1 - p (about 4 standard deviations)
DROPOUT, DROPOUT_SEED, KEPT_TOL = 0.1, 12345, 1e-3
# the flagship eval batch (the service's max_batch, and the kernels' batch),
# back-to-back calls in one CUDA-event timing and the timings whose median is
# kept, timesteps of the synthetic test split, forecast requests and the
# threads that send the concurrent ones
BATCH, REPS, TIMING_RUNS, STEPS, REQUESTS, THREADS = 8, 20, 5, 150, 16, 6
# train phase: warm-up and timed steps of the flagship train step, and the
# windows of the gradient check
TRAIN_WARMUP, TRAIN_STEPS, GRAD_BATCH = 2, 10, 2
# gradient check: the largest per-tensor max|kernel bf16 - plain fp32| /
# max|plain fp32| over the trainable tensors. bf16 alone moves the worst tensor
# by a few percent (the bf16 plain path, printed beside it); a wrong attention
# backward moves lora_A/lora_B and everything below the blocks by order 1.
GRAD_TOL = 0.1
# flash attention checks: (batch, T, causal, head dim, dtypes) by label; "path"
# is the byte LM's pretraining batch (64 rows of seq_len 128 + 1 tokens, 12 heads
# of 64); "t300" makes the JAX wrapper pad T to 512 and mask keys >= t_valid;
# "t1024" is the shape of scripts/bench_flash_attention.py; "d32" and "d128" the
# kernel's other head dims
FLASH_CASES = {
    "path": (64, 129, True, 64, ("fp32", "bf16")),
    "t300": (8, 300, False, 64, ("fp32", "bf16")),
    "t1024": (8, 1024, True, 64, ("fp32", "bf16")),
    "d32": (64, 129, True, 32, ("bf16",)),
    "d128": (64, 129, True, 128, ("bf16",)),
}
# stencil GAT checks of the tiled kernel: (slices M, stencil radius km, nodes N)
# by label; "path" is the flagship eval batch (8 windows x 48 steps, N padded to
# 2944), "eval" the eval step's batch of 16 windows, "r300" the 300 km
# (long_horizon) stencil (33 offsets, largest |shift| 144), "n2911" the
# unpadded node axis (rows not 16-byte aligned), "m70000" more slices than a
# grid's y axis held (65535) on the GAT_SMALL_GRID stencil padded to 64 nodes;
# check_gat adds "trainer", the trainer's validation batch (batch_size x L_in
# slices of Config()).
GAT_CASES = {
    "path": (BATCH * 48, 150.0, 2944),
    "eval": (2 * BATCH * 48, 150.0, 2944),
    "r300": (2 * BATCH * 48, 300.0, 2944),
    "n2911": (BATCH * 48, 150.0, 2911),
    "m70000": (70_000, 150.0, 64),
}
# and of its general form: (slices M, stencil, nodes N, heads, channels), the
# stencil a radius in km or a synthetic one by name (GAT_SYNTHETIC); "path" is
# the serve batch of a 1 head x 22 channel config (trainer phase), "r450" the
# 450 km stencil (81 offsets, largest |shift| 284) at the trainer's validation
# batch, "n2911" 4 heads x 16 channels on the unpadded node axis; "forced" the
# flagship 2 x 11 eval batch through the bare C entry with general = 1 (the
# tiled form's own shape, timed beside the tiled form's bare entry: the
# general form's yardstick); "overflow" a span past the widest window that
# fits (the offsets outside it read from device memory); "oob" shifts past N
# marked valid, whose neighbours the kernel must count out of range
GAT_GENERAL_CASES = {
    "path": (BATCH * 48, 150.0, 2944, 1, 22),
    "r450": (2 * 48, 450.0, 2944, 2, 11),
    "n2911": (2 * 48, 150.0, 2911, 4, 16),
    "forced": (BATCH * 48, 150.0, 2944, 2, 11),
    "overflow": (2 * 48, "overflow", 2944, 2, 11),
    "oob": (2 * 48, "oob", 2944, 1, 22),
}
# the synthetic stencils: shifts added to the 150 km stencil's, each valid on
# every real lane whose neighbour is in range ("overflow": a span of 5,100
# nodes, about three times the widest window a block holds in bf16) or on
# every real lane ("oob": N, -N - 3 and 5,000 nodes, no neighbour in range; the
# plain version, which wraps around, is given the mask with the range check
# folded in)
GAT_SYNTHETIC = {"overflow": lambda n: (1400, -1400, 2500, -2600), "oob": lambda n: (n, -n - 3, 5000)}
GAT_SMALL_GRID = (6, 8)
# fused MLP checks: rows by label; "path" is the serve batch (8 windows x 2944
# padded nodes x 3 patches), "window" one window's rows, "ragged" a row count
# that no tile divides
MLP_ROWS = {"path": BATCH * 2944 * 3, "window": 2944 * 3, "ragged": 1000}
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
# ablation phase, SARIMA: the simulated series' steps (the eval harness's
# fit_window), the season, Adam steps of a fit and the forecast batch (the
# harness's); the series is AR-dominated (the JAX test's recovery case), and
# the fitted phi's node mean must lie within SARIMA_PHI_TOL of its truth, as
# that test asks. Kernel against plain: each output's largest difference over
# its largest magnitude within SARIMA_RTOL (fp32 both; the kernel contracts
# multiply-adds and sums a node's terms in time order, the plain version sums
# with torch's reductions, and the recursion is stable with |coefficients| <
# 0.99, so the two differ at fp32 rounding); the raw parameters after 3 Adam
# steps within SARIMA_ADAM_ATOL. A step moves a raw parameter by lr * m / (sqrt(v)
# + eps), about lr = 0.05 where its gradient is large; where a node's gradient
# is near eps = 1e-8 (the loss is a mean over 2911 nodes, so a gradient is
# ~1e-4 at most), a gradient difference d moves the step by up to lr * d /
# (4 eps), about 4e-4 for d = 1e-6 of the largest gradient: three steps
# stay within 1e-3, where a wrong gradient moves the parameters by ~lr.
SARIMA_T, SARIMA_SEASON, SARIMA_FIT_STEPS, SARIMA_BATCH = 2000, 12, 400, 64
SARIMA_TRUTH, SARIMA_PHI_TOL = (0.6, 0.0, 0.0, 0.0), 0.15
SARIMA_RTOL, SARIMA_ADAM_ATOL = 1e-4, 1e-3
# the fit kernels' edge shapes (T, N, season), held against the plain versions
# as the flagship is: the test CLI's 94-step fit, a node count below one tile
# at season 1, the CLI's largest season at L_in 48, and T below season + 1
# (no loss term); then the warm fit steps timed and profiled
SARIMA_EDGES = ((94, 2911, 12), (1987, 37, 1), (500, 2911, 23), (10, 2911, 12))
# the forecast's edge shapes (windows, L, N, season, horizon), held against
# forecast_reference as the flagship is: the eval CLI's last partial batch (91
# test windows), one window, a node count below a warp at season 1, the
# shortest window at season 12, the CLI's largest season at L_in 48, and
# seasons 302 and 528 (one warp a block: its rings fill shared memory)
SARIMA_FORECAST_EDGES = ((27, 48, 2911, 12, 12), (1, 48, 2911, 12, 12), (5, 4, 37, 1, 3), (8, 26, 2911, 12, 12),
                         (8, 48, 2911, 23, 12), (2, 606, 64, 302, 12), (2, 1060, 64, 528, 12))
# the forecast's windows in a batch large enough that no call's host cost
# hides its device time (a year's test split is 4,380 windows)
SARIMA_FORECAST_LARGE = 1024
# kernel_device_ms: the launches a reading of the forecast's device time is
# taken over
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


def log(msg: str) -> None:
    print(msg, flush=True)


# csrc/temporal_conv.cu runs once in every eval forward of a bf16 model at the
# flagship's temporal widths and length, beside the GAT kernel: the checks of
# the GAT's launches compare the counts without it, and the phases that know
# their forwards check its own count.
TEMPORAL = "temporal_conv"


def gat_launches(counts: dict) -> dict:
    """Launch counts without the temporal conv kernel's."""
    return {k: v for k, v in counts.items() if k != TEMPORAL}


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


def compare(got, want, dtype_name: str) -> tuple[float, float, bool]:
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool(((diff <= atol + rtol * w.abs()) & g.isfinite()).all())
    return max_abs, max_rel, ok


def bound(bytes_moved: float, flops: float, flop_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dropout_mask_check(rows: int, t: int, d: int, heads: int, failures: list) -> dict:
    """The forward kernel's own keep mask, read back through its output: with
    q = k = 0 every causal weight is 1/(tq+1), and v[m, s, h, j] = [j == s]
    puts weight s of head h in output lane h*Dh + s. The mask must be the plain
    hash's bit for bit, keep 1 - p of the draws, and change with the seed."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_threshold

    dev = torch.device("cuda")
    hd = d // heads
    zeros = torch.zeros(rows, t, d, device=dev)
    v = torch.zeros(rows, t, heads, hd, device=dev)
    idx = torch.arange(t, device=dev)
    v[:, idx, :, idx] = 1.0
    v = v.reshape(rows, t, d)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    unscale = (idx + 1.0)[None, :, None, None] * (1.0 - DROPOUT)

    def kernel_mask(seed: int) -> torch.Tensor:  # (M, H, Tq, Ts)
        out = ops.short_attention_forward(zeros, zeros, v, heads, DROPOUT, seed)
        return (out.reshape(rows, t, heads, hd)[..., :t] * unscale > 0.5).permute(0, 2, 1, 3) & causal

    mask, other = kernel_mask(DROPOUT_SEED), kernel_mask(DROPOUT_SEED + 1)
    plain = (dropout_bits(DROPOUT_SEED, rows, heads, t, dev) >= dropout_threshold(DROPOUT)) & causal
    draws = rows * heads * int(causal.sum())
    kept = float(mask.sum()) / draws
    out = {
        "dropout_draws": draws, "kept_fraction": kept, "kept_tol": KEPT_TOL,
        "mask_equals_plain_hash": bool(torch.equal(mask, plain)),
        "mask_share_changed_by_next_seed": float((mask != other).sum()) / draws,
    }
    log(
        f"dropout p={DROPOUT}: kernel kept {kept:.6f} of {draws} draws (want {1 - DROPOUT} +- {KEPT_TOL}); "
        f"mask equals the plain hash: {out['mask_equals_plain_hash']}; seed+1 changes "
        f"{out['mask_share_changed_by_next_seed']:.4f} of it"
    )
    if abs(kept - (1.0 - DROPOUT)) > KEPT_TOL:
        failures.append("short_attention kept fraction")
    if not out["mask_equals_plain_hash"]:
        failures.append("short_attention mask differs from the plain hash")
    if out["mask_share_changed_by_next_seed"] < 0.1:
        failures.append("short_attention mask does not change with the seed")
    return out


def check_kernels(args, graph, results: dict) -> list[dict]:
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config

    cfg = Config().resolved().model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = -(-cfg.num_nodes // 128) * 128  # the model pads the node axis to 2944
    rows = BATCH * n
    rows_llm = rows * cfg.num_patches
    d, heads = cfg.d_llm, cfg.llm_heads
    entries, failures = [], []

    def rand(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    # --- 1. stencil GAT at (B*L, H*C, N): the tiled kernel, then its general form ---
    train_cfg = Config().resolved().train
    hc = (cfg.spatial_heads, cfg.spatial_out_channels)
    tiled = {k: (*v, *hc) for k, v in GAT_CASES.items()}
    tiled["trainer"] = (train_cfg.batch_size * train_cfg.L_in, 150.0, n, *hc)
    entries.append(check_gat(graph, rand, failures, "gat_stencil", tiled))
    general = check_gat(graph, rand, failures, "gat_stencil_general", GAT_GENERAL_CASES)
    general["ptxas"] = [k for k in results.get("gat_ptxas", []) if "gat_stencil_general_kernel" in k["entry"]]
    entries.append(general)

    # --- 2. short causal attention at (B*N, T, D), q/k/v views of the c_attn output ---
    t = cfg.num_patches
    hd = d // heads
    qkv = rand(rows, t, 3 * d)
    q, k, v = qkv.split(d, dim=-1)
    attn = {
        "name": "short_attention", "source": "tec_mollm_tpu_torch/csrc/short_attention.cu",
        "replaces": "tec_mollm_tpu/ops/short_attention.py:253",
        "shape": f"q,k,v ({rows},{t},{d}) bf16, {heads} heads, dropout {DROPOUT}",
        "bytes": 4 * rows * t * d * 2,
        "flops": rows * heads * (t * (t + 1) // 2) * hd * 4,
        "flop_rate": PEAK_FLOPS["fp32"],
    }
    for rate, tag in ((0.0, "p0"), (DROPOUT, "bf16")):  # tag "bf16": the training call, p = 0.1
        got = ops.short_attention_forward(q, k, v, heads, rate, DROPOUT_SEED)
        want = ops.short_causal_attention_reference(q, k, v, heads, rate, DROPOUT_SEED)
        torch.cuda.synchronize()
        attn[f"max_abs_err_{tag}"], attn[f"max_rel_err_{tag}"], ok = compare(got, want, "bf16")
        attn[f"tol_{tag}"] = TOL["bf16"]
        if not ok:
            failures.append(f"short_attention bf16 p={rate}")
    attn["max_abs_err"] = attn["max_abs_err_bf16"]
    attn.update(dropout_mask_check(rows, t, d, heads, failures))
    q4, k4, v4 = (a.reshape(rows, t, heads, hd).transpose(1, 2) for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn["ms_p0"] = time_ms(lambda: ops.short_attention_forward(q, k, v, heads), REPS)
    attn["ms"] = time_ms(lambda: ops.short_attention_forward(q, k, v, heads, DROPOUT, DROPOUT_SEED), REPS)
    attn["plain_ms"] = time_ms(
        lambda: ops.short_causal_attention_reference(q, k, v, heads, DROPOUT, DROPOUT_SEED), REPS
    )
    attn["library_ms"] = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True, dropout_p=DROPOUT), REPS)
    entries.append(attn)

    # --- 2b. its backward: q, k, v, g -> (B*N, T, 3D) = [dq | dk | dv] ---
    bwd = {
        "name": "short_attention_bwd", "source": "tec_mollm_tpu_torch/csrc/short_attention.cu",
        "replaces": "tec_mollm_tpu/ops/short_attention.py:279",
        "shape": f"q,k,v,g ({rows},{t},{d}) -> dqkv ({rows},{t},{3 * d}), {heads} heads, dropout {DROPOUT}",
        "bytes": 7 * rows * t * d * 2,
        # per causal (query, key) pair and head: q.k, g.v, and the dv, dq, dk
        # multiply-adds, 2 * Dh each
        "flops": rows * heads * (t * (t + 1) // 2) * hd * 10,
        "flop_rate": PEAK_FLOPS["fp32"],
    }
    g = rand(rows, t, d)
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        qkv_d, g_d = qkv.to(dt), g.to(dt)
        qd, kd, vd = qkv_d.split(d, dim=-1)
        for rate in (0.0, DROPOUT):
            tag = name if rate else f"{name}_p0"
            got = ops.short_attention_backward(qd, kd, vd, g_d, heads, rate, DROPOUT_SEED)
            want = ops.short_causal_attention_backward_reference(qd, kd, vd, g_d, heads, rate, DROPOUT_SEED)
            torch.cuda.synchronize()
            bwd[f"max_abs_err_{tag}"], bwd[f"max_rel_err_{tag}"], ok = compare(got, want, name)
            bwd[f"tol_{tag}"] = TOL[name]
            if not ok:
                failures.append(f"short_attention_bwd {name} p={rate}")
    bwd["max_abs_err"] = bwd["max_abs_err_bf16"]
    bwd["ms"] = time_ms(lambda: ops.short_attention_backward(q, k, v, g, heads, DROPOUT, DROPOUT_SEED), REPS)
    bwd["plain_ms"] = time_ms(
        lambda: ops.short_causal_attention_backward_reference(q, k, v, g, heads, DROPOUT, DROPOUT_SEED), REPS
    )
    q4, k4, v4 = (a.detach().requires_grad_() for a in (q4, k4, v4))
    g4 = g.reshape(rows, t, heads, hd).transpose(1, 2)
    lib_out = sdpa(q4, k4, v4, is_causal=True, dropout_p=DROPOUT)
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True), REPS)
    entries.append(bwd)

    # --- 3. fused LN -> MLP -> residual at (B*N*T, d) ---
    entries.append(check_mlp(cfg, rand, failures))
    entries.append(check_flash(cfg, rand, failures))
    entries.append(check_temporal(cfg, failures))

    for e in entries:
        e["bound_ms"], e["bound_by"] = bound(e["bytes"], e["flops"], e.pop("flop_rate"))
        e["route"] = "cuda"
        lib_ms = "-" if e["library_ms"] is None else "%.4f ms" % e["library_ms"]
        errs = ", ".join(
            "%s max_abs %.3e max_rel %.3e (tol atol %g rtol %g)" % (
                name, e[f"max_abs_err_{name}" if f"max_abs_err_{name}" in e else "max_abs_err"],
                e[f"max_rel_err_{name}"], *e[f"tol_{name}"])
            for name in [key[len("max_rel_err_"):] for key in e if key.startswith("max_rel_err_")]
        )
        log(
            f"kernel {e['name']}: {e['shape']}: {errs}; kernel {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, library {lib_ms}, bound {e['bound_ms']:.4f} ms ({e['bound_by']})"
        )
    results["kernel_failures"] = failures
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return entries


def gat_bare_entry(xl, xr, valid, att, shifts, general: bool = False):
    """A call of the GAT kernel's C entry with its arguments marshalled once,
    into a fresh output: the wrapper's launch without its checks and Python
    (the timing cap); with ``general`` the general form whatever the layout.
    Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import gat_stencil as g

    att32 = att.float().contiguous()
    out = torch.empty_like(xl)
    fn = _build.function("gat_stencil_forward", g.ARGTYPES)
    shifts = g.check_stencil(shifts)
    args = list(g.entry_args(xl, xr, valid, att32, shifts, out, 0.2))
    if general:
        args[4], args[14] = g._device_shifts(shifts, xl.device).data_ptr(), 1

    def call():
        _build.check(g.NAME, fn(*args))
        return out

    return call


def gat_plan(shifts, channels: int, n: int, bf16: bool) -> dict:
    """The general form's plan for a call, from the C entry
    gat_stencil_general_plan; raises where it differs from the Python mirror
    (ops/gat_stencil.py:general_plan)."""
    import ctypes

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import gat_stencil as g

    out = (ctypes.c_longlong * len(g.GeneralPlan._fields))()
    host = g._shift_array(tuple(shifts))
    fn = _build.function("gat_stencil_general_plan", g.PLAN_ARGTYPES)
    _build.check("gat_stencil_general_plan", fn(ctypes.cast(host, ctypes.c_void_p), len(shifts), channels, n,
                                                 int(bf16), ctypes.cast(out, ctypes.c_void_p)))
    plan = g.GeneralPlan(*out)
    mirror = g.general_plan(shifts, channels, n, 2 if bf16 else 4)
    if plan != mirror:
        raise RuntimeError(f"the general form's plan {plan} differs from the mirror's {mirror}")
    return plan._asdict()


def flash_bare_entry(q, k, v, causal: bool):
    """A call of the flash kernel's C entry with its arguments marshalled
    once (``flash_attention.entry_args``), into a fresh output: the wrapper's
    launch without its checks and Python. Not counted."""
    import importlib

    import torch

    from tec_mollm_tpu_torch.ops import _build

    # the module (ops re-exports its function under the same name)
    fa = importlib.import_module("tec_mollm_tpu_torch.ops.flash_attention")
    q, k, v = (fa._aligned16(a) for a in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.function("flash_attention_forward", fa.ARGTYPES)
    args = fa.entry_args(q, k, v, out, causal, 0.0, 0)

    def call():
        _build.check(fa.NAME, fn(*args))
        return out

    return call


def sarima_bare_entry(y, coeffs, season: int, e=None, scale: float = 0.0):
    """A call of a SARIMA fit kernel's C entry (the forward, or with ``e``
    the adjoint) with its arguments marshalled once, into fresh outputs: the
    wrapper's launch without its checks and Python. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import sarima as sops

    steps, n = y.shape
    stream = _build.stream_handle(y.device)
    if e is None:
        name, out = sops.FORWARD, (torch.empty_like(y), torch.empty(n, dtype=torch.float32, device=y.device))
        fn = _build.function("sarima_css_forward", sops.FORWARD_ARGTYPES)
        args = (y.data_ptr(), coeffs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), steps, n, season, stream)
    else:
        name, out = sops.BACKWARD, torch.empty((4, n), dtype=torch.float32, device=y.device)
        fn = _build.function("sarima_css_backward", sops.BACKWARD_ARGTYPES)
        args = (y.data_ptr(), e.data_ptr(), coeffs.data_ptr(), out.data_ptr(), scale, steps, n, season, stream)

    def call():
        _build.check(name, fn(*args))
        return out

    return call


def forecast_bare_entry(x, coeffs, horizon: int, season: int):
    """A call of the SARIMA forecast kernel's C entry with its arguments
    marshalled once, into a fresh output: the wrapper's launch without its
    checks and Python. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import sarima as sops

    b, length, n = x.shape
    out = torch.empty((b, horizon, n), dtype=torch.float32, device=x.device)
    fn = _build.function("sarima_forecast", sops.FORECAST_ARGTYPES)
    args = (x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), b, length, n, season, horizon,
            _build.stream_handle(x.device))

    def call():
        _build.check(sops.FORECAST, fn(*args))
        return out

    return call


def forecast_plan_of(length: int, season: int, horizon: int) -> dict:
    """The SARIMA forecast's launch plan for a call, from the C entry
    sarima_forecast_plan; raises where it differs from the Python mirror
    (ops/sarima.py:forecast_plan)."""
    import ctypes

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import sarima as sops

    out = (ctypes.c_longlong * len(sops.ForecastPlan._fields))()
    fn = _build.function("sarima_forecast_plan", sops.FORECAST_PLAN_ARGTYPES)
    _build.check("sarima_forecast_plan", fn(length, season, horizon, ctypes.cast(out, ctypes.c_void_p)))
    plan, mirror = sops.ForecastPlan(*out), sops.forecast_plan(length, season, horizon)
    if plan != mirror:
        raise RuntimeError(f"the forecast's plan {plan} differs from the mirror's {mirror}")
    return plan._asdict()


def kernel_device_ms(fn, reps: int, match: str) -> tuple[float | None, int]:
    """One launch's device time of the kernels whose names hold ``match``,
    and the launches it was taken over: torch.profiler's CUDA kernel events
    (CUPTI) over ``reps`` calls of ``fn`` after two warm-up calls, summed and
    divided by the launches the trace saw. The host's cost of a call does
    not enter it. Late in this script the trace misses the first launches
    it should see (about 40 in phase 14 on the H100, 2 fit steps in the
    fit's profile), so many are traced; (None, 0) where it saw none: a time
    not measured, not a failed kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in device_rows(prof.key_averages()) if match in r[2]]
    launches = sum(c for _, c, _ in rows)
    return (sum(ms for ms, _, _ in rows) / launches if launches else None), launches


def device_note(ms: float | None, launches: int, reps: int, bound_ms: float) -> str:
    """kernel_device_ms's reading for a log line, beside the bound."""
    if ms is None:
        return f"on the device not measured (the profiler saw none of {reps} launches)"
    return f"on the device {ms:.4f} ms over {launches} of {reps} launches, the bound {bound_ms / ms:.1%} of it"


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


def check_gat(graph, rand, failures: list, name: str, cases: dict) -> dict:
    """One form of the stencil GAT kernel against its plain version at
    ``cases`` (label: (M, stencil, N, heads, channels)) in fp32 and bf16,
    padded lanes exactly 0; the entry's times are the "path" case's in bf16,
    through the wrapper and through the bare C entry, with the other cases'
    times, bounds and shares of bound under their labels. Every call must
    launch this form (``name``), but "forced", which goes through the bare
    entry with general = 1. The general form also launches twice on the same
    inputs (the same bits) and checks its plan (gat_plan)."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.graph.builder import build_grid_stencil

    dev = torch.device("cuda")
    general = name == "gat_stencil_general"

    def stencil(km, n: int, small: bool = False):
        """shifts, the kernel's mask, and the plain version's (the range check folded in for "oob")"""
        if small:
            g_small = build_graph(*grid_coordinates(*GAT_SMALL_GRID))
            shifts, v = g_small.stencil_shifts, g_small.stencil_valid
        elif km == 150.0 or km in GAT_SYNTHETIC:
            shifts, v = graph.stencil_shifts, graph.stencil_valid
        else:
            shifts, v = build_grid_stencil(*grid_coordinates(41, 71), km)
        shifts = [int(s) for s in shifts]
        valid = torch.zeros(len(shifts), n, dtype=torch.bool, device=dev)
        valid[:, :v.shape[1]] = torch.as_tensor(v, device=dev)
        if km in GAT_SYNTHETIC:
            real = v.shape[1]
            extra = list(GAT_SYNTHETIC[km](n))
            nodes = torch.arange(n, device=dev)
            rows = []
            for s in extra:
                row = nodes < real
                if km == "overflow":
                    row &= (nodes + s >= 0) & (nodes + s < n)
                rows.append(row)
            shifts += extra
            valid = torch.cat([valid, torch.stack(rows)])
        j = torch.arange(n, device=dev)[None, :] + torch.tensor(shifts, device=dev)[:, None]
        return tuple(shifts), valid, valid & (j >= 0) & (j < n)

    entry = {
        "name": name, "source": "tec_mollm_tpu_torch/csrc/gat_stencil.cu",
        "replaces": "tec_mollm_tpu/ops/gat_stencil.py:104", "library_ms": None,
    }
    for label, (m, km, n, heads, channels) in cases.items():
        shifts, valid, valid_plain = stencil(km, n, small=label == "m70000")
        att = rand(heads, channels, dtype=torch.float32, std=0.3)
        hc = heads * channels
        real = int(valid.any(dim=0).nonzero().max()) + 1  # lanes past the grid's nodes are padding
        reach = max(map(abs, shifts))
        case = {"shape": f"xl,xr ({m},{hc},{n}), {heads}x{channels}; valid ({len(shifts)},{n}); "
                         f"{km if isinstance(km, str) else f'{km:g} km'}; largest |shift| {reach}"}
        forced = label == "forced"
        for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xl, xr = rand(m, hc, n, dtype=dt), rand(m, hc, n, dtype=dt)
            ops.reset_counts()
            if forced:
                got = gat_bare_entry(xl, xr, valid, att, shifts, general=True)().clone()
            else:
                got = ops.gat_stencil_attention(xl, xr, valid, att, shifts)
            counts = ops.launch_counts()
            want = ops.gat_stencil_reference(xl, xr, valid_plain, att, shifts)
            torch.cuda.synchronize()
            tag = dname if label == "path" else f"{label}_{dname}"
            entry[f"max_abs_err_{tag}"], entry[f"max_rel_err_{tag}"], ok = compare(got, want, dname)
            entry[f"tol_{tag}"] = TOL[dname]
            if not ok:
                failures.append(f"{name} {label} {dname}")
            if counts != ({} if forced else {name: 1}):
                failures.append(f"{name} {label} {dname}: launched {counts}")
            if real < n and not bool((got[..., real:] == 0).all()):
                failures.append(f"{name} {label} {dname}: padded lanes not exactly 0")
            case[f"padded_lanes_{dname}"] = n - real
            if general:
                again = (gat_bare_entry(xl, xr, valid, att, shifts, general=True)() if forced
                         else ops.gat_stencil_attention(xl, xr, valid, att, shifts))
                case[f"same_bits_{dname}"] = bool(torch.equal(got, again))
                if not case[f"same_bits_{dname}"]:
                    failures.append(f"{name} {label} {dname}: two launches differ")
                case[f"plan_{dname}"] = gat_plan(shifts, channels, n, dt == torch.bfloat16)
                del again
            del got, want
        if general:
            plan = case["plan_bf16"]
            if label == "overflow" and not 0 < plan["window_offsets"] < plan["reach"]:
                failures.append(f"{name} overflow: the plan reads no offset from device memory: {plan}")
            if label == "oob" and plan["reach"] != len(graph.stencil_shifts):
                failures.append(f"{name} oob: shifts past N counted as reaching a node: {plan}")
        valid_pairs = int(valid_plain.sum())
        run = gat_bare_entry(xl, xr, valid, att, shifts, general=forced)
        case.update({
            "bare_ms": time_ms(run, REPS),
            "bytes": 3 * m * hc * n * 2 + valid.numel() + att.numel() * 4,
            # per valid (node, offset) pair and slice: add, leaky-relu, multiply-add
            # per channel for the score, exp, and a multiply-add per channel for the sum
            "flops": m * valid_pairs * (hc * 5 + 2 * hc + 4),
        })
        if not forced:
            case["ms"] = time_ms(lambda: ops.gat_stencil_attention(xl, xr, valid, att, shifts), REPS)
        else:
            case["tiled_bare_ms"] = time_ms(gat_bare_entry(xl, xr, valid, att, shifts), REPS)
        case["bound_ms"], case["bound_by"] = bound(case["bytes"], case["flops"], PEAK_FLOPS["fp32"])
        case["share_of_bound_bare"] = case["bound_ms"] / case["bare_ms"]
        if label == "path":
            case["plain_ms"] = time_ms(lambda: ops.gat_stencil_reference(xl, xr, valid, att, shifts), REPS)
            case["share_of_bound"] = case["bound_ms"] / case["ms"]
            entry.update(case, flop_rate=PEAK_FLOPS["fp32"])
            log(f"kernel {name}[path]: bare entry {case['bare_ms']:.4f} ms (wrapper {case['ms']:.4f}), "
                f"the bound {case['share_of_bound_bare']:.1%} of it")
        else:
            entry[label] = case
            times = (f"kernel {case['ms']:.4f} ms (bare {case['bare_ms']:.4f})" if not forced else
                     f"bare {case['bare_ms']:.4f} ms (the tiled form's bare {case['tiled_bare_ms']:.4f})")
            log(
                f"kernel {name}[{label}]: {case['shape']}: {times}, bound {case['bound_ms']:.4f} ms "
                f"({case['bound_by']}; {case['share_of_bound_bare']:.1%} of the bare time)"
                + (f"; plan {case['plan_bf16']}" if general else "")
            )
        del xl, xr
    entry["max_abs_err"] = entry["max_abs_err_bf16"]
    return entry


def check_mlp(cfg, rand, failures: list) -> dict:
    """The fused MLP against its plain version at MLP_ROWS, plus the branch
    alone at the path's rows; the entry's times are the path's. Beside it, the
    cuBLAS time of the two products alone, and the kernel's launches by name
    from one profiled call."""
    import torch

    from tec_mollm_tpu_torch import ops

    d = cfg.d_llm
    dh = cfg.llm_mlp_ratio * d
    ln_w = 1.0 + rand(d, dtype=torch.float32, std=0.1)
    ln_b = rand(d, dtype=torch.float32, std=0.1)
    w1, b1 = rand(d, dh, std=0.02), rand(dh, dtype=torch.float32, std=0.02)
    w2, b2 = rand(dh, d, std=0.02), rand(d, dtype=torch.float32, std=0.02)
    weights = (ln_w, ln_b, w1, b1, w2, b2)
    rows = MLP_ROWS["path"]
    entry = {
        "name": "fused_mlp", "source": "tec_mollm_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "tec_mollm_tpu/ops/fused_mlp.py:78",
        "shape": f"x ({rows},{d}) bf16, w1 ({d},{dh}), w2 ({dh},{d}) bf16",
    }
    for label, n in MLP_ROWS.items():
        x = rand(n, d)
        got = ops.fused_ln_mlp(x, *weights)
        want = ops.fused_ln_mlp_reference(x, *weights)
        torch.cuda.synchronize()
        tag = "bf16" if label == "path" else label
        entry[f"max_abs_err_{tag}"], entry[f"max_rel_err_{tag}"], ok = compare(got, want, "bf16")
        entry[f"tol_{tag}"] = TOL["bf16"]
        if not ok:
            failures.append(f"fused_mlp {label} ({n} rows)")
        if label == "path":
            x_path = x
    # The residual (|x| ~ 1) dominates the output, so the check above barely sees
    # an error in the MLP branch (~0.35). Scaled by 2^-6 (exact in bf16), x keeps
    # its LN output and the same branch, and the output is about the branch alone:
    # the same tolerance then bounds the GEMMs and their epilogues.
    x_small = x_path * 2.0**-6
    got = ops.fused_ln_mlp(x_small, *weights)
    want = ops.fused_ln_mlp_reference(x_small, *weights)
    torch.cuda.synchronize()
    entry["max_abs_err_branch"], entry["max_rel_err_branch"], ok = compare(got, want, "bf16")
    entry["tol_branch"] = TOL["bf16"]
    if not ok:
        failures.append("fused_mlp bf16, branch alone")
    args = (x_path, *weights)
    hidden = rand(rows, dh)
    entry.update({
        "max_abs_err": entry["max_abs_err_bf16"],
        "ms": time_ms(lambda: ops.fused_ln_mlp(*args), REPS),
        "plain_ms": time_ms(lambda: ops.fused_ln_mlp_reference(*args), REPS),
        "library_ms": None,
        # not library_ms (no one call computes the fused function): the two
        # products alone through cuBLAS, an anchor for the GEMMs' time
        "cublas_products_ms": time_ms(lambda: (x_path @ w1, hidden @ w2), REPS),
        "bytes": 2 * rows * d * 2 + 2 * d * dh * 2 + (3 * d + dh) * 4,
        "flops": 4 * rows * d * dh,
        "flop_rate": PEAK_FLOPS["bf16_tensor"],
        "profile": profile_call(lambda: ops.fused_ln_mlp(*args), top=6),
    })
    log(
        f"anchor: cuBLAS x@w1 + h@w2 (bf16, {rows} rows) {entry['cublas_products_ms']:.4f} ms; the fused "
        f"MLP kernel {entry['ms']:.4f} ms; one profiled call: "
        + ", ".join(f"{r['name'][:48]} {r['ms']:.4f} ms" for r in entry["profile"]["top"])
    )
    return entry


# temporal conv kernel: the flagship eval batch (16 windows x 2,944 padded
# nodes, as EvalExecutor runs it), a ragged count (one window's 2,911 nodes
# + 5) and the serve batch (8 windows)
TEMPORAL_CASES = {"eval": (16, 2944), "ragged": (1, 2911 + 5), "path": (BATCH, 2944)}


def temporal_bare_entry(x, wpack, params):
    """A call of the temporal kernel's C entry with its arguments marshalled
    once, into a fresh output: the wrapper's launch without its checks and
    Python. x is a (B, N, 48, C) view with unit channel stride. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build

    tc = importlib.import_module("tec_mollm_tpu_torch.ops.temporal_conv")  # ops.temporal_conv is the function
    b, n = x.shape[:2]
    out = torch.empty(b * n, tc.OUT_LENGTH, tc.CHANNELS[-1], dtype=x.dtype, device=x.device)
    fn = _build.function("temporal_conv_forward", tc.ARGTYPES)
    args = (x.data_ptr(), b * n, n, x.stride(0), x.stride(1), x.stride(2), x.shape[-1], wpack.data_ptr(),
            wpack.numel() * wpack.element_size(), params.data_ptr(), out.data_ptr(), _build.stream_handle(x.device))

    def call():
        _build.check(tc.NAME, fn(*args))
        return out

    return call


def check_temporal(cfg, failures: list) -> dict:
    """The temporal encoder's conv blocks (csrc/temporal_conv.cu) against the
    mirror (ops/temporal_conv.py:temporal_conv_mirror) at TEMPORAL_CASES, on
    the (B, N, L, C) view of a (B, L, N, C) tensor as the model hands it, on
    seeded blocks whose GroupNorm affines are not the identity: the same bits
    twice, one launch a call. Timed through the wrapper, the bare C entry and
    on the device's clock at the eval batch, beside the plain blocks the
    model ran before (the unfused MultiScaleConvBlock pair in bf16)."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.models.temporal import TemporalEncoder

    tc = importlib.import_module("tec_mollm_tpu_torch.ops.temporal_conv")
    dev = torch.device("cuda")
    enc = TemporalEncoder(cfg)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for block in enc.conv_embedder.embedder:
            block.reset_parameters(g)
            for _, norm, _ in block.convs:
                norm.weight.add_(0.2 * torch.randn(norm.weight.shape, generator=g))
                norm.bias.add_(0.2 * torch.randn(norm.bias.shape, generator=g))
            for conv in [c for c, _, _ in block.convs] + [block.final_conv]:
                conv.bias.add_(0.1 * torch.randn(conv.bias.shape, generator=g))
    enc = enc.to(dev).eval()
    blocks = enc.conv_embedder.embedder
    wpack, params = tc.pack_blocks(blocks, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(11)
    length, cin = cfg.temporal_seq_len, cfg.spatial_channels
    b, n = TEMPORAL_CASES["eval"]
    entry = {
        "name": "temporal_conv", "source": "tec_mollm_tpu_torch/csrc/temporal_conv.cu",
        "replaces": "none (the port's own)",
        "shape": f"x ({b},{n},{length},{cin}) bf16 view -> ({b * n},{tc.OUT_LENGTH},{tc.CHANNELS[-1]})",
    }
    views = {}
    for label, (bb, nn_) in TEMPORAL_CASES.items():
        x = torch.randn(bb, length, nn_, cin, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
        views[label] = x
        ops.reset_counts()
        got = ops.temporal_conv(x, wpack, params)
        torch.cuda.synchronize()
        launches = ops.launch_counts().get("temporal_conv", 0)
        again = ops.temporal_conv(x, wpack, params)
        want = ops.temporal_conv_mirror(x, wpack, params)
        torch.cuda.synchronize()
        tag = "bf16" if label == "eval" else label
        entry[f"max_abs_err_{tag}"], entry[f"max_rel_err_{tag}"], ok = compare(got, want, "bf16")
        entry[f"tol_{tag}"] = TOL["bf16"]
        entry[f"same_bits_{label}"] = bool(torch.equal(got, again))
        entry[f"launches_a_call_{label}"] = launches
        if not ok:
            failures.append(f"temporal_conv {label}")
        if not entry[f"same_bits_{label}"] or launches != 1:
            failures.append(f"temporal_conv {label}: not the same bits twice or not one launch a call")
    x = views["eval"]
    rows = b * n

    def plain():
        return enc.conv_embedder(x.reshape(-1, length, cin).transpose(1, 2)).transpose(1, 2)

    with torch.no_grad():
        plain_out = plain()
        entry["max_abs_vs_plain_blocks"] = float((ops.temporal_conv(x, wpack, params).float() - plain_out.float()).abs().max())
        entry["plain_ms"] = time_ms(plain, 5)
    entry["ms"] = time_ms(lambda: ops.temporal_conv(x, wpack, params), REPS)
    entry["bare_ms"] = time_ms(temporal_bare_entry(x, wpack, params), REPS)
    entry["device_ms"], entry["device_launches"] = kernel_device_ms(
        lambda: ops.temporal_conv(x, wpack, params), REPS, "temporal_conv_kernel")
    c1, c2 = tc.CHANNELS
    taps = sum(tc.KERNEL_SIZES)
    entry.update({
        "max_abs_err": entry["max_abs_err_bf16"],
        "library_ms": None,
        # the products' operations at each branch's own taps (benchmark/counts.py's
        # temporal.* terms), the input read and the output written once
        "flops": 2 * rows * (length * cin * c1 * taps + length // 2 * 3 * c1 * c1
                             + length // 2 * c1 * c2 * taps + length // 4 * 3 * c2 * c2),
        "bytes": rows * (length * cin + tc.OUT_LENGTH * c2) * 2,
        "flop_rate": PEAK_FLOPS["bf16_tensor"],
    })
    log(f"temporal_conv: bare {entry['bare_ms']:.4f} ms, on the device "
        + ("not measured" if entry["device_ms"] is None else f"{entry['device_ms']:.4f} ms")
        + f"; the plain blocks {entry['plain_ms']:.4f} ms; kernel against the plain blocks max abs "
        f"{entry['max_abs_vs_plain_blocks']:.3e}")
    return entry


def flash_mask_check(failures: list) -> dict:
    """The flash kernel's own keep mask at the path shape, read back through its
    output: with q = k = 0 every causal weight of query i is 1/(i+1), and for a
    window of 64 keys starting at w, v[b, j, h, c] = [j == w + c] puts key
    w + c's weight in output lane c. The mask must be the plain hash's bit for
    bit, keep 1 - p of the draws, and change with the seed."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_threshold

    b, t, _, hd, _ = FLASH_CASES["path"]
    heads = 12
    dev = torch.device("cuda")
    zeros = torch.zeros(b, t, heads, hd, device=dev, dtype=torch.bfloat16)
    unscale = (torch.arange(t, device=dev) + 1.0)[None, :, None, None] * (1.0 - DROPOUT)

    def kernel_mask(seed: int) -> torch.Tensor:  # (B, H, Tq, Tk)
        mask = torch.zeros(b, heads, t, t, dtype=torch.bool, device=dev)
        for w in range(0, t, hd):
            width = min(hd, t - w)
            v = torch.zeros_like(zeros)
            idx = torch.arange(width, device=dev)
            v[:, w + idx, :, idx] = 1.0
            out = ops.flash_attention_forward(zeros, zeros, v, True, DROPOUT, seed)
            mask[..., w:w + width] = (out[..., :width].float() * unscale > 0.5).permute(0, 2, 1, 3)
        return mask

    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    mask, other = kernel_mask(DROPOUT_SEED) & causal, kernel_mask(DROPOUT_SEED + 1) & causal
    plain = (dropout_bits(DROPOUT_SEED, b, heads, t, dev) >= dropout_threshold(DROPOUT)) & causal
    draws = b * heads * int(causal.sum())
    kept = float(mask.sum()) / draws
    out = {
        "flash_dropout_draws": draws, "flash_kept_fraction": kept,
        "flash_mask_equals_plain_hash": bool(torch.equal(mask, plain)),
        "flash_mask_share_changed_by_next_seed": float((mask != other).sum()) / draws,
    }
    log(
        f"flash dropout p={DROPOUT}: kernel kept {kept:.6f} of {draws} draws (want {1 - DROPOUT} +- {KEPT_TOL}); "
        f"mask equals the plain hash: {out['flash_mask_equals_plain_hash']}; seed+1 changes "
        f"{out['flash_mask_share_changed_by_next_seed']:.4f} of it"
    )
    if abs(kept - (1.0 - DROPOUT)) > KEPT_TOL:
        failures.append("flash_attention kept fraction")
    if not out["flash_mask_equals_plain_hash"]:
        failures.append("flash_attention mask differs from the plain hash")
    if out["flash_mask_share_changed_by_next_seed"] < 0.1:
        failures.append("flash_attention mask does not change with the seed")
    return out


def check_flash(cfg, rand, failures: list) -> dict:
    """Flash attention against its plain version at FLASH_CASES, on q, k, v
    that are (B, T, H, Dh) views of one (B, T, 3D) c_attn output, as the model
    hands them over; at the path shape also with dropout p = 0.1 (the
    pretraining call) and on a view that is not 16-byte aligned (the wrapper
    copies it). The entry's times are the path shape's at p = 0, the function
    SDPA computes; the other shapes go under their labels with their own
    bounds."""
    import torch

    from tec_mollm_tpu_torch import ops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = cfg.llm_heads
    entry = {
        "name": "flash_attention", "source": "tec_mollm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "tec_mollm_tpu/ops/flash_attention.py:114",
    }

    def views(b, t, hd, dt, pad=0):
        d = heads * hd
        qkv = rand(b, t, 3 * d + pad, dtype=dt)[..., pad:]
        return [a.reshape(b, t, heads, hd) for a in qkv.split(d, dim=-1)]

    def check(label, tag, dtype_name, q, k, v, causal, rate=0.0):
        got = ops.flash_attention_forward(q, k, v, causal, rate, DROPOUT_SEED)
        want = ops.flash_attention_reference(q, k, v, causal, rate, DROPOUT_SEED)
        torch.cuda.synchronize()
        entry[f"max_abs_err_{tag}"], entry[f"max_rel_err_{tag}"], ok = compare(got, want, dtype_name)
        entry[f"tol_{tag}"] = TOL[dtype_name]
        if not ok:
            failures.append(f"flash_attention {label} {tag}")

    for label, (b, t, causal, hd, dtypes) in FLASH_CASES.items():
        for name in dtypes:
            q, k, v = views(b, t, hd, torch.float32 if name == "fp32" else torch.bfloat16)
            check(label, name if label == "path" else f"{label}_{name}", name, q, k, v, causal)
        # the bf16 views, (B, H, T, Dh) for SDPA
        q4, k4, v4 = (a.transpose(1, 2) for a in (q, k, v))
        pairs = t * (t + 1) // 2 if causal else t * t
        case = {
            "shape": f"q,k,v ({b},{t},{heads},{hd}) bf16 views of ({b},{t},{3 * heads * hd}), causal {causal}",
            "ms": time_ms(lambda: ops.flash_attention_forward(q, k, v, causal), REPS),
            "plain_ms": time_ms(lambda: ops.flash_attention_reference(q, k, v, causal), REPS),
            "library_ms": time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), REPS),
            # q, k, v read and the output written once; q.k and p.v, 2 * Dh each
            "bytes": 4 * b * t * heads * hd * 2,
            "flops": b * heads * pairs * hd * 4,
        }
        if label == "path":
            entry.update(case, flop_rate=PEAK_FLOPS["bf16_tensor"])
            # the bare C entry beside the wrapper: is the wrapper's host cost the time?
            bare = flash_bare_entry(q, k, v, causal)
            torch.testing.assert_close(bare(), ops.flash_attention_forward(q, k, v, causal), rtol=0, atol=0)
            entry["bare_ms"] = time_ms(bare, REPS)
            check(label, "bf16_p01", "bf16", q, k, v, causal, DROPOUT)
            entry["ms_p01"] = time_ms(lambda: ops.flash_attention_forward(q, k, v, causal, DROPOUT, DROPOUT_SEED), REPS)
            entry["library_ms_p01"] = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal, dropout_p=DROPOUT), REPS)
            entry["x_sdpa"] = case["ms"] / case["library_ms"]
            qm, km, vm = views(b, t, hd, torch.bfloat16, pad=1)  # 2-byte offset, odd token stride
            check(label, "misaligned", "bf16", qm, km, vm, causal)
            log(
                f"kernel flash_attention[path]: p=0.1 {entry['ms_p01']:.4f} ms (SDPA dropout_p 0.1 "
                f"{entry['library_ms_p01']:.4f} ms); p=0 {case['ms']:.4f} ms = {entry['x_sdpa']:.2f} x SDPA; "
                f"bare entry {entry['bare_ms']:.4f} ms (wrapper {case['ms']:.4f}, SDPA {case['library_ms']:.4f})"
            )
        else:
            case["bound_ms"], case["bound_by"] = bound(case["bytes"], case["flops"], PEAK_FLOPS["bf16_tensor"])
            entry[label] = case
            log(
                f"kernel flash_attention[{label}]: {case['shape']}: kernel {case['ms']:.4f} ms, plain "
                f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
                f"({case['bound_by']})"
            )
    entry.update(flash_mask_check(failures))
    entry["max_abs_err"] = entry["max_abs_err_bf16"]
    return entry


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


def serve_phase(args, graph, data_dir: str, results: dict) -> dict:
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
    n_req_windows = sum(len(r) for r in requests)
    paths = {}
    for path, flags in (("default", {}), ("fused", {"fused_attn": True, "use_fused_mlp": True})):
        service = ForecastService(cfg, data_dir, state_dict=state, max_batch=BATCH, **flags)
        try:
            ops.reset_counts()
            forecasts, wall = drive_http(service, requests, THREADS)
            counts = ops.launch_counts()
            stats = service.stats()
            # one full batch of 8 windows through the model, timed on the host
            full = service.datasets["test"].gather_batch(np.arange(BATCH))
            fwd = []
            for _ in range(5):
                t0 = time.perf_counter()
                service._run_padded(full, BATCH)
                fwd.append(time.perf_counter() - t0)
            prof = profile_call(lambda: service._run_padded(full, BATCH))
        finally:
            service.close()
        for idx, f in forecasts.items():
            if f.shape != (len(idx), cfg.train.L_out, cfg.model.num_nodes) or not np.isfinite(f).all():
                raise RuntimeError(f"{path}: forecast for {idx} has shape {f.shape} or is not finite")
        fwd_s = statistics.median(fwd)
        paths[path] = {
            "forecasts": forecasts, "launches": counts, "stats": stats,
            "requests": len(requests), "windows": n_req_windows, "wall_s": wall,
            "windows_per_s_served": n_req_windows / wall,
            "batch_forward_ms": fwd_s * 1e3,
            "windows_per_s_full_batch": BATCH / fwd_s,
            "forwards": stats.get("batches"),
            "profile": prof,
        }
        log(
            f"serve[{path}]: {len(requests)} requests ({n_req_windows} windows) in {wall:.3f} s "
            f"-> {n_req_windows / wall:.2f} windows/s; p50 {stats.get('p50_ms')} ms, "
            f"p95 {stats.get('p95_ms')} ms; {stats.get('batches')} device batches "
            f"(mean {stats.get('mean_batch_rows')} rows, padded forward p50 "
            f"{stats.get('forward_p50_ms')} ms); full batch of {BATCH}: "
            f"{fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} windows/s; launches {counts}"
        )
        log(
            f"profile[{path}]: one batch of {BATCH}: wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']:.2f} ms (busy {prof['device_busy_share']:.2%})"
        )
        for row in prof["top"][:8]:
            log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")

    need = {"default": ["gat_stencil", TEMPORAL], "fused": ["gat_stencil", TEMPORAL, "short_attention", "fused_mlp"]}
    for path, names in need.items():
        missing = [k for k in names if paths[path]["launches"].get(k, 0) == 0]
        if missing:
            raise RuntimeError(f"serve[{path}] never launched {missing}")

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
    results["serve_check"] = {
        "max_abs_diff_fused_vs_default_scaled": diff_paths,
        "max_abs_diff_default_vs_fp32_plain_scaled": diff_ref,
        "tol_scaled": SERVE_TOL_SCALED,
    }
    log(
        f"serve check: fused vs default max |diff| {diff_paths:.4e}, default (bf16, kernels) vs "
        f"fp32 plain path {diff_ref:.4e} (scaled units; tol {SERVE_TOL_SCALED})"
    )
    if not (diff_paths <= SERVE_TOL_SCALED and diff_ref <= SERVE_TOL_SCALED):
        raise RuntimeError("served forecasts disagree beyond the stated tolerance")
    for p in paths.values():
        del p["forecasts"]
    return paths


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
    m = dataclasses.replace(
        cfg.model, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0
    )
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
    if (counts_a.get("gat_stencil", 0) != TRAINER_EPOCHS * val_batches or set(gat_launches(counts_a)) - {"gat_stencil"}
            or counts_a.get(TEMPORAL, 0) != counts_a["gat_stencil"]):
        raise RuntimeError(f"trainer[A]: launches {counts_a}, want gat_stencil = {TRAINER_EPOCHS * val_batches} "
                           "(one a validation forward) and nothing else")

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
    if gat_launches(ops.launch_counts()):
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
    if not finite or served["stencil"]["route"] != "kernel" or not served["stencil"]["launches"].get("gat_stencil"):
        raise RuntimeError(f"trainer serve: stencil service {served['stencil']['route']}, {served['stencil']['launches']}")
    if gat_launches(served["padded"]["launches"]) or not diff <= SERVE_TOL_SCALED:
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
    if (not route_122.startswith("kernel, general form: ") or "1x22" not in route_122
            or set(gat_launches(counts_122)) != {"gat_stencil_general"} or gat_launches(counts_plain) or not finite_122
            or not diff_122 <= SERVE_TOL_SCALED):
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
    want_launches = {"gat_stencil": TRAINER_EPOCHS * val_batches}

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
        if gat_launches(r["launches"]) != want_launches or len(r["history"]) != TRAINER_EPOCHS:
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
    # traced on the CPU, an artifact holds the plain conv blocks (the temporal
    # kernel takes CUDA tensors): its reference runs the same blocks
    from tec_mollm_tpu_torch.models import temporal

    devices, temporal.KERNEL_DEVICES = temporal.KERNEL_DEVICES, ()
    service = ForecastService(cfg, data_dir, checkpoint=best, max_batch=BATCH)
    try:
        reference["plain_blocks"] = serve_http(service)
    finally:
        service.close()
        temporal.KERNEL_DEVICES = devices

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
        per_forward = {"gat_stencil": 1, **({"short_attention": layers, "fused_mlp": layers} if ref == "fused" else {})}
        want_nodes = {"tec_mollm.gat_stencil": 1, **({"tec_mollm.short_attention": layers,
                                                       "tec_mollm.fused_ln_mlp": layers} if ref == "fused" else {})}
        if label != "cpu_traced":  # traced on the card: the temporal op; on the CPU: the plain blocks
            per_forward[TEMPORAL], want_nodes["tec_mollm.temporal_conv"] = 1, 1
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
        if custom != want_nodes or node_ops.get("aten.roll", 0):
            failures.append(f"{label}: op nodes {custom}, roll {node_ops.get('aten.roll', 0)}, want {want_nodes}")
        if served["launches"] != want or not forwards:
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
    if cli_counts != {"gat_stencil": SERVE_CLI_BENCH + 1, TEMPORAL: SERVE_CLI_BENCH + 1} or cli_stats.get("source") != "artifact":
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
    if a["launches"].get("gat_stencil", 0) != TRAINER_EPOCHS * val_batches or set(gat_launches(a["launches"])) - {"gat_stencil"}:
        raise RuntimeError(f"ddp[a]: launches {a['launches']}, want gat_stencil = {TRAINER_EPOCHS * val_batches}")

    # --- (b) DDP_RANKS gloo ranks on the one card, fp32 and no dropout, against one process ---
    m = dataclasses.replace(cfg.model, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0,
                            post_llm_dropout=0.0)
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
    if gat_b != want_gat or any(set(gat_launches(r["launches"])) - {"gat_stencil"} for r in ranks):
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
            set(gat_launches(r["launches"])) - {"gat_stencil"} for r in ranks):
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
    from tec_mollm_tpu_torch.data.scaler import StandardScaler
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
    want_counts = {"gat_stencil": eval_batches + chunks}
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
    if not os.path.exists(os.path.join(point_dir, "rollout_results.csv")) or gat_launches(counts_point) != want_counts:
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
    if gat_launches(plain_counts) or not rel <= VAL_RTOL:
        raise RuntimeError(f"eval[point]: kernel vs plain GAT {rel:.3e}, plain launches {plain_counts}")

    # --- the eval loop timed on a warm executor, then profiled ---
    state = harness.load_params_for_eval(cfg, ckpt)
    scaler = StandardScaler.load(os.path.join(data_dir, "target_scaler.npz"))
    ex = harness.EvalExecutor(cfg, graph, state, batch)
    ex.stream_metrics(test_ds, scaler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.stream_metrics(test_ds, scaler)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    prof = profile_call(lambda: ex.stream_metrics(test_ds, scaler))
    busy = prof["device_ms"] / (stream_s * 1e3)
    del ex
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
        "eval_windows_per_s": len(test_ds) / stream_s, "eval_ms_per_batch": stream_s * 1e3 / eval_batches,
        "eval_device_busy_share_unprofiled_wall": busy, "profile_eval": prof,
        "rollout_s": rollout_s, "rollout_kernel_ms_per_chunk": rollout_kernel_ms / chunks,
        "profile_rollout": prof_rollout,
    }
    log(
        f"eval timing: {len(test_ds)} windows in {stream_s * 1e3:.1f} ms on a warm executor = "
        f"{timing['eval_windows_per_s']:.1f} windows/s, {timing['eval_ms_per_batch']:.2f} ms a batch of {batch}; "
        f"device {prof['device_ms']:.2f} ms = busy {busy:.2%} of the unprofiled wall ({prof['device_busy_share']:.2%} "
        f"under the profiler); rollout eval {rollout_s * 1e3:.1f} ms (checkpoint load and model build included), "
        f"its kernels {timing['rollout_kernel_ms_per_chunk']:.2f} ms a chunk of {point['rollout']['num_windows']} "
        "windows"
    )
    for row in prof["top"][:8]:
        log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")

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
    if set(gat_launches(launches)) != {"gat_stencil"}:
        raise RuntimeError(f"eval: launches {launches}, want the GAT kernel alone beside the temporal kernel")
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


def simulate_sarima(steps: int, nodes: int, season: int, coeffs: tuple, seed: int) -> np.ndarray:
    """(steps, nodes) drawn from SARIMA(1,1,1)x(1,1,1,season) with the given
    (phi, Phi, theta, Theta): the SARMA recursion on unit innovations, then
    (1-B) and (1-B^s) integrated (the JAX test's simulator, over all nodes)."""
    phi, sphi, theta, stheta = coeffs
    eps = np.random.default_rng(seed).normal(0, 1, (steps, nodes))
    y = np.zeros((steps, nodes))
    for t in range(steps):
        y[t] = eps[t]
        if t >= 1:
            y[t] += phi * y[t - 1] + theta * eps[t - 1]
        if t >= season:
            y[t] += sphi * y[t - season] + stheta * eps[t - season]
        if t >= season + 1:
            y[t] += -phi * sphi * y[t - season - 1] + theta * stheta * eps[t - season - 1]
    x1 = np.cumsum(y, axis=0)
    x = np.zeros_like(x1)
    for t in range(steps):
        x[t] = x1[t] + (x[t - season] if t >= season else 0.0)
    return x


def sarima_kernel_checks(args) -> dict:
    """Phase 14 (a)'s kernels: the three against their plain versions on a
    simulated (SARIMA_T, 2911) series, the fit's two also at SARIMA_EDGES and
    twice on the same inputs, 3 Adam steps kernel against plain, and their
    times. Returns the series, its scaled difference y and the forecast
    windows for the fit, and what failed."""
    import torch

    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models import sarima
    from tec_mollm_tpu_torch.ops import sarima as sops

    dev = torch.device("cuda")
    cfg = Config().resolved()
    n, s, L_in, L_out = cfg.model.num_nodes, SARIMA_SEASON, cfg.train.L_in, cfg.train.L_out
    series = simulate_sarima(SARIMA_T, n, s, SARIMA_TRUTH, args.seed)
    y = sarima.scaled_difference(series, s, dev)
    steps_t = y.shape[0]
    raw = torch.randn(4, n, generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev) * 0.5
    coeffs = (0.99 * torch.tanh(raw)).contiguous()
    scale = 2.0 / ((steps_t - s - 1) * n)
    starts = np.linspace(0, SARIMA_T - L_in, SARIMA_BATCH).astype(np.int64)
    wins = torch.tensor(np.stack([series[a : a + L_in] for a in starts]), dtype=torch.float32, device=dev)

    def rel(got, want) -> tuple[float, float]:
        # largest difference, and over the largest magnitude (the difference itself where want is all 0)
        diff, top = float((got - want).abs().max()), float(want.abs().max())
        return diff, diff / top if top > 0 else diff

    e_k, part_k = sops.css_forward(y, coeffs, s)
    e_p, part_p = sops.css_forward_reference(y, coeffs, s)
    g_k = sops.css_backward(y, e_k, coeffs, s, scale)
    g_p = sops.css_backward_reference(y, e_p, coeffs, s, scale)
    f_k, f_p = sops.forecast(wins, coeffs, L_out, s), sops.forecast_reference(wins, coeffs, L_out, s)
    (loss_k, graw_k), (loss_p, graw_p) = sops.css_loss_and_grad(raw, y, s), sops.css_loss_and_grad_reference(raw, y, s)
    torch.cuda.synchronize()
    errs = {"e": rel(e_k, e_p), "partial": rel(part_k, part_p), "grad": rel(g_k, g_p), "forecast": rel(f_k, f_p),
            "loss": rel(loss_k, loss_p), "grad_raw": rel(graw_k, graw_p)}
    raw3_k = sarima.adam_fit(y, s, 3)
    raw3_p = sarima.adam_fit(y, s, 3, loss_and_grad=sops.css_loss_and_grad_reference)
    adam_err = float((raw3_k - raw3_p).abs().max())
    log(
        f"sarima: y ({steps_t}, {n}) fp32, season {s}; kernel vs plain, largest difference / largest magnitude: "
        + ", ".join(f"{k} {r:.3e}" for k, (_, r) in errs.items())
        + f" (tol {SARIMA_RTOL}); raw after 3 Adam steps differ by {adam_err:.3e} (tol {SARIMA_ADAM_ATOL})"
    )
    failures = [k for k, (_, r) in errs.items() if not r <= SARIMA_RTOL]
    if not adam_err <= SARIMA_ADAM_ATOL:
        failures.append("adam")

    # the fit kernels at the edge shapes, and two launches on the same inputs
    # give the same bits (the flagship's too)
    edges = []
    for t_e, n_e, s_e in SARIMA_EDGES:
        ye, ce = y[:t_e, :n_e].contiguous(), coeffs[:, :n_e].contiguous()
        sc = 2.0 / (max(t_e - s_e - 1, 1) * n_e)
        (e1, p1), (e2, p2) = sops.css_forward(ye, ce, s_e), sops.css_forward(ye, ce, s_e)
        ep, pp = sops.css_forward_reference(ye, ce, s_e)
        g1, g2 = sops.css_backward(ye, ep, ce, s_e, sc), sops.css_backward(ye, ep, ce, s_e, sc)
        gp = sops.css_backward_reference(ye, ep, ce, s_e, sc)
        torch.cuda.synchronize()
        edge = {"shape": (t_e, n_e, s_e), "e": rel(e1, ep), "partial": rel(p1, pp), "grad": rel(g1, gp),
                "same_bits": bool(torch.equal(e1, e2) and torch.equal(p1, p2) and torch.equal(g1, g2)),
                "partial_zero": bool(t_e < s_e + 1 and not p1.any() and not g1.any())}
        log(f"sarima edge (T {t_e}, N {n_e}, s {s_e}): kernel vs plain e {edge['e'][1]:.3e}, partial "
            f"{edge['partial'][1]:.3e}, grad {edge['grad'][1]:.3e} (tol {SARIMA_RTOL}); two launches the same "
            f"bits {edge['same_bits']}" + (f"; T < s + 1: partial and grad 0 {edge['partial_zero']}"
                                           if t_e < s_e + 1 else ""))
        bad = [k for k in ("e", "partial", "grad") if not edge[k][1] <= SARIMA_RTOL]
        if bad or not edge["same_bits"] or (t_e < s_e + 1 and not edge["partial_zero"]):
            failures.append(f"edge {edge['shape']}: {bad}, same bits {edge['same_bits']}")
        edges.append(edge)
    # the forecast at its edge shapes: windows of the series, as many nodes
    forecast_edges = []
    for b_e, l_e, n_e, s_e, h_e in SARIMA_FORECAST_EDGES:
        at = np.linspace(0, SARIMA_T - l_e, b_e).astype(np.int64)
        xe = torch.tensor(np.stack([series[a : a + l_e, :n_e] for a in at]), dtype=torch.float32, device=dev)
        ce = coeffs[:, :n_e].contiguous()
        f1, f2 = sops.forecast(xe, ce, h_e, s_e), sops.forecast(xe, ce, h_e, s_e)
        fp = sops.forecast_reference(xe, ce, h_e, s_e)
        torch.cuda.synchronize()
        edge = {"shape": (b_e, l_e, n_e, s_e, h_e), "forecast": rel(f1, fp), "same_bits": bool(torch.equal(f1, f2)),
                "finite": bool(f1.isfinite().all()), "plan": forecast_plan_of(l_e, s_e, h_e)}
        log(f"sarima forecast edge (windows {b_e}, L {l_e}, N {n_e}, s {s_e}, horizon {h_e}): kernel vs plain "
            f"{edge['forecast'][1]:.3e} (tol {SARIMA_RTOL}); two launches the same bits {edge['same_bits']}; "
            f"plan {edge['plan']}")
        if not (edge["forecast"][1] <= SARIMA_RTOL and edge["same_bits"] and edge["finite"]):
            failures.append(f"forecast edge {edge['shape']}: {edge['forecast'][1]:.3e}, same bits {edge['same_bits']}")
        forecast_edges.append(edge)
    e_again, part_again = sops.css_forward(y, coeffs, s)
    g_again = sops.css_backward(y, e_k, coeffs, s, scale)
    f_again = sops.forecast(wins, coeffs, L_out, s)
    same_bits = bool(torch.equal(e_again, e_k) and torch.equal(part_again, part_k) and torch.equal(g_again, g_k)
                     and torch.equal(f_again, f_k))
    log(f"sarima: flagship, two launches the same bits (the three kernels): {same_bits}; the forecast's plan "
        f"{forecast_plan_of(L_in, s, L_out)}")
    if not same_bits:
        failures.append("flagship: two launches differ")

    # the kernels' entries of the kernels line: times (also through their
    # bare C entries), bounds (bytes: each input read once, each
    # output written once)
    arr = steps_t * n * 4
    bare_calls = {sops.FORWARD: sarima_bare_entry(y, coeffs, s),
                  sops.BACKWARD: sarima_bare_entry(y, coeffs, s, e_k, scale),
                  sops.FORECAST: forecast_bare_entry(wins, coeffs, L_out, s)}
    entries = []
    for name, shape, fn, plain, bytes_moved, flops, err in (
        (sops.FORWARD, f"y ({steps_t},{n}) fp32, coeffs (4,{n}) -> e, partial",
         lambda: sops.css_forward(y, coeffs, s), lambda: sops.css_forward_reference(y, coeffs, s),
         2 * arr + 20 * n, 14 * steps_t * n, errs["e"]),
        (sops.BACKWARD, f"y, e ({steps_t},{n}) fp32, coeffs (4,{n}) -> grad (4,{n})",
         lambda: sops.css_backward(y, e_k, coeffs, s, scale),
         lambda: sops.css_backward_reference(y, e_k, coeffs, s, scale), 2 * arr + 32 * n, 20 * steps_t * n,
         errs["grad"]),
        (sops.FORECAST, f"windows ({SARIMA_BATCH},{L_in},{n}) fp32 -> ({SARIMA_BATCH},{L_out},{n})",
         lambda: sops.forecast(wins, coeffs, L_out, s), lambda: sops.forecast_reference(wins, coeffs, L_out, s),
         SARIMA_BATCH * (L_in + L_out) * n * 4 + 16 * n, SARIMA_BATCH * n * (16 * L_in + 16 * L_out), errs["forecast"]),
    ):
        e = {"name": name, "route": "cuda", "source": "tec_mollm_tpu_torch/csrc/sarima.cu",
             "replaces": "tec_mollm_tpu/models/sarima.py:61", "shape": shape, "bytes": bytes_moved, "flops": flops,
             "max_abs_err": err[0], "max_rel_err": err[1], "tol_rel": SARIMA_RTOL,
             "ms": time_ms(fn, REPS), "plain_ms": time_ms(plain, 1, runs=2), "library_ms": None}
        e["bound_ms"], e["bound_by"] = bound(bytes_moved, flops, PEAK_FLOPS["fp32"])
        bare = ""
        if name in bare_calls:
            e["bare_ms"] = time_ms(bare_calls[name], REPS)
            bare = f" (bare {e['bare_ms']:.4f} ms, the bound {e['bound_ms'] / e['bare_ms']:.1%} of it)"
        if name == sops.FORECAST:
            e["device_ms"], seen = kernel_device_ms(bare_calls[name], DEVICE_REPS, "forecast_")
            bare += "; " + device_note(e["device_ms"], seen, DEVICE_REPS, e["bound_ms"])
        log(f"kernel {name}: {shape}: max_abs {err[0]:.3e} max_rel {err[1]:.3e}; kernel {e['ms']:.4f} ms{bare}, "
            f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
        entries.append(e)
    entries[-1]["large"] = forecast_large(series, coeffs, L_in, L_out, s, failures)
    step_ms = time_ms(lambda: sops.css_loss_and_grad(raw, y, s), REPS)

    return {"series": series, "y": y, "wins": wins, "L_out": L_out, "entries": entries, "errors": errs,
            "adam_err": adam_err, "edges": edges, "forecast_edges": forecast_edges, "same_bits": same_bits,
            "step_ms": step_ms, "failures": failures}


def forecast_large(series, coeffs, L_in: int, L_out: int, s: int, failures: list) -> dict:
    """The forecast at SARIMA_FORECAST_LARGE windows of the series: against
    its plain version, then timed through the wrapper, the bare C entry and
    on the device's clock, beside its bytes bound."""
    import torch

    from tec_mollm_tpu_torch.ops import sarima as sops

    n = series.shape[1]
    starts = np.linspace(0, SARIMA_T - L_in, SARIMA_FORECAST_LARGE).astype(np.int64)
    wins = torch.tensor(np.stack([series[a : a + L_in] for a in starts]), dtype=torch.float32, device="cuda")
    got, want = sops.forecast(wins, coeffs, L_out, s), sops.forecast_reference(wins, coeffs, L_out, s)
    err = float((got - want).abs().max()) / float(want.abs().max())
    del want
    bytes_moved = SARIMA_FORECAST_LARGE * (L_in + L_out) * n * 4 + 16 * n
    bare = forecast_bare_entry(wins, coeffs, L_out, s)
    out = {"windows": SARIMA_FORECAST_LARGE, "max_rel_err": err, "bytes": bytes_moved,
           "bound_ms": bytes_moved / PEAK_BYTES * 1e3, "ms": time_ms(lambda: sops.forecast(wins, coeffs, L_out, s), 5),
           "bare_ms": time_ms(bare, 5)}
    out["device_ms"], seen = kernel_device_ms(bare, DEVICE_REPS, "forecast_")
    log(f"kernel sarima_forecast at {SARIMA_FORECAST_LARGE} windows ({bytes_moved / 1e6:.1f} MB): kernel vs plain "
        f"{err:.3e} (tol {SARIMA_RTOL}); {out['ms']:.4f} ms, bare {out['bare_ms']:.4f}; bound {out['bound_ms']:.4f} "
        f"ms; " + device_note(out["device_ms"], seen, DEVICE_REPS, out["bound_ms"]))
    if not err <= SARIMA_RTOL:
        failures.append(f"forecast at {SARIMA_FORECAST_LARGE} windows: {err:.3e}")
    return out


def sarima_fit(checks: dict) -> dict:
    """Phase 14 (a)'s main path: the full fit of SARIMA_FIT_STEPS steps
    through the kernels on sarima_kernel_checks' series and one forecast
    batch, launches counted from zero; then SARIMA_PROFILE_STEPS warm fit
    steps timed and as many profiled. Appends what failed to
    checks["failures"]."""
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.models import sarima
    from tec_mollm_tpu_torch.ops import sarima as sops

    s, y, n = SARIMA_SEASON, checks["y"], checks["y"].shape[1]
    step_ms, failures = checks["step_ms"], checks["failures"]
    ops.reset_counts()
    t0 = time.perf_counter()
    params = sarima.fit_sarima(checks["series"], season=s, steps=SARIMA_FIT_STEPS, device=torch.device("cuda"))
    fit_wall = time.perf_counter() - t0
    preds = sarima.forecast_windows(params, checks["wins"], checks["L_out"], season=s)
    torch.cuda.synchronize()
    fit_counts = ops.launch_counts()
    phi_mean = float(params.phi.mean())
    log(
        f"sarima: fit of {SARIMA_FIT_STEPS} Adam steps on ({SARIMA_T}, {n}): {fit_wall:.3f} s, "
        f"{fit_wall / SARIMA_FIT_STEPS * 1e3:.3f} ms a step (loss and gradient alone, back to back, {step_ms:.4f} "
        f"ms a call, {step_ms / (fit_wall / SARIMA_FIT_STEPS * 1e3):.2%} of the step); forecast "
        f"{checks['entries'][2]['ms']:.4f} ms a batch of {SARIMA_BATCH}; phi mean {phi_mean:.4f} "
        f"(truth {SARIMA_TRUTH[0]} +- {SARIMA_PHI_TOL}); launches {fit_counts}"
    )
    want = {sops.FORWARD: SARIMA_FIT_STEPS, sops.BACKWARD: SARIMA_FIT_STEPS, sops.FORECAST: 1}
    if fit_counts != want:
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
    return {"fit_wall_s": fit_wall, "fit_ms_a_step": fit_wall / SARIMA_FIT_STEPS * 1e3, "phi_mean": phi_mean,
            "fit_launches": fit_counts, "warm_step_ms": warm_step_ms, "device_step_ms": device_step_ms,
            "warm_step_busy_share": device_step_ms / warm_step_ms, "fit_profile": prof}


def sarima_phase(args, data_dir: str) -> dict:
    """The SARIMA baseline at flagship width (phase 14 (a)): the kernel checks
    (sarima_kernel_checks), the full fit through the kernels (sarima_fit),
    and the test CLI with --baseline sarima on phase 8's checkpoint and data."""
    import torch

    from tec_mollm_tpu_torch import ops, test
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation import harness
    from tec_mollm_tpu_torch.ops import sarima as sops

    phase_t0 = time.perf_counter()
    cfg = Config().resolved()
    s, L_in, L_out = SARIMA_SEASON, cfg.train.L_in, cfg.train.L_out
    checks = sarima_kernel_checks(args)
    fit = sarima_fit(checks)
    failures = checks["failures"]
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
    if (cli_counts.get(sops.FORWARD), cli_counts.get(sops.BACKWARD), cli_counts.get(sops.FORECAST)) != (
            cli_steps, cli_steps, batches):
        failures.append(f"test CLI launches {cli_counts}")
    if failures:
        raise RuntimeError(f"sarima: {failures}")
    return {
        "entries": checks["entries"], "launches": launches, "errors": checks["errors"],
        "adam_3_steps_max_abs": checks["adam_err"], "edges": checks["edges"],
        "forecast_edges": checks["forecast_edges"], "same_bits": checks["same_bits"],
        "loss_and_grad_ms": checks["step_ms"], "forecast_ms_a_batch": checks["entries"][2]["ms"], **fit,
        "cli_wall_s": cli_wall, "cli_launches": cli_counts, "cli_results": res["results"],
        "wall_s": time.perf_counter() - phase_t0,
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
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0))
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
    build_s = time.perf_counter() - t0
    log(f"build: {lib} in {build_s:.1f} s")
    ptxas = (lib.parent / "ptxas.log").read_text() if (lib.parent / "ptxas.log").exists() else ""
    for line in ptxas_summary(ptxas):
        log(f"  {line}")
    results["gat_ptxas"] = ptxas_entries(ptxas, "gat_stencil.cu")
    for k in results["gat_ptxas"]:
        log(f"  gat_stencil {k['entry']}: {k.get('registers')} registers, {k.get('spill_store_bytes')} bytes "
            f"spilled, {k.get('static_smem_bytes')} bytes static smem")
    results["sarima_ptxas"] = ptxas_entries(ptxas, "sarima.cu")
    for k in results["sarima_ptxas"]:
        if "css_" in k["entry"] or "forecast_" in k["entry"]:  # dynamic shared memory: phase 14 prints it
            log(f"  sarima {k['entry']}: {k.get('registers')} registers, {k.get('spill_store_bytes')} bytes "
                f"spilled, {k.get('static_smem_bytes')} bytes static smem")
    results["temporal_ptxas"] = ptxas_entries(ptxas, "temporal_conv.cu")
    for k in results["temporal_ptxas"]:
        log(f"  temporal_conv {k['entry']}: {k.get('registers')} registers, {k.get('spill_store_bytes')} bytes "
            f"spilled")
    results["build_s"] = build_s
    results["ptxas"] = ptxas

    lat, lon = grid_coordinates(41, 71)
    graph = build_graph(lat, lon, distance_threshold_km=150.0)
    entries = check_kernels(args, graph, results)
    results["kernels"] = entries
    with tempfile.TemporaryDirectory(prefix="tec_smoke_") as data_dir:
        paths = serve_phase(args, graph, data_dir, results)
        results["serve"] = paths
        train = train_phase(args)
        results["train"] = train
        trainer = trainer_phase(args, graph, data_dir, train["windows_per_s"])
        results["trainer"] = trainer
        prep = preprocess_phase(args, data_dir)
        results["preprocess"] = prep
        device_data = device_data_phase(args, prep["plain"]["dir"])
        results["device_data"] = device_data
        export = export_phase(args, data_dir)
        results["export"] = export
        evaluation = eval_phase(args, graph, data_dir)
        results["eval"] = evaluation
        ddp = data_parallel_phase(args, data_dir, trainer)
        results["data_parallel"] = ddp
        tp = tensor_parallel_phase(args, data_dir, ddp)
        results["tensor_parallel"] = tp
        ablation = ablation_phase(args, data_dir)
        results["ablation"] = ablation
        entries += ablation["sarima"]["entries"]
    pretrain = pretrain_phase(args, graph)
    results["pretrain"] = pretrain
    runs = [p["launches"] for p in paths.values()] + [
        train["launches"], trainer["launches"], trainer["launches_1x22"], device_data["launches"], export["launches"],
        evaluation["launches"], ddp["launches"], tp["launches"], ablation["launches"], pretrain["launches"]]
    for e in entries:
        # launches over the main-path runs (both serve cells, the train steps,
        # the trainer's run A, its 1 x 22 serve, the --device-data trainer, the
        # artifacts' services, the eval phase's CLI and service runs, the
        # data- and tensor-parallel ranks' runs, phase 14's SARIMA fit, test
        # CLI and arm steps, and the pretrain steps), each counted from zero
        # (a rank's in its own process)
        e["launches"] = sum(r.get(e["name"], 0) for r in runs)
        e["launches_export"] = export["launches"].get(e["name"], 0)
        e["launches_device_data"] = device_data["launches"].get(e["name"], 0)
        e["launches_eval"] = evaluation["launches"].get(e["name"], 0)
        e["launches_ddp"] = ddp["launches"].get(e["name"], 0)
        e["launches_tp"] = tp["launches"].get(e["name"], 0)
        e["launches_ablation"] = ablation["launches"].get(e["name"], 0)
        e["launches_per_forward_fused"] = paths["fused"]["launches"].get(e["name"], 0) / paths["fused"]["forwards"]
        e["launches_per_train_step"] = train["launches_per_step"].get(e["name"], 0)
        e["launches_trainer_run"] = trainer["launches"].get(e["name"], 0)
        e["launches_per_pretrain_step"] = pretrain["launches_per_step"].get(e["name"], 0)
    missing = [e["name"] for e in entries if e["launches"] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on a main path: {missing}")
    results["card"] = card
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{k: e.get(k) for k in keys} for e in entries]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
