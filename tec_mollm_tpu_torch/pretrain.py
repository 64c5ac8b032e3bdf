"""Surrogate GPT-2 pretraining: a byte LM on local text, on one GPU.

    python -m tec_mollm_tpu_torch.pretrain --out checkpoints/surrogate_gpt2_torch \\
        --steps 3000 --batch-size 64 --seq-len 128 [--cpu]

The counterpart of the JAX package's ``scripts/pretrain_backbone.py``, with its
flags. It trains ``ByteLM`` (the forecast model's GPT-2 backbone without LoRA,
bf16 compute on fp32 parameters) with its attention on the flash kernel
(T = seq_len + 1; in training the kernel drops attention probabilities at
``llm_dropout``, as the einsum attention of the JAX ``ByteLM`` does), then writes ``<out>/pytorch_model.bin`` and ``config.json``
(an HF GPT-2 checkpoint) and ``pretrain_meta.json``. The checkpoint loads into
the forecast model through ``models/hf_import.load_gpt2_into_model``.

The default corpus is the text under the repository and the installed torch
and numpy sources (the JAX script reads the jax, flax, numpy and optax
sources, so the text differs, not the model). It runs on the GPU and raises
without CUDA unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.models.byte_lm import ByteLM, byte_batches, gather_text_corpus, pretrain_model_config
from tec_mollm_tpu_torch.models.hf_export import backbone_state_dict_to_hf, save_hf_checkpoint
from tec_mollm_tpu_torch.training.pretrain import create_pretrain_state, make_pretrain_step, val_loss
from tec_mollm_tpu_torch.training.schedule import warmup_cosine_decay

REPO_ROOT = Path(__file__).resolve().parent.parent
logger = logging.getLogger("pretrain")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="byte-LM surrogate pretraining")
    p.add_argument("--out", default="checkpoints/surrogate_gpt2_torch")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d-llm", type=int, default=768)
    p.add_argument("--llm-layers", type=int, default=3)
    p.add_argument("--llm-heads", type=int, default=12)
    p.add_argument("--corpus-roots", nargs="*", default=None,
                   help="text roots (default: the repository + the torch and numpy sources)")
    p.add_argument("--max-corpus-mb", type=int, default=48)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    device = resolve_device("cpu" if args.cpu else None)
    roots = args.corpus_roots or [str(REPO_ROOT), os.path.dirname(torch.__file__), os.path.dirname(np.__file__)]
    corpus = gather_text_corpus(roots, max_bytes=args.max_corpus_mb * 1024 * 1024)
    logger.info("corpus: %.1f MB from %d roots", len(corpus) / 1e6, len(roots))
    batches, val_batch = byte_batches(corpus, args.batch_size, args.seq_len, seed=args.seed)

    cfg = pretrain_model_config(ModelConfig(d_llm=args.d_llm, llm_layers=args.llm_layers, llm_heads=args.llm_heads))
    model = ByteLM(cfg, dtype=torch.bfloat16, use_flash=True, seed=args.seed).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("ByteLM params: %.1f M on %s", n_params / 1e6, device)

    state = create_pretrain_state(model, seed=args.seed)
    step = make_pretrain_step(warmup_cosine_decay(0.0, args.lr, args.warmup, args.steps, args.lr * 0.01))
    val_tokens = torch.from_numpy(val_batch).to(device)
    first_val = float(val_loss(model, val_tokens))
    logger.info("val loss before training: %.4f nats/byte", first_val)

    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        metrics = step(state, torch.from_numpy(next(batches)).to(device))
        losses.append(metrics["loss"])
        if (i + 1) % args.log_every == 0:
            recent = float(torch.stack(losses[-args.log_every:]).mean())
            logger.info(
                "step %d/%d | train %.4f | val %.4f | %.1f steps/s", i + 1, args.steps, recent,
                float(val_loss(model, val_tokens)), (i + 1) / (time.perf_counter() - t0),
            )
    final_val = float(val_loss(model, val_tokens))

    sd = backbone_state_dict_to_hf(model.backbone, wte=model.wte)
    path = save_hf_checkpoint(
        sd, args.out, meta={"surrogate": "byte-lm", "steps": args.steps, "val_loss_nats_per_byte": final_val}
    )
    with open(os.path.join(args.out, "pretrain_meta.json"), "w") as f:
        json.dump({
            "steps": args.steps,
            "batch_size": args.batch_size,
            "seq_len": args.seq_len,
            "corpus_mb": len(corpus) / 1e6,
            "val_loss_initial": first_val,
            "val_loss_final": final_val,
            "params_m": n_params / 1e6,
        }, f, indent=2)
    logger.info("saved surrogate checkpoint to %s (val %.4f -> %.4f nats/byte)", path, first_val, final_val)
    return 0


if __name__ == "__main__":
    sys.exit(main())
