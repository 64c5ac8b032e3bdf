"""Byte-level language model over the GPT-2 backbone, for surrogate pretraining.

The counterpart of ``tec_mollm_tpu/models/byte_lm.py``. Pretrained GPT-2 weights
cannot be downloaded offline, so the same 3-block, 768-wide backbone is
pretrained as a byte LM on local text, exported as an HF GPT-2 checkpoint
(``models/hf_export.py``) and imported into the forecast model
(``models/hf_import.py``), the path a real GPT-2 checkpoint would take.

The LM is wte (256 bytes, d) + ``GPT2Backbone`` + a tied readout in fp32
(logits = h @ wte^T). The backbone has no LoRA (``lora_r = 0``) and the JAX
backbone's default LayerNorms (fp32, ``lean_ln=False``). ``use_flash=True``
sends its attention (T = seq_len + 1 = 129 by default) to the flash kernel,
which in training drops attention probabilities at ``llm_dropout`` where the
JAX ``ByteLM``'s einsum attention drops them.

The corpus and batch functions are the JAX module's numpy code, copied: the
same corpus and seed give the same batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models.gpt2 import GPT2Backbone


def pretrain_model_config(base: ModelConfig | None = None) -> ModelConfig:
    """The downstream transformer shape without LoRA, so the exported
    checkpoint is a plain GPT-2 state dict."""
    base = base or ModelConfig()
    return dataclasses.replace(base, lora_r=0, lora_alpha=0.0, lora_dropout=0.0)


class ByteLM(nn.Module):
    """256-way byte LM: wte + GPT2Backbone + tied logits. Parameters are fp32;
    ``dtype`` is the compute dtype of the embedding and the backbone."""

    def __init__(
        self,
        cfg: ModelConfig,
        dtype: torch.dtype = torch.float32,
        vocab: int = 256,
        use_flash: bool = False,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.wte = nn.Parameter(torch.empty(vocab, cfg.d_llm))
        self.backbone = GPT2Backbone(cfg, use_flash=use_flash, lean_ln=False)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.wte, 0.0, 0.02, generator=g)
        self.backbone.reset_parameters(g)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) int -> logits (B, T, vocab) fp32."""
        h = self.backbone(F.embedding(tokens.long(), self.wte).to(self.dtype))
        return h.float() @ self.wte.float().t()


def next_byte_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of predicting token t+1 from positions <= t (nats)."""
    return F.cross_entropy(logits[:, :-1].flatten(0, 1), tokens[:, 1:].flatten().long())


def gather_text_corpus(
    roots: list[str],
    extensions: tuple[str, ...] = (".py", ".md", ".txt", ".rst"),
    max_bytes: int = 64 * 1024 * 1024,
    max_file_bytes: int = 512 * 1024,
) -> bytes:
    """Concatenate the text files under ``roots`` into one byte corpus, in a
    deterministic order, skipping caches and hidden directories."""
    chunks: list[bytes] = []
    total = 0
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            if "__pycache__" in dirpath or "/." in dirpath:
                continue
            for name in sorted(filenames):
                if not name.endswith(extensions):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    with open(path, "rb") as f:
                        data = f.read(max_file_bytes)
                except OSError:
                    continue
                chunks.append(data)
                total += len(data)
                if total >= max_bytes:
                    return b"\n".join(chunks)[:max_bytes]
    return b"\n".join(chunks)


def byte_batches(
    corpus: bytes,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    val_fraction: float = 0.02,
) -> tuple[Iterator[np.ndarray], np.ndarray]:
    """Infinite iterator of (B, seq_len + 1) int32 training batches at random
    offsets, and one fixed validation batch from a held-out tail."""
    arr = np.frombuffer(corpus, dtype=np.uint8)
    # the val slice holds at least one full window, and the train remainder
    # leaves room for one
    n_val = max(int(len(arr) * val_fraction), batch_size * (seq_len + 1), seq_len + 2)
    min_bytes = n_val + seq_len + 2
    if len(arr) < min_bytes:
        raise ValueError(
            f"corpus of {len(arr)} bytes is too small for batch_size="
            f"{batch_size} x seq_len={seq_len}: need >= {min_bytes} bytes "
            "(shrink the batch/sequence or point --corpus-roots at more text)"
        )
    train, val = arr[:-n_val], arr[-n_val:]
    rng = np.random.default_rng(seed)

    v_off = rng.integers(0, len(val) - seq_len - 1, size=batch_size)
    val_batch = np.stack([val[o : o + seq_len + 1] for o in v_off]).astype(np.int32)

    def it() -> Iterator[np.ndarray]:
        while True:
            offs = rng.integers(0, len(train) - seq_len - 1, size=batch_size)
            yield np.stack([train[o : o + seq_len + 1] for o in offs]).astype(np.int32)

    return it(), val_batch
