"""Run names: the JAX package's (and the reference's) dynamic naming."""

from __future__ import annotations

import time


def make_run_name(
    L_in: int,
    train_stride: int,
    batch_size: int,
    lr: float,
    llm_layers: int,
    timestamp: str | None = None,
) -> str:
    """L{L_in}_S{stride}_B{batch}_LR{lr}_LLM{layers}_{YYYYmmdd-HHMM}."""
    if timestamp is None:
        timestamp = time.strftime("%Y%m%d-%H%M")
    return f"L{L_in}_S{train_stride}_B{batch_size}_LR{lr}_LLM{llm_layers}_{timestamp}"
