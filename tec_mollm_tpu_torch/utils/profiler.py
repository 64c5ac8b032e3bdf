"""Step timing and ``torch.profiler`` traces."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def sync(device: torch.device | str | None = None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """Step wall times and item counts -> throughput. Each ``stop``
    synchronises ``device`` first, so the time covers the work the step queued
    on the card, not only its launch."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.steps = 0
        self.items = 0
        self.elapsed = 0.0

    def start(self) -> None:
        sync(self.device)
        self._t0 = time.perf_counter()

    def stop(self, items: int = 0) -> float:
        sync(self.device)
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        self.steps += 1
        self.items += items
        return dt

    @property
    def items_per_sec(self) -> float:
        return self.items / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def avg_step_ms(self) -> float:
        return self.elapsed / self.steps * 1000 if self.steps else 0.0


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[torch.profiler.profile | None]:
    """``torch.profiler`` over the block (the CPU, and CUDA when present),
    written as a Chrome trace to ``logdir/trace.json``; yields the profiler, or
    None and does nothing when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
