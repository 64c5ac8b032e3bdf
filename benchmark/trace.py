"""The traced segment: ``torch.profiler`` over CPU and CUDA, reduced to what
the per-layer metrics read.

``Capture`` wraps the segment: it synchronises the device before and after,
so ``window_s`` (the host's clock) covers all the work the segment queued, and
keeps the profiler's events. ``reduce`` turns them into a summary:

* ``busy_s``: the length of the union of every kernel, copy and memset
  interval on the device (not their sum: overlapping streams count once);
* ``launches``: the host's ``cudaLaunchKernel`` / ``cuLaunchKernel`` calls
  (and their ``Ex`` forms);
* ``spans``: for each ``record_function`` span the benchmark opened, the
  device time of the kernels launched inside it (matched by the runtime call's
  correlation id), one entry per span;
* ``device_ops``: the kernels and copies that took the most device time;
* ``idle_gaps``: the longest gaps between device work, summed by the
  innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
SPAN_PREFIX = "benchmark::"
TOP = 10
GAPS_NAMED = 400


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Capture:
    """``host_ops=False`` records the device and the runtime calls alone: a
    host-bound loop then runs nearer its untraced speed, and the idle gaps are
    named by the runtime call in progress."""

    def __init__(self, device: torch.device, host_ops: bool = True):
        self.device = device
        self.host_ops = host_ops
        self.window_s = 0.0
        self.events = []

    def __enter__(self) -> "Capture":
        activities = [torch.profiler.ProfilerActivity.CPU] if self.host_ops or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._prof.profiler.kineto_results.events()


class Span:
    """A ``record_function`` span opened by a forward pre-hook and closed by a
    forward hook of ``module``: the benchmark's own boundary around a layer,
    whatever implements it."""

    def __init__(self, module: torch.nn.Module, name: str):
        self.name = SPAN_PREFIX + name
        self._stack = []
        self._handles = [module.register_forward_pre_hook(self._open), module.register_forward_hook(self._close)]

    def _open(self, module, args):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._stack.append(rf)

    def _close(self, module, args, output):
        self._stack.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def kind(e) -> str:
    """The kineto activity type of an event; worked out from its device, name
    and annotation flag where the profiler does not say (older torch)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    user = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if user:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if user:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu") and name[2:3].isupper():
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals: np.ndarray) -> tuple[float, np.ndarray]:
    """(covered length, gaps as (start, end) rows) of (start, end) rows."""
    if not len(intervals):
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier one ended
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    run_ends = np.concatenate([ends[np.nonzero(new)[0][1:] - 1], ends[-1:]])
    gaps = np.stack([run_ends[:-1], starts[1:]], axis=1)
    return float((run_ends - starts).sum()), gaps


def reduce(capture: Capture) -> dict:
    dev, launches, runtime, cpu, calls, spans_cpu, spans_gpu = [], 0, {}, [], [], [], []
    for e in capture.events:
        k = kind(e)
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if k in DEVICE_KINDS:
            dev.append((start, start + dur, name, e.correlation_id(), e.linked_correlation_id()))
        elif k in ("cuda_runtime", "cuda_driver"):
            runtime[e.correlation_id()] = (start, e.start_thread_id())
            calls.append((start, start + dur, name))
            if name.startswith(LAUNCH_PREFIXES):
                launches += 1
        elif k == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans_cpu.append((name[len(SPAN_PREFIX):], start, start + dur, e.start_thread_id()))
        elif k == "gpu_user_annotation" and name.startswith(SPAN_PREFIX):
            spans_gpu.append((name[len(SPAN_PREFIX):], start, start + dur))
        elif k in ("cpu_op", "user_annotation"):
            cpu.append((start, start + dur, name))
    iv = np.array([(s, t) for s, t, *_ in dev], dtype=np.float64).reshape(-1, 2)
    busy_ns, gaps = _union(iv)

    by_name: dict[str, float] = defaultdict(float)
    for s, t, name, _, _ in dev:
        by_name[name] += (t - s) * 1e-9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    spans: dict[str, list[float]] = defaultdict(list)
    match = "none"
    if spans_cpu:
        bounds = defaultdict(list)
        for name, s, t, tid in spans_cpu:
            bounds[name].append((s, t, tid))
        for name, rows in bounds.items():
            secs = [0.0] * len(rows)
            starts = np.array([r[0] for r in rows])
            order = np.argsort(starts)
            for s, t, _, corr, linked in dev:
                launch = runtime.get(corr) or runtime.get(linked)
                if launch is None:
                    continue
                at, tid = launch
                k = np.searchsorted(starts[order], at, side="right") - 1
                if k >= 0:
                    r = rows[order[k]]
                    if r[0] <= at <= r[1] and r[2] == tid:
                        secs[order[k]] += (t - s) * 1e-9
            spans[name] = secs
        if any(sum(v) for v in spans.values()):
            match = "correlation"
    if spans_gpu and match == "none":
        # no launch matched by correlation: the kernels inside the span's
        # interval on the device's own timeline
        spans = defaultdict(list)
        starts = np.array([s for s, _, *_ in dev], dtype=np.float64)
        ends = np.array([t for _, t, *_ in dev], dtype=np.float64)
        for name, s, t in spans_gpu:
            inside = (starts >= s) & (ends <= t)
            spans[name].append(float((ends[inside] - starts[inside]).sum()) * 1e-9)
        match = "device annotation"

    idle = _name_gaps(gaps, cpu or calls)
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": capture.window_s,
        "launches": launches,
        "device_events": len(dev),
        "spans": dict(spans),
        "span_match": match,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": idle,
    }


def _name_gaps(gaps: np.ndarray, ops_list: list) -> list:
    """The longest gaps summed by the innermost host operation running at
    each gap's middle, or, where none is, by the last one that ended before
    it ("after <op>")."""
    if not len(gaps) or not ops_list:
        return []
    widths = gaps[:, 1] - gaps[:, 0]
    longest = np.argsort(-widths)[:GAPS_NAMED]
    ops = np.array([(s, t) for s, t, _ in ops_list], dtype=np.float64)
    names = [n for _, _, n in ops_list]
    totals: dict[str, float] = defaultdict(float)
    for g in longest:
        mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
        inside = np.nonzero((ops[:, 0] <= mid) & (ops[:, 1] >= mid))[0]
        if len(inside):
            name = names[inside[np.argmin(ops[inside, 1] - ops[inside, 0])]]
        else:
            before = np.nonzero(ops[:, 1] < mid)[0]
            name = "after " + names[before[np.argmax(ops[before, 1])]] if len(before) else "(no host op traced)"
        totals[name] += widths[g] * 1e-9
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
