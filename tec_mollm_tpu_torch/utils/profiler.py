"""Step timing, the port's spans and counters, and ``torch.profiler`` traces.

Spans record only while a ``torch.profiler`` is active, in this process and
on any thread: ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets when it starts and clears when it stops. (``torch._C._autograd.
_profiler_enabled()`` is the profiler's state on the calling thread alone, and
so reads False on the serving threads.) Off, ``span`` does that one check and
returns a shared no-op span: no ``record_function``, no CUDA event, no record.

On, a span keeps a record in memory (name, thread, start and end, its id, its
parent's id and its attributes) and opens ``record_function(name)``, so that
on the thread the profiler records the span is among the profiler's own
events too. The records of one profiler-active interval form a session; a new
one replaces the last, and ``recorded()`` returns the latest. A span open when
the profiler starts or stops counts for its part inside the session (``record``
keeps an interval that ended after the stop too). A session holds at most
``MAX_RECORDS`` spans and counts the ones it drops past that.

Clock: ``now()`` (``time.perf_counter_ns``) times every span, and a session
converts it with one offset, taken when it starts, to the wall-clock epoch
kineto stamps its events on: a span's ``start_ns`` and ``end_ns`` are directly
comparable with the device intervals of the same trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 200_000
# a trace.json row of program spans: this plus the thread's native id, beside
# kineto's own rows of the process
SPAN_ROW_BASE = 1 << 40

now = time.perf_counter_ns


def sync(device: torch.device | str | None = None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall time and item counts -> throughput. Each ``stop`` synchronises
    ``device`` first, so the time covers the work queued on the card, not
    only its launch."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.items = 0
        self.elapsed = 0.0

    def start(self) -> None:
        sync(self.device)
        self._t0 = time.perf_counter()

    def stop(self, items: int = 0) -> float:
        sync(self.device)
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        self.items += items
        return dt

    @property
    def items_per_sec(self) -> float:
        return self.items / self.elapsed if self.elapsed > 0 else 0.0


# ----------------------------------------------------------------- spans


class _Session:
    """The records of one profiler-active interval."""

    def __init__(self):
        self.offset_ns = time.time_ns() - now()
        self.start = now()
        self.end: int | None = None
        self.records: list[tuple] = []
        self.counts: dict[str, int] = {}
        self.threads: dict[int, str] = {}
        self.dropped = 0
        self.lock = threading.Lock()

    def overlaps(self, start: int, end: int) -> bool:
        return end > self.start and (self.end is None or start < self.end)

    def add(self, name: str, tid: int, start: int, end: int, sid: int, parent: int | None, attrs: dict) -> None:
        """Keep a span, clipped to the session: one open when the profiler
        started counts from its start, one still open when it stopped ends
        there."""
        if not self.overlaps(start, end):
            return
        start = max(start, self.start)
        if self.end is not None:
            end = min(end, self.end)
        with self.lock:
            if len(self.records) < MAX_RECORDS:
                self.records.append((name, tid, start, end, sid, parent, attrs))
            else:
                self.dropped += 1


_session: _Session | None = None
_session_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _begin_session() -> None:
    global _session
    with _session_lock:
        _session = _Session()


def _end_session() -> None:
    s = _session
    if s is not None and s.end is None:
        s.end = now()


def _open_session() -> _Session:
    """The latest session: the one recording now, or one that ended after the
    caller saw the profiler active (its spans are clipped to its end). One is
    begun if the profiler started before this module was imported."""
    global _session
    if _session is None:
        with _session_lock:
            if _session is None:
                _session = _Session()
    return _session


def _install_session_hooks() -> None:
    """Begin a session as any profiler starts and end it as it stops: the
    profiler calls these two module functions from ``_start_trace`` and
    ``__exit__``."""
    start, stop = _autograd_profiler._run_on_profiler_start, _autograd_profiler._run_on_profiler_stop
    if getattr(start, "_opens_span_session", False):
        return

    def on_start():
        _begin_session()
        start()

    def on_stop():
        stop()
        _end_session()

    on_start._opens_span_session = True
    _autograd_profiler._run_on_profiler_start = on_start
    _autograd_profiler._run_on_profiler_stop = on_stop


_install_session_hooks()


def _thread() -> tuple[int, list]:
    """(native id, stack of open spans) of the calling thread."""
    try:
        return _local.tid, _local.stack
    except AttributeError:
        _local.tid, _local.stack = threading.get_native_id(), []
        return _local.tid, _local.stack


class _Off:
    """The span while nothing records: falsy, and does nothing."""

    id = start = end = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def begin(self, at: int) -> "_Off":
        return self

    def finish(self, at: int) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class Span:
    """A recording span; ``with`` opens and closes it on the calling thread.
    ``begin(t)`` and ``finish(t)`` take a clock reading (``now()``) the caller
    already has as the start or the end, so that an interval the program times
    for itself and the span share one reading."""

    __slots__ = ("name", "id", "parent", "attrs", "start", "end", "_session", "_rf", "_tid")

    def __init__(self, session: _Session, name: str, parent: int | None, attrs: dict):
        self._session = session
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.attrs = attrs
        self.start: int | None = None
        self.end: int | None = None

    def __bool__(self) -> bool:
        return True

    def begin(self, at: int) -> "Span":
        self.start = at
        return self

    def finish(self, at: int) -> None:
        self.end = at

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tid, stack = _thread()
        self._tid = tid
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.start is None:
            self.start = now()
        return self

    def __exit__(self, *exc) -> None:
        if self.end is None:
            self.end = now()
        self._rf.__exit__(*exc)
        _, stack = _thread()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        s = self._session
        if self._tid not in s.threads:
            s.threads[self._tid] = threading.current_thread().name
        s.add(self.name, self._tid, self.start, self.end, self.id, self.parent, self.attrs)


def recording() -> bool:
    """Whether a profiler is active, so spans and counters record: a caller
    that must read the device for a counter asks this first."""
    return bool(_autograd_profiler._is_profiler_enabled)


def span(name: str, parent: int | None = None, **attrs) -> Span | _Off:
    """A span named ``name`` under ``parent`` (a span's id; by default the
    calling thread's innermost open span), with ``attrs``; ``OFF`` while no
    profiler is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return Span(_open_session(), name, parent, attrs)


def record(name: str, start: int, end: int, parent: int | None = None, **attrs) -> int | None:
    """A span the caller timed itself (``now()`` readings), on the calling
    thread, clipped to the session it overlaps: so a wait that began before
    the profiler started, or ended after it stopped, counts for the part
    inside. Its id, or None where it overlaps no session."""
    if _autograd_profiler._is_profiler_enabled:
        s = _open_session()
    else:
        s = _session
        if s is None or s.end is None:
            return None
    if not s.overlaps(start, end):
        return None
    tid, stack = _thread()
    if parent is None and stack:
        parent = stack[-1].id
    if tid not in s.threads:
        s.threads[tid] = threading.current_thread().name
    sid = next(_ids)
    s.add(name, tid, start, end, sid, parent, attrs)
    return sid


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the session recording now."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    s = _open_session()
    with s.lock:
        s.counts[name] = s.counts.get(name, 0) + n


def _union_within(intervals: list[tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    covered, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return covered


def recorded() -> dict[str, Any]:
    """The latest session: ``spans`` (dicts of ``name``, ``thread``,
    ``start_ns``, ``end_ns`` on the profiler's clock, ``id``, ``parent`` and
    ``attrs``), ``counts``, ``threads`` (native id -> name), ``dropped``,
    ``window_ns`` (its start and end, the end None while it records) and
    ``stats``: for each span name its ``count``, ``total_ms``, ``self_ms``
    (the duration less the part its child spans cover), ``p50_ms`` and
    ``p95_ms``."""
    s = _session
    if s is None:
        return {"spans": [], "counts": {}, "threads": {}, "dropped": 0, "window_ns": None, "stats": {}}
    with s.lock:
        records, counts, dropped = list(s.records), dict(s.counts), s.dropped
    off = s.offset_ns
    children: dict[int, list[tuple[int, int]]] = {}
    for _, _, a, b, _, parent, _ in records:
        if parent is not None:
            children.setdefault(parent, []).append((a, b))
    spans, by_name = [], {}
    for name, tid, a, b, sid, parent, attrs in records:
        spans.append({"name": name, "thread": tid, "start_ns": a + off, "end_ns": b + off, "id": sid,
                      "parent": parent, "attrs": attrs})
        own = b - a - _union_within(children.get(sid, []), a, b)
        by_name.setdefault(name, []).append((b - a, own))
    stats = {}
    for name, rows in by_name.items():
        dur = np.array([r[0] for r in rows], dtype=np.float64) * 1e-6
        stats[name] = {"count": len(rows), "total_ms": float(dur.sum()),
                       "self_ms": float(sum(r[1] for r in rows)) * 1e-6,
                       "p50_ms": float(np.percentile(dur, 50)), "p95_ms": float(np.percentile(dur, 95))}
    return {"spans": spans, "counts": counts, "threads": dict(s.threads), "dropped": dropped,
            "window_ns": (s.start + off, None if s.end is None else s.end + off), "stats": stats}


# ----------------------------------------------------------------- traces


def add_spans_to_chrome_trace(path: str) -> None:
    """Add the latest session's spans to a Chrome trace written by
    ``torch.profiler``: one row per host thread, on the file's own time base
    (``ts`` in µs from its ``baseTimeNanoseconds``), beside kineto's rows; the
    counts and the dropped spans under ``programSpans``."""
    rec = recorded()
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid, name in sorted(rec["threads"].items()):
        row = SPAN_ROW_BASE + tid
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": row,
                       "args": {"name": f"program spans: {name} (thread {tid})"}})
        events.append({"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": row, "args": {"sort_index": row}})
    for sp in rec["spans"]:
        events.append({"ph": "X", "cat": "program_span", "name": sp["name"], "pid": pid,
                       "tid": SPAN_ROW_BASE + sp["thread"], "ts": (sp["start_ns"] - base) / 1e3,
                       "dur": (sp["end_ns"] - sp["start_ns"]) / 1e3,
                       "args": {"id": sp["id"], "parent": sp["parent"], **sp["attrs"]}})
    doc["programSpans"] = {"counts": rec["counts"], "dropped": rec["dropped"]}
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[torch.profiler.profile | None]:
    """``torch.profiler`` over the block (the CPU, and CUDA when present),
    written as a Chrome trace to ``logdir/trace.json`` with the program's
    spans of every thread; yields the profiler, or None and does nothing when
    ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path)
