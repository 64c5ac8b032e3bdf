"""What the readers of the program's own spans share: the port's latest
recording session (``tec_mollm_tpu_torch.utils.profiler.recorded()``), which
after the traced segment holds that segment alone. Nothing is read from a
record without a traced segment, nor from a program without the tracer."""

from __future__ import annotations

import numpy as np

# a percentile of fewer spans than this is not reported
MIN_SAMPLES = 20


def session(record: dict) -> dict | None:
    """The spans the program recorded in the traced segment, or None."""
    t = record.get("trace")
    if not t or t.get("window_s", 0) <= 0:
        return None
    try:
        from tec_mollm_tpu_torch.utils import profiler
    except ImportError:
        return None
    recorded = getattr(profiler, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    return rec if rec["spans"] else None


def p50(values: list[float]) -> float | None:
    return float(np.percentile(values, 50)) if len(values) >= MIN_SAMPLES else None


def duration_p50_ms(record: dict, name: str) -> float | None:
    """The median duration in ms of the spans named ``name``."""
    rec = session(record)
    if rec is None:
        return None
    return p50([(s["end_ns"] - s["start_ns"]) * 1e-6 for s in rec["spans"] if s["name"] == name])


def share(record: dict, name: str, threads: set[int] | None = None) -> float | None:
    """The spans named ``name`` (on ``threads``, if given) summed, as a
    percentage of the traced segment's wall time; None without any."""
    rec = session(record)
    if rec is None:
        return None
    spans = [s for s in rec["spans"] if s["name"] == name and (threads is None or s["thread"] in threads)]
    if not spans:
        return None
    total_s = sum(s["end_ns"] - s["start_ns"] for s in spans) * 1e-9
    return 100.0 * total_s / record["trace"]["window_s"]
