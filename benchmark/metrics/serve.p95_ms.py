"""The 95th percentile of request latency in the untraced window: every
request due in it, timed at the client from its due time to its answer, a
failed or unanswered one counting as never answered. Per-layer, not bounded:
between runs of one code on one H100 host it spread too far to bound
(PERF.md)."""


def read(record: dict) -> float | None:
    return record["window"].get("p95_ms")
