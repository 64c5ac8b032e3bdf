"""The routing's skew in the traced pass: the heaviest expert's routed rows,
summed over the DeepSeekMoE layer calls, over the mean expert's (the program's
counters ``llm.moe.rows_max`` and ``llm.moe.rows``, the latter over the
routed experts). 1 is even routing; the routed experts' roofline is read
against it, and a change of it means routing changed."""

from benchmark.metrics import _spans


def read(record: dict) -> float | None:
    rec = _spans.session(record)
    if rec is None:
        return None
    c = rec["counts"]
    experts = record["config"].get("model", {}).get("deepseek_v2", {}).get("n_routed_experts")
    if not c.get("llm.moe.rows") or "llm.moe.rows_max" not in c or not experts:
        return None
    return c["llm.moe.rows_max"] / (c["llm.moe.rows"] / experts)
