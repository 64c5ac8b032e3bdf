"""The scoring loop's share of the bf16 peak: the benchmark's count of a
forward's FLOPs per window (``counts.forward_flops``) times the windows the
untraced window scored, over its wall time."""

from benchmark import counts


def read(record: dict) -> float | None:
    w = record["window"]
    if record["device_kind"] not in counts.PEAKS or not w.get("windows"):
        return None
    rate = counts.forward_flops(record["config"]) * w["windows"] / w["elapsed_s"]
    return 100.0 * rate / counts.peaks(record["device_kind"])["bf16_flops"]
