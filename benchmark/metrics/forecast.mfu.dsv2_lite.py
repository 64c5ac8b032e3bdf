"""The scoring loop's share of the bf16 peak on the DeepSeek-V2 backbone: the
count of a forward's FLOPs per window (``counts_moe.forward_flops``: 6 routed
and 2 shared experts a token, the router, the MLA projections, the dense
layer, the front end and the head) times the windows the untraced window
scored, over its wall time."""

from benchmark import counts, counts_moe


def read(record: dict) -> float | None:
    w = record["window"]
    if record["device_kind"] not in counts.PEAKS or not w.get("windows"):
        return None
    rate = counts_moe.forward_flops(record["config"]) * w["windows"] / w["elapsed_s"]
    return 100.0 * rate / counts.peaks(record["device_kind"])["bf16_flops"]
