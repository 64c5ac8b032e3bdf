"""The routed experts' share of their roofline in the traced pass: the least
time the chip could take for their products over the pass's windows
(``counts_moe.experts_span``: the larger of the FLOPs at the bf16 peak and
the bytes at the HBM peak; the FLOPs bound it at the published widths) over
the device time of every kernel launched inside the benchmark's spans around
each layer's routed-experts module (``mlp.experts``)."""

from benchmark import counts, counts_moe

SPAN = "moe_experts"


def read(record: dict) -> float | None:
    t = record.get("trace")
    spans = (t or {}).get("spans", {}).get(SPAN)
    if not spans or record["device_kind"] not in counts.PEAKS or sum(spans) <= 0:
        return None
    config = record["config"]
    flops, nbytes = counts_moe.experts_span(config, t["windows"], record["batch"])
    least, _ = counts.least_seconds(flops, nbytes, record["device_kind"], config["train"]["bf16"])
    return 100.0 * least / sum(spans)
