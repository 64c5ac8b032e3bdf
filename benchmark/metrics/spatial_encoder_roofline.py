"""The spatial encoder's share of its roofline in the traced pass: the least
time the chip could take for the encoder's work over the pass's windows
(``counts.gat_span``: the larger of its FLOPs at the bf16 peak and its bytes
at the HBM peak; bytes bound it at the flagship's shapes) over the device time
of every kernel launched inside the benchmark's span around
``model.spatial_encoder``."""

from benchmark import counts


def read(record: dict) -> float | None:
    t = record.get("trace")
    spans = (t or {}).get("spans", {}).get("spatial_encoder")
    if not spans or record["device_kind"] not in counts.PEAKS or sum(spans) <= 0:
        return None
    flops, nbytes = counts.gat_span(record["config"], t["windows"])
    least, _ = counts.least_seconds(flops, nbytes, record["device_kind"], record["config"]["train"]["bf16"])
    return 100.0 * least / sum(spans)
