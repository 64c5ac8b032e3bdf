"""The median device time of a padded batch's forward: the ``device_ms`` of
the program's ``serve.dispatch`` spans in the traced segment (CUDA events
around the forward, read after the copy back)."""

from benchmark.metrics import _spans


def read(record: dict) -> float | None:
    rec = _spans.session(record)
    if rec is None:
        return None
    return _spans.p50([s["attrs"]["device_ms"] for s in rec["spans"]
                       if s["name"] == "serve.dispatch" and "device_ms" in s["attrs"]])
