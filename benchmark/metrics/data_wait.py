"""The loop's time blocked on the loader's prefetch queue, as a share of the
traced segment: the program's ``data.wait`` spans on the thread that ran the
loop's steps (``train.step`` or ``eval.step`` spans). Read under one name a
cell (``data_wait.train.scale_up``, ``data_wait.forecast``)."""

from benchmark.metrics import _spans

LOOP_SPANS = ("train.step", "eval.step")


def read(record: dict) -> float | None:
    rec = _spans.session(record)
    if rec is None:
        return None
    loop = {s["thread"] for s in rec["spans"] if s["name"] in LOOP_SPANS}
    return _spans.share(record, "data.wait", loop) if loop else None
