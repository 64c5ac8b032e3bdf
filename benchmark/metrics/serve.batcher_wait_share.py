"""The batcher thread's time blocked on an empty queue, waiting for the first
request of a batch, as a share of the traced segment: the program's
``serve.batcher_wait`` spans. At a fixed offered rate a faster serving path
leaves the batcher waiting longer."""

from benchmark.metrics import _spans


def read(record: dict) -> float | None:
    return _spans.share(record, "serve.batcher_wait")
