"""The median time a served request waits between its submission to the
batcher and the start of the dispatch that carries it (the batch window and
the wait for the device lock included): the program's ``serve.queue`` spans in
the traced segment."""

from benchmark.metrics import _spans


def read(record: dict) -> float | None:
    return _spans.duration_p50_ms(record, "serve.queue")
