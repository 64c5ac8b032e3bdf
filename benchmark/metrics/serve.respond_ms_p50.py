"""The median time from a request's result in hand to its last byte written
(TECU scaling, clip, ``tolist``, ``json.dumps``, the socket write): the
program's ``serve.respond`` spans in the traced segment."""

from benchmark.metrics import _spans


def read(record: dict) -> float | None:
    return _spans.duration_p50_ms(record, "serve.respond")
