"""The device's idle share of the traced segment: 100 * (1 - busy / window),
busy being the union of every kernel, copy and memset interval on the card.
Read under one name a driver kind (``device_idle.serve``) or a cell."""


def read(record: dict) -> float | None:
    t = record.get("trace")
    if not t or t["device_events"] == 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
