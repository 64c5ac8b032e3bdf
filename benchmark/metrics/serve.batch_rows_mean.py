"""The batcher's mean windows per device batch:
``ForecastService.stats()["mean_batch_rows"]`` after the window."""


def read(record: dict) -> float | None:
    return record.get("serve_stats", {}).get("mean_batch_rows")
