"""The service's own median host time of a padded batch (copy in, forward,
copy out): ``ForecastService.stats()["forward_p50_ms"]`` after the window."""


def read(record: dict) -> float | None:
    return record.get("serve_stats", {}).get("forward_p50_ms")
