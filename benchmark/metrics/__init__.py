"""The readers of the per-layer metrics: ``<name>.py`` with ``read(record) ->
float | None``, found by the longest dotted prefix of a metric's name in
``BENCHMARK.json`` (``spec.reader``), which also says its cells and its unit.
``record`` holds the window's numbers (``window``), the configuration, the
traffic, the device's name and the traced segment's summary (``trace``,
``trace.reduce``), and what the driver's ``traced`` added. A reader that finds nothing returns None and the metric is
left out of the line."""
