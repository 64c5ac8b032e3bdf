"""Metric constants of the reference's evaluation (``evaluation/metrics.py`` of
the JAX package): predictions are clipped to the physical TEC range
[TEC_MIN, TEC_MAX] TECU after the inverse transform; truths are not clipped.
The per-horizon metric functions come with the evaluation CLIs."""

TEC_MIN, TEC_MAX = 0.0, 200.0
