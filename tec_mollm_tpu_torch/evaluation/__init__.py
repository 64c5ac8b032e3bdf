"""Evaluation: physical-unit metric constants and streaming validation metrics."""
