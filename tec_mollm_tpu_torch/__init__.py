"""PyTorch + CUDA port of tec_mollm_tpu for NVIDIA Hopper (H100).

The JAX package ``tec_mollm_tpu`` is the reference; this package imports none of
it. Its hand-written kernels live in ``csrc/`` and are built on first use into
``build/tec_mollm_tpu_torch/`` at the repository root (``ops/_build.py``).
"""
