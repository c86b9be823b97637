"""PyTorch / CUDA port of the CLTune-style auto-tuner.

A second package beside the JAX package ``repro``: the same layout, module
for module, with the Pallas TPU kernels rewritten as CUDA kernels for the
NVIDIA H100 (``sm_90a``).  It imports neither ``jax`` nor ``repro``.
"""
