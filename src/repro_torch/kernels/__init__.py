"""CUDA kernels for the H100, one package per kernel family.

  matmul/     GEMM          (paper section VI)

Each package ships <name>.py (the kernel's wrapper and its plain PyTorch
version), csrc/ (the CUDA source, built by :mod:`.build`), ops.py (a
``@tunable`` declaration + public op resolving configs via
``repro_torch.core.registry.lookup``) and ref.py (the PyTorch oracle).
Importing this package registers the kernels in the tunable registry.
The conv2d and flash-attention kernels wait for their port (ROADMAP.md).
"""

from . import matmul

__all__ = ["matmul"]
