"""CUDA kernels for the H100, one package per kernel family.

  matmul/     GEMM             (paper section VI)
  conv2d/     2D convolution   (paper section V)
  attention/  flash attention  (beyond the paper)

Each package ships <name>.py (the kernel's wrapper, its launch counter
``LAUNCHES`` and its plain PyTorch version), csrc/ (the CUDA source,
built by :mod:`.build`), ops.py (a ``@tunable`` declaration + public op
resolving configs via ``repro_torch.core.registry.lookup``) and ref.py
(the PyTorch oracle).  Importing this package registers the kernels in
the tunable registry.
"""

from . import attention, conv2d, matmul

__all__ = ["attention", "conv2d", "matmul"]
