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

from typing import Dict

from . import attention, conv2d, matmul

__all__ = ["attention", "conv2d", "launch_counts", "matmul"]


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, by counter name: the
    three families' and AdamW's passes (``repro_torch.optim.fused``)."""
    from ..optim import fused      # the optimizer imports this package
    return {**matmul.LAUNCHES, **conv2d.LAUNCHES, **attention.LAUNCHES,
            **fused.LAUNCHES}
