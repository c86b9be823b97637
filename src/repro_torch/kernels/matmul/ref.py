"""PyTorch oracle for the GEMM case study.

Paper form (section VI): C = alpha * A^T B + beta * C, single precision,
power-of-two dims.  ``trans_a`` selects whether A arrives K-major (the
paper's A^T layout) or M-major.

A float32 product on the card must run in full float32: TF32 keeps about
three decimal digits and fails the float32 tolerance.  Full float32 is
PyTorch's default; importing this module sets it explicitly
(``torch.backends.cuda.matmul.allow_tf32 = False``), for the oracle and
for the GEMM's plain version alike.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def gemm_reference(a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor | None = None, *, alpha: float = 1.0,
                   beta: float = 0.0, trans_a: bool = False,
                   acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = alpha * op(A) @ B + beta * C with op(A) = A^T if trans_a.

    a: (M, K) or (K, M) when trans_a; b: (K, N); returns (M, N) in a.dtype.
    """
    lhs = a.t() if trans_a else a
    out = lhs.to(acc_dtype) @ b.to(acc_dtype)
    out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c.to(acc_dtype)
    return out.to(a.dtype)
