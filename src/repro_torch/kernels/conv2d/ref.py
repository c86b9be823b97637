"""PyTorch oracle for the 2D-convolution case study (paper section V).

B[x,y] = w * sum_{i,j} F[i,j] * A[x+i-hx, y+j-hy]   (zero padding at borders)

Single-channel, single-precision, same-size output: the paper's
deep-learning-style 2D convolution, with hx = Fh//2 and hy = Fw//2.

The padding is explicit and asymmetric, Fh//2 rows above and (Fh-1)//2
below (Fw//2 / (Fw-1)//2 columns), then ``F.conv2d(padding=0)``.
``padding="same"`` puts the extra row of an even filter on the other side
and answers a different function.

cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits and fails the float32 tolerance.  Importing this
module turns that off (``torch.backends.cudnn.allow_tf32 = False``) for
the oracle, for the library path (``HALO_MODE="xla"``) and for the
timing yardstick alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cudnn.allow_tf32 = False


def conv2d_reference(image: torch.Tensor, filt: torch.Tensor,
                     weight: float = 1.0) -> torch.Tensor:
    """image: (H, W) f32; filt: (Fh, Fw) f32; returns (H, W)."""
    fh, fw = filt.shape
    img = F.pad(image[None, None].to(torch.float32),
                (fw // 2, (fw - 1) // 2, fh // 2, (fh - 1) // 2))
    out = F.conv2d(img, filt[None, None].to(torch.float32), padding=0)
    return (weight * out[0, 0]).to(image.dtype)


def conv_flops(H: int, W: int, Fh: int, Fw: int) -> float:
    """Paper footnote 2: GFLOPS computed as (1 + 2*Xf*Yf) * X * Y / t."""
    return (1.0 + 2.0 * Fh * Fw) * H * W


def conv_bytes(H: int, W: int, elt_bytes: int = 4) -> float:
    """Paper footnote 2: bandwidth as 2 * X * Y (read + write) / t."""
    return 2.0 * H * W * elt_bytes
