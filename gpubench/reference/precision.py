"""The precision a reference is computed in.

``float32`` is the reference itself.  A lower precision rounds every
value the program holds in its own type: each product's operands and
output, forward and backward, and each activation the reference marks
(``held``: the residual stream).  The products accumulate in float32 on
the rounded operands, as tensor cores do.  ``bfloat16`` rounds to
bfloat16; ``float8_e4m3fn`` rounds to fp8 (e4m3) after scaling the whole
tensor so that its largest magnitude lands on fp8's largest finite value
(448), as fp8 with a per-tensor scale does.  The reference put in the
program's place and computed in the precision below the configuration's
is the control that the comparison must refuse.
"""

from __future__ import annotations

from typing import Callable

import torch

PRECISIONS = ("float32", "bfloat16", "float8_e4m3fn")
FP8_MAX = 448.0


def full_float32() -> None:
    """float32 products in float32: TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (float32) -> x rounded to ``precision``, back in float32."""
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "float8_e4m3fn":
        def fp8(x: torch.Tensor) -> torch.Tensor:
            amax = x.detach().abs().amax().clamp(min=1e-30)
            scale = FP8_MAX / amax
            return (x * scale).to(torch.float8_e4m3fn).float() / scale
        return fp8
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b on rounded operands, the output rounded; the backward's two
    products round their operands and outputs too."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        # the operands are saved as given and rounded again in the
        # backward: no rounded copy of every weight is held
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(rnd(a) @ rnd(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        rg = rnd(g)
        return rnd(rg @ rnd(b).mT), rnd(rnd(a).mT @ rg), None


class _Held(torch.autograd.Function):
    """x rounded where the program holds it in its type; its gradient is
    rounded on the way back."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def product(precision: str):
    """(a, b) -> a @ b computed in ``precision`` (float32 tensors in and
    out; batch dims broadcast as in ``torch.matmul``, same shapes only)."""
    if precision == "float32":
        return torch.matmul
    rnd = rounder(precision)
    return lambda a, b: _RoundedMatmul.apply(a, b, rnd)


def held(precision: str):
    """x -> x as held in ``precision`` (identity in float32)."""
    if precision == "float32":
        return lambda x: x
    rnd = rounder(precision)
    return lambda x: _Held.apply(x, rnd)
