"""Result verification: CLTune's ``SetReference`` mechanism.

The outputs of each tested kernel configuration are compared against the
outputs of a reference implementation; a mismatch marks the configuration as
failed so "no parameter-dependent bugs are present in the kernel"
(paper section III-A).

Outputs are tensors, or tuples/lists (nested) of tensors.  The comparison
runs on the tensors' own device, so verifying a 2048x2048 result on the
card copies nothing to the host.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

# default absolute/relative tolerances per result dtype
_TOLS = {
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (2e-2, 2e-2),
    torch.float16: (2e-3, 2e-3),
    torch.float64: (1e-12, 1e-12),
}


class VerificationError(AssertionError):
    pass


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [torch.as_tensor(tree)]


def _leaf_close(a: torch.Tensor, b: torch.Tensor, atol: Optional[float],
                rtol: Optional[float]) -> None:
    if a.shape != b.shape:
        raise VerificationError(
            f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    b = b.to(a.device)
    if a.dtype != b.dtype:
        # allow dtype promotion differences; compare in f32
        a = a.to(torch.float32)
        b = b.to(torch.float32)
    da, dr = _TOLS.get(a.dtype, (1e-5, 1e-5))
    atol = da if atol is None else atol
    rtol = dr if rtol is None else rtol
    # the tolerance follows the result dtype; the test itself runs in at
    # least f32 so that narrow types are not compared in their own rounding
    wide = torch.promote_types(a.dtype, torch.float32)
    if not torch.allclose(a.to(wide), b.to(wide), atol=atol, rtol=rtol,
                          equal_nan=False):
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        err = (a64 - b64).abs()
        denom = b64.abs().clamp_min(1e-30)
        raise VerificationError(
            f"output mismatch: max_abs_err={err.max().item():.3e} "
            f"max_rel_err={(err / denom).max().item():.3e} "
            f"(atol={atol}, rtol={rtol})")


def assert_trees_close(candidate: Any, reference: Any,
                       atol: Optional[float] = None,
                       rtol: Optional[float] = None) -> None:
    """Assert two (nested tuples of) tensors match within tolerance."""
    ca = _leaves(candidate)
    re_ = _leaves(reference)
    if len(ca) != len(re_):
        raise VerificationError(
            f"leaf count mismatch: {len(ca)} vs {len(re_)}")
    for a, b in zip(ca, re_):
        _leaf_close(a, b, atol, rtol)


def trees_close(candidate: Any, reference: Any,
                atol: Optional[float] = None,
                rtol: Optional[float] = None) -> bool:
    try:
        assert_trees_close(candidate, reference, atol=atol, rtol=rtol)
        return True
    except VerificationError:
        return False
