"""Quotients with a Python-number operand, correctly rounded.

JAX divides an array by a weakly typed Python number with one IEEE
division in the array's dtype.  PyTorch's CUDA division of a tensor by a
Python number multiplies by its rounded reciprocal instead, and `c / t`
is `reciprocal(t) * c` on every device, so neither matches JAX nor a
kernel that divides.  These helpers make the number a 0-d tensor of the
operand's dtype and device first, which takes the true division
everywhere.
"""

from __future__ import annotations

import torch

__all__ = ["scalar", "div", "rdiv"]


def scalar(ref: torch.Tensor, c: float) -> torch.Tensor:
    """c as a 0-d tensor of ref's dtype and device."""
    return torch.full((), c, dtype=ref.dtype, device=ref.device)


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c, one correctly rounded division in a's dtype."""
    return torch.div(a, scalar(a, c))


def rdiv(c: float, a: torch.Tensor) -> torch.Tensor:
    """c / a, one correctly rounded division in a's dtype."""
    return torch.div(scalar(a, c), a)
