"""Static-offset neighbour access for stencils (port of
fluidsims_tpu.ops.shift).

Whole-array shifted views built from slices and concatenation, with edge
clamping or periodic wrapping: the plain PyTorch counterpart of the
reference's index arithmetic (tau_hypersonic_cuda.cu:266-313,
tau_gray_scott.cu:137-139).  Same names, arguments and results as the JAX
module; a zero shift returns the input tensor itself.
"""

from __future__ import annotations

import torch

__all__ = ["shift_clamped", "shift_wrapped", "shift_axis_clamped",
           "shift_axis_wrapped"]


def shift_axis_clamped(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """Return S with S[..., i, ...] = a[..., clip(i+d, 0, n-1), ...].

    Edge-replicated shift: the out-of-range region takes the edge value,
    as the reference's index clamping does.  |d| >= n raises ValueError.
    """
    if d == 0:
        return a
    axis = axis % a.ndim
    n = a.shape[axis]
    if abs(d) >= n:
        raise ValueError(f"shift {d} exceeds axis size {n}")
    if d > 0:
        body = a.narrow(axis, d, n - d)
        edge = a.narrow(axis, n - 1, 1)
        return torch.cat([body] + [edge] * d, dim=axis)
    body = a.narrow(axis, 0, n + d)
    edge = a.narrow(axis, 0, 1)
    return torch.cat([edge] * (-d) + [body], dim=axis)


def shift_axis_wrapped(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """Return S with S[..., i, ...] = a[..., (i+d) mod n, ...] (periodic);
    any d, |d| >= n included."""
    if d == 0:
        return a
    axis = axis % a.ndim
    n = a.shape[axis]
    d = d % n
    if d == 0:
        return a
    return torch.cat([a.narrow(axis, d, n - d), a.narrow(axis, 0, d)],
                     dim=axis)


def shift_clamped(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """2-D edge-clamped shift: S[y, x] = a[clip(y+dy), clip(x+dx)]."""
    return shift_axis_clamped(shift_axis_clamped(a, dy, axis=-2), dx, axis=-1)


def shift_wrapped(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """2-D periodic shift: S[y, x] = a[(y+dy) % H, (x+dx) % W]."""
    return shift_axis_wrapped(shift_axis_wrapped(a, dy, axis=-2), dx, axis=-1)
