"""Element gathers of the semi-Lagrangian samplers (port of
fluidsims_tpu.ops.gather).

The JAX module flattens multi-dimensional indexing into a 1-D take because
the TPU gathers that way ~10x faster.  The port keeps the same flattened
form, as `index_select` on the flat field, so both packages read the same
elements in the same layout.
"""

from __future__ import annotations

import torch

__all__ = ["gather2d", "gather3d"]


def gather2d(f: torch.Tensor, j: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """f[j, i] for integer index tensors of any (matching) shape."""
    ny, nx = f.shape
    flat = (j.long() * nx + i.long()).reshape(-1)
    return f.reshape(-1).index_select(0, flat).reshape(j.shape)


def gather3d(f: torch.Tensor, k: torch.Tensor, j: torch.Tensor,
             i: torch.Tensor) -> torch.Tensor:
    """f[k, j, i] for integer index tensors of any (matching) shape."""
    nz, ny, nx = f.shape
    flat = ((k.long() * ny + j.long()) * nx + i.long()).reshape(-1)
    return f.reshape(-1).index_select(0, flat).reshape(k.shape)
