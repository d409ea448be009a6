"""Carry a hypersonic2d state across packages through numpy.

`state_to_numpy(np.asarray(...))` of a JAX `Hypersonic2DState` and
`state_from_numpy` here give the port the identical state, so both
packages can step it and be compared; the reverse direction returns the
port's state as numpy arrays for any consumer.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.euler2d import Cons
from .solvers.hypersonic2d import Hypersonic2DState

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(U_fields, mask, t, *, dtype: torch.dtype,
                     device=None) -> Hypersonic2DState:
    """Build a state from four `(ny, nx)` arrays (rho, mx, my, E), a bool
    mask and a scalar time.  The arrays are copied."""
    U = Cons(*(torch.tensor(np.asarray(f), dtype=dtype, device=device)
               for f in U_fields))
    m = torch.tensor(np.asarray(mask, dtype=bool), device=device)
    shape = tuple(m.shape)
    for name, f in zip(Cons._fields, U):
        if tuple(f.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(f.shape)}, mask {shape}")
    return Hypersonic2DState(
        U=U, mask=m, t=torch.tensor(float(np.asarray(t)), dtype=dtype,
                                    device=device))


def state_to_numpy(state: Hypersonic2DState):
    """(U_fields tuple of 4 arrays, mask, t) as numpy, copied to the host."""
    U = tuple(f.detach().cpu().numpy() for f in state.U)
    return U, state.mask.detach().cpu().numpy(), state.t.detach().cpu().numpy()
