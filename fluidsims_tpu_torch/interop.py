"""Carry states and configs across packages through numpy and plain dicts.

`state_to_numpy(np.asarray(...))` of a JAX `Hypersonic2DState` and
`state_from_numpy` here give the port the identical state, so both
packages can step it and be compared; the reverse direction returns the
port's state as numpy arrays for any consumer.  `sph_state_from_numpy` /
`sph_state_to_numpy` do the same for SPH, and `sph_config_from_dict` maps
the fields of a JAX `SPHConfig` (its `asdict()`) to the port's, renaming
the engines.  Nothing here imports the JAX package.

Every `device=None` means the GPU, as for the solvers' `init`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .ops.euler2d import Cons
from .solvers.hypersonic2d import Hypersonic2DState
from .solvers.sph import SPHConfig, SPHState

__all__ = ["state_from_numpy", "state_to_numpy", "sph_state_from_numpy",
           "sph_state_to_numpy", "sph_config_from_dict"]

# JAX engine name -> port engine name
_SPH_ENGINES = {"auto": "auto", "pallas": "cuda", "xla": "torch",
                "exact": "exact"}


def _device(device):
    return resolve_device("cuda") if device is None else device


def state_from_numpy(U_fields, mask, t, *, dtype: torch.dtype,
                     device=None) -> Hypersonic2DState:
    """Build a state from four `(ny, nx)` arrays (rho, mx, my, E), a bool
    mask and a scalar time.  The arrays are copied."""
    device = _device(device)
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


def sph_state_from_numpy(pos, vel, t, tau, rain_carry, step_idx, *,
                         dtype: torch.dtype, device=None) -> SPHState:
    """Build an SPH state from (n, 2) positions and velocities and the four
    scalars of the clock, the rain accumulator and the step count.  The
    arrays are copied."""
    device = _device(device)
    p = torch.tensor(np.asarray(pos), dtype=dtype, device=device)
    v = torch.tensor(np.asarray(vel), dtype=dtype, device=device)
    if p.ndim != 2 or p.shape[1] != 2 or p.shape != v.shape:
        raise ValueError(f"pos {tuple(p.shape)} and vel {tuple(v.shape)} "
                         "must both be (n, 2)")

    def scalar(x, dt=dtype):
        return torch.tensor(np.asarray(x).item(), dtype=dt, device=device)

    return SPHState(pos=p, vel=v, t=scalar(t), tau=scalar(tau),
                    rain_carry=scalar(rain_carry),
                    step_idx=scalar(step_idx, torch.int32))


def sph_state_to_numpy(state: SPHState):
    """(pos, vel, t, tau, rain_carry, step_idx) as numpy, copied to the
    host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def sph_config_from_dict(fields: dict) -> SPHConfig:
    """The port's SPHConfig for the fields of a JAX SPHConfig (`asdict()`):
    engine 'pallas' becomes 'cuda' and 'xla' becomes 'torch'."""
    fields = dict(fields)
    fields["engine"] = _SPH_ENGINES[fields.get("engine", "auto")]
    return SPHConfig(**fields)
