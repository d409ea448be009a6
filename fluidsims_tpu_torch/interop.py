"""Carry states and configs across packages through numpy and plain dicts.

`state_to_numpy(np.asarray(...))` of a JAX `Hypersonic2DState` and
`state_from_numpy` here give the port the identical state, so both
packages can step it and be compared; the reverse direction returns the
port's state as numpy arrays for any consumer.  `sph_state_from_numpy` /
`sph_state_to_numpy` do the same for SPH, and `sph_config_from_dict` maps
the fields of a JAX `SPHConfig` (its `asdict()`) to the port's, renaming
the engines.  `hyp3d_state_from_numpy` / `hyp3d_state_to_numpy` and
`hyp3d_config_from_dict` do the same for the 3-D hypersonic solver, and
the `gs_*`, `lbm_*`, `burgers_*`, `sw_*`, `mhd_*`, `stam3d_*` and
`stam2d_*` functions for Gray–Scott, the D2Q9 LBM, Burgers, shallow water,
GLM-MHD and the 3-D and 2-D stable fluids, the `flip_*` functions for
FLIP/APIC, the `mpm_*` functions for MLS-MPM and the `nbody_*` functions
for the prime-graph layout.
Nothing here imports the JAX package.

Every `device=None` means the GPU, as for the solvers' `init`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .ops.euler2d import Cons
from .solvers.burgers import BurgersConfig, BurgersState
from .solvers.flip_apic import FlipApicConfig, FlipApicState
from .solvers.gray_scott import GrayScottConfig, GrayScottState
from .solvers.hypersonic2d import Hypersonic2DState
from .solvers.hypersonic3d import Hypersonic3DConfig, Hypersonic3DState
from .solvers.lbm import LBMConfig, LBMState
from .solvers.mhd import ConsM, MHDConfig, MHDState
from .solvers.mpm import MPMConfig, MPMState
from .solvers.nbody_graph import GraphLayoutConfig, GraphLayoutState
from .solvers.shallow_water import ShallowWaterConfig, ShallowWaterState
from .solvers.sph import SPHConfig, SPHState
from .solvers.stam2d import Stam2DConfig, Stam2DState
from .solvers.stam3d import Stam3DConfig, Stam3DState

__all__ = ["state_from_numpy", "state_to_numpy", "sph_state_from_numpy",
           "sph_state_to_numpy", "sph_config_from_dict",
           "hyp3d_state_from_numpy", "hyp3d_state_to_numpy",
           "hyp3d_config_from_dict", "gs_state_from_numpy",
           "gs_state_to_numpy", "gs_config_from_dict", "lbm_state_from_numpy",
           "lbm_state_to_numpy", "lbm_config_from_dict",
           "burgers_state_from_numpy", "burgers_state_to_numpy",
           "burgers_config_from_dict", "sw_state_from_numpy",
           "sw_state_to_numpy", "sw_config_from_dict", "mhd_state_from_numpy",
           "mhd_state_to_numpy", "mhd_config_from_dict",
           "stam3d_state_from_numpy", "stam3d_state_to_numpy",
           "stam3d_config_from_dict", "stam2d_state_from_numpy",
           "stam2d_state_to_numpy", "stam2d_config_from_dict",
           "flip_state_from_numpy", "flip_state_to_numpy",
           "flip_config_from_dict", "mpm_state_from_numpy",
           "mpm_state_to_numpy", "mpm_config_from_dict",
           "nbody_state_from_numpy", "nbody_state_to_numpy",
           "nbody_config_from_dict"]

# JAX engine name -> port engine name
_ENGINES = {"auto": "auto", "pallas": "cuda", "hybrid": "cuda",
            "xla": "torch", "exact": "exact", "dense": "dense",
            "scatter": "scatter"}


def _device(device):
    return resolve_device("cuda") if device is None else device


def _config(cls, fields: dict):
    """cls(**fields) with the JAX engine name mapped to the port's."""
    fields = dict(fields)
    fields["engine"] = _ENGINES[fields.get("engine", "auto")]
    return cls(**fields)


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
    return _config(SPHConfig, fields)


def hyp3d_state_from_numpy(xi, phix, phiy, phiz, lam, zet, solid, t, dtau, *,
                           dtype: torch.dtype,
                           device=None) -> Hypersonic3DState:
    """Build a 3-D state from the six (nz, ny, nx) log-space fields, the
    bool solid mask and the scalars t and dtau.  The arrays are copied."""
    device = _device(device)
    fields = [torch.tensor(np.asarray(f), dtype=dtype, device=device)
              for f in (xi, phix, phiy, phiz, lam, zet)]
    m = torch.tensor(np.asarray(solid, dtype=bool), device=device)
    if m.ndim != 3:
        raise ValueError(f"solid must be (nz, ny, nx), got {tuple(m.shape)}")
    for name, f in zip(Hypersonic3DState._fields, fields):
        if f.shape != m.shape:
            raise ValueError(f"{name} has shape {tuple(f.shape)}, solid "
                             f"{tuple(m.shape)}")

    def scalar(x):
        return torch.tensor(np.asarray(x).item(), dtype=dtype, device=device)

    return Hypersonic3DState(*fields, solid=m, t=scalar(t), dtau=scalar(dtau))


def hyp3d_state_to_numpy(state: Hypersonic3DState):
    """(xi, phix, phiy, phiz, lam, zet, solid, t, dtau) as numpy, copied to
    the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def hyp3d_config_from_dict(fields: dict) -> Hypersonic3DConfig:
    """The port's Hypersonic3DConfig for the fields of a JAX
    Hypersonic3DConfig (`asdict()`): the same names and meanings."""
    return Hypersonic3DConfig(**fields)


def gs_state_from_numpy(u, v, *, dtype: torch.dtype,
                        device=None) -> GrayScottState:
    """Build a Gray–Scott state from two (ny, nx) arrays.  The arrays are
    copied."""
    device = _device(device)
    u = torch.tensor(np.asarray(u), dtype=dtype, device=device)
    v = torch.tensor(np.asarray(v), dtype=dtype, device=device)
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} must "
                         "both be (ny, nx)")
    return GrayScottState(u=u, v=v)


def gs_state_to_numpy(state: GrayScottState):
    """(u, v) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def gs_config_from_dict(fields: dict) -> GrayScottConfig:
    """The port's GrayScottConfig for the fields of a JAX GrayScottConfig
    (`asdict()`): engine 'pallas' becomes 'cuda' and 'xla' becomes
    'torch'."""
    return _config(GrayScottConfig, fields)


def lbm_state_from_numpy(f, solid, *, dtype: torch.dtype,
                         device=None) -> LBMState:
    """Build an LBM state from the (9, ny, nx) populations and the (ny, nx)
    solid mask, taken as bool.  The arrays are copied."""
    device = _device(device)
    f = torch.tensor(np.asarray(f), dtype=dtype, device=device)
    m = torch.tensor(np.asarray(solid, dtype=bool), device=device)
    if m.ndim != 2 or tuple(f.shape) != (9, *m.shape):
        raise ValueError(f"f {tuple(f.shape)} must be (9, ny, nx) and solid "
                         f"{tuple(m.shape)} (ny, nx)")
    return LBMState(f=f, solid=m)


def lbm_state_to_numpy(state: LBMState):
    """(f, solid) as numpy, copied to the host."""
    return tuple(x.detach().cpu().numpy() for x in state)


def lbm_config_from_dict(fields: dict) -> LBMConfig:
    """The port's LBMConfig for the fields of a JAX LBMConfig (`asdict()`):
    engine 'pallas' becomes 'cuda' and 'xla' becomes 'torch'."""
    return _config(LBMConfig, fields)


def _fields_and_scalars(fields, scalars, names, dtype, device):
    """Copies of equal-shaped 2-D arrays and 0-d scalars as tensors."""
    device = _device(device)
    ts = [torch.tensor(np.asarray(f), dtype=dtype, device=device)
          for f in fields]
    for name, f in zip(names, ts):
        if f.ndim != 2 or f.shape != ts[0].shape:
            raise ValueError(f"{name} has shape {tuple(f.shape)}; every "
                             f"field must be (ny, nx) = {tuple(ts[0].shape)}")
    return ts + [torch.tensor(np.asarray(x).item(), dtype=dtype,
                              device=device) for x in scalars]


def burgers_state_from_numpy(phi_u, phi_v, t, tau, *, dtype: torch.dtype,
                             device=None) -> BurgersState:
    """Build a Burgers state from two (ny, nx) arrays and the clock
    scalars t and tau.  The arrays are copied."""
    return BurgersState(*_fields_and_scalars(
        (phi_u, phi_v), (t, tau), BurgersState._fields, dtype, device))


def burgers_state_to_numpy(state: BurgersState):
    """(phi_u, phi_v, t, tau) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def burgers_config_from_dict(fields: dict) -> BurgersConfig:
    """The port's BurgersConfig for the fields of a JAX BurgersConfig
    (`asdict()`): engine 'pallas' becomes 'cuda' and 'xla' becomes
    'torch'."""
    return _config(BurgersConfig, fields)


def sw_state_from_numpy(sigma, u, v, t, tau, *, dtype: torch.dtype,
                        device=None) -> ShallowWaterState:
    """Build a shallow-water state from three (ny, nx) arrays and the
    clock scalars t and tau.  The arrays are copied."""
    return ShallowWaterState(*_fields_and_scalars(
        (sigma, u, v), (t, tau), ShallowWaterState._fields, dtype, device))


def sw_state_to_numpy(state: ShallowWaterState):
    """(sigma, u, v, t, tau) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def sw_config_from_dict(fields: dict) -> ShallowWaterConfig:
    """The port's ShallowWaterConfig for the fields of a JAX
    ShallowWaterConfig (`asdict()`): engine 'pallas' becomes 'cuda' and
    'xla' becomes 'torch'."""
    return _config(ShallowWaterConfig, fields)


def mhd_state_from_numpy(U_fields, t, *, dtype: torch.dtype,
                         device=None) -> MHDState:
    """Build an MHD state from the seven (ny, nx) conserved fields (rho,
    mx, my, E, Bx, By, psi) and the scalar t.  The arrays are copied."""
    if len(U_fields) != len(ConsM._fields):
        raise ValueError(f"{len(U_fields)} fields, want "
                         f"{len(ConsM._fields)}")
    *U, t = _fields_and_scalars(U_fields, (t,), ConsM._fields, dtype, device)
    return MHDState(U=ConsM(*U), t=t)


def mhd_state_to_numpy(state: MHDState):
    """(U_fields tuple of 7 arrays, t) as numpy, copied to the host."""
    return (tuple(f.detach().cpu().numpy() for f in state.U),
            state.t.detach().cpu().numpy())


def mhd_config_from_dict(fields: dict) -> MHDConfig:
    """The port's MHDConfig for the fields of a JAX MHDConfig (`asdict()`):
    engine 'pallas' becomes 'cuda' and 'xla' becomes 'torch'."""
    return _config(MHDConfig, fields)


def stam3d_state_from_numpy(u, v, w, u0, v0, w0, d, d0, step_idx, *,
                            dtype: torch.dtype, device=None) -> Stam3DState:
    """Build a 3-D stable-fluids state from eight equal (n+2)^3 arrays,
    ghost rings included, and the step index.  The arrays are copied."""
    device = _device(device)
    fields = [torch.tensor(np.asarray(f), dtype=dtype, device=device)
              for f in (u, v, w, u0, v0, w0, d, d0)]
    shape = tuple(fields[0].shape)
    if len(shape) != 3 or len(set(shape)) != 1 or any(
            tuple(f.shape) != shape for f in fields):
        raise ValueError("the eight fields must all be (n+2, n+2, n+2), got "
                         f"{[tuple(f.shape) for f in fields]}")
    return Stam3DState(*fields, step_idx=torch.tensor(
        int(np.asarray(step_idx)), dtype=torch.int32, device=device))


def stam3d_state_to_numpy(state: Stam3DState):
    """(u, v, w, u0, v0, w0, d, d0, step_idx) as numpy, copied to the
    host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def stam3d_config_from_dict(fields: dict) -> Stam3DConfig:
    """The port's Stam3DConfig for the fields of a JAX Stam3DConfig
    (`asdict()`): engine 'pallas' becomes 'cuda' and 'xla' becomes
    'torch'."""
    return _config(Stam3DConfig, fields)


def stam2d_state_from_numpy(u, v, u0, v0, d, d0, step_idx, ovf, *,
                            dtype: torch.dtype, device=None) -> Stam2DState:
    """Build a 2-D stable-fluids state from six equal (n, n) interior
    arrays, the step index and the clamped-cell count.  The arrays are
    copied."""
    device = _device(device)
    fields = [torch.tensor(np.asarray(f), dtype=dtype, device=device)
              for f in (u, v, u0, v0, d, d0)]
    shape = tuple(fields[0].shape)
    if len(shape) != 2 or shape[0] != shape[1] or any(
            tuple(f.shape) != shape for f in fields):
        raise ValueError("the six fields must all be (n, n), got "
                         f"{[tuple(f.shape) for f in fields]}")

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)

    return Stam2DState(*fields, step_idx=scalar(step_idx), ovf=scalar(ovf))


def stam2d_state_to_numpy(state: Stam2DState):
    """(u, v, u0, v0, d, d0, step_idx, ovf) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def stam2d_config_from_dict(fields: dict) -> Stam2DConfig:
    """The port's Stam2DConfig for the fields of a JAX Stam2DConfig
    (`asdict()`): engine 'xla' becomes 'torch', 'pallas' and 'hybrid'
    become 'cuda', and `repair_window` (read only by JAX's hybrid repair)
    is dropped.  The results differ where JAX's engine does: JAX's
    'pallas' clamps the back-traces past `advect_band` rows, while the
    port's 'cuda' engine traces every cell exactly, as JAX's 'xla' does."""
    fields = dict(fields)
    fields.pop("repair_window", None)
    return _config(Stam2DConfig, fields)


def flip_state_from_numpy(pos, vel, affine_x, affine_y, density, *,
                          dtype: torch.dtype, device=None) -> FlipApicState:
    """Build a FLIP/APIC state from four (np, 2) particle arrays and the
    (n, n) density raster, taken as int32.  The arrays are copied."""
    device = _device(device)
    parts = [torch.tensor(np.asarray(f), dtype=dtype, device=device)
             for f in (pos, vel, affine_x, affine_y)]
    dens = torch.tensor(np.asarray(density, dtype=np.int32), device=device)
    if parts[0].ndim != 2 or parts[0].shape[1] != 2 or any(
            f.shape != parts[0].shape for f in parts):
        raise ValueError("pos, vel, affine_x and affine_y must all be "
                         f"(np, 2), got {[tuple(f.shape) for f in parts]}")
    if dens.ndim != 2 or dens.shape[0] != dens.shape[1]:
        raise ValueError(f"density must be (n, n), got {tuple(dens.shape)}")
    return FlipApicState(*parts, density=dens)


def flip_state_to_numpy(state: FlipApicState):
    """(pos, vel, affine_x, affine_y, density) as numpy, copied to the
    host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def flip_config_from_dict(fields: dict) -> FlipApicConfig:
    """The port's FlipApicConfig for the fields of a JAX FlipApicConfig
    (`asdict()`): engine 'pallas' becomes 'cuda'; 'dense' and 'scatter'
    keep their names.  JAX's 'pallas' is its cell-dense engine in VMEM,
    which drops the particles past a cell's K slots; the port's 'cuda'
    engine has the 'scatter' semantics and drops none."""
    return _config(FlipApicConfig, fields)


def mpm_state_from_numpy(pos, vel, F, Jp, *, dtype: torch.dtype,
                         device=None) -> MPMState:
    """Build an MLS-MPM state from (np, 2) pos and vel, (np, 2, 2) F and
    (np,) Jp.  The arrays are copied into contiguous tensors (JAX's init
    makes F a broadcast view)."""
    device = _device(device)
    pos, vel, F, Jp = (torch.tensor(np.ascontiguousarray(f), dtype=dtype,
                                    device=device)
                       for f in (pos, vel, F, Jp))
    n = pos.shape[0]
    if (pos.shape != (n, 2) or vel.shape != (n, 2) or F.shape != (n, 2, 2)
            or Jp.shape != (n,)):
        raise ValueError("pos, vel, F and Jp must be (np, 2), (np, 2), "
                         "(np, 2, 2) and (np,), got "
                         f"{[tuple(f.shape) for f in (pos, vel, F, Jp)]}")
    return MPMState(pos=pos, vel=vel, F=F, Jp=Jp)


def mpm_state_to_numpy(state: MPMState):
    """(pos, vel, F, Jp) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def mpm_config_from_dict(fields: dict) -> MPMConfig:
    """The port's MPMConfig for the fields of a JAX MPMConfig (`asdict()`):
    engine 'pallas' becomes 'cuda'; 'dense' and 'scatter' keep their names.
    JAX's 'pallas' is its cell-dense engine in VMEM, which drops the
    particles past a cell's K slots; the port's 'cuda' engine has the
    'scatter' semantics and drops none."""
    return _config(MPMConfig, fields)


def nbody_state_from_numpy(pos, vel, edges, steps, *, dtype: torch.dtype,
                           device=None) -> GraphLayoutState:
    """Build a graph-layout state from (n, dims) pos and vel, the (m, 2)
    edge list and the step count.  The arrays are copied; edges become
    int32 and the count a 0-d int32 tensor."""
    device = _device(device)
    pos, vel = (torch.tensor(np.ascontiguousarray(f), dtype=dtype,
                             device=device) for f in (pos, vel))
    edges = torch.tensor(np.asarray(edges, np.int32), device=device)
    if (pos.dim() != 2 or pos.shape[1] not in (2, 3)
            or vel.shape != pos.shape or edges.dim() != 2
            or edges.shape[1] != 2):
        raise ValueError("pos and vel must be (n, 2) or (n, 3) alike and "
                         "edges (m, 2), got "
                         f"{[tuple(f.shape) for f in (pos, vel, edges)]}")
    return GraphLayoutState(
        pos=pos, vel=vel, edges=edges,
        steps=torch.tensor(int(np.asarray(steps)), dtype=torch.int32,
                           device=device))


def nbody_state_to_numpy(state: GraphLayoutState):
    """(pos, vel, edges, steps) as numpy, copied to the host."""
    return tuple(f.detach().cpu().numpy() for f in state)


def nbody_config_from_dict(fields: dict) -> GraphLayoutConfig:
    """The port's GraphLayoutConfig for the fields of a JAX
    GraphLayoutConfig (`asdict()`); the engines have the same names."""
    return GraphLayoutConfig(**fields)
