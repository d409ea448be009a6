"""Time-stepping clocks: CFL controller and the log-time (τ) clock.

Port of fluidsims_tpu.core.clock.  The reference's "tau_" programs advance
a log-time clock `t = t0 * e^τ` with `dt_eff = min(t*dτ, dt_CFL)`
(tau_burgers.cu:13,692, tau_sph.cu:666-668,718-721), and the 3-D solver
adds a deadband feedback controller on dτ (tau_hypersonic_3d_cuda.cu:
1697-1704).

Every function here works on 0-d tensors and never reads a value back to
the host, so dt stays on the device between steps: the reference's per-step
device->host wavespeed readback (tau_hypersonic_cuda.cu:1846-1850) does not
exist in the port either.  Constants combine in Python double first and
enter tensor arithmetic once, in the tensor's dtype, as the JAX package's
weakly typed scalars do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TauClock", "tau_clock", "tau_tick", "tau_tick_feedback",
           "dtau_feedback", "cfl_dt"]


class TauClock(NamedTuple):
    """Carry state for the τ clock (all 0-d tensors)."""

    t: torch.Tensor      # physical time
    tau: torch.Tensor    # log-time
    dtau: torch.Tensor   # current log-time step


def tau_clock(t0: float = 1e-3, dtau: float = 1e-2, dtype=torch.float32,
              device=None) -> TauClock:
    return TauClock(
        t=torch.tensor(t0, dtype=dtype, device=device),
        tau=torch.tensor(0.0, dtype=dtype, device=device),
        dtau=torch.tensor(dtau, dtype=dtype, device=device),
    )


def tau_tick(clock: TauClock, dt_cfl) -> tuple[TauClock, torch.Tensor]:
    """One τ-clock advance with CFL capping: dt = min(t*dτ, dt_cfl).

    The τ coordinate always advances by dτ, physical time by the capped dt
    (tau_burgers.cu:692, tau_sph.cu:718-721).
    """
    dt_tau = clock.t * clock.dtau
    dt = torch.minimum(dt_tau, torch.as_tensor(dt_cfl, dtype=dt_tau.dtype,
                                               device=dt_tau.device))
    new = TauClock(t=clock.t + dt, tau=clock.tau + clock.dtau, dtau=clock.dtau)
    return new, dt


def dtau_feedback(
    dtau,
    dt,
    dt_cfl,
    shrink: float = 0.80,
    grow: float = 1.10,
    hi_band: float = 1.10,
    lo_band: float = 0.85,
    dtau_min: float = 1e-7,
    dtau_max: float = 5e-2,
):
    """The reference's dτ feedback controller with deadband
    (tau_hypersonic_3d_cuda.cu:1697-1704, th3cs.cu:1178-1183).

    Shrink dτ 0.8x only when the τ-implied dt overshoots 1.10*dt_cfl; grow
    1.1x only when it undershoots 0.85*dt_cfl; hold inside the deadband.
    Clamped to the reference's [1e-7, 5e-2].
    """
    return torch.clamp(
        torch.where(
            dt > hi_band * dt_cfl, dtau * shrink,
            torch.where(dt < lo_band * dt_cfl, dtau * grow, dtau),
        ),
        dtau_min,
        dtau_max,
    )


def tau_tick_feedback(
    clock: TauClock,
    dt_cfl,
    shrink: float = 0.8,
    grow: float = 1.1,
    dtau_min: float = 1e-7,
    dtau_max: float = 5e-2,
) -> tuple[TauClock, torch.Tensor]:
    """τ advance with dτ feedback control (tau_hypersonic_3d_cuda.cu:1697-1704).

    dt is capped at the CFL limit, and dτ is adjusted by `dtau_feedback`
    from the τ-implied dt.
    """
    dt_tau = clock.t * clock.dtau
    dt = torch.minimum(dt_tau, torch.as_tensor(dt_cfl, dtype=dt_tau.dtype,
                                               device=dt_tau.device))
    new_dtau = dtau_feedback(
        clock.dtau, dt_tau, dt_cfl,
        shrink=shrink, grow=grow, dtau_min=dtau_min, dtau_max=dtau_max,
    )
    new = TauClock(t=clock.t + dt, tau=clock.tau + clock.dtau, dtau=new_dtau)
    return new, dt


def cfl_dt(max_wavespeed: torch.Tensor, cfl: float, dx: float = 1.0,
           nu_max: float = 0.0) -> torch.Tensor:
    """Combined convective + explicit-diffusion stable dt.

    dt_conv = CFL*dx/maxs; if diffusion is active the explicit 2-D limit
    dt_diff = 0.25*dx^2/nu caps it (tau_hypersonic_cuda.cu:1852-1865).
    `max_wavespeed` is a 0-d tensor; non-finite values are floored, so the
    result is always a usable positive dt.  (`c / tensor` in torch is
    reciprocal-then-multiply, one rounding more than JAX's division, so the
    quotient is taken tensor by tensor.)
    """
    maxs = torch.where(torch.isfinite(max_wavespeed), max_wavespeed, 1e-12)
    maxs = torch.clamp_min(maxs, 1e-12)
    dt = torch.div(torch.full_like(maxs, cfl * dx), maxs)
    if nu_max > 1e-12:
        dt = torch.clamp_max(dt, 0.25 * dx * dx / nu_max)
    return dt
