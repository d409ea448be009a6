"""Program side of configuration `hypersonic3d-sphere`: the port's public
3-D solver API, engine `auto` (`solvers.hypersonic3d.run` through
`core/stepper.run_steps` into `step`: the torch ops of the τ clock and the
encode around kernels p4 `hypersonic3d_pad` (decode and halo padding),
#2 `hypersonic3d_step` and p2 `hypersonic3d_wavespeed`, whose wrappers
take the plain versions on CPU tensors)."""

from __future__ import annotations

import torch

from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as h3

FIELDS = ("xi", "phix", "phiy", "phiz", "lam", "zet")
KERNELS = {"h3d_step": "step3_kernel", "h3d_wavespeed": "wavespeed3_kernel",
           "h3d_pad": "pad3_kernel"}

_PHYSICS = ("cfl", "u_ref", "R", "gamma_floor", "Twall", "tau_vib",
            "theta_v", "sdf_cx", "sdf_cy", "sdf_cz", "sdf_r", "inflow_r",
            "inflow_p", "inflow_u", "inflow_v", "inflow_w", "sponge_n",
            "sponge_strength", "sponge_out_n", "sponge_out_strength", "t0",
            "dtau0", "outflow")


class Program:
    def __init__(self, cfg: dict, traffic: dict, device, ref):
        n = int(traffic["n"])
        self.cfg = h3.Hypersonic3DConfig(
            nx=n, ny=n, nz=n, dx=1.0 / n, dy=1.0 / n, dz=1.0 / n,
            dtype=traffic["dtype"], **{k: cfg[k] for k in _PHYSICS})
        self.device = torch.device(device)
        self.ref = ref

    def init(self, noise):
        s = h3.init(self.cfg, self.device)
        self.solid = s.solid
        return self.state(self.ref.perturb(self.fields(s), noise))

    def state(self, fields: dict):
        return h3.Hypersonic3DState(*(fields[k] for k in FIELDS),
                                    solid=self.solid, t=fields["t"],
                                    dtau=fields["dtau"])

    @staticmethod
    def fields(s) -> dict:
        return {k: getattr(s, k) for k in FIELDS + ("t", "dtau")}

    def run(self, s, n: int):
        return h3.run(self.cfg, s, n)

    @staticmethod
    def clock(s) -> list:
        return [s.t, s.dtau]

    @staticmethod
    def launches() -> int:
        return sum(hk.LAUNCHES.values())

    def control_frame(self, fields: dict, n: int):
        """The program has no path below float32 (its kernels take float32
        and float64): the reference in bfloat16 stands in."""
        return None
