"""Program side of configuration `hypersonic2d-capsule`: the port's public
2-D solver API, engine `auto` (`solvers.hypersonic2d.run` through
`core/stepper.run_steps` into `step`, which launches kernels #1
`hypersonic2d_step` and p1 `hypersonic2d_wavespeed` on CUDA tensors and
takes their plain versions on CPU tensors)."""

from __future__ import annotations

import torch

from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
from fluidsims_tpu_torch.ops.euler2d import Cons
from fluidsims_tpu_torch.solvers import hypersonic2d as h2

FIELDS = ("rho", "mx", "my", "E")
# kernel name in portbench/counts -> a fragment of its name in the trace
KERNELS = {"h2d_step": "step_kernel",
           "h2d_wavespeed": "inflow_wavespeed_kernel"}


def solver_config(cfg: dict, traffic: dict, dtype: str):
    nx, ny = int(traffic["nx"]), int(traffic["ny"])
    g = cfg["geometry_per_grid"]
    return h2.Hypersonic2DConfig(
        nx=nx, ny=ny, gamma=cfg["gamma"], cfl=cfg["cfl"],
        visc_nu=cfg["visc_nu"], visc_rho=cfg["visc_rho"],
        visc_e=cfg["visc_e"], inflow_mach=cfg["inflow_mach"],
        geom_x0=g["x0_per_nx"] * nx, geom_cy=g["cy_per_ny"] * ny,
        geom_Rb=g["Rb_per_ny"] * ny, geom_Rn=g["Rn_per_ny"] * ny,
        geom_theta=cfg["geom_theta"],
        steps_per_frame=int(traffic["steps_per_frame"]), dtype=dtype)


class Program:
    def __init__(self, cfg: dict, traffic: dict, device, ref):
        self.cfg = solver_config(cfg, traffic, traffic["dtype"])
        self.raw = (cfg, traffic)
        self.device = torch.device(device)
        self.ref = ref

    def init(self, noise):
        """The port's init, then the benchmark's seeded perturbation."""
        s = h2.init(self.cfg, self.device)
        self.mask = s.mask
        return self.state(self.ref.perturb(self.fields(s), noise))

    def state(self, fields: dict):
        return h2.Hypersonic2DState(
            U=Cons(*(fields[k] for k in FIELDS)), mask=self.mask,
            t=fields["t"])

    @staticmethod
    def fields(s) -> dict:
        return dict(zip(FIELDS, s.U), t=s.t)

    def run(self, s, n: int):
        return h2.run(self.cfg, s, n)

    @staticmethod
    def clock(s) -> list:
        return [s.t]

    @staticmethod
    def launches() -> int:
        return sum(hk.LAUNCHES.values())

    def control_frame(self, fields: dict, n: int):
        """The program's own lower-precision path: the float32 kernels,
        from the same state rounded to float32, on the reference's mask.
        None where the configuration already runs float32 (the program
        has no lower path)."""
        if self.cfg.dtype != "float64":
            return None
        cfg32 = solver_config(*self.raw, "float32")
        s = h2.Hypersonic2DState(
            U=Cons(*(fields[k].to(torch.float32) for k in FIELDS)),
            mask=self.ref.solid.contiguous(),
            t=fields["t"].to(torch.float32))
        out = h2.run(cfg32, s, n)
        return {k: v.to(torch.float64) for k, v in self.fields(out).items()}
