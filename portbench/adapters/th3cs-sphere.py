"""Program side of configuration `th3cs-sphere`: the port's th3cs export,
`solvers.th3cs.video_exporter`, driven a frame a `push`: the 3-D step as
configuration `hypersonic3d-sphere` runs it (`solvers.hypersonic3d.run`,
kernels p4, #2 and p2 on the card, their plain versions on CPU tensors),
then the schlieren (`hypersonic3d.vis_field`) and its quantization on the
device, the frame `window` deep in flight, and the oldest frame's
volume to the host and appended to one `.4spl`.  After `frames_per_video`
frames the exporter is closed (the frames in flight written, the footer)
and a new one opened at the same path, as a user re-running th3cs on the
state carried on.  The finished video is first moved aside and removed on
a thread of the adapter's own: opening the next one over it would truncate
~1 GB inside the frame (0.23-0.39 s on the H100 machine's disk, once in 60
frames), a cost of the run's file and not of the export a frame pays.  So
the cell's directory holds the open video and at most one being removed.

The fields the checks read add the frame's uint8 volume (`vol`) as the
`.4spl` holds it: the exporter is flushed and the frame's bytes are read
back from the file, at the place the frames pushed into the video give
it, so the checks hold the written export to the reference as well as
the step.  The `.4spl` lies in a directory of its own under the
checkout's build/portbench_cache/, which is removed when the program is
freed."""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from fluidsims_tpu_torch.io import fourspl
from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk
from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from fluidsims_tpu_torch.solvers.th3cs import (GAMMA, schlieren_frame,
                                               video_exporter)

FLOW = ("xi", "phix", "phiy", "phiz", "lam", "zet")
FIELDS = FLOW + ("vol",)
KERNELS = {"h3d_step": "step3_kernel", "h3d_wavespeed": "wavespeed3_kernel",
           "h3d_pad": "pad3_kernel"}
CACHE = Path(__file__).resolve().parents[2] / "build" / "portbench_cache"

_PHYSICS = ("cfl", "u_ref", "R", "gamma_floor", "Twall", "tau_vib",
            "theta_v", "sdf_cx", "sdf_cy", "sdf_cz", "sdf_r", "inflow_r",
            "inflow_p", "inflow_u", "inflow_v", "inflow_w", "sponge_n",
            "sponge_strength", "sponge_out_n", "sponge_out_strength", "t0",
            "dtau0", "outflow")


class State(NamedTuple):
    flow: h3.Hypersonic3DState
    frame: int | None    # its place in the open video (None: not exported)


class Program:
    def __init__(self, cfg: dict, traffic: dict, device, ref):
        n = int(traffic["n"])
        self.cfg = h3.Hypersonic3DConfig(
            nx=n, ny=n, nz=n, dx=1.0 / n, dy=1.0 / n, dz=1.0 / n,
            dtype=traffic["dtype"], **{k: cfg[k] for k in _PHYSICS})
        self.device = torch.device(device)
        self.ref = ref
        ex = cfg["export"]
        if (ex["view"], ex["gamma"], ex["flags"]) != (
                "schlieren", GAMMA, fourspl.FLAG_F32_PRECISION):
            raise ValueError(f"th3cs exports the schlieren at gamma {GAMMA}"
                             f" with flags {fourspl.FLAG_F32_PRECISION}, the"
                             f" configuration asks for {ex}")
        self.spf = int(traffic["steps_per_frame"])
        self.per_video = int(ex["frames_per_video"])
        CACHE.mkdir(parents=True, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="th3cs-", dir=CACHE)
        weakref.finalize(self, shutil.rmtree, self.dir, True)
        self.path = Path(self.dir) / "volume.4spl"
        self.p_size, self.window = int(ex["p_size"]), int(ex["window"])
        self.videos, self.remover = 0, None
        self.exporter = self.open_video()

    def open_video(self):
        return video_exporter(
            self.path, self.cfg, self.spf, p_size=self.p_size,
            engine="cuda" if self.device.type == "cuda" else "torch",
            window=self.window)

    def init(self, noise):
        s = h3.init(self.cfg, self.device)
        self.solid = s.solid
        flow = {k: getattr(s, k) for k in FLOW + ("t", "dtau")}
        return self.state(self.ref.perturb(flow, noise))

    def state(self, fields: dict) -> State:
        flow = h3.Hypersonic3DState(*(fields[k] for k in FLOW),
                                    solid=self.solid, t=fields["t"],
                                    dtau=fields["dtau"])
        return State(flow, None)

    def fields(self, s: State) -> dict:
        if s.frame is None:
            vol = schlieren_frame(self.cfg, s.flow)
        else:
            self.exporter.flush()
            vol = self.written(s.frame)
        return dict({k: getattr(s.flow, k) for k in FLOW + ("t", "dtau")},
                    vol=vol)

    def written(self, k: int) -> torch.Tensor:
        """Frame k of the video at the path as the file holds it; zeros
        unless the header publishes exactly the k + 1 frames pushed into
        the video and the file holds all of frame k."""
        shape = (self.cfg.nz, self.cfg.ny, self.cfg.nx)
        size = shape[0] * shape[1] * shape[2]
        with open(self.path, "rb") as f:
            head = struct.unpack(fourspl.HEADER_FMT, f.read(32))
            frames, p_size = head[8], head[9]
            f.seek(32 + p_size * 48 + k * size)
            data = f.read(size) if frames == k + 1 else b""
        vol = np.zeros(size, np.uint8)
        vol[:len(data)] = np.frombuffer(data, np.uint8)
        return torch.from_numpy(vol.reshape(shape))

    def run(self, s: State, n: int) -> State:
        if n != self.spf:
            raise ValueError(f"the exporter steps {self.spf} a frame, "
                             f"asked for {n}")
        if self.exporter.pushed == self.per_video:
            self.exporter.close()
            self.retire()
            self.exporter = self.open_video()
        flow = self.exporter.push(s.flow)
        return State(flow, self.exporter.pushed - 1)

    def retire(self) -> None:
        """Moves the finished video off the path and removes it on a
        thread, after the one removed before it."""
        self.videos += 1
        old = self.path.with_name(f"finished-{self.videos}.4spl")
        os.replace(self.path, old)
        if self.remover is not None:
            self.remover.join()
        self.remover = threading.Thread(target=old.unlink, daemon=True)
        self.remover.start()

    @staticmethod
    def clock(s: State) -> list:
        return [s.flow.t, s.flow.dtau]

    @staticmethod
    def launches() -> int:
        return sum(hk.LAUNCHES.values())

    def control_frame(self, fields: dict, n: int):
        """The program has no path below float32 (its kernels take float32
        and float64): the reference in bfloat16 stands in."""
        return None
