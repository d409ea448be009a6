"""Plain PyTorch reference of configuration `th3cs-sphere`: the upstream's
headless 3-D export, th3cs.cu.  A frame is the frozen 3-D step of
portbench/reference/hypersonic3d-sphere.py (loaded from its file, not
copied), then the frame's volume: the schlieren |grad rho| as central
differences of the decoded, halo-padded density, zero inside solids
(k_schlieren_export, :641-673), then normalized by the frame's min and
max, raised to gamma 0.65 and quantized to 8 bits (:1199-1222).

One departure from th3cs.cu, on purpose: the index is the count of the
thresholds (k/255)^(1/0.65), k = 1..255, computed in float64 and rounded
once to float32, times the frame's range, that the value less the
frame's min reaches, as the port's documented quantizer takes it
(io/fourspl.gamma_thresholds), not th3cs.cu's truncation of
powf(v, 0.65) * 255.  The two differ by one index at representation
boundaries, and a slack of one index would blunt the check of `vol`.

It imports nothing of the program.  The state adds `vol`, the frame's
uint8 indices, to the step's fields; its scale is 255, so a difference of
one index reads 1/255.  The schlieren is computed in the dtype of its
inputs, the quantization in float32 (the program's quantizer casts to it).
Interface: as portbench/reference/hypersonic2d-capsule.py.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _load_step():
    path = Path(__file__).with_name("hypersonic3d-sphere.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_th3cs_reference_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


h3 = _load_step()

FIELDS = h3.FIELDS + ("vol",)
CLOCK = h3.CLOCK
GAMMA = 0.65
LEVELS = 256


def thresholds(gamma: float = GAMMA, levels: int = LEVELS) -> np.ndarray:
    """(k/(levels-1))^(1/gamma), k = 1..levels-1, in float64, rounded once
    to float32."""
    k = np.arange(1, levels, dtype=np.float64)
    return ((k / (levels - 1)) ** (1.0 / gamma)).astype(np.float32)


def schlieren(c, f, solid, solid_pad):
    """|grad rho| by central differences of the padded density, zero in
    solid cells."""
    q = h3.decode(c, f)
    infl = tuple(torch.tensor(v, dtype=q[0].dtype, device=q[0].device)
                 for v in h3.inflow_values(c))
    r = h3._padded(c, q, solid_pad, infl)[0]
    H = h3.HALO
    nz, ny, nx = solid.shape

    def nb(dz, dy, dx):
        return r[H + dz:H + dz + nz, H + dy:H + dy + ny, H + dx:H + dx + nx]

    gx = (nb(0, 0, 1) - nb(0, 0, -1)) * (0.5 / c.dx)
    gy = (nb(0, 1, 0) - nb(0, -1, 0)) * (0.5 / c.dy)
    gz = (nb(1, 0, 0) - nb(-1, 0, 0)) * (0.5 / c.dz)
    return torch.where(solid, 0.0, torch.sqrt(gx * gx + gy * gy + gz * gz))


def quantize(field):
    """The frame's 8-bit indices: per-frame min/max, gamma, as the count of
    the scaled thresholds the value less the min reaches."""
    v = field.to(torch.float32)
    mn = torch.amin(v)
    rng = torch.clamp_min(torch.amax(v) - mn, 1e-12)
    d = v - mn
    idx = torch.zeros(v.shape, dtype=torch.uint8, device=v.device)
    for t in torch.from_numpy(thresholds()).to(v.device) * rng:
        idx += d >= t
    return idx


class Reference(h3.Reference):
    def __init__(self, cfg: dict, traffic: dict, device):
        super().__init__(cfg, traffic, device)
        self.scales = dict(self.scales, vol=float(LEVELS - 1))

    def volume(self, state: dict):
        f = tuple(state[k] for k in h3.FIELDS)
        return quantize(schlieren(self.c, f, self.solid, self.solid_pad))

    def work(self) -> dict:
        """The 3-D step's units, and the bytes of a frame's volume."""
        return dict(super().work(), frame_bytes=self.solid.numel())

    def init(self, dtype, noise) -> dict:
        state = super().init(dtype, noise)
        return dict(state, vol=self.volume(state))

    def frame(self, state: dict, n: int, dtype) -> dict:
        out = super().frame(state, n, dtype)
        return dict(out, vol=self.volume(out))
