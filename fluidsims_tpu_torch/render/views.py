"""Diagnostic view-mode library for the 2-D hypersonic solver (port of
fluidsims_tpu.render.views).

Behavioral spec: the 7 view modes of tau_hypersonic_cuda.cu
(k_render_vals :1178-1238, mode list :6-14): log rho, log p, speed,
schlieren |grad rho| (with BC-aware neighbor sampling, sample_prim_bc
:706-727), vorticity asinh(omega), Mach, log(p/rho); masked min/max
normalization (:1240-1334) and the jet colormap render (k_render_pixels
:1262-1279, solid cells gray 110).

`render_value` and `normalize_masked` run in torch on the state's device;
`render_rgba` copies the normalized field and the mask to the host in one
transfer and colours them there with numpy.  Where PyTorch on the card
divides through a rounded reciprocal, the views match JAX to rounding, not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import euler2d as e2
from ..ops.scalar import rdiv
from ..solvers import hypersonic2d as h2
from .colormap import jet, to_rgba

__all__ = ["VIEW_MODES", "render_value", "normalize_masked", "render_rgba",
           "normalized_to_host", "stream_frame_fn"]

VIEW_MODES = [
    "log_rho", "log_p", "speed", "schlieren", "vorticity", "mach",
    "log_p_over_rho",
]


def _sample_prim_bc(cfg, U, mask, dy, dx):
    """Neighbor prim with BC semantics (sample_prim_bc)."""
    center = e2.cons_to_prim(U, cfg.gamma)
    nb = h2._neighbor(cfg, U, mask, center, dy, dx)
    return e2.cons_to_prim(nb, cfg.gamma)


def render_value(cfg, state: h2.Hypersonic2DState, mode: str) -> torch.Tensor:
    """Per-cell scalar for a view mode; 0 in masked/non-finite cells."""
    U, mask = state.U, state.mask
    p = e2.cons_to_prim(U, cfg.gamma)

    if mode == "log_rho":
        v = torch.log(p.rho)
    elif mode == "log_p":
        v = torch.log(p.p)
    elif mode == "speed":
        v = torch.sqrt(p.u**2 + p.v**2)
    elif mode == "schlieren":
        rl = _sample_prim_bc(cfg, U, mask, 0, -1).rho
        rr = _sample_prim_bc(cfg, U, mask, 0, 1).rho
        rb = _sample_prim_bc(cfg, U, mask, -1, 0).rho
        rt = _sample_prim_bc(cfg, U, mask, 1, 0).rho
        gx = 0.5 * (rr - rl)
        gy = 0.5 * (rt - rb)
        v = torch.log(1e-12 + torch.sqrt(gx * gx + gy * gy))
    elif mode == "vorticity":
        pl = _sample_prim_bc(cfg, U, mask, 0, -1)
        pr = _sample_prim_bc(cfg, U, mask, 0, 1)
        pb = _sample_prim_bc(cfg, U, mask, -1, 0)
        pt = _sample_prim_bc(cfg, U, mask, 1, 0)
        omega = 0.5 * (pr.v - pl.v) - 0.5 * (pt.u - pb.u)
        v = torch.asinh(omega)
    elif mode == "mach":
        a = e2.sound_speed(p, cfg.gamma)
        v = torch.sqrt(p.u**2 + p.v**2) / torch.clamp_min(a, 1e-30)
    elif mode == "log_p_over_rho":
        v = torch.log(torch.clamp_min(
            p.p / torch.clamp_min(p.rho, e2.EPS_RHO), 1e-30))
    else:
        raise ValueError(f"unknown view mode {mode}")

    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(torch.isfinite(v), v, zero)
    return torch.where(mask, zero, v)


def normalize_masked(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Min/max over fluid cells only (k_render_vals/k_reduce_minmax)."""
    big = torch.full((), 1e30, dtype=v.dtype, device=v.device)
    mn = torch.amin(torch.where(mask, big, v))
    mx = torch.amax(torch.where(mask, -big, v))
    inv = rdiv(1.0, torch.clamp_min(mx - mn, 1e-30))
    return (v - mn) * inv


def normalized_to_host(cfg, state: h2.Hypersonic2DState,
                       mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(normalized view, solid mask) as numpy: the view and its
    normalization on the state's device, then one copy to the host of
    both."""
    t = normalize_masked(render_value(cfg, state, mode), state.mask)
    both = torch.stack([t, state.mask.to(t.dtype)]).cpu().numpy()
    return both[0], both[1] != 0


def render_rgba(cfg, state: h2.Hypersonic2DState, mode: str) -> np.ndarray:
    """(ny, nx, 4) uint8 frame; solids gray (110,110,110)
    (k_render_pixels :1270-1272)."""
    t, solid = normalized_to_host(cfg, state, mode)
    rgba = to_rgba(jet(t))
    rgba[solid] = np.array([110, 110, 110, 255], np.uint8)
    return rgba


def stream_frame_fn(cfg, run, mode: str, steps_per_frame: int,
                    serve_max: int):
    """The live stream's frame function for `hypersonic2d --serve`:
    `(frame_fn, (width, height))` with `frame_fn(state) -> (state, uint8
    frame)`.  A frame is `run(state, steps_per_frame)`, the view, its
    masked normalization (solids 0, fluid clipped to [0, 1]), a mean pool
    to at most `serve_max` cells per axis, y flipped so that the viewer's
    z-up volume shows the domain upright, and the gamma-0.65 quantization,
    all on the state's device; only the (1, height, width) uint8 frame
    needs to cross to the host."""
    from ..io import fourspl

    fy = max(1, -(-cfg.ny // serve_max))
    fx = max(1, -(-cfg.nx // serve_max))
    hc, wc = cfg.ny // fy, cfg.nx // fx

    def frame_fn(st):
        st2 = run(st, steps_per_frame)
        t = normalize_masked(render_value(cfg, st2, mode), st2.mask)
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        t = torch.where(st2.mask, zero, torch.clamp(t, 0.0, 1.0))
        t = t[:hc * fy, :wc * fx].reshape(hc, fy, wc, fx).mean((1, 3))
        return st2, fourspl.quantize_frame_device(t.flip(0)[None],
                                                  gamma=0.65)

    return frame_fn, (wc, hc)
