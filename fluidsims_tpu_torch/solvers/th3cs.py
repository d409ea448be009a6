"""Headless 3-D hypersonic run exporting a schlieren `.4spl` volume video.

Port of fluidsims_tpu.solvers.th3cs.  Behavioral spec: th3cs.cu — the
physics of tau_hypersonic_3d_cuda.cu (solvers/hypersonic3d.py) run
headless for 60 frames x 4 steps (:1132-1134), schlieren |grad rho| per
frame (k_schlieren_export :641-673, the viewer's schlieren mode), a
256-entry heat palette (:1144-1150), per-frame min/max normalization with
gamma 0.65 and 8-bit quantization (:1199-1222), written with header flags
0x0004 (:1226-1228) via io/fourspl.

A frame is `steps_per_frame` steps, then `vis_field(..., "schlieren")`,
then `quantize_frame_device`, all on the device; only the uint8 indices
cross to the host.  The engine is what the caller names: "cuda" steps
through the CUDA kernels (their wrappers launch them on a GPU or raise),
"torch" through their plain versions.  Nothing switches engines on a
failure.

`export_4spl` writes the file at the end through the Python writer of
io/fourspl.py, which zlib's CRC-32 makes faster than the native writer of
io/fourspl_native.py (a byte-table CRC-32 loop, kept for the C API; both
give the same bytes; PERF.md §6).  `export_4spl_streamed` appends each
frame as it lands (io/live4spl.py), so a polling viewer shows the run
live, and ends with the same bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..io import fourspl
from . import hypersonic3d as h3

__all__ = ["ENGINES", "make_frame_fn", "export_4spl", "export_4spl_streamed",
           "stream_frames"]

ENGINES = ("cuda", "torch")


def _hooks(cfg, engine: str) -> dict:
    """step() hooks for the engine: {} keeps step()'s defaults, the CUDA
    kernels."""
    from ..kernels import hypersonic3d_cuda as hk

    if engine == "cuda":
        return {}
    if engine == "torch":
        return {"core": functools.partial(hk.step_core_plain, cfg),
                "wavespeed": functools.partial(hk.wavespeed_plain, cfg)}
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def make_frame_fn(cfg, steps_per_frame: int, engine: str = "cuda"):
    """`frame_fn(state) -> (state, uint8 volume)`: steps -> schlieren ->
    on-device gamma-0.65 quantization."""
    hooks = _hooks(cfg, engine)

    def frame_fn(s):
        s2 = h3.run(cfg, s, steps_per_frame, **hooks)
        vol = h3.vis_field(cfg, s2, "schlieren")
        return s2, fourspl.quantize_frame_device(vol, gamma=0.65)

    return frame_fn


def _start(cfg, device, engine):
    """(cfg, initial state) of an export on `device` (None: the GPU)."""
    cfg = cfg or h3.default_config()
    if device is None:
        device = resolve_device("cuda")
    if engine == "cuda" and torch.device(device).type != "cuda":
        raise ValueError("engine 'cuda' runs the CUDA kernels and needs a "
                         "CUDA device; use engine 'torch' on the CPU")
    return cfg, h3.init(cfg, device)


def export_4spl(
    path,
    cfg: h3.Hypersonic3DConfig | None = None,
    frames: int = 60,
    steps_per_frame: int = 4,
    p_size: int = 256,
    device=None,
    engine: str = "cuda",
    verbose: bool = False,
) -> fourspl.Splat4DVideo:
    """Run the 3-D solver and export the schlieren volume video to `path`.
    `device=None` means the GPU.  Returns the video written."""
    cfg, state = _start(cfg, device, engine)
    frame_fn = make_frame_fn(cfg, steps_per_frame, engine)
    out = []
    stream_frames(frame_fn, state, frames, out, verbose=verbose)
    video = fourspl.Splat4DVideo(
        width=cfg.nx, height=cfg.ny, depth=cfg.nz, frames=frames,
        palette=fourspl.heat_palette(p_size), indices=np.stack(out),
        flags=fourspl.FLAG_F32_PRECISION,
    )
    fourspl.write_4spl(path, video)
    return video


def export_4spl_streamed(
    path,
    cfg: h3.Hypersonic3DConfig | None = None,
    frames: int = 60,
    steps_per_frame: int = 4,
    p_size: int = 256,
    device=None,
    engine: str = "cuda",
    verbose: bool = False,
    on_frame=None,
) -> None:
    """Run the 3-D solver and stream the schlieren video: each frame is
    appended to `path` (and published through the header's frame count)
    the moment it lands, so a polling viewer (viewer/index.html?live=1)
    shows the shock forming while the solver runs.  After the final frame
    the footer is written and the file is byte-identical to
    `export_4spl`'s.  `on_frame(i, total)` fires after frame i is on
    disk."""
    from ..io.live4spl import Stream4splWriter

    cfg, state = _start(cfg, device, engine)
    frame_fn = make_frame_fn(cfg, steps_per_frame, engine)
    with Stream4splWriter(path, cfg.nx, cfg.ny, cfg.nz,
                          fourspl.heat_palette(p_size)) as wtr:
        stream_frames(frame_fn, state, frames, wtr, verbose=verbose,
                      on_frame=on_frame)


def stream_frames(frame_fn, state, frames: int, wtr, verbose: bool = False,
                  on_frame=None, window: int = 4):
    """Drive `frame_fn(state) -> (state, uint8 volume)` for `frames`
    frames, appending each volume (numpy) to `wtr` (a list, or a stream
    writer with `append`).  Torch enqueues the device work asynchronously,
    so a `window`-deep queue of frames keeps the device busy while earlier
    frames are copied to the host.  Returns the final state."""
    pending = []

    def collect(f, qf):
        wtr.append(qf.cpu().numpy())
        if verbose:
            print(f"frame {f + 1}/{frames}")
        if on_frame is not None:
            on_frame(f, frames)

    for f in range(frames):
        state, qf = frame_fn(state)
        pending.append((f, qf))
        if len(pending) >= window:
            collect(*pending.pop(0))
    for f, qf in pending:
        collect(f, qf)
    return state
