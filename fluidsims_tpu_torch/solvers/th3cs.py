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

`Exporter` drives the frames one at a time (`push`): a window of frames
stays in flight on the device while the oldest crosses to the host and is
written.  `export_4spl` collects the frames into a list and writes the
file at the end through the Python writer of io/fourspl.py, which zlib's
CRC-32 makes faster than the native writer of io/fourspl_native.py (a
byte-table CRC-32 loop, kept for the C API; both give the same bytes;
PERF.md §6).  `export_4spl_streamed` appends each frame as it lands
(io/live4spl.py), so a polling viewer shows the run live, and ends with the
same bytes.

Spans (core/metrics.span): `fst.th3cs.vis` (the schlieren) and
`fst.th3cs.quantize` around a frame's device work after its steps;
`fst.th3cs.collect` (the volume's copy to the host and its wait) and
`fst.th3cs.write` (the writer's CRC, write and header patch) around each
frame's export; `fst.th3cs.write` also holds the opening of a streamed
video (its header and palette) and its footer.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.metrics import span
from ..io import fourspl
from . import hypersonic3d as h3

__all__ = ["ENGINES", "GAMMA", "Exporter", "schlieren_frame", "make_frame_fn",
           "video_exporter", "export_4spl", "export_4spl_streamed",
           "stream_frames"]

ENGINES = ("cuda", "torch")
GAMMA = 0.65    # th3cs.cu:1199-1222


def _hooks(cfg, engine: str) -> dict:
    """step() hooks for the engine: {} keeps step()'s defaults, the CUDA
    kernels."""
    from ..kernels import hypersonic3d_cuda as hk

    if engine == "cuda":
        return {}
    if engine == "torch":
        return {"core": functools.partial(hk.step_core_plain, cfg),
                "wavespeed": functools.partial(hk.wavespeed_plain, cfg),
                "pad": functools.partial(hk.pad_plain, cfg)}
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def schlieren_frame(cfg, s) -> torch.Tensor:
    """The state's frame on its device: the schlieren |grad rho|
    (k_schlieren_export, :641-673), then the gamma-0.65 8-bit
    quantization; a uint8 (nz, ny, nx) volume."""
    with span("fst.th3cs.vis"):
        vol = h3.vis_field(cfg, s, "schlieren")
    with span("fst.th3cs.quantize"):
        return fourspl.quantize_frame_device(vol, gamma=GAMMA)


def make_frame_fn(cfg, steps_per_frame: int, engine: str = "cuda"):
    """`frame_fn(state) -> (state, uint8 volume)`: steps -> schlieren ->
    on-device gamma-0.65 quantization."""
    hooks = _hooks(cfg, engine)

    def frame_fn(s):
        s2 = h3.run(cfg, s, steps_per_frame, **hooks)
        return s2, schlieren_frame(cfg, s2)

    return frame_fn


class Exporter:
    """An export driven one frame at a time.

    `push(state)` enqueues `frame_fn(state) -> (state, uint8 volume)` and
    returns the new state; once `window` frames are in flight the oldest
    is collected: its volume copied to the host, appended to `video` (a
    list, or a stream writer with `append` and `finish`) and reported to
    `on_frame(i)` (i counts the frames pushed).  Torch enqueues the device
    work asynchronously, so the window keeps frames queued on the device
    while earlier ones are copied to the host.  `flush()` collects every
    frame in flight; `close()` flushes and finishes the video.  As a
    context manager it closes on exit; on an exception it finishes the
    video and drops the frames in flight."""

    def __init__(self, frame_fn, video, window: int = 4, on_frame=None):
        if window < 1:
            raise ValueError(f"window must be at least 1, got {window}")
        self.frame_fn, self.video = frame_fn, video
        self.window, self.on_frame = window, on_frame
        self.pushed = 0
        self._pending = collections.deque()

    def push(self, state):
        state, vol = self.frame_fn(state)
        self._pending.append((self.pushed, vol))
        self.pushed += 1
        if len(self._pending) >= self.window:
            self._collect(*self._pending.popleft())
        return state

    def _collect(self, i: int, vol) -> None:
        with span("fst.th3cs.collect"):
            host = vol.cpu().numpy()
        with span("fst.th3cs.write"):
            self.video.append(host)
        if self.on_frame is not None:
            self.on_frame(i)

    def _finish(self) -> None:
        finish = getattr(self.video, "finish", None)
        if finish is not None:
            with span("fst.th3cs.write"):
                finish()

    def flush(self) -> None:
        while self._pending:
            self._collect(*self._pending.popleft())

    def close(self) -> None:
        self.flush()
        self._finish()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._finish()
        return False


def video_exporter(path, cfg, steps_per_frame: int = 4, p_size: int = 256,
                   engine: str = "cuda", window: int = 4,
                   on_frame=None) -> Exporter:
    """th3cs's streamed export of `cfg`'s run to the `.4spl` at `path`:
    each frame appended as it lands (io/live4spl.py), flags 0x0004, the
    heat palette of `p_size` entries; `close()` writes the footer."""
    from ..io.live4spl import Stream4splWriter

    with span("fst.th3cs.write"):
        wtr = Stream4splWriter(path, cfg.nx, cfg.ny, cfg.nz,
                               fourspl.heat_palette(p_size))
    return Exporter(make_frame_fn(cfg, steps_per_frame, engine), wtr,
                    window=window, on_frame=on_frame)


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
    cfg, state = _start(cfg, device, engine)
    with video_exporter(path, cfg, steps_per_frame, p_size, engine,
                        on_frame=_reporter(frames, verbose, on_frame)) as ex:
        for _ in range(frames):
            state = ex.push(state)


def _reporter(frames: int, verbose: bool, on_frame):
    """An `Exporter`'s `on_frame(i)` from an export's `verbose` and its
    caller's `on_frame(i, total)`."""
    def done(i):
        if verbose:
            print(f"frame {i + 1}/{frames}")
        if on_frame is not None:
            on_frame(i, frames)

    return done


def stream_frames(frame_fn, state, frames: int, wtr, verbose: bool = False,
                  on_frame=None, window: int = 4):
    """Drive `frame_fn(state) -> (state, uint8 volume)` for `frames`
    frames through an `Exporter` with a `window`-deep queue, appending each
    volume (numpy) to `wtr` (a list, or a stream writer with `append`),
    which stays open.  Returns the final state."""
    ex = Exporter(frame_fn, wtr, window=window,
                  on_frame=_reporter(frames, verbose, on_frame))
    for _ in range(frames):
        state = ex.push(state)
    ex.flush()
    return state
