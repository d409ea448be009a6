"""Tracing / profiling / observability utilities (port of
fluidsims_tpu.core.metrics).

Mirrors the reference's measurement machinery (SURVEY.md §5): wall + device
timing brackets (the cudaEvent pairs of js_cuda.cu:404-437 become
`torch.cuda.synchronize` brackets), domain throughput metrics (steps/sec,
MLUPS = cells*steps/1e6/s, particle-steps/sec), torch.profiler trace capture
for the Nsight `-lineinfo` role, and the program's named spans inside such a
capture (`span`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

__all__ = ["Throughput", "device_timer", "trace", "span"]


@dataclass
class Throughput:
    """steps/sec + cells/sec (MLUPS) + particle-steps/sec reporter."""

    cells: int | None = None
    particles: int | None = None
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0

    def tick(self, n_steps: int = 1):
        self._steps += n_steps

    def report(self) -> dict:
        wall = time.perf_counter() - self._t0
        out = {"steps": self._steps, "wall_s": wall,
               "steps_per_sec": self._steps / wall if wall > 0 else 0.0}
        if self.cells:
            out["mlups"] = self.cells * self._steps / wall / 1e6
        if self.particles:
            out["particle_steps_per_sec"] = (
                self.particles * self._steps / wall
            )
        return out


@contextlib.contextmanager
def device_timer(result_holder: dict, key: str = "wall_s", device=None):
    """Time a region into `result_holder[key]` (seconds).  On a CUDA
    device the region is bracketed by `torch.cuda.synchronize` on both
    sides, so it measures the device's work, not the enqueue; on the CPU
    it is the host's time.  `device=None` means the current CUDA device
    where there is one, else the CPU."""
    from .stepper import sync  # stepper imports `span` from here

    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    result_holder[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler capture of the region (the host, and the card where
    there is one), exported on exit as a Chrome trace `trace.json` in
    `log_dir` (open with Perfetto or chrome://tracing).  `log_dir=None`
    means `build/fluidsims_tpu_torch/trace` beside the package.  Yields
    the directory."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        from ..kernels._build import build_dir

        log_dir = build_dir() / "trace"
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / "trace.json"))


_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A named range of the program (`fst.` and its layer, e.g. `fst.step`)
    in whatever torch.profiler records: `trace()`, the profile tools or a
    caller's own window.  While a profiler records it is a range on the
    profiler's clock, nested in the ranges open around it, and every
    runtime call made inside it (a kernel's launch, a copy, a sync) lies
    inside it; otherwise it is one shared no-op context, after a single
    check.

    The range has a function's scope (`_RecordFunctionFast`), not the user
    scope of `torch.profiler.record_function`: a user-scope range is also
    drawn on the device's timeline, as an event over the kernels it
    launched, which a reader of the device's operations would count as
    one."""
    if not _profiling():
        return _NO_SPAN
    return _range(name)
