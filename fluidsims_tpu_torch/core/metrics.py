"""Tracing / profiling / observability utilities (port of
fluidsims_tpu.core.metrics).

Mirrors the reference's measurement machinery (SURVEY.md §5): wall + device
timing brackets (the cudaEvent pairs of js_cuda.cu:404-437 become
`torch.cuda.synchronize` brackets), domain throughput metrics (steps/sec,
MLUPS = cells*steps/1e6/s, particle-steps/sec), EMA-smoothed FPS counters
(0.95/0.05, tau_shallow_water.cu:729-731), and torch.profiler trace capture
for the Nsight `-lineinfo` role.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .stepper import sync

__all__ = ["EMA", "Throughput", "device_timer", "trace"]


@dataclass
class EMA:
    """Exponential moving average, reference smoothing 0.95/0.05."""

    alpha: float = 0.05
    value: float = 0.0
    initialized: bool = False

    def update(self, x: float) -> float:
        if not self.initialized:
            self.value = x
            self.initialized = True
        else:
            self.value = (1.0 - self.alpha) * self.value + self.alpha * x
        return self.value


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
