"""Step drivers: the multi-step loop, the frame loop and the headless
benchmark.

Port of fluidsims_tpu.core.stepper.  JAX compiles a batch of steps into one
`lax.scan`; PyTorch runs eagerly, so the loop is a Python loop that only
enqueues device work.  The loop itself reads nothing back to the host (no
`.item()`, `float()` or sync), and dt lives on the device from the
wavespeed reduction to the update (see core/clock.py).  The hypersonic
steps copy nothing from the host either: the 3-D step's prologue kernel
takes its inflow state as a launch argument.  Capturing the loop in a
CUDA graph, the GPU analog of the compiled scan, is later work.

Under a profiler `run_steps` records the spans `fst.run` around the loop
and `fst.step` around each call of the step function (core/metrics.span).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from .metrics import span

__all__ = ["run_steps", "run_split", "frame_loop", "device_of", "sync",
           "benchmark"]


def run_steps(step_fn: Callable[[Any], Any], state: Any, n_steps: int):
    """Apply `step_fn(state) -> state` `n_steps` times."""
    with span("fst.run"):
        for _ in range(n_steps):
            with span("fst.step"):
                state = step_fn(state)
    return state


def run_split(block_fn: Callable[[Any], Any], step_fn: Callable[[Any], Any],
              k: int, state: Any, n_steps: int):
    """`n_steps` steps as `n_steps // k` calls of `block_fn` (k steps each)
    then `n_steps % k` calls of `step_fn` (one step each); with k = 1,
    `step_fn` every step.  The split of the K-step engines (JAX's
    run_multistep, with one-step calls for the remainder)."""
    n_blocks, rem = divmod(n_steps, k) if k > 1 else (0, n_steps)
    return run_steps(step_fn, run_steps(block_fn, state, n_blocks), rem)


def frame_loop(
    step_fn: Callable[[Any], Any],
    state: Any,
    n_frames: int,
    steps_per_frame: int,
    on_frame: Callable[[int, Any], None] | None = None,
):
    """Host-side frame loop: `steps_per_frame` steps, then
    `on_frame(f, state)`, `n_frames` times; returns the final state.

    The counterpart of the reference's render loop.  The loop itself never
    syncs the host: what `on_frame` reads back (a frame, a checkpoint) is
    the frame's only device-to-host traffic."""
    for f in range(n_frames):
        state = run_steps(step_fn, state, steps_per_frame)
        if on_frame is not None:
            on_frame(f, state)
    return state


def device_of(state: Any) -> torch.device:
    """The device of the first tensor found in a (nested) tuple state."""
    stack = [state]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (tuple, list)):
            stack.extend(x)
    raise TypeError("state holds no tensor")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(
    step_fn: Callable[[Any], Any] | None,
    state: Any,
    steps: int,
    warmup_steps: int = 10,
    cells: int | None = None,
    run_fn: Callable[[Any, int], Any] | None = None,
) -> dict:
    """Headless benchmark: run `steps` steps, report wall-clock rates.

    Mirrors the reference's --headless benches (js_cuda.cu:401-441): the
    warm-up (kernel build, first launches) is excluded, and the timed
    window is bracketed by device synchronisation so it measures the
    device's work, not the enqueue.  Returns the keys of the JAX twin.
    `run_fn(state, n) -> state`, where given, runs the n steps in one call
    in place of n calls of `step_fn` (engines that fuse steps, such as the
    K-step kernels).  Warm-up and timed run both start from `state`.
    """
    if run_fn is None:
        def run_fn(st, n):
            return run_steps(step_fn, st, n)
    device = device_of(state)
    warm = run_fn(state, max(1, warmup_steps))
    sync(device)
    del warm

    t0 = time.perf_counter()
    out = run_fn(state, steps)
    sync(device)
    dt = time.perf_counter() - t0
    del out

    result = {
        "steps": steps,
        "wall_s": dt,
        "steps_per_sec": steps / dt,
    }
    if cells is not None:
        result["cells"] = cells
        result["mcells_per_sec"] = cells * steps / dt / 1e6
    return result
