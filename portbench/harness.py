"""The benchmark's run: one cell, one seed, one measured window.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name (portbench/README.md):
BENCHMARK.json names the cell's configuration and traffic; the
configuration has a file of its constants (configs/<config>.json), the
program's side (adapters/<config>.py) and a plain reference
(reference/<config>.py); the traffic is a file of parameters
(traffic/<traffic>.json); the cell's limits are cells/<workload>.json; each
metric is read by metrics/<metric>.py, and each kernel's operations and
bytes are counted by counts/<kernel>.py.

A run: set-up (the program's init from the seed's perturbation, one warm
frame, buffers), then frames for `--seconds`: a frame is the traffic's
`steps_per_frame` steps through the program's public `run`, then one read
of the simulated clock to the host, its only sync.  Two frames drawn from
the seed have their state copied before and after.  With `--trace 1` a
profiled window of `trace_frames` frames follows.  After the windows the
reference checks the initial state, the warm frame from its own initial
state, and each copied frame from the program's state before it.  The
memory peak is the program's: the initial and warm states are copied to
the host, and the device copies of the checked frames are left out of it.
The last line of standard output is the result's JSON object."""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import compare, peaks
from . import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidsims_tpu")
# the precision just below each stated one: the control's, where the
# reference names none of its own (`control_dtype`)
LOWER = {"float64": "float32", "float32": "bfloat16"}


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


@functools.lru_cache(maxsize=None)
def load_module(path: Path):
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with every file it names."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_name = self.entry["config"]
        self.cfg = read_json(self.root / confs[self.config_name]["file"])
        pb = self.pb = self.root / "portbench"
        self.traffic = read_json(pb / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = read_json(pb / "cells" / f"{workload}.json")["limits"]
        self.adapter = load_module(pb / "adapters" / f"{self.config_name}.py")
        self.reference = load_module(pb / "reference"
                                     / f"{self.config_name}.py")

    def metrics(self, kind: str) -> list:
        """The entries of `kind` ("end_to_end" or "per_layer") this cell
        reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.pb / "metrics" / f"{metric}.py")

    def counts(self, kernel: str):
        return load_module(self.pb / "counts" / f"{kernel}.py")


@dataclass
class Window:
    """What the timed window saw, on the host clock."""

    frames: list       # seconds of each frame, enqueue to readback
    enqueue: list      # seconds of each frame's `run` call
    steps: int
    seconds: float     # the whole window, bracketed by syncs
    failed: int        # frames whose clock came back non-finite or stalled


@dataclass
class Context:
    """What a metric's reader (metrics/<name>.py, `read(ctx)`) gets."""

    window: Window
    trace: tracing.Trace | None
    setup_s: float
    work: dict         # the reference's units of work (Reference.work)
    kernels: dict      # kernel name in counts/ -> fragment of its trace name
    cell: Cell
    gpu: bool          # False for a run on the CPU: no device share then

    def roofline(self, kernel: str) -> float | None:
        """The kernel's least time (counts/<kernel>.py against peaks.py)
        over the mean device time of its launches in the trace, in %."""
        if self.trace is None or kernel not in self.kernels:
            return None
        ev = self.trace.matching(self.kernels[kernel])
        if not ev:
            return None
        mean_s = sum(e - s for _, s, e in ev) * 1e-6 / len(ev)
        c = self.cell.counts(kernel)
        least = peaks.least_seconds(c.ops(self.work), c.nbytes(self.work),
                                    self.work["dtype"])
        return least / mean_s * 100.0

    def device_others(self) -> list | None:
        """The traced device operations that are none of the port's
        kernels, or None where the trace holds no device operation."""
        if self.trace is None or not self.trace.device:
            return None
        return self.trace.others(self.kernels.values())


def make_noise(seed: int, ref, device) -> list:
    """The seeded perturbation's standard normal fields, as many and of the
    shape the reference asks for, made on the device in one call each."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(ref.noise_shape, generator=g, device=device,
                        dtype=torch.float32)
            for _ in range(ref.noise_fields)]


def control_dtype(ref, dtype_name: str):
    """The control's precision: the reference's own choice, else the one
    just below the stated precision."""
    import torch

    own = getattr(ref, "control_dtype", None)
    return own if own is not None else getattr(torch, LOWER[dtype_name])


def to_host(fields: dict) -> dict:
    return {k: v.to("cpu", copy=True) for k, v in fields.items()}


def to_dev(dev, fields: dict) -> dict:
    return {k: v.to(dev) for k, v in fields.items()}


def snapshot_times(seed: int, seconds: float, k: int) -> list:
    """When in the window (seconds from its start) each of the k checked
    frames is due: one in each k-th of 5%-95% of the window."""
    rng = random.Random(seed)
    width = 0.9 / k
    return [seconds * (0.05 + width * (i + rng.random())) for i in range(k)]


class Driver:
    """Frames of the program: `steps_per_frame` steps through its `run`,
    then the clock to the host."""

    def __init__(self, prog, state, spf: int):
        import torch

        self.torch = torch
        self.prog, self.state, self.spf = prog, state, spf

    def _span(self, name: str, on: bool):
        if not on:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(tracing.SPAN_PREFIX + name)

    def frame(self, annotate: bool = False):
        t0 = time.perf_counter()
        with self._span("enqueue", annotate):
            self.state = self.prog.run(self.state, self.spf)
        t1 = time.perf_counter()
        with self._span("readback", annotate):
            clock = self.torch.stack(
                self.prog.clock(self.state)).cpu().tolist()
        return t1 - t0, time.perf_counter() - t1, clock

    def frames(self, n: int, annotate: bool = False) -> None:
        with self._span("window", annotate):
            for _ in range(n):
                self.frame(annotate)

    def copy_into(self, buf: dict) -> None:
        for k, v in self.prog.fields(self.state).items():
            buf[k].copy_(v)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(drv: Driver, seconds: float, snap_at: list, bufs: list,
                 clock0: list, device) -> Window:
    """Frames until `seconds` have passed and every checked frame is
    copied; each checked frame's state is copied before and after it."""
    frames, enqueue, failed = [], [], 0
    last, taken, pending = clock0, 0, None
    sync(device)
    t0 = time.perf_counter()
    while True:
        e, r, clock = drv.frame()
        frames.append(e + r)
        enqueue.append(e)
        if not all(math.isfinite(x) for x in clock) or clock[0] <= last[0]:
            failed += 1
        last = clock
        if pending is not None:
            drv.copy_into(bufs[pending][1])
            pending = None
        now = time.perf_counter() - t0
        if now >= seconds and taken == len(snap_at):
            break
        if taken < len(snap_at) and now >= snap_at[taken]:
            drv.copy_into(bufs[taken][0])
            pending, taken = taken, taken + 1
    sync(device)
    return Window(frames=frames, enqueue=enqueue,
                  steps=len(frames) * drv.spf,
                  seconds=time.perf_counter() - t0, failed=failed)


def checks(cell: Cell, ref, prog, noise, init_snap, warm_snap, bufs,
           control: bool) -> tuple[dict, dict | None]:
    """The numbers that decide `correct` ({init_err, frame_err,
    time_err}), and with `control` the same numbers of the control: the
    program's lower-precision path where it has one, else the reference in
    the precision below the stated one, in the program's place."""
    import torch

    mod = cell.reference
    dtype_name = cell.traffic["dtype"]
    dtype = getattr(torch, dtype_name)
    spf = int(cell.traffic["steps_per_frame"])
    lower = control_dtype(ref, dtype_name) if control else None

    def errs(pairs):
        return (max(compare.field_err(p, r, mod.FIELDS, ref.scales)
                    for p, r in pairs),
                max(compare.clock_err(p, r, mod.CLOCK) for p, r in pairs))

    def ctl_frame(state):
        out = prog.control_frame(state, spf)
        return ref.frame(state, spf, lower) if out is None else out

    ref_init = ref.init(dtype, noise)
    starts = [ref_init] + [pre for pre, _ in bufs]
    progs = [warm_snap] + [post for _, post in bufs]
    got, ctl = [], []
    for start, out in zip(starts, progs):
        r = ref.frame(start, spf, dtype)
        got.append((out, r))
        if control:
            ctl.append((ctl_frame(start), r))
    f_err, t_err = errs(got)
    numbers = {"init_err": max(errs([(init_snap, ref_init)])),
               "frame_err": f_err, "time_err": t_err}
    if not control:
        return numbers, None
    cf, ct = errs(ctl)
    return numbers, {"init_err": max(errs([(ref.init(lower, noise),
                                            ref_init)])),
                     "frame_err": cf, "time_err": ct}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def cache_dirs(root: Path) -> None:
    """Every cache the run might fill at a fixed place in the checkout.  The
    port builds its kernels into build/fluidsims_tpu_torch itself."""
    base = Path(root) / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute_cache")


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: Path = ROOT, device: str = "cuda", t_start: float | None = None,
        control: bool = False) -> dict:
    """One run of the cell; returns the result (plus `control` readings
    when asked).  `device="cpu"` skips the look for a card (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cache_dirs(root)
    import torch

    cell = Cell(root, workload)
    chips = int(cell.entry["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {chips}")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    torch.set_num_threads(1)
    traffic = cell.traffic
    spf = int(traffic["steps_per_frame"])
    n_checked = int(traffic["check_frames"])

    # ---- set-up: the inputs, the program's state, one warm frame ----
    ref = cell.reference.Reference(cell.cfg, traffic, dev)
    noise = make_noise(seed, ref, dev)
    prog = cell.adapter.Program(cell.cfg, traffic, dev, ref)
    drv = Driver(prog, prog.init(noise), spf)
    del noise   # made again from the seed for the checks
    init_snap = to_host(prog.fields(drv.state))
    _, _, clock0 = drv.frame()
    warm_snap = to_host(prog.fields(drv.state))
    # the checked frames' copies stay on the device through the window (a
    # copy to the host there would stall it): their bytes are left out of
    # the program's peak
    cuda = dev.type == "cuda"
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    bufs = [tuple({k: torch.empty_like(v, device=dev)
                   for k, v in warm_snap.items()}
                  for _ in range(2)) for _ in range(n_checked)]
    sync(dev)
    if cuda:
        held = torch.cuda.memory_allocated(dev) - held
        peak_before = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    # ---- the measured window, then the traced one ----
    win = timed_window(drv, seconds, snapshot_times(seed, seconds, n_checked),
                       bufs, clock0, dev)
    tr = None
    if trace:
        tr = tracing.profile(drv.frames, int(traffic["trace_frames"]), spf,
                             prog.launches)
    peak = max(peak_before, torch.cuda.max_memory_allocated(dev) - held) \
        if cuda else 0

    # ---- the program's state freed, the reference checks ----
    drv.state = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    on_dev = functools.partial(to_dev, dev)
    numbers, ctl = checks(cell, ref, prog, make_noise(seed, ref, dev),
                          on_dev(init_snap), on_dev(warm_snap), bufs, control)
    ok = win.failed == 0 and set(numbers) == set(cell.limits) and all(
        numbers[n] <= cell.limits[n] for n in numbers)

    ctx = Context(window=win, trace=tr, setup_s=setup_s, work=ref.work(),
                  kernels=dict(cell.adapter.KERNELS), cell=cell, gpu=cuda)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cuda:
        dinfo = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": chips, "memory_peak_bytes": peak,
                 "power_limit": _power_limit()}
    else:
        dinfo = {"platform": dev.type, "kind": dev.type, "count": 1,
                 "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(win.frames),
              "failed": win.failed, "metrics": metrics, "device": dinfo}
    if tr is not None:
        dinfo["busy_s"] = tr.busy_s
        dinfo["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if ctl is not None:
        result["control"] = ctl
    result["check"] = {n: {"value": v, "limit": cell.limits.get(n)}
                       for n, v in numbers.items()}
    return result


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not have loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     t_start=t_start)
    except NoDevice as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: no result: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
