"""The program's own spans in a profiled window: what each `fst.*` span of
`fluidsims_tpu_torch` (core/metrics.span) costs the host, how often and how
long the host waits for the device inside a step, which device operations
each span launched, and which span ends each idle stretch of the device.

The harness's trace (trace.py) keeps the device operations and the
benchmark's own spans.  The program's spans, the host's CUDA runtime calls
and the links between them are read here, in a profiled window of its own
that follows the cell's checks: the cell's program is built again, from a
seed of its own (`SEED`), runs one warm frame, one frame under the profiler
for its start-up and then `trace_frames` frames, as the harness's traced
window does.  The per-layer readers of metrics/ share one such window a
run (`of`).  A program without `core.metrics.span`, or a run off the card,
gives no window, and the readers report nothing.

A device operation is linked to the span that launched it through the
profiler's correlation id: the operation's id is that of the runtime call
that launched it (cudaLaunchKernel, cudaMemcpyAsync, ...), and the call
lies inside the spans open on the host at that moment, the innermost
last.  A kernel launched through a torch op is reached through the op.

The table by span and the idle stretches by span, for one cell:

    python3 -m portbench.spans --workload NAME [--seed N]
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import statistics
from collections import Counter
from dataclasses import dataclass, field

from . import trace as tracing

PREFIX = "fst."
STEP = PREFIX + "step"
RUN = PREFIX + "run"
OUTSIDE = "outside program"
SEED = 20_261_018
# runtime calls that return only once the device has drained
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"})


def is_sync(name: str) -> bool:
    """A synchronising runtime call: a stream, device or event sync, or a
    synchronous copy (cudaMemcpy* and cuMemcpy* without `Async`)."""
    if name in SYNC_CALLS:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name


def is_runtime(name: str) -> bool:
    return name.startswith("cu") and not name.startswith("cupti")


@dataclass
class Spans:
    """One profiled window, on the profiler's clock (us): the program's
    spans [(name, start, end)], the host's CUDA runtime calls [(name,
    start, end, id)], the device operations [(name, start, end, id)], the
    window (start, end) and the host's frames [(start, end)]."""

    spans: list
    calls: list
    device: list
    window: tuple
    frames: list = field(default_factory=list)

    def __post_init__(self):
        w0, w1 = self.window
        self.spans = sorted((s for s in self.spans if w0 <= s[1] < w1),
                            key=lambda s: (s[1], -s[2]))
        self.calls = sorted((c for c in self.calls if w0 <= c[1] < w1),
                            key=lambda c: c[1])
        self.device = [(n, max(s, w0), min(e, w1), i)
                       for n, s, e, i in self.device if e > w0 and s < w1]
        self.busy = tracing.union((n, s, e) for n, s, e, _ in self.device)
        # each call's open spans, outermost first, as indices into spans
        self.chain = _open_spans(self.spans, [c[1] for c in self.calls])
        by_id = {c[3]: k for k, c in enumerate(self.calls)}
        self.launch = [by_id.get(i) for _, _, _, i in self.device]

    @property
    def steps(self) -> int:
        return sum(1 for s in self.spans if s[0] == STEP)

    def _in(self, k: int, name: str) -> bool:
        """Call k lies inside a span called `name`."""
        return any(self.spans[j][0] == name for j in self.chain[k])

    def launcher(self, d: int) -> int | None:
        """The index of the innermost span open when device operation d
        was launched, or None."""
        k = self.launch[d]
        return self.chain[k][-1] if k is not None and self.chain[k] else None

    def _sync_calls(self, name: str = STEP) -> list:
        return [c for k, c in enumerate(self.calls)
                if is_sync(c[0]) and self._in(k, name)]

    def syncs_per_step(self) -> float | None:
        if not self.steps:
            return None
        return len(self._sync_calls()) / self.steps

    def sync_wait_ms_per_step(self) -> float | None:
        if not self.steps:
            return None
        return sum(e - s for _, s, e, _ in self._sync_calls()) \
            * 1e-3 / self.steps

    def dispatch_ms_per_step(self) -> float | None:
        """The host's time inside the step spans less its waits there."""
        if not self.steps:
            return None
        inside = sum(e - s for n, s, e in self.spans if n == STEP)
        waits = sum(e - s for _, s, e, _ in self._sync_calls())
        return (inside - waits) * 1e-3 / self.steps

    def device_ms_per_step(self, name: str) -> float | None:
        """Device time a step of the operations launched inside the spans
        called `name`."""
        if not self.steps:
            return None
        tot = sum(e - s for d, (_, s, e, _) in enumerate(self.device)
                  if self.launch[d] is not None
                  and self._in(self.launch[d], name))
        return tot * 1e-3 / self.steps

    def frame_gap_ms(self) -> float | None:
        """The mean over `fst.run` spans of the idle stretch that ends at
        the first device operation the span launched (0 where the device
        was still busy then)."""
        first: dict = {}
        for d, (_, s, _, _) in enumerate(self.device):
            k = self.launch[d]
            for j in (() if k is None else self.chain[k]):
                if self.spans[j][0] == RUN and s < first.get(j, s + 1):
                    first[j] = s
        gaps = [self._idle_before(t) for t in first.values()]
        return statistics.fmean(gaps) * 1e-3 if gaps else None

    def _idle_before(self, t: float) -> float:
        """The idle stretch of the window that ends at t (0 if busy)."""
        ends = [e for s, e in self.busy if s < t]
        if not ends:
            return t - self.window[0]
        return max(0.0, t - max(ends))

    def by_span(self) -> dict:
        """For each span name: calls, host ms, device ms of the operations
        launched inside it, and synchronising calls, each a step."""
        if not self.steps:
            return {}
        n = self.steps
        out = {}
        for name in sorted({s[0] for s in self.spans}):
            inst = [s for s in self.spans if s[0] == name]
            out[name] = {
                "calls": len(inst) / n,
                "host_ms": sum(e - s for _, s, e in inst) * 1e-3 / n,
                "device_ms": self.device_ms_per_step(name),
                "syncs": len(self._sync_calls(name)) / n}
        return out

    def idle_by_span(self) -> dict:
        """The window's idle seconds, summed by the innermost span that
        launched the operation ending each idle stretch."""
        out: dict = {}
        starts = sorted((s, d) for d, (_, s, _, _) in enumerate(self.device))
        keys = [s for s, _ in starts]
        t = self.window[0]
        for s, e in self.busy:
            if s > t:
                d = starts[bisect.bisect_left(keys, s)][1]
                j = self.launcher(d)
                name = OUTSIDE if j is None else self.spans[j][0]
                out[name] = out.get(name, 0.0) + (s - t) * 1e-6
            t = max(t, e)
        return out

    def frame_ms(self) -> list:
        return [(e - s) * 1e-3 for s, e in self.frames]


def _open_spans(spans: list, times: list) -> list:
    """For each time (sorted), the indices of the spans (sorted by start,
    properly nested) open at it, outermost first."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out.append(tuple(stack))
    return out


def from_events(events) -> Spans:
    """Reduce torch.profiler's events of a window that the benchmark's
    `portbench.window` span brackets."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, calls, device, window, frames = [], [], [], [], {}
    for e in events:
        n, s, t = e.name, e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not n.startswith((PREFIX, tracing.SPAN_PREFIX)):
                device.append((n, s, t, e.id))
        elif n.startswith(PREFIX):
            spans.append((n, s, t))
        elif n == tracing.SPAN_PREFIX + "window":
            window.append((s, t))
        elif n in (tracing.SPAN_PREFIX + "enqueue",
                   tracing.SPAN_PREFIX + "readback"):
            frames.setdefault(n, []).append((s, t))
        elif is_runtime(n):
            calls.append((n, s, t, e.id))
    if len(window) != 1:
        raise RuntimeError(f"expected one traced window, found {len(window)}")
    enq = sorted(frames.get(tracing.SPAN_PREFIX + "enqueue", []))
    rb = sorted(frames.get(tracing.SPAN_PREFIX + "readback", []))
    return Spans(spans=spans, calls=calls, device=device, window=window[0],
                 frames=[(a[0], b[1]) for a, b in zip(enq, rb)])


def has_spans() -> bool:
    """The program under test records spans (core/metrics.span)."""
    return hasattr(importlib.import_module("fluidsims_tpu_torch.core.metrics"),
                   "span")


def measure(cell, device: str = "cuda", seed: int = SEED) -> Spans | None:
    """The profiled window of `window`, or None where the program records
    no spans or the window holds no step."""
    if not has_spans():
        return None
    sp = window(cell, device, seed)
    return sp if sp.steps else None


def window(cell, device: str = "cuda", seed: int = SEED) -> Spans:
    """The cell's program, built again from `seed`, one warm frame, then
    the traffic's `trace_frames` frames under torch.profiler."""
    import torch

    from . import harness

    dev = torch.device(device)
    ref = cell.reference.Reference(cell.cfg, cell.traffic, dev)
    prog = cell.adapter.Program(cell.cfg, cell.traffic, dev, ref)
    drv = harness.Driver(prog, prog.init(harness.make_noise(seed, ref, dev)),
                         int(cell.traffic["steps_per_frame"]))
    drv.frame()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        drv.frames(1)
        drv.frames(int(cell.traffic["trace_frames"]), annotate=True)
    return from_events(prof.events())


_LAST: dict = {}


def of(ctx) -> Spans | None:
    """The run's profiled window of program spans, made once for the
    readers of one run (`ctx`); None off the card."""
    if not ctx.gpu:
        return None
    if _LAST.get("ctx") is not ctx:
        _LAST.clear()
        _LAST.update(ctx=ctx, spans=measure(ctx.cell))
    return _LAST["spans"]


def main(argv=None) -> int:
    from . import harness

    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    sp = window(harness.Cell(harness.ROOT, args.workload), seed=args.seed)
    print(json.dumps({
        "workload": args.workload, "steps": sp.steps,
        "frame_ms_median": statistics.median(sp.frame_ms()),
        "host_syncs_per_step": sp.syncs_per_step(),
        "sync_wait_ms_per_step": sp.sync_wait_ms_per_step(),
        "dispatch_ms_per_step": sp.dispatch_ms_per_step(),
        "frame_gap_ms": sp.frame_gap_ms(),
        "program_spans": sp.by_span(), "idle_by_span": sp.idle_by_span(),
        "syncs_by_call": Counter(c[0] for c in sp._sync_calls())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
