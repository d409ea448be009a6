"""The traced window: torch.profiler over a fixed number of frames, reduced
to device intervals, the benchmark's own host spans and the numbers the
per-layer readers and the breakdown take from them.

Host spans are `torch.profiler.record_function` ranges the loop opens
around its calls into the program: `portbench.window` around the traced
frames, `portbench.enqueue` around each frame's `run` call and
`portbench.readback` around the read of the clock to the host."""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    """Device operations [(name, start_us, end_us)] inside the traced
    window, the host spans [(name, start_us, end_us)], the window
    (start_us, end_us), the steps it holds and the port's launches its
    counters saw."""

    device: list
    host: list
    window: tuple
    steps: int
    port_launches: int
    busy: list = field(init=False)

    def __post_init__(self):
        w0, w1 = self.window
        self.device = [(n, max(s, w0), min(e, w1)) for n, s, e in self.device
                       if e > w0 and s < w1]
        self.busy = union(self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def matching(self, fragment: str) -> list:
        return [(n, s, e) for n, s, e in self.device if fragment in n]

    def others(self, fragments) -> list:
        return [(n, s, e) for n, s, e in self.device
                if not any(f in n for f in fragments)]

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the k device operations that took most time."""
        tot: dict = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return [[n[:160], v] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[host span, seconds] of the k longest stretches of the window in
        which no device operation ran, each named by the benchmark's span
        (enqueue, readback) that covers most of it."""
        gaps, t = [], self.window[0]
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        spans = [(n, s, e) for n, s, e in self.host
                 if n != SPAN_PREFIX + "window"]

        def host_in(g0, g1):
            cover: dict = {}
            for n, s, e in spans:
                if min(e, g1) > max(s, g0):
                    cover[n] = cover.get(n, 0.0) + min(e, g1) - max(s, g0)
            if not cover:
                return "outside spans"
            return max(cover, key=cover.get)[len(SPAN_PREFIX):]

        gaps.sort(key=lambda g: g[0] - g[1])
        return [[host_in(s, e), (e - s) * 1e-6] for s, e in gaps[:k]]


def union(intervals) -> list:
    """The union of [(name, start, end)] as sorted disjoint (start, end)."""
    out: list = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profile(frames, n_frames: int, steps_per_frame: int, launches) -> Trace:
    """Run one frame, then the window `frames(n_frames, annotate=True)`,
    under torch.profiler and reduce what the window recorded.
    `launches()` reads the port's launch counters."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler's own start-up slows the first frame's enqueue: one
        # frame before the window takes it
        frames(1)
        before = launches()
        frames(n_frames, annotate=True)
        port = launches() - before
    device, host = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith(SPAN_PREFIX):
            # a span is also drawn on the device's timeline: no operation
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(rng)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(rng)
    window = [(s, e) for n, s, e in host if n == SPAN_PREFIX + "window"]
    if len(window) != 1:
        raise RuntimeError(f"expected one traced window, found {len(window)}")
    return Trace(device=device, host=host, window=window[0],
                 steps=n_frames * steps_per_frame, port_launches=port)
