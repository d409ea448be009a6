"""The program-span readers (portbench/spans.py, metrics/ of the program's
spans): syncs, waits, dispatch, frame gaps and a span's device time on a
synthetic window; the window's plumbing on the CPU; on the card, each
kernel linked to the span that launched it, and the harness's own trace
untouched by the program's spans."""

from __future__ import annotations

from collections import Counter

import pytest

from portbench import harness, spans
from portbench import trace as tracing

READERS = ("host_syncs_per_step", "sync_wait_ms_per_step",
           "dispatch_ms_per_step", "frame_gap_ms", "h3d_pad_ms_per_step")


def _window():
    # two frames in a window of 1000 us; one step span starts before the
    # window (the warm frame's) and is left out: 3 steps
    sp = [("fst.step", -50.0, -10.0),
          ("fst.run", 100.0, 500.0),
          ("fst.step", 110.0, 300.0), ("fst.h3d.pad", 120.0, 200.0),
          ("fst.h3d.update", 210.0, 290.0),
          ("fst.step", 310.0, 490.0), ("fst.h3d.pad", 320.0, 400.0),
          ("fst.h3d.update", 410.0, 480.0),
          ("fst.run", 600.0, 900.0),
          ("fst.step", 610.0, 890.0), ("fst.h3d.pad", 620.0, 700.0),
          ("fst.h3d.update", 710.0, 880.0)]
    calls = [("cudaLaunchKernel", 130.0, 135.0, 1),
             ("cudaStreamSynchronize", 150.0, 170.0, 90),
             ("cudaLaunchKernel", 220.0, 225.0, 2),
             ("cudaLaunchKernel", 330.0, 335.0, 3),
             ("cudaMemcpy", 350.0, 360.0, 91),
             ("cudaMemcpyAsync", 362.0, 364.0, 92),
             ("cudaLaunchKernel", 420.0, 425.0, 4),
             ("cudaMemcpyAsync", 550.0, 552.0, 5),
             ("cudaStreamSynchronize", 552.0, 570.0, 93),
             ("cudaLaunchKernel", 630.0, 631.0, 6),
             ("cudaLaunchKernel", 720.0, 722.0, 7)]
    device = [("CatArrayBatchedCopy", 140.0, 180.0, 1),
              ("step3_kernel", 230.0, 330.0, 2),
              ("CatArrayBatchedCopy", 340.0, 380.0, 3),
              ("step3_kernel", 430.0, 530.0, 4),
              ("Memcpy DtoH", 555.0, 560.0, 5),
              ("CatArrayBatchedCopy", 650.0, 690.0, 6),
              ("step3_kernel", 725.0, 800.0, 7),
              ("late_kernel", 950.0, 990.0, 99)]
    return spans.Spans(spans=sp, calls=calls, device=device,
                       window=(0.0, 1000.0),
                       frames=[(100.0, 570.0), (600.0, 990.0)])


def _ctx(workload="h3d-sphere-f32-256", gpu=True):
    cell = harness.Cell(harness.ROOT, workload)
    win = harness.Window(frames=[0.1], enqueue=[0.05], steps=3, seconds=0.1,
                         failed=0)
    return harness.Context(window=win, trace=None, setup_s=1.0, work={},
                           kernels=dict(cell.adapter.KERNELS), cell=cell,
                           gpu=gpu)


def _read(ctx, name):
    return ctx.cell.reader(name).read(ctx)


@pytest.fixture
def synthetic(monkeypatch):
    made = []

    def measure(cell):
        made.append(cell.name)
        return _window()

    monkeypatch.setattr(spans, "measure", measure)
    return made


def test_the_readers_on_a_synthetic_window(synthetic):
    ctx = _ctx()
    # syncs inside steps: a stream sync (20 us) and a synchronous copy
    # (10 us); the readback's sync lies outside every step
    assert _read(ctx, "host_syncs_per_step") == pytest.approx(2 / 3)
    assert _read(ctx, "sync_wait_ms_per_step") == pytest.approx(0.030 / 3)
    # the steps' host time (190 + 180 + 280 us) less the waits
    assert _read(ctx, "dispatch_ms_per_step") == pytest.approx(0.620 / 3)
    # frame 1's first launch at 140 after an idle window start; frame 2's
    # at 650, idle since the readback's copy ended at 560
    assert _read(ctx, "frame_gap_ms") == pytest.approx((0.140 + 0.090) / 2)
    assert _read(ctx, "h3d_pad_ms_per_step") == pytest.approx(0.120 / 3)
    # one profiled window for all the readers of a run
    assert synthetic == ["h3d-sphere-f32-256"]


def test_links_run_through_the_launching_call_to_the_innermost_span():
    sp = _window()
    names = [None if sp.launcher(d) is None else sp.spans[sp.launcher(d)][0]
             for d in range(len(sp.device))]
    assert names == ["fst.h3d.pad", "fst.h3d.update", "fst.h3d.pad",
                     "fst.h3d.update", None, "fst.h3d.pad",
                     "fst.h3d.update", None]
    assert sp.steps == 3


def test_by_span_and_idle_by_span():
    sp = _window()
    rows = sp.by_span()
    assert set(rows) == {"fst.run", "fst.step", "fst.h3d.pad",
                         "fst.h3d.update"}
    assert rows["fst.step"]["calls"] == 1.0
    assert rows["fst.run"]["calls"] == pytest.approx(2 / 3)
    assert rows["fst.step"]["host_ms"] == pytest.approx(0.650 / 3)
    # every device op of the steps: 3 cats of 40 us, #2 100 + 100 + 75 us
    assert rows["fst.step"]["device_ms"] == pytest.approx(0.395 / 3)
    assert rows["fst.run"]["device_ms"] == pytest.approx(0.395 / 3)
    assert rows["fst.h3d.update"]["device_ms"] == pytest.approx(0.275 / 3)
    assert rows["fst.h3d.pad"]["syncs"] == pytest.approx(2 / 3)
    assert rows["fst.h3d.update"]["syncs"] == 0.0
    idle = sp.idle_by_span()
    assert idle == {"fst.h3d.pad": pytest.approx(240e-6),
                    "fst.h3d.update": pytest.approx(135e-6),
                    spans.OUTSIDE: pytest.approx(175e-6)}
    assert sp.frame_ms() == [pytest.approx(0.470), pytest.approx(0.390)]


def test_spans_nest_by_time():
    sp = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0),
          ("d", 5.0, 9.0), ("e", 12.0, 13.0)]
    got = spans._open_spans(sp, [0.5, 2.5, 3.5, 4.5, 6.0, 11.0, 12.5])
    assert got == [(0,), (0, 1, 2), (0, 1), (0,), (0, 3), (), (4,)]


@pytest.mark.parametrize("name,sync", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cudaMemcpy", True),
    ("cudaMemcpy2D", True), ("cuMemcpyDtoH_v2", True),
    ("cudaMemcpyAsync", False), ("cudaMemcpy2DAsync", False),
    ("cudaLaunchKernel", False), ("cudaStreamIsCapturing", False)])
def test_which_calls_wait_for_the_device(name, sync):
    assert spans.is_sync(name) is sync


def test_an_empty_window_reads_nothing():
    sp = spans.Spans(spans=[], calls=[], device=[], window=(0.0, 1.0))
    assert sp.steps == 0
    assert sp.syncs_per_step() is None and sp.dispatch_ms_per_step() is None
    assert sp.frame_gap_ms() is None and sp.by_span() == {}


def test_nothing_is_read_off_the_card_or_from_a_program_without_spans(
        monkeypatch):
    def never(cell):
        raise AssertionError("no window off the card")

    monkeypatch.setattr(spans, "measure", never)
    ctx = _ctx(gpu=False)
    for name in READERS:
        assert _read(ctx, name) is None, name
    monkeypatch.undo()
    monkeypatch.setattr(spans, "has_spans", lambda: False)
    assert spans.measure(harness.Cell(harness.ROOT, "h3d-sphere-f32-256"),
                         device="cpu") is None


@pytest.mark.parametrize("workload,phases", [
    ("h2d-capsule-f64-8192x1024", ("fst.h2d.dt", "fst.h2d.update")),
    ("h3d-sphere-f32-256", ("fst.h3d.tau", "fst.h3d.pad", "fst.h3d.update",
                            "fst.h3d.dt", "fst.h3d.encode"))])
def test_the_window_on_the_cpu(tiny_root, workload, phases):
    cell = harness.Cell(tiny_root, workload)
    sp = spans.measure(cell, device="cpu")
    spf = int(cell.traffic["steps_per_frame"])
    frames = int(cell.traffic["trace_frames"])
    assert sp.steps == spf * frames
    rows = sp.by_span()
    assert rows["fst.run"]["calls"] == pytest.approx(1 / spf)
    for p in phases:
        assert rows[p]["calls"] == 1.0, p
    assert sp.syncs_per_step() == 0.0 and sp.device == []
    assert len(sp.frame_ms()) == frames


# ---- on the card -----------------------------------------------------------

@pytest.mark.card
def test_each_kernel_links_to_the_span_that_launched_it(card, tiny_root):
    sp = spans.measure(harness.Cell(tiny_root, "h3d-sphere-f32-256"))
    linked = {}
    for d, (name, s, _, _) in enumerate(sp.device):
        j = sp.launcher(d)
        if j is None:
            continue
        # on one clock: an operation starts after the span that launched it
        assert s >= sp.spans[j][1], (name, sp.spans[j])
        linked.setdefault(sp.spans[j][0], set()).add(name)
    assert any("step3_kernel" in n for n in linked["fst.h3d.update"])
    assert any("wavespeed3_kernel" in n for n in linked["fst.h3d.dt"])
    assert any("pad3_kernel" in n for n in linked["fst.h3d.pad"])
    assert not any("step3_kernel" in n for k, v in linked.items()
                   if k != "fst.h3d.update" for n in v)


@pytest.mark.card
def test_the_2d_step_never_waits_for_the_device(card, tiny_root):
    sp = spans.measure(harness.Cell(tiny_root, "h2d-capsule-f32-8192x1024"))
    assert sp.syncs_per_step() == 0.0
    rows = sp.by_span()
    assert rows["fst.h2d.update"]["device_ms"] > 0
    assert rows["fst.h2d.dt"]["device_ms"] > 0


@pytest.mark.card
def test_the_harness_trace_is_the_same_with_and_without_spans(
        card, tiny_root, monkeypatch):
    import torch

    from fluidsims_tpu_torch.core import metrics

    cell = harness.Cell(tiny_root, "h3d-sphere-f32-256")
    dev = torch.device("cuda", 0)
    ref = cell.reference.Reference(cell.cfg, cell.traffic, dev)
    prog = cell.adapter.Program(cell.cfg, cell.traffic, dev, ref)
    drv = harness.Driver(prog, prog.init(harness.make_noise(3, ref, dev)), 2)
    drv.frame()

    def reduced():
        tr = tracing.profile(drv.frames, 3, 2, prog.launches)
        return Counter(n for n, _, _ in tr.device), tr.port_launches, \
            len(tr.host)

    with_spans = reduced()
    monkeypatch.setattr(metrics, "_profiling", lambda: False)
    assert metrics.span("fst.step") is metrics._NO_SPAN
    without = reduced()
    assert not any(n.startswith("fst.") for n in with_spans[0])
    assert with_spans[1:] == without[1:]
    # the same operations; the count of a torch op's operations once
    # differed between two profiles of the same frames on the card, the
    # port's kernels are held to one launch each a step
    assert set(with_spans[0]) == set(without[0])
    for kernel in cell.adapter.KERNELS.values():
        assert sum(c for n, c in with_spans[0].items() if kernel in n) == \
            sum(c for n, c in without[0].items() if kernel in n) == 3 * 2
