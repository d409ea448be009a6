"""The metric arithmetic: rates over the whole window, tails over every
frame, the trace's busy union, idle gaps and roofline shares."""

from __future__ import annotations

import statistics

import pytest

from portbench import harness, peaks, stats
from portbench import trace as tracing


def _ctx(root, frames, steps_per_frame=4, trace=None, cells=1000,
         gpu=True, workload="h2d-capsule-f64-8192x1024"):
    cell = harness.Cell(root, workload)
    win = harness.Window(frames=frames, enqueue=[f / 2 for f in frames],
                         steps=len(frames) * steps_per_frame,
                         seconds=sum(frames) + 0.5, failed=0)
    work = {"cells": cells, "fluid_cells": cells - 100, "itemsize": 8,
            "dtype": "float64"}
    return harness.Context(window=win, trace=trace, setup_s=7.5, work=work,
                           kernels=dict(cell.adapter.KERNELS), cell=cell,
                           gpu=gpu)


def _read(ctx, name):
    return ctx.cell.reader(name).read(ctx)


@pytest.mark.parametrize("q,want", [(0, 1.0), (50, 3.0), (95, 4.8),
                                    (100, 5.0), (25, 2.0)])
def test_percentile_interpolates_between_ranks(q, want):
    assert stats.percentile([5.0, 1.0, 3.0, 2.0, 4.0], q) == pytest.approx(want)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / 12.5)


def test_rate_is_all_the_work_over_the_whole_window():
    ctx = _ctx(harness.ROOT, [0.1] * 10, steps_per_frame=4, cells=2_000_000)
    # 10 frames x 4 steps x 2e6 cells over 1.0 + 0.5 s, in millions
    assert _read(ctx, "mcell_steps_per_s") == pytest.approx(
        2e6 * 40 / 1.5 / 1e6)


def test_p95_is_taken_over_every_frame_not_over_chunk_medians():
    # 20 chunks of 10 frames, each with one slow frame: every chunk's
    # median is 10 ms, the 95th percentile of all 200 frames is 50 ms
    frames = ([0.010] * 9 + [0.050]) * 20
    chunk_medians = [statistics.median(frames[i:i + 10])
                     for i in range(0, 200, 10)]
    p95_of_chunks = stats.percentile(chunk_medians, 95)
    got = _read(_ctx(harness.ROOT, frames), "frame_ms_p95")
    assert got == pytest.approx(stats.percentile(frames, 95) * 1e3)
    assert got == pytest.approx(50.0)
    assert p95_of_chunks == pytest.approx(0.010)


def test_host_metrics_of_the_window():
    frames = [0.02, 0.04, 0.03]
    ctx = _ctx(harness.ROOT, frames, steps_per_frame=2)
    assert _read(ctx, "setup_s") == 7.5
    assert _read(ctx, "frame_ms_median") == pytest.approx(30.0)
    assert _read(ctx, "enqueue_ms_per_step") == pytest.approx(
        sum(f / 2 for f in frames) / 6 * 1e3)


def _trace():
    # a window of 100 us: kernels 10-40 (step), 35-50 (torch op, overlaps),
    # 60-70 (wavespeed); one op outside the window is clipped away
    device = [("void step_kernel<double>(A)", 10.0, 40.0),
              ("elementwise_kernel", 35.0, 50.0),
              ("inflow_wavespeed_kernel<double>", 60.0, 70.0),
              ("late_kernel", 150.0, 160.0)]
    host = [("portbench.window", 0.0, 100.0),
            ("portbench.enqueue", 0.0, 55.0),
            ("portbench.readback", 55.0, 100.0)]
    return tracing.Trace(device=device, host=host, window=(0.0, 100.0),
                         steps=2, port_launches=2)


def test_trace_union_idle_share_and_gaps():
    tr = _trace()
    assert tr.busy == [(10.0, 50.0), (60.0, 70.0)]
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.window_s == pytest.approx(100e-6)
    ctx = _ctx(harness.ROOT, [0.1], trace=tr)
    assert _read(ctx, "idle_share") == pytest.approx(50.0)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["readback", pytest.approx(30e-6)]
    assert sorted(g[0] for g in gaps) == ["enqueue", "enqueue", "readback"]
    assert sum(g[1] for g in gaps) == pytest.approx(50e-6)
    top = tr.top_ops()
    assert top[0] == ["void step_kernel<double>(A)", pytest.approx(30e-6)]
    assert len(top) == 3


def test_solver_metrics_count_everything_but_the_ports_kernels():
    ctx = _ctx(harness.ROOT, [0.1], trace=_trace())
    assert _read(ctx, "torch_ops_ms_per_step") == pytest.approx(15e-3 / 2)
    # 2 port launches counted by the LaunchCounters + 1 other op, 2 steps
    assert _read(ctx, "launches_per_step") == pytest.approx(1.5)


def test_roofline_is_the_least_time_over_the_mean_launch():
    tr = _trace()
    ctx = _ctx(harness.ROOT, [0.1], trace=tr, cells=1_000_000)
    c = ctx.cell.counts("h2d_step")
    least = peaks.least_seconds(c.ops(ctx.work), c.nbytes(ctx.work), "float64")
    assert _read(ctx, "h2d_step_roofline") == pytest.approx(
        least / 30e-6 * 100)
    ctx3 = _ctx(harness.ROOT, [0.1], trace=tr, workload="h3d-sphere-f32-256")
    assert _read(ctx3, "h3d_step_roofline") is None  # no #2 in this trace


def test_device_metrics_are_not_made_up_without_a_card_trace():
    ctx = _ctx(harness.ROOT, [0.1], gpu=False)
    for name in ("idle_share", "h2d_step_roofline", "torch_ops_ms_per_step",
                 "launches_per_step"):
        assert _read(ctx, name) is None, name
    empty = tracing.Trace(device=[], host=[("portbench.window", 0.0, 9.0)],
                          window=(0.0, 9.0), steps=1, port_launches=0)
    ctx = _ctx(harness.ROOT, [0.1], trace=empty, gpu=False)
    assert _read(ctx, "idle_share") is None
    assert _read(ctx, "torch_ops_ms_per_step") is None


def test_snapshot_times_fall_in_their_own_share_of_the_window():
    for seed in (0, 1, 2**31 + 7, 4_000_000_000):
        t = harness.snapshot_times(seed, 20.0, 2)
        assert 1.0 <= t[0] < 10.0 <= t[1] < 19.0
        assert t == harness.snapshot_times(seed, 20.0, 2)
