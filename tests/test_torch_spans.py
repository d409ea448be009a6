"""The port's program spans (core/metrics.span): under a profiler the
driver's `fst.run` / `fst.step` and each hypersonic step's phases are
recorded, nested and counted as the code runs them; without one `span` is a
single shared no-op, and the spans change no number of the state."""

from __future__ import annotations

import contextlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidsims_tpu_torch.core import metrics
from fluidsims_tpu_torch.core.stepper import run_split, run_steps
from fluidsims_tpu_torch.solvers import hypersonic2d as h2
from fluidsims_tpu_torch.solvers import hypersonic3d as h3

CPU = torch.device("cpu")
N_STEPS = 3
PHASES = {
    "h2d": ("fst.h2d.dt", "fst.h2d.update"),
    "h3d": ("fst.h3d.tau", "fst.h3d.pad", "fst.h3d.update", "fst.h3d.dt",
            "fst.h3d.encode"),
}


def _case(which):
    if which == "h2d":
        cfg = h2.default_config(48, 24, dtype="float64")
        return h2.init(cfg, CPU), lambda s, n: h2.run(cfg, s, n)
    cfg = h3.default_config(10, dtype="float64")
    return h3.init(cfg, CPU), lambda s, n: h3.run(cfg, s, n)


def _fields(s):
    return [*(s.U if hasattr(s, "U") else s[:6]), s.t]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("fst.")]


@pytest.mark.parametrize("which", ["h2d", "h3d"])
def test_run_records_the_driver_and_each_phase_once_a_step(which):
    s, run = _case(which)
    _, ev = _profiled(lambda: run(s, N_STEPS))
    counts = Counter(e.name for e in ev)
    want = {"fst.run": 1, "fst.step": N_STEPS}
    want.update({p: N_STEPS for p in PHASES[which]})
    assert counts == want
    for e in ev:
        parent = e.cpu_parent
        if e.name == "fst.run":
            assert parent is None or not parent.name.startswith("fst.")
        elif e.name == "fst.step":
            assert parent.name == "fst.run"
        else:
            assert parent.name == "fst.step", (e.name, parent.name)
    # the phases of one step follow the code's order inside their step
    for step in (e for e in ev if e.name == "fst.step"):
        inside = sorted((e for e in ev if e.cpu_parent is step),
                        key=lambda e: e.time_range.start)
        assert tuple(e.name for e in inside) == PHASES[which]
        assert all(step.time_range.start <= e.time_range.start
                   and e.time_range.end <= step.time_range.end
                   for e in inside)


def test_run_split_records_a_step_span_a_call():
    calls = []
    _, ev = _profiled(lambda: run_split(lambda x: calls.append("k") or x + 4,
                                        lambda x: calls.append("1") or x + 1,
                                        4, 0, 10))
    assert calls == ["k", "k", "1", "1"]
    counts = Counter(e.name for e in ev)
    assert counts == {"fst.run": 2, "fst.step": 4}


def test_without_a_profiler_span_is_one_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    a, b = metrics.span("fst.step"), metrics.span("fst.h3d.pad")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a as got:
        assert got is None
    assert run_steps(lambda x: x + 1, 0, 5) == 5


def test_a_span_records_only_inside_a_profile():
    with metrics.span("fst.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("fst.inside"):
            torch.ones(3).sum()
    with metrics.span("fst.after"):
        pass
    names = [e.name for e in prof.events() if e.name.startswith("fst.")]
    assert names == ["fst.inside"]
    (inside,) = (e for e in prof.events() if e.name == "fst.inside")
    children = {c.name for c in inside.cpu_children}
    assert "aten::sum" in children


@pytest.mark.parametrize("which", ["h2d", "h3d"])
def test_states_are_bitwise_equal_with_spans_on_and_off(which):
    s, run = _case(which)
    off = run(s, N_STEPS)
    s2, run2 = _case(which)
    on, ev = _profiled(lambda: run2(s2, N_STEPS))
    assert ev
    for a, b in zip(_fields(off), _fields(on), strict=True):
        assert torch.equal(a, b)
    if which == "h3d":
        assert torch.equal(off.dtau, on.dtau)
