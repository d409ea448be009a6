"""Each frozen reference against the port's `torch` engine (the plain
versions its kernel wrappers run on CPU tensors) at a tiny grid: the same
operations in the same order, so the same bits."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

CASES = [("h2d-capsule-f64-8192x1024", dict(nx=48, ny=24), 20),
         ("h2d-capsule-f32-8192x1024", dict(nx=40, ny=40), 20),
         ("h3d-sphere-f32-256", dict(n=12), 12)]


def _pair(workload, grid, dtype=None):
    cell = harness.Cell(harness.ROOT, workload)
    traffic = dict(cell.traffic, **grid)
    if dtype:
        traffic["dtype"] = dtype
    dev = torch.device("cpu")
    ref = cell.reference.Reference(cell.cfg, traffic, dev)
    prog = cell.adapter.Program(cell.cfg, traffic, dev, ref)
    noise = harness.make_noise(2**31 + 5, ref, dev)
    return cell, ref, prog, noise, getattr(torch, traffic["dtype"])


@pytest.mark.parametrize("workload,grid,steps", CASES)
@pytest.mark.parametrize("dtype", [None, "float64"])
def test_reference_matches_the_ports_plain_step(workload, grid, steps, dtype):
    cell, ref, prog, noise, dt = _pair(workload, grid, dtype)
    state = prog.init(noise)
    start = ref.init(dt, noise)
    for k, v in prog.fields(state).items():
        assert torch.equal(v, start[k]), k
    got = prog.fields(prog.run(state, steps))
    want = ref.frame(start, steps, dt)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(want[cell.reference.CLOCK[0]]) > float(
        start[cell.reference.CLOCK[0]])


@pytest.mark.parametrize("workload,grid,steps", CASES)
def test_reference_runs_in_the_controls_precision(workload, grid, steps):
    cell, ref, prog, noise, dt = _pair(workload, grid)
    lower = harness.control_dtype(ref, cell.traffic["dtype"])
    out = ref.frame(ref.init(dt, noise), 3, lower)
    for k, v in out.items():
        assert v.dtype == lower and bool(torch.isfinite(v).all()), k


def test_the_reference_masks_are_the_programs():
    cell, ref, prog, noise, dt = _pair(*CASES[0][:2])
    prog.init(noise)
    assert torch.equal(ref.solid, prog.mask)
    assert 0 < int(ref.solid.sum()) < ref.solid.numel()
    cell, ref, prog, noise, dt = _pair(*CASES[2][:2])
    prog.init(noise)
    assert torch.equal(ref.solid, prog.solid)
