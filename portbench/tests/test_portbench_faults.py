"""`correct` fails where it should: the control (the lower-precision path
in the program's place) and a timed path broken underneath a whole run,
with the harness's look for a card skipped and every cell at a tiny grid.
The faults a cell can have: a step that returns its state unchanged, half
of the grid left out of the update, an answer altered where it is made.
(One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import json

import pytest
import torch

from fluidsims_tpu_torch.solvers import hypersonic2d as h2
from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from portbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 99


def _run(root, workload, control=False):
    return harness.run(workload, SEED, 0.3, False, root=root, device="cpu",
                       control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_is_correct_and_the_control_is_not(tiny_root,
                                                              workload):
    res = _run(tiny_root, workload, control=True)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    limits = {n: c["limit"] for n, c in res["check"].items()}
    assert any(res["control"][n] > limits[n] for n in limits), \
        (res["control"], limits)


def _unchanged(step):
    return lambda cfg, s, *a, **k: s


def _keep_half(new, old):
    """The inflow half (the first half of x) of `old`, the rest `new`."""
    half = new.shape[-1] // 2
    return torch.cat([old[..., :half], new[..., half:]], dim=-1)


def _half(step):
    """Half of the grid left out of the update: the inflow side, where the
    flow changes first."""
    def broken(cfg, s, *a, **k):
        out = step(cfg, s, *a, **k)
        new, old = out._asdict(), s._asdict()
        for key, v in new.items():
            if key in ("mask", "solid") or not isinstance(v, (tuple,
                                                              torch.Tensor)):
                continue
            if isinstance(v, tuple):
                new[key] = type(v)(*map(_keep_half, v, old[key]))
            elif v.dim() >= 2:
                new[key] = _keep_half(v, old[key])
        return type(out)(**new)
    return broken


def _altered(step):
    def broken(cfg, s, *a, **k):
        out = step(cfg, s, *a, **k)
        f = out.U.rho if hasattr(out, "U") else out.xi
        f = f.clone()
        idx = tuple(n // 4 for n in f.shape)   # a fluid cell
        f[idx] = f[idx] * 2.0
        if hasattr(out, "U"):
            return out._replace(U=out.U._replace(rho=f))
        return out._replace(xi=f)
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload,
                                            fault):
    mod = h3 if workload.startswith("h3d") else h2
    monkeypatch.setattr(mod, "step", fault(mod.step))
    res = _run(tiny_root, workload)
    assert not res["correct"], res["check"]
