"""Configuration `th3cs-sphere` at a tiny grid on the CPU: its reference
against the port's plain path, bitwise, with the frame's volume as the
`.4spl` holds it; a broken timed step, a frame volume off by one index,
and a frame written stale or dropped fail `correct`.  Its step faults go
into the 3-D step that th3cs runs (test_portbench_faults.py picks the
solver by a cell's name)."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from fluidsims_tpu_torch.solvers import th3cs
from portbench import harness

CELL = "th3cs-sphere-f32-256-4spl"
SEED = 2**31 + 77
FAULTS = harness.load_module(Path(__file__).with_name(
    "test_portbench_faults.py"))


def test_the_cells_files_are_found_by_name():
    cell = harness.Cell(harness.ROOT, CELL)
    assert cell.reference.FIELDS == cell.adapter.FIELDS
    assert cell.cfg["export"]["frames_per_video"] == 60
    assert (cell.traffic["n"], cell.traffic["steps_per_frame"]) == (256, 4)
    assert cell.limits["frame_err"] < 1 / 255
    for name in ("th3cs_vis_ms_per_frame", "th3cs_collect_ms_per_frame",
                 "th3cs_export_overlap", "th3cs_write_gb_per_s"):
        assert callable(cell.reader(name).read)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_matches_the_ports_plain_frames(dtype):
    cell = harness.Cell(harness.ROOT, CELL)
    traffic = dict(cell.traffic, n=12, dtype=dtype)
    dev = torch.device("cpu")
    ref = cell.reference.Reference(cell.cfg, traffic, dev)
    prog = cell.adapter.Program(cell.cfg, traffic, dev, ref)
    noise = harness.make_noise(SEED, ref, dev)
    dt = getattr(torch, dtype)
    state, want = prog.init(noise), ref.init(dt, noise)
    for _ in range(3):
        got = prog.fields(state)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        state = prog.run(state, int(traffic["steps_per_frame"]))
        want = ref.frame(want, int(traffic["steps_per_frame"]), dt)
    assert want["vol"].dtype == torch.uint8
    assert int(want["vol"].min()) == 0 and int(want["vol"].max()) == 255


def test_the_sound_export_is_correct_and_its_control_is_not(tiny_root):
    res = harness.run(CELL, SEED, 0.3, True, root=tiny_root, device="cpu",
                      control=True)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    limits = {n: c["limit"] for n, c in res["check"].items()}
    assert any(res["control"][n] > limits[n] for n in limits)


@pytest.mark.parametrize("fault", ["_unchanged", "_half", "_altered"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(h3, "step", getattr(FAULTS, fault)(h3.step))
    res = harness.run(CELL, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert not res["correct"], res["check"]


def test_a_volume_one_index_off_is_not_correct(tiny_root, monkeypatch):
    sound = th3cs.schlieren_frame

    def off_by_one(cfg, s):
        vol = sound(cfg, s).clone()
        idx = tuple(n // 4 for n in vol.shape)   # a fluid cell
        vol[idx] = vol[idx] + 1 if int(vol[idx]) < 255 else vol[idx] - 1
        return vol

    monkeypatch.setattr(th3cs, "schlieren_frame", off_by_one)
    res = harness.run(CELL, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert not res["correct"], res["check"]
    assert res["check"]["frame_err"]["value"] == pytest.approx(1 / 255)


def _stale(sound):
    last = []

    def collect(self, i, vol):
        # each frame written as the frame collected before it
        sound(self, i, last[-1] if last else vol)
        last.append(vol)

    return collect


def _dropped(sound):
    def collect(self, i, vol):
        # each video's first frame never reaches the file
        if i > 0:
            sound(self, i, vol)

    return collect


@pytest.mark.parametrize("fault", [_stale, _dropped])
def test_a_frame_written_stale_or_dropped_is_not_correct(tiny_root,
                                                         monkeypatch, fault):
    monkeypatch.setattr(th3cs.Exporter, "_collect",
                        fault(th3cs.Exporter._collect))
    res = harness.run(CELL, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert not res["correct"], res["check"]
    assert res["check"]["frame_err"]["value"] > res["check"]["frame_err"][
        "limit"]
