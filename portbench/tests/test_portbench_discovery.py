"""The harness finds every part by name, BENCHMARK.json keeps to the
benchmark's contract, and a cell, a configuration and a per-layer metric
are each added with new files and entries alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (rs + 60) * (2 + 14 * 24) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and c["source"].startswith("https://")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] \
        == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(workload, tiny):
    cell = harness.Cell(harness.ROOT, workload)
    assert set(cell.limits) == {"init_err", "frame_err", "time_err"}
    # the configuration's tiny sizes, which the CPU tests run it at
    assert {"steps_per_frame", "check_frames", "trace_frames"} <= set(
        tiny.sizes(harness.ROOT, cell.config_name))
    assert hasattr(cell.adapter, "Program") and cell.adapter.KERNELS
    assert cell.reference.FIELDS == cell.adapter.FIELDS
    ref = cell.reference.Reference(cell.cfg, cell.traffic, "cpu")
    assert ref.noise_fields >= 1 and len(ref.noise_shape) >= 2
    assert harness.control_dtype(ref, cell.traffic["dtype"]) is not None
    e2e = cell.metrics("end_to_end")
    per_layer = cell.metrics("per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(cell.reader(m["name"]).read)
    for m in per_layer:
        assert m["moves"] in {x["name"] for x in e2e}
        if m["name"].endswith("_roofline"):
            kernel = m["name"].removesuffix("_roofline")
            assert kernel in cell.adapter.KERNELS
            assert callable(cell.counts(kernel).ops)


def test_a_reference_may_name_its_controls_precision():
    class Ref:
        control_dtype = "its own"

    assert harness.control_dtype(Ref(), "int32") == "its own"
    assert harness.control_dtype(object(), "float64") is torch.float32
    with pytest.raises(KeyError):
        harness.control_dtype(object(), "int32")


def _add_entry(root, key, entry):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench[key].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_a_metric_is_added_as_a_file(tiny_root):
    (tiny_root / "portbench" / "metrics" / "frames_per_s.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.window.frames) / ctx.window.seconds\n")
    _add_entry(tiny_root, "per_layer", {
        "name": "frames_per_s", "unit": "frames/s", "better": "higher",
        "source": "host_clock", "layer": "driver", "moves": "frame_ms_p95",
        "workloads": ["h3d-sphere-f32-256"]})
    res = harness.run("h3d-sphere-f32-256", 5, 0.2, True, root=tiny_root,
                      device="cpu")
    assert res["metrics"]["frames_per_s"]["value"] > 0
    assert res["metrics"]["frames_per_s"]["unit"] == "frames/s"


def test_a_cell_is_added_as_files(tiny_root):
    pb = tiny_root / "portbench"
    (pb / "traffic" / "tiny-f64-40x40.json").write_text(json.dumps(dict(
        nx=40, ny=40, dtype="float64", steps_per_frame=2, check_frames=1,
        trace_frames=1)))
    shutil.copy(pb / "cells" / "h2d-capsule-f64-8192x1024.json",
                pb / "cells" / "h2d-square.json")
    _add_entry(tiny_root, "workloads", {
        "name": "h2d-square", "config": "hypersonic2d-capsule",
        "traffic": "tiny-f64-40x40", "chips": 1, "why": "a throwaway cell"})
    res = harness.run("h2d-square", 6, 0.2, False, root=tiny_root,
                      device="cpu")
    assert res["correct"] and res["attempted"] >= 2
    assert set(res["metrics"]) == {"mcell_steps_per_s", "frame_ms_p95",
                                   "setup_s"}


def _benchmark_copy(dst):
    """BENCHMARK.json and portbench/, tests and tiny sizes included."""
    dst.mkdir(parents=True)
    shutil.copy(harness.ROOT / "BENCHMARK.json", dst)
    shutil.copytree(harness.ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_is_added_as_files(tmp_path, tiny):
    src = _benchmark_copy(tmp_path / "benchmark")
    before, bench_before = _hashes(src), json.loads(
        (src / "BENCHMARK.json").read_text())
    pb = src / "portbench"
    cfg = json.loads((pb / "configs" / "hypersonic2d-capsule.json").read_text())
    cfg.update(name="capsule-mach10", inflow_mach=10.0)
    (pb / "configs" / "capsule-mach10.json").write_text(json.dumps(cfg))
    for d in ("adapters", "reference"):
        shutil.copy(pb / d / "hypersonic2d-capsule.py",
                    pb / d / "capsule-mach10.py")
    (pb / "traffic" / "f64-4096x512-8spf.json").write_text(json.dumps(dict(
        nx=4096, ny=512, dtype="float64", steps_per_frame=8, check_frames=2,
        trace_frames=4)))
    shutil.copy(pb / "cells" / "h2d-capsule-f64-8192x1024.json",
                pb / "cells" / "mach10.json")
    tiny.file(src, "capsule-mach10").write_text(json.dumps(dict(
        nx=48, ny=24, steps_per_frame=2, check_frames=1, trace_frames=1)))
    _add_entry(src, "configs", {
        "name": "capsule-mach10", "source": "https://example.org/mach10",
        "file": "portbench/configs/capsule-mach10.json", "reduced": [],
        "why": "a throwaway configuration"})
    _add_entry(src, "workloads", {
        "name": "mach10", "config": "capsule-mach10",
        "traffic": "f64-4096x512-8spf", "chips": 1,
        "why": "a throwaway cell"})
    # new files, and entries appended to BENCHMARK.json: nothing else moved
    after = _hashes(src)
    assert {f for f in before if after[f] != before[f]} == {
        Path("BENCHMARK.json")}
    bench = json.loads((src / "BENCHMARK.json").read_text())
    for key, old in bench_before.items():
        new = bench[key]
        assert (new[:len(old)] if isinstance(old, list) else new) == old, key

    root = tiny.make_root(tmp_path / "checkout", src)
    res = harness.run("mach10", 7, 0.2, False, root=root, device="cpu")
    assert res["correct"], res["check"]
    cell = harness.Cell(root, "mach10")
    assert cell.cfg["inflow_mach"] == 10.0
    assert (cell.traffic["nx"], cell.traffic["ny"],
            cell.traffic["steps_per_frame"]) == (48, 24, 2)


def test_a_configuration_without_tiny_sizes_is_named(tmp_path, tiny):
    src = _benchmark_copy(tmp_path / "benchmark")
    _add_entry(src, "configs", {
        "name": "capsule-untried", "source": "https://example.org/untried",
        "file": "portbench/configs/hypersonic2d-capsule.json", "reduced": [],
        "why": "a configuration with no tiny sizes"})
    _add_entry(src, "workloads", {
        "name": "untried", "config": "capsule-untried",
        "traffic": "f64-8192x1024-24spf", "chips": 1,
        "why": "a throwaway cell"})
    missing = tiny.file(src, "capsule-untried")
    with pytest.raises(FileNotFoundError) as e:
        tiny.make_root(tmp_path / "checkout", src)
    assert str(missing) in str(e.value)
    assert "'capsule-untried'" in str(e.value)
