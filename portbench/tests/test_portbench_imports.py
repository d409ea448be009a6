"""What the benchmark loads: nothing of JAX or the JAX package (top-level
module names compared whole, so `fluidsims_tpu_torch` is not
`fluidsims_tpu`), and a reference that loads nothing of the program.
Each check runs in a fresh interpreter."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_a_whole_run_loads_no_jax(tiny_root):
    p = _python(f"""
        import json, sys
        from pathlib import Path
        from portbench import harness
        for w in {CELLS!r}:
            for trace in (False, True):
                harness.run(w, 7, 0.2, trace, root=Path("."), device="cpu")
        print(json.dumps(harness.forbidden_modules()))
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] == "fluidsims_tpu_torch")))
    """, tiny_root)
    assert p.returncode == 0, p.stderr[-3000:]
    found, port = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "fluidsims_tpu_torch.solvers.hypersonic2d" in port


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fluidsims_tpu_torchx", sys)
    assert "fluidsims_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_a_reference_loads_nothing_of_the_program(tiny_root, config):
    p = _python(f"""
        import importlib.abc, json, sys
        from pathlib import Path

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("fluidsims_tpu_torch",
                                          "fluidsims_tpu", "jax", "jaxlib"):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import torch
        from portbench import harness
        bench = json.loads(Path("BENCHMARK.json").read_text())
        conf = [c for c in bench["configs"] if c["name"] == {config!r}][0]
        cfg = json.loads(Path(conf["file"]).read_text())
        w = [w for w in bench["workloads"] if w["config"] == {config!r}][0]
        traffic = json.loads(Path("portbench/traffic",
                                  w["traffic"] + ".json").read_text())
        mod = harness.load_module(Path("portbench/reference/{config}.py"))
        ref = mod.Reference(cfg, traffic, "cpu")
        noise = harness.make_noise(3, ref, "cpu")
        dt = getattr(torch, traffic["dtype"])
        out = ref.frame(ref.init(dt, noise), 2, dt)
        solid = getattr(ref, "solid", None)
        print(sorted(out), None if solid is None else int(solid.sum()))
    """, tiny_root)
    assert p.returncode == 0, p.stderr[-3000:]


def test_no_card_no_result(tiny_root):
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        CELLS[0], "--seed", "4294967311", "--seconds", "1",
                        "--trace", "0"], cwd=tiny_root, capture_output=True,
                       text=True, timeout=300)
    if p.returncode == 0:
        pytest.skip("a card is present here")
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        CELLS[0], "--seed", "11", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
