"""Fixtures of the benchmark's tests.

Run on the CPU:  python -m pytest portbench/tests -q
Run the card's tests on the GPU machine:  python3 -m pytest portbench/tests -q -m card

`tiny_root` is a copy of the benchmark (BENCHMARK.json and portbench/) in a
temporary directory, the program linked beside it, whose cells run the
same configurations at tiny grids, so a whole run fits the CPU.  A
configuration's tiny sizes are the file tests/tiny/<config>.json, found by
the configuration's name."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def tiny_file(root: Path, config: str) -> Path:
    """Where the tiny sizes of configuration `config` lie under `root`."""
    return Path(root) / "portbench" / "tests" / "tiny" / f"{config}.json"


def tiny_sizes(root: Path, config: str) -> dict:
    path = tiny_file(root, config)
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config!r} has no tiny sizes: {path} is missing")
    return json.loads(path.read_text())


def make_tiny_root(dst: Path, src: Path = REPO) -> Path:
    """A copy of the benchmark under `src` in `dst`, each cell's traffic
    replaced by its configuration's tiny sizes in the cell's dtype."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(src / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "fluidsims_tpu_torch").symlink_to(REPO / "fluidsims_tpu_torch")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        real = json.loads(
            (dst / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        tiny = dict(tiny_sizes(src, w["config"]), dtype=real["dtype"])
        w["traffic"] = "tiny-" + w["name"]
        (dst / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tiny))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture
def tiny():
    """The tiny sizes' helpers, for tests that build a root of their own."""
    return SimpleNamespace(file=tiny_file, sizes=tiny_sizes,
                           make_root=make_tiny_root)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
