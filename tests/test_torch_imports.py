"""The port imports neither `jax` nor the JAX package.

The machine with the GPU has no JAX, so a stray import would show only
there.  One subprocess, whose meta path refuses `jax`, `jaxlib` and
`fluidsims_tpu`, imports every module of fluidsims_tpu_torch (and
chip_smoke.py) in turn; each module is one case.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import fluidsims_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["fluidsims_tpu_torch", "chip_smoke"] + sorted(
    m.name for m in pkgutil.walk_packages(fluidsims_tpu_torch.__path__,
                                          "fluidsims_tpu_torch."))

_SCRIPT = """
import importlib, json, sys, traceback

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "fluidsims_tpu"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
out = {}
for mod in sys.argv[1:]:
    try:
        importlib.import_module(mod)
        out[mod] = "ok"
    except Exception:
        out[mod] = traceback.format_exc()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *MODULES],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_listed():
    assert "fluidsims_tpu_torch.kernels.sph_cuda" in MODULES
    assert "fluidsims_tpu_torch.solvers.sph" in MODULES
    for mod in ("ops.weno", "solvers.hypersonic3d", "solvers.th3cs",
                "kernels.hypersonic3d_cuda", "io", "io.fourspl", "ops.shift",
                "solvers.gray_scott", "solvers.lbm",
                "kernels.gray_scott_cuda", "kernels.lbm_cuda",
                "solvers.burgers", "solvers.shallow_water", "solvers.mhd",
                "kernels.burgers_cuda", "kernels.shallow_water_cuda",
                "kernels.mhd_cuda", "ops.scalar", "ops.gather",
                "solvers.stam3d", "kernels.stam3d_cuda", "solvers.stam2d",
                "kernels.stam2d_cuda", "solvers.flip_apic",
                "kernels.flip_cuda", "solvers.mpm", "kernels.mpm_cuda",
                "ops.cell_list", "solvers.nbody_native", "render",
                "render.points", "core.interactive", "core.checkpoint",
                "core.metrics", "core.native", "render.colormap",
                "render.terminal", "render.views", "io.png", "io.live4spl",
                "io.fourspl_native", "solvers.hypersonic2d_cpu",
                "solvers.hypersonic2d_cpu_native", "solvers.stam2d_cpu"):
        assert f"fluidsims_tpu_torch.{mod}" in MODULES
    assert "fluidsims_tpu_torch.solvers.nbody_graph" in MODULES
    assert "fluidsims_tpu_torch.kernels.nbody_cuda" in MODULES
    assert len(MODULES) >= 70


@pytest.mark.parametrize("mod", MODULES)
def test_imports_without_jax(imported, mod):
    assert imported[mod] == "ok", imported[mod]
