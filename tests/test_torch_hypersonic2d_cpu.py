"""Port vs JAX: the CPU reference solvers and their subcommands.

`solvers/hypersonic2d_cpu` (the numpy CPU reference, tau_hypersonic.c)
and `solvers/stam2d_cpu` (sim.c's Gauss–Seidel reference) are the port's
copies of the JAX package's numpy modules: bit for bit equal to them after
N steps.  `solvers/hypersonic2d_cpu_native` builds the port's copy of
native/hypersonic2d_cpu.c and is bit for bit equal to the numpy path, as
tests/test_hypersonic2d_cpu.py:68 holds JAX's.  Then the
`hypersonic2d-cpu` and `regression` subcommands.
"""

import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import hypersonic2d_cpu as jcpu
from fluidsims_tpu.solvers import stam2d_cpu as jstam
from fluidsims_tpu_torch import cli
from fluidsims_tpu_torch import regression as treg
from fluidsims_tpu_torch.solvers import hypersonic2d_cpu as tcpu
from fluidsims_tpu_torch.solvers import hypersonic2d_cpu_native as hn
from fluidsims_tpu_torch.solvers import stam2d_cpu as tstam

torch.set_num_threads(1)


@pytest.mark.parametrize("w, h, steps", [(48, 24, 10), (40, 40, 25),
                                         (33, 21, 7)])
def test_hypersonic2d_cpu_bitwise_to_jax(w, h, steps):
    jsim = jcpu.HypersonicCPU(jcpu.HypersonicCPUConfig(w=w, h=h))
    tsim = tcpu.HypersonicCPU(tcpu.HypersonicCPUConfig(w=w, h=h))
    np.testing.assert_array_equal(tsim.mask, jsim.mask)
    np.testing.assert_array_equal(tsim.U, jsim.U)
    for _ in range(steps):
        jsim.step()
        tsim.step()
    np.testing.assert_array_equal(tsim.U, jsim.U)
    assert tsim.t == jsim.t > 0


def test_hypersonic2d_cpu_config_validation():
    with pytest.raises(ValueError):
        tcpu.HypersonicCPUConfig(w=16, h=16, gamma=1.0)
    assert tcpu.HypersonicCPUConfig().asdict() == \
        jcpu.HypersonicCPUConfig().asdict()


def test_slip_wall_and_obstacle():
    """tests/test_hypersonic2d_cpu.py's checks on the port's copy."""
    sim = tcpu.HypersonicCPU(tcpu.HypersonicCPUConfig(w=60, h=60))
    c = sim._prim_to_cons(np.array([[1.0, 2.0, 3.0, 1.5]]))
    r = sim._cons_to_prim(sim._reflect_slip(c, 1.0, 0.0))[0]
    np.testing.assert_allclose(r[1:3], [-2.0, 3.0], rtol=1e-12)
    r = sim._cons_to_prim(sim._reflect_slip(c, 0.0, 1.0))[0]
    np.testing.assert_allclose(r[1:3], [2.0, -3.0], rtol=1e-12)
    assert sim.mask[30, 20] and not sim.mask[0, 0]


@pytest.mark.parametrize("n, steps", [(24, 3), (17, 2)])
def test_stam2d_cpu_bitwise_to_jax(n, steps):
    jsim = jstam.Stam2DCPU(jstam.Stam2DCPUConfig(n=n))
    tsim = tstam.Stam2DCPU(tstam.Stam2DCPUConfig(n=n))
    for _ in range(steps):
        jsim.step()
        tsim.step()
    for f in ("u", "v", "u0", "v0", "d", "d0"):
        np.testing.assert_array_equal(getattr(tsim, f), getattr(jsim, f))
    assert tsim.step_idx == jsim.step_idx == steps
    assert np.isfinite(tsim.d).all() and tsim.d.max() > 0


@pytest.mark.parametrize("w, h, steps", [(72, 48, 25), (31, 17, 9)])
def test_native_build_bitwise_to_numpy(w, h, steps):
    assert hn.native_available()
    cfg = tcpu.HypersonicCPUConfig(w=w, h=h)
    py = tcpu.HypersonicCPU(cfg)
    with hn.HypersonicCPUNative(cfg) as nat:
        U0, m0, t0 = nat.state
        np.testing.assert_array_equal(U0, py.U)
        np.testing.assert_array_equal(m0, py.mask)
        assert t0 == 0.0
        for _ in range(steps):
            py.step()
        nat.step(steps)
        U, mask, t = nat.state
        np.testing.assert_array_equal(U, py.U)
        assert t == py.t
        # set_state, then the same steps again from there
        nat.set_state(U0, 0.0)
        nat.step(steps)
        np.testing.assert_array_equal(nat.U, py.U)


def test_native_library_lands_in_build():
    from pathlib import Path

    import ctypes

    lib = hn._load()
    assert isinstance(lib, ctypes.CDLL)
    path = Path(lib._name)
    assert path.parent.name == "fluidsims_tpu_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libhypersonic2d_cpu_")


# ---------------------------------- CLI -------------------------------------


@pytest.mark.parametrize("native", [False, True])
def test_cli_hypersonic2d_cpu(capsys, native):
    argv = ["hypersonic2d-cpu", "--nx", "24", "--ny", "24", "--steps", "3"]
    assert cli.main(argv + (["--native"] if native else [])) == 0
    out = capsys.readouterr().out
    assert f"hypersonic2d-cpu[{'native' if native else 'numpy'}]: 3 steps" \
        in out
    assert "rho range [" in out


def test_cli_hypersonic2d_cpu_matches_jax_lines(capsys):
    from fluidsims_tpu.cli import main as jmain

    argv = ["hypersonic2d-cpu", "--nx", "30", "--ny", "20", "--steps", "4"]
    jmain(argv)
    jout = capsys.readouterr().out.splitlines()
    cli.main(argv + ["--native"])
    tout = capsys.readouterr().out.splitlines()
    assert tout[-1] == jout[-1]          # t and the rho range


def test_cli_hypersonic2d_cpu_interactive_warns(capsys):
    assert cli.main(["hypersonic2d-cpu", "--nx", "24", "--ny", "24",
                     "--steps", "1", "--interactive"]) == 0
    assert "no effect" in capsys.readouterr().err


def test_cli_regression_write_then_verify(tmp_path, capsys):
    base = ["regression", "--device", "cpu", "--nx", "64", "--ny", "32",
            "--steps", "4", "--baseline", str(tmp_path / "b.txt")]
    with pytest.raises(SystemExit) as e:
        cli.main(base + ["--write-baseline"])
    assert e.value.code == 0
    assert treg.read_snapshot(tmp_path / "b.txt")["steps"] == 4
    with pytest.raises(SystemExit) as e:
        cli.main(base)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "regression hypersonic2d 64x32 steps=4 device=cpu" in out
    assert "Passed: 12\nFailed: 0" in out
    # a baseline of another run fails the gate
    snap = treg.read_snapshot(tmp_path / "b.txt")
    snap["sum_rho"] *= 1.0 + 1e-6
    treg.write_snapshot(tmp_path / "b.txt", snap)
    with pytest.raises(SystemExit) as e:
        cli.main(base)
    assert e.value.code == 1
    assert "FAIL: sum_rho" in capsys.readouterr().out


def test_cli_regression_defaults():
    args = cli.build_parser().parse_args(["regression"])
    assert (args.nx, args.ny, args.steps, args.baseline, args.device,
            args.write_baseline) == (2048, 1024, 24,
                                     "hypersonic2d_baseline.txt", "cuda",
                                     False)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["regression", "--write-baseline",
                                       "--verify-baseline"])
