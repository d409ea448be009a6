"""The port's CLI and snapshot regression, on the CPU."""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu import regression as jreg
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch import regression as treg
from fluidsims_tpu_torch.solvers import hypersonic2d as th2

torch.set_num_threads(1)


def test_cli_cpu_torch_runs(capsys):
    rc = cli.main(["hypersonic2d", "--device", "cpu", "--impl", "torch",
                   "--nx", "64", "--ny", "32", "--steps", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "steps/s" in out and "Mcell-steps/s" in out and "t = " in out


def test_cli_cuda_without_card_raises():
    args = ["hypersonic2d", "--nx", "64", "--ny", "32", "--steps", "1"]
    if torch.cuda.is_available():
        assert cli.main(args) == 0
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args)                       # default --device cuda
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args + ["--impl", "torch"])


def test_cli_has_no_auto_engine_and_cuda_impl_needs_gpu():
    with pytest.raises(SystemExit):
        cli.main(["hypersonic2d", "--impl", "auto", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --device cuda"):
        cli.main(["hypersonic2d", "--impl", "cuda", "--device", "cpu",
                  "--nx", "64", "--ny", "32", "--steps", "1"])


def test_snapshot_write_then_verify(tmp_path, capsys):
    path = tmp_path / "baseline.txt"
    kw = dict(nx=64, ny=32, steps=6, baseline=str(path), device="cpu")
    assert treg.run_regression(write=True, **kw) == 0
    assert treg.read_snapshot(path)["steps"] == 6
    assert treg.run_regression(**kw) == 0
    assert "Failed: 0" in capsys.readouterr().out
    snap = treg.read_snapshot(path)
    snap["sum_E"] *= 1.0 + 1e-6
    assert treg.verify_snapshot(treg.read_snapshot(path), snap)


def test_snapshot_matches_jax_on_same_state():
    jcfg = jh2.default_config(nx=64, ny=32, dtype="float64")
    tcfg = th2.default_config(nx=64, ny=32, dtype="float64")
    s = jax.jit(lambda st: jh2.run(jcfg, st, 5))(jh2.init(jcfg))
    st = interop.state_from_numpy([np.asarray(f) for f in s.U],
                                  np.asarray(s.mask), np.asarray(s.t),
                                  dtype=torch.float64,
                                  device=torch.device("cpu"))
    assert treg.compute_snapshot(tcfg, st, 5) == jreg.compute_snapshot(jcfg, s, 5)
