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


@pytest.mark.parametrize("cmd, unit", [("gray-scott", "Mcell-steps/s"),
                                       ("lbm", "MLUPS")])
@pytest.mark.parametrize("engine", ["torch", "auto"])
def test_cli_stencils_cpu(capsys, cmd, unit, engine):
    extra = ["--radius", "4"] if cmd == "lbm" else []
    rc = cli.main([cmd, "--device", "cpu", "--engine", engine, "--nx", "32",
                   "--ny", "32", "--steps", "2", *extra])
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine=torch" in out and "steps/s" in out and unit in out


@pytest.mark.parametrize("cmd", ["gray-scott", "lbm"])
def test_cli_stencils_cuda_engine_needs_gpu(cmd):
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main([cmd, "--device", "cpu", "--engine", "cuda", "--nx", "32",
                  "--ny", "32", "--steps", "1"])
    with pytest.raises(SystemExit):
        cli.main([cmd, "--device", "cpu", "--engine", "xla"])


@pytest.mark.parametrize("argv", [
    ["burgers", "--nx", "32", "--ny", "24"],
    ["burgers", "--nx", "64", "--ny", "1", "--colehopf", "--dtau", "1e-3",
     "--muscl", "--visc_substeps", "2"],
    ["shallow-water", "--nx", "32", "--ny", "24"],
    ["mhd", "--nx", "32", "--ny", "24", "--case", "orszag-tang",
     "--stable-hll"]])
@pytest.mark.parametrize("engine", ["torch", "auto"])
def test_cli_resident_solvers_cpu(capsys, argv, engine):
    rc = cli.main([*argv, "--device", "cpu", "--engine", engine, "--steps",
                   "2", "--block-k", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine=torch" in out and "steps/s" in out
    assert "Mcell-steps/s" in out and "block_k=4" in out
    if argv[0] == "mhd":
        assert "t = " in out


@pytest.mark.parametrize("cmd", ["burgers", "shallow-water", "mhd"])
def test_cli_resident_solvers_cuda_engine_needs_gpu(cmd):
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main([cmd, "--device", "cpu", "--engine", "cuda", "--nx", "32",
                  "--ny", "24", "--steps", "1"])
    with pytest.raises(SystemExit):
        cli.main([cmd, "--device", "cpu", "--engine", "pallas"])


def test_cli_resident_defaults_follow_the_jax_cli():
    """--block-k defaults to 16 for all three, as fluidsims_tpu/cli.py has
    it (the shallow-water and MHD configs say 8)."""
    ap = cli.build_parser()
    for cmd in ("burgers", "shallow-water", "mhd"):
        assert ap.parse_args([cmd]).block_k == 16
    args = ap.parse_args(["mhd"])
    assert (args.nx, args.ny, args.case, args.steps) == (320, 220,
                                                         "briowu", 200)


@pytest.mark.parametrize("engine", ["torch", "auto"])
def test_cli_stam3d_cpu(capsys, engine):
    assert cli.main(["stam3d", "--device", "cpu", "--engine", engine, "--n",
                     "16", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "stam3d 16^3 float32 engine=torch advect_k=2" in out
    assert "steps/s" in out and "Mcell-steps/s" in out
    assert "advect capped:" in out


def test_cli_stam3d_cuda_engine_needs_gpu():
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main(["stam3d", "--device", "cpu", "--engine", "cuda", "--n",
                  "16", "--steps", "1"])
    with pytest.raises(SystemExit):
        cli.main(["stam3d", "--device", "cpu", "--engine", "pallas"])
    args = cli.build_parser().parse_args(["stam3d"])
    assert (args.n, args.steps, args.jacobi, args.advect_k) == (192, 20, 12, 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cli_stam2d_cpu(capsys, dtype):
    assert cli.main(["stam2d", "--device", "cpu", "--n", "16", "--steps", "2",
                     "--dtype", dtype]) == 0
    out = capsys.readouterr().out
    assert f"stam2d 16^2 {dtype} engine=torch" in out
    assert "steps/s" in out and "Mcell-steps/s" in out
    assert "advect_overflow_count: " in out and "advect_band=16" in out


def test_cli_stam2d_engines_and_defaults():
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main(["stam2d", "--device", "cpu", "--engine", "cuda", "--n",
                  "16", "--steps", "1"])
    for engine in ("pallas", "hybrid", "xla"):
        with pytest.raises(SystemExit):
            cli.main(["stam2d", "--device", "cpu", "--engine", engine])
    args = cli.build_parser().parse_args(["stam2d"])
    assert (args.n, args.steps, args.engine, args.advect_band, args.dtype,
            args.device) == (512, 100, "auto", 16, "float32", "cuda")


@pytest.mark.parametrize("engine", ["scatter", "dense", "auto"])
def test_cli_flip_cpu(capsys, engine):
    assert cli.main(["flip", "--device", "cpu", "--engine", engine,
                     "--particles", "256", "--grid", "32", "--steps",
                     "2"]) == 0
    out = capsys.readouterr().out
    ran = "dense" if engine == "auto" else engine
    assert f"flip-apic n=256 grid=32^2 float32 engine={ran}" in out
    assert "steps/s" in out and "M particle-steps/s" in out
    assert "occupied=" in out and "peak_cell=" in out
    assert "overflow: 0 particles beyond the cell capacity K=32" in out


def test_cli_flip_engines_overflow_and_defaults(capsys):
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.main(["flip", "--device", "cpu", "--engine", "cuda",
                  "--particles", "64", "--grid", "16", "--steps", "1"])
    with pytest.raises(SystemExit):
        cli.main(["flip", "--device", "cpu", "--engine", "pallas"])
    assert cli.main(["flip", "--device", "cpu", "--engine", "dense",
                     "--particles", "2048", "--grid", "16", "--bin-capacity",
                     "2", "--steps", "1", "--dtype", "float64"]) == 0
    captured = capsys.readouterr()
    dropped = int(captured.out.split("overflow: ")[1].split()[0])
    assert dropped > 0 and "WARNING" in captured.err
    args = cli.build_parser().parse_args(["flip"])
    assert (args.particles, args.grid, args.jacobi, args.dt, args.gravity,
            args.flip, args.apic, args.engine, args.bin_capacity, args.steps,
            args.dtype, args.device) == (
        65536, 128, 48, 0.004, 7.5, 0.97, 0.85, "auto", 0, 200, "float32",
        "cuda")
