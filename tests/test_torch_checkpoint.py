"""Port vs JAX: checkpoints (core/checkpoint), the metrics and the frame
loop (core/metrics, core/stepper.frame_loop), and the CLI's resume.

The round trip for each of the 13 solver state classes; JAX's error cases
(tests/test_core_utils.py:28-50); a file that the JAX package saved loads
into the port with the leaves `interop` would give, and a file the port
saved loads into the JAX package; `--save-state`/`--load-state` through
the CLI: 8 steps straight equal 4 + 4 bit for bit on the CPU, as
tests/test_core_utils.py:93-110 holds JAX's.
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.core import checkpoint as jckpt
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.core import checkpoint as ckpt
from fluidsims_tpu_torch.core.clock import TauClock
from fluidsims_tpu_torch.core.metrics import Throughput, device_timer, trace
from fluidsims_tpu_torch.core.stepper import frame_loop, run_steps
from fluidsims_tpu_torch.solvers import (burgers, flip_apic, gray_scott,
                                         hypersonic2d, hypersonic3d, lbm, mhd,
                                         mpm, nbody_graph, shallow_water, sph,
                                         stam2d, stam3d)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (module, config factory, state class name) for each solver state class
SOLVERS = {
    "burgers": (burgers, lambda m: m.BurgersConfig(nx=16, ny=12),
                "BurgersState"),
    "flip": (flip_apic, lambda m: m.FlipApicConfig(particles=64, grid=16),
             "FlipApicState"),
    "gray_scott": (gray_scott, lambda m: m.GrayScottConfig(nx=16, ny=8),
                   "GrayScottState"),
    "hypersonic2d": (hypersonic2d,
                     lambda m: m.default_config(nx=32, ny=16),
                     "Hypersonic2DState"),
    "hypersonic3d": (hypersonic3d, lambda m: m.default_config(8),
                     "Hypersonic3DState"),
    "lbm": (lbm, lambda m: m.LBMConfig(nx=16, ny=16, obstacle_radius=3.0),
            "LBMState"),
    "mhd": (mhd, lambda m: m.MHDConfig(nx=16, ny=12), "MHDState"),
    "mpm": (mpm, lambda m: m.MPMConfig(n=64, gx=16, gy=16), "MPMState"),
    "nbody": (nbody_graph, lambda m: m.GraphLayoutConfig(max_number=64),
              "GraphLayoutState"),
    "shallow_water": (shallow_water,
                      lambda m: m.ShallowWaterConfig(nx=16, ny=12),
                      "ShallowWaterState"),
    "sph": (sph, lambda m: m.SPHConfig(n=64), "SPHState"),
    "stam2d": (stam2d, lambda m: m.Stam2DConfig(n=16), "Stam2DState"),
    "stam3d": (stam3d, lambda m: m.Stam3DConfig(n=8), "Stam3DState"),
}


def leaves_equal(a, b) -> None:
    la, lb = ckpt.flatten(a), ckpt.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_roundtrip_and_resume(tmp_path, name):
    mod, make, cls = SOLVERS[name]
    cfg = make(mod)
    s0 = mod.init(cfg, CPU)
    assert type(s0).__name__ == cls
    s2 = mod.run(cfg, s0, 2)
    p = tmp_path / "s.npz"
    ckpt.save_state(p, s2)
    with np.load(p) as data:
        assert bytes(data["__state_class__"]).decode() == cls
        assert (json.loads(bytes(data["__treedef__"]).decode())
                == ckpt.structure(s2))
        assert f"leaf_{len(ckpt.flatten(s2))}" not in data
    restored = ckpt.load_state(p, s0)
    assert type(restored) is type(s2)
    leaves_equal(restored, s2)
    # resuming from the checkpoint continues bit for bit
    leaves_equal(mod.run(cfg, restored, 2), mod.run(cfg, s2, 2))


def test_flatten_is_depth_first_like_jax():
    cfg = hypersonic2d.default_config(nx=16, ny=8)
    s = hypersonic2d.init(cfg, CPU)
    assert ckpt.structure(s) == ("Hypersonic2DState(U=Cons(rho=*, mx=*, "
                                 "my=*, E=*), mask=*, t=*)")
    leaves = ckpt.flatten(s)
    assert all(x is y for x, y in zip(leaves, [*s.U, s.mask, s.t]))
    assert len(leaves) == 6
    m = mhd.init(mhd.MHDConfig(nx=8, ny=8), CPU)
    assert ckpt.flatten(m)[-1] is m.t
    assert len(ckpt.flatten(m)) == len(m.U) + 1
    assert ckpt.unflatten(m, ckpt.flatten(m)) == m
    with pytest.raises(ValueError, match="more leaves"):
        ckpt.unflatten(m, ckpt.flatten(m) + [m.t])


def test_restore_casts_to_the_template(tmp_path):
    """Each leaf takes the template leaf's dtype (and device)."""
    cfg64 = gray_scott.GrayScottConfig(nx=16, ny=8, dtype="float64")
    cfg32 = gray_scott.GrayScottConfig(nx=16, ny=8)
    s64 = gray_scott.run(cfg64, gray_scott.init(cfg64, CPU), 3)
    ckpt.save_state(tmp_path / "g.npz", s64)
    r = ckpt.load_state(tmp_path / "g.npz", gray_scott.init(cfg32, CPU))
    assert r.u.dtype == torch.float32 and r.u.device == CPU
    assert torch.equal(r.v, s64.v.to(torch.float32))


def test_rejects_mismatched_state(tmp_path):
    """JAX's error cases: other leaf shapes, another structure with as
    many leaves, another solver's state."""
    cfg = gray_scott.GrayScottConfig(nx=32, ny=16)
    s = gray_scott.init(cfg, CPU)
    p = tmp_path / "state.npz"
    ckpt.save_state(p, s)
    other = gray_scott.init(gray_scott.GrayScottConfig(nx=16, ny=16), CPU)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(p, other)
    z = torch.zeros(())
    with pytest.raises(ValueError, match="refusing"):
        ckpt.load_state(p, TauClock(t=z, tau=z, dtau=z))
    sw = shallow_water.init(shallow_water.ShallowWaterConfig(nx=32, ny=16),
                            CPU)
    with pytest.raises(ValueError, match="GrayScottState"):
        ckpt.load_state(p, sw)


def test_leaf_count_checks(tmp_path):
    s = gray_scott.init(gray_scott.GrayScottConfig(nx=8, ny=8), CPU)
    few = tmp_path / "few.npz"
    np.savez(few, leaf_0=s.u.numpy())
    with pytest.raises(ValueError, match="1 leaves but the template"):
        ckpt.load_state(few, s)
    many = tmp_path / "many.npz"
    np.savez(many, leaf_0=s.u.numpy(), leaf_1=s.v.numpy(),
             leaf_2=s.v.numpy())
    with pytest.raises(ValueError, match="more leaves"):
        ckpt.load_state(many, s)


def test_legacy_file_structure_mismatch(tmp_path):
    """A file without __state_class__ whose structure string differs is an
    error unless strict=False (the CLI's --load-lenient), which warns."""
    s = gray_scott.init(gray_scott.GrayScottConfig(nx=8, ny=8), CPU)
    p = tmp_path / "legacy.npz"
    np.savez(p, leaf_0=s.u.numpy() + 1, leaf_1=s.v.numpy(),
             __treedef__=np.frombuffer(json.dumps("Other(a=*, b=*)").encode(),
                                       np.uint8))
    with pytest.raises(ValueError, match="strict=False"):
        ckpt.load_state(p, s)
    with pytest.warns(UserWarning, match="structure string differs"):
        r = ckpt.load_state(p, s, strict=False)
    assert torch.equal(r.u, s.u + 1)


# --------------------------- across the packages ----------------------------


def _jax_module(name):
    import importlib

    mod = {"flip": "flip_apic", "nbody": "nbody_graph"}.get(name, name)
    return importlib.import_module(f"fluidsims_tpu.solvers.{mod}")


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_jax_file_loads_into_the_port(tmp_path, name):
    mod, make, cls = SOLVERS[name]
    jmod = _jax_module(name)
    js = jmod.init(make(jmod))
    p = tmp_path / "j.npz"
    jckpt.save_state(p, js)
    with pytest.warns(UserWarning, match="structure string differs"):
        r = ckpt.load_state(p, mod.init(make(mod), CPU))
    assert type(r).__name__ == cls
    jl = jax.tree_util.tree_leaves(js)
    tl = ckpt.flatten(r)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_array_equal(b.numpy().astype(a.dtype), a)


def test_jax_file_equals_the_interop_conversion(tmp_path):
    """The flagship, Gray–Scott (f64) and MHD (nested ConsM) files of the
    JAX package load into the states `interop` builds from the same
    arrays."""
    from fluidsims_tpu.solvers import gray_scott as jgs
    from fluidsims_tpu.solvers import hypersonic2d as jh2
    from fluidsims_tpu.solvers import mhd as jmhd

    jc = jh2.default_config(nx=32, ny=16, dtype="float64")
    js = jh2.run(jc, jh2.init(jc), 3)
    jckpt.save_state(tmp_path / "h.npz", js)
    tc = hypersonic2d.default_config(nx=32, ny=16, dtype="float64")
    with pytest.warns(UserWarning):
        r = ckpt.load_state(tmp_path / "h.npz", hypersonic2d.init(tc, CPU))
    ref = interop.state_from_numpy([np.asarray(f) for f in js.U],
                                   np.asarray(js.mask), np.asarray(js.t),
                                   dtype=torch.float64, device=CPU)
    leaves_equal(r, ref)

    gc = jgs.GrayScottConfig(nx=16, ny=8, dtype="float64")
    gs_ = jgs.run(gc, jgs.init(gc), 4)
    jckpt.save_state(tmp_path / "g.npz", gs_)
    with pytest.warns(UserWarning):
        r = ckpt.load_state(tmp_path / "g.npz", gray_scott.init(
            gray_scott.GrayScottConfig(nx=16, ny=8, dtype="float64"), CPU))
    leaves_equal(r, interop.gs_state_from_numpy(
        np.asarray(gs_.u), np.asarray(gs_.v), dtype=torch.float64,
        device=CPU))

    mc = jmhd.MHDConfig(nx=16, ny=12, dtype="float64")
    ms = jmhd.run(mc, jmhd.init(mc), 2)
    jckpt.save_state(tmp_path / "m.npz", ms)
    with pytest.warns(UserWarning):
        r = ckpt.load_state(tmp_path / "m.npz", mhd.init(
            mhd.MHDConfig(nx=16, ny=12, dtype="float64"), CPU))
    leaves_equal(r, interop.mhd_state_from_numpy(
        [np.asarray(f) for f in ms.U], np.asarray(ms.t),
        dtype=torch.float64, device=CPU))


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_port_file_loads_into_jax(tmp_path, name):
    mod, make, cls = SOLVERS[name]
    jmod = _jax_module(name)
    s = mod.run(make(mod), mod.init(make(mod), CPU), 1)
    p = tmp_path / "t.npz"
    ckpt.save_state(p, s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the structure strings differ
        r = jckpt.load_state(p, jmod.init(make(jmod)))
    assert type(r).__name__ == cls
    for a, b in zip(jax.tree_util.tree_leaves(r), ckpt.flatten(s)):
        np.testing.assert_array_equal(np.asarray(a),
                                      b.numpy().astype(np.asarray(a).dtype))


# ---------------------------------- CLI -------------------------------------

RESUME_CASES = {
    "hypersonic2d": ["--nx", "64", "--ny", "32", "--impl", "torch"],
    "hypersonic3d": ["--n", "12", "--impl", "torch"],
    "gray-scott": ["--nx", "32", "--ny", "16"],
    "lbm": ["--nx", "32", "--ny", "16", "--radius", "4"],
    "burgers": ["--nx", "32", "--ny", "24"],
    "shallow-water": ["--nx", "32", "--ny", "24"],
    "mhd": ["--nx", "32", "--ny", "24", "--case", "orszag-tang"],
    "stam2d": ["--n", "16"],
    "stam3d": ["--n", "12"],
    "sph": ["--n", "256", "--engine", "torch"],
    "flip": ["--particles", "256", "--grid", "16", "--engine", "scatter"],
    "mpm": ["--n", "256", "--gx", "32", "--gy", "32", "--engine", "scatter"],
    "nbody": ["--max-number", "128"],
}


@pytest.mark.parametrize("cmd", sorted(RESUME_CASES))
def test_cli_resume_bitwise(tmp_path, capsys, cmd):
    """8 steps straight == 4 steps, --save-state, --load-state, 4 more."""
    full, mid, end = (tmp_path / f"{k}.npz" for k in ("full", "mid", "end"))
    base = [cmd, *RESUME_CASES[cmd], "--device", "cpu", "--headless"]
    assert cli.main(base + ["--steps", "8", "--save-state", str(full)]) == 0
    assert cli.main(base + ["--steps", "4", "--save-state", str(mid)]) == 0
    assert cli.main(base + ["--steps", "4", "--load-state", str(mid),
                            "--save-state", str(end)]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {mid}" in out and f"saved state to {end}" in out
    with np.load(full) as a, np.load(end) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A checkpoint of JAX's CLI resumes through the port's: JAX 4 steps +
    port 4 steps against JAX 8 steps, within the f64 bar."""
    from fluidsims_tpu.cli import main as jmain

    mid, jend, tend = (tmp_path / f"{k}.npz" for k in ("m", "j", "t"))
    args = ["hypersonic2d", "--nx", "64", "--ny", "32", "--dtype", "float64",
            "--headless"]
    jmain(args + ["--impl", "xla", "--steps", "4", "--save-state", str(mid)])
    jmain(args + ["--impl", "xla", "--steps", "8", "--save-state",
                  str(jend)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(args + ["--impl", "torch", "--device", "cpu", "--steps", "4",
                         "--load-state", str(mid), "--save-state",
                         str(tend)])
    capsys.readouterr()
    with np.load(jend) as a, np.load(tend) as b:
        for i in range(6):
            x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
            assert x.dtype == y.dtype and x.shape == y.shape
            scale = np.maximum(np.abs(x.astype(np.float64)), 1.0)
            assert np.max(np.abs(x.astype(np.float64) - y) / scale) <= 1e-10


def test_cli_load_lenient_flag(tmp_path, capsys):
    s = gray_scott.init(gray_scott.GrayScottConfig(nx=16, ny=8), CPU)
    p = tmp_path / "legacy.npz"
    np.savez(p, leaf_0=s.u.numpy(), leaf_1=s.v.numpy(),
             __treedef__=np.frombuffer(json.dumps("X").encode(), np.uint8))
    argv = ["gray-scott", "--nx", "16", "--ny", "8", "--device", "cpu",
            "--steps", "1", "--load-state", str(p)]
    with pytest.raises(ValueError, match="legacy checkpoint"):
        cli.main(argv)
    with pytest.warns(UserWarning):
        assert cli.main(argv + ["--load-lenient"]) == 0
    assert "resumed from" in capsys.readouterr().out


# ------------------------- metrics and the frame loop -----------------------


def test_ema_and_throughput():
    # Throughput alone: the port has no EMA (the JAX package's is
    # tested in tests/test_core_utils.py)
    tp = Throughput(cells=100, particles=7)
    tp.tick(3)
    tp.tick()
    rep = tp.report()
    assert rep["steps"] == 4 and rep["wall_s"] > 0
    assert rep["mlups"] == pytest.approx(100 * 4 / rep["wall_s"] / 1e6)
    assert rep["particle_steps_per_sec"] == pytest.approx(
        7 * 4 / rep["wall_s"])


def test_device_timer_and_trace(tmp_path):
    held = {}
    with device_timer(held, device=CPU):
        torch.ones(64).sum()
    assert held["wall_s"] >= 0
    with device_timer(held, "other"):
        pass
    assert "other" in held
    with trace(tmp_path / "tr") as d:
        assert d == tmp_path / "tr"
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {ev.get("name", "") for ev in data["traceEvents"]}
    assert any("mm" in n for n in names)


def test_frame_loop_matches_run_steps():
    cfg = gray_scott.GrayScottConfig(nx=16, ny=8)
    s = gray_scott.init(cfg, CPU)
    seen = []

    def step(st):
        return gray_scott.step(cfg, st)

    out = frame_loop(step, s, 3, 4,
                     on_frame=lambda f, st: seen.append((f, st.v.clone())))
    assert [f for f, _ in seen] == [0, 1, 2]
    ref = run_steps(step, s, 12)
    assert torch.equal(out.v, ref.v)
    assert torch.equal(seen[1][1], run_steps(step, s, 8).v)
    assert frame_loop(step, s, 0, 4) is s


def test_cli_nbody_native_has_no_checkpoint(tmp_path):
    """The native engine runs on the host; its layouts are not the
    device state a checkpoint holds."""
    with pytest.raises(SystemExit, match="--native runs on the host"):
        cli.main(["nbody", "--native", "--device", "cpu", "--max-number",
                  "64", "--steps", "1", "--save-state",
                  str(tmp_path / "n.npz")])
