"""Port vs JAX: the n-body layout's host side, its native Barnes–Hut engine
(solvers/nbody_native.py over the port's copy of nbody_bh.c), its point
renderer (render/points.py), the interactive loop (core/interactive.py)
and the `nbody` subcommand of the port's CLI, all on the CPU.

The native engine built from the port's copy gives JAX's engine's bits on
one state at one thread count; theta=0 is the exact pairwise sum of
tests/test_nbody_native.py's NumPy step (1e-10).  The renderers give the
JAX copy's strings on the same positions.
"""

import io

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.render import points as jrp
from fluidsims_tpu.solvers import nbody_graph as jng
from fluidsims_tpu.solvers import nbody_native as jnn
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.core import interactive as ti
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.render import points as trp
from fluidsims_tpu_torch.solvers import nbody_graph as tng
from fluidsims_tpu_torch.solvers import nbody_native as tnn

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def native():
    if not tnn.native_available():
        pytest.skip("no C compiler")
    return tnn


def _rand_state(n, dims, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, dims)) * 50.0
    pos[0] = 0.0
    return pos, rng.normal(size=(n, dims))


def _numpy_step(cfg, edges, pos, vel):
    """tests/test_nbody_native.py's independent dense NumPy step."""
    f = np.zeros_like(pos)
    src, dst = edges[:, 0], edges[:, 1]
    d = pos[dst] - pos[src]
    d2 = (d * d).sum(-1) + cfg.softening
    inv = 1.0 / np.sqrt(d2)
    fm = cfg.spring_k * (d2 * inv - cfg.link_length) * inv
    np.add.at(f, src[src != 0], (fm[:, None] * d)[src != 0])
    np.add.at(f, dst[dst != 0], (-fm[:, None] * d)[dst != 0])
    dd = pos[:, None, :] - pos[None, :, :]
    dd2 = (dd * dd).sum(-1) + cfg.softening
    iv = 1.0 / np.sqrt(dd2)
    fm2 = cfg.repulsion / dd2 * iv
    np.fill_diagonal(fm2, 0.0)
    f += (fm2[..., None] * dd).sum(1)
    v = (vel + f * cfg.dt) * cfg.damping
    sp = np.sqrt((v * v).sum(-1, keepdims=True))
    v = np.where(sp > cfg.max_speed,
                 v * cfg.max_speed / np.maximum(sp, 1e-30), v)
    v[0] = 0.0
    p = pos + v * cfg.dt
    p[0] = 0.0
    return p, v


# ----------------------------- the native engine -----------------------------


def test_builds_from_the_ports_copy_into_build(native):
    lib = native._load()
    src = native.source_path()
    assert src.parent.name == "native"
    assert src.parent.parent.name == "fluidsims_tpu_torch"
    assert src.read_bytes().count(b"bh_create") >= 1
    path = lib._name
    assert str(_build.build_dir()) in path and "native" not in path


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("theta", [0.0, 0.75])
def test_bhengine_bitwise_to_jax(native, dims, theta):
    if not jnn.native_available():
        pytest.skip("no C compiler for the JAX package's engine")
    tc = tng.GraphLayoutConfig(max_number=300, dims=dims, dtype="float64")
    jc = jng.GraphLayoutConfig(max_number=300, dims=dims, dtype="float64")
    edges = tng.generate_edges(300)
    pos, vel = _rand_state(300, dims, seed=dims)
    with native.BHEngine(tc, edges, n_threads=3, theta=theta) as eng:
        eng.set_state(pos, vel)
        eng.run(4)
        got = eng.get_state()
    with jnn.BHEngine(jc, edges, n_threads=3, theta=theta) as eng:
        eng.set_state(pos, vel)
        eng.run(4)
        ref = eng.get_state()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dims", [2, 3])
def test_theta0_matches_exact_pairwise(native, dims):
    cfg = tng.GraphLayoutConfig(max_number=180, dims=dims, dtype="float64")
    edges = tng.generate_edges(cfg.max_number)
    pos, _ = _rand_state(cfg.n_bodies, dims)
    vel = np.zeros_like(pos)
    with native.BHEngine(cfg, edges, n_threads=2, theta=0.0) as eng:
        eng.set_state(pos, vel)
        eng.run(3)
        p, v = eng.get_state()
    pr, vr = pos.copy(), vel.copy()
    for _ in range(3):
        pr, vr = _numpy_step(cfg, edges, pr, vr)
    assert np.abs(p - pr).max() < 1e-10
    assert np.abs(v - vr).max() < 1e-10


def test_theta0_matches_the_ports_f64_step(native):
    """theta=0 is the exact engine: 3 native steps against 3 steps of the
    port's `step` (plain repulsion, sorted-incidence springs) in f64."""
    cfg = tng.GraphLayoutConfig(max_number=200, dtype="float64")
    s = tng.init(cfg, CPU)
    pos, vel = _rand_state(200, 2, seed=5)
    s = s._replace(pos=torch.tensor(pos), vel=torch.tensor(vel))
    out = native.run_native(cfg, s, 3, n_threads=2, theta=0.0)
    ref = tng.run(cfg, s, 3)
    assert np.abs(out.pos.numpy() - ref.pos.numpy()).max() < 1e-10
    assert np.abs(out.vel.numpy() - ref.vel.numpy()).max() < 1e-10


def test_run_native_returns_port_state(native):
    cfg = tng.GraphLayoutConfig(max_number=150, dims=3, dtype="float32")
    s = tng.init(cfg, CPU)
    out = native.run_native(cfg, s, 10, n_threads=2, theta=0.75)
    assert isinstance(out, tng.GraphLayoutState)
    assert isinstance(out.pos, torch.Tensor) and out.pos.device == CPU
    assert out.pos.dtype == torch.float32 == out.vel.dtype
    assert int(out.steps) == 10 and out.edges is s.edges
    p = out.pos.numpy()
    assert np.isfinite(p).all()
    assert np.abs(p[0]).max() == 0.0        # root pinned
    assert np.sqrt((p[1:] ** 2).sum(-1)).mean() < 20.0 * np.sqrt(150)
    # the same as JAX's run_native from the same state
    if jnn.native_available():
        jc = jng.GraphLayoutConfig(max_number=150, dims=3, dtype="float32")
        ref = jnn.run_native(jc, jng.init(jc), 10, n_threads=2, theta=0.75)
        np.testing.assert_array_equal(p, np.asarray(ref.pos))


def test_set_state_checks_shape(native):
    cfg = tng.GraphLayoutConfig(max_number=20)
    with native.BHEngine(cfg, tng.generate_edges(20), n_threads=1) as eng:
        with pytest.raises(ValueError, match="pos and vel"):
            eng.set_state(np.zeros((19, 2)), np.zeros((19, 2)))


# -------------------------------- rendering ----------------------------------


def _layout(dims, n=512, seed=0):
    jc = jng.GraphLayoutConfig(max_number=n, dims=dims)
    pos = np.asarray(jax.jit(lambda s: jng.run(jc, s, 15))(jng.init(jc)).pos)
    rng = np.random.default_rng(seed)
    return pos + rng.normal(size=pos.shape).astype(pos.dtype)


@pytest.mark.parametrize("scheme", list(jrp.SCHEMES))
@pytest.mark.parametrize("color", [True, False])
def test_render_points_same_string(scheme, color):
    assert trp.SCHEMES == jrp.SCHEMES
    np.testing.assert_array_equal(trp.PALETTE16, jrp.PALETTE16)
    pos = _layout(2)
    assert (trp.render_points(pos, 40, 20, scheme=scheme, color=color)
            == jrp.render_points(pos, 40, 20, scheme=scheme, color=color))
    cam_t = trp.camera_fit(pos, 40, 20)
    cam_j = jrp.camera_fit(pos, 40, 20)
    assert (cam_t.tx, cam_t.ty, cam_t.zoom) == (cam_j.tx, cam_j.ty,
                                                cam_j.zoom)
    # a panned, zoomed camera (into the disc tier of the zoom LOD)
    for zoom in (0.9, 3.0, 20.0):
        ct = trp.Camera2D(tx=50.0, ty=-30.0, zoom=zoom)
        cj = jrp.Camera2D(tx=50.0, ty=-30.0, zoom=zoom)
        assert (trp.render_points(pos, 40, 20, scheme=scheme, color=color,
                                  camera=ct)
                == jrp.render_points(pos, 40, 20, scheme=scheme,
                                     color=color, camera=cj))


@pytest.mark.parametrize("scheme", list(jrp.SCHEMES))
def test_render_points_3d_same_string(scheme):
    pos = _layout(3)
    assert (trp.render_points_3d(pos, 40, 20, scheme=scheme)
            == jrp.render_points_3d(pos, 40, 20, scheme=scheme))
    ct, cj = trp.fit_orbit(pos), jrp.fit_orbit(pos)
    for cam in (ct, cj):
        cam.yaw += 0.4
        cam.pitch = -0.3
        cam.distance *= 0.7
    assert (trp.render_points_3d(pos, 40, 20, scheme=scheme, color=False,
                                 camera=ct)
            == jrp.render_points_3d(pos, 40, 20, scheme=scheme, color=False,
                                    camera=cj))


def test_zoom_lod_offsets():
    for zoom in (0.5, 1.0, 2.0, 4.9, 5.0, 20.0, 100.0):
        assert trp._splat_offsets(zoom) == jrp._splat_offsets(zoom)
    assert len(trp._splat_offsets(20.0)) > 4


# ----------------------------- interactive loop ------------------------------


def test_interactive_loop_scripted():
    """The copy's loop: scripted keys, a bounded run, a rebuild on
    invalidate, quit."""
    keys_seen = []
    built = []

    def make_runner():
        built.append(1)
        return lambda st, n: st + n

    def nudge(ctx):
        keys_seen.append("n")
        ctx.invalidate()

    script = iter(["", "n", "p", "", " ", "p", "", "q"])
    out = io.StringIO()
    final = ti.interactive_loop(
        0, make_runner, lambda st: f"state {st}", {"n": ("nudge", nudge),
                                                   "p": ("pause", lambda c:
                                                         setattr(c, "paused",
                                                                 not c.paused)),
                                                   " ": ("step", lambda c:
                                                         setattr(c,
                                                                 "step_once",
                                                                 True))},
        stride=2, input_fn=lambda: next(script, "q"), out=out, fps_cap=0)
    assert keys_seen == ["n"] and len(built) == 2
    # frames 1, 2 advance; 3 paused; 4 paused; 5 single step; 6-7 run
    assert final == 2 * 5
    assert "[q]uit [n]nudge [p]pause [spc]step" in out.getvalue()
    assert "[PAUSED]" in out.getvalue()


@pytest.mark.parametrize("dims", [2, 3])
def test_nbody_live_view_scripted_keys(capsys, dims):
    """`nbody`'s live view under a scripted key source, headless: camera,
    colour, stride and reset keys, then quit."""
    args = cli.build_parser().parse_args(
        ["nbody", "--device", "cpu", "--max-number", "256", "--dims",
         str(dims), "--interactive", "--cols", "40", "--rows", "12",
         "--steps", "0"])
    moves = "hjkl" if dims == 2 else "adws"
    script = iter(["", "z", "c", moves, "+", "x", "-", "b", "r", "", "q"])
    args.input_fn = lambda: next(script, "q")
    final = cli.cmd_nbody(args)
    out = capsys.readouterr().out
    assert isinstance(final, tng.GraphLayoutState)
    assert "256 nodes 1009 edges" in out
    assert "stride=2" in out and "[index]" in out
    assert ("zoom=" in out) if dims == 2 else ("pitch=" in out)
    assert "[b]reset" in out


def test_nbody_live_render_stride(capsys):
    """--render --stride N --steps M animates for M steps, as JAX's CLI."""
    cli.main(["nbody", "--device", "cpu", "--max-number", "512", "--steps",
              "4", "--stride", "2", "--render", "--cols", "40", "--rows",
              "12"])
    out = capsys.readouterr().out
    assert "step 4" in out
    assert "[r]refit" in out and "[h]pan-l" in out and "zoom=" in out


def test_nbody_live_native(capsys, native):
    args = cli.build_parser().parse_args(
        ["nbody", "--device", "cpu", "--max-number", "200", "--native",
         "--threads", "2", "--render", "--stride", "3", "--steps", "6",
         "--cols", "30", "--rows", "8", "--no-color"])
    args.input_fn = lambda: ""
    final = cli.cmd_nbody(args)
    assert isinstance(final, np.ndarray) and final.shape == (200, 2)
    assert "step 6" in capsys.readouterr().out


# ----------------------------------- CLI -------------------------------------


def _jax_lines(argv):
    """JAX's report lines for the same flags (its CLI, on the CPU)."""
    from fluidsims_tpu.cli import main as jmain
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        jmain(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("extra", [["--headless"], ["--native"],
                                   ["--render", "--cols", "40", "--rows",
                                    "10"],
                                   ["--engine", "grid", "--dims", "3",
                                    "--grid-res", "8", "--dtype",
                                    "float64"]])
def test_cli_nbody(capsys, extra):
    if "--native" in extra and not tnn.native_available():
        pytest.skip("no C compiler")
    argv = ["nbody", "--max-number", "256", "--steps", "2", *extra]
    assert cli.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    ref = _jax_lines(argv)
    assert out[0].startswith("nbody engine=")
    assert out[1].startswith("nbody: 2 steps, 256 nodes, 1009 edges -> ")
    assert out[1].endswith(" steps/s")
    assert ref[0].startswith("nbody: 2 steps, 256 nodes, 1009 edges -> ")
    # the extent line and any frame are JAX's, to the printed digits
    assert out[2:] == ref[1:]


def test_cli_nbody_needs_a_gpu_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["nbody", "--max-number", "64", "--steps", "1"])


def test_interop_state_renders_like_jax():
    jc = jng.GraphLayoutConfig(max_number=300)
    sj = jng.init(jc)
    st = interop.nbody_state_from_numpy(*(np.asarray(f) for f in sj),
                                        dtype=torch.float32, device=CPU)
    assert (trp.render_points(st.pos.numpy(), 30, 10)
            == jrp.render_points(np.asarray(sj.pos), 30, 10))
