"""Port vs JAX: the render layer (colormaps, terminal renderers, the PNG
writer, the flagship's view modes, its BC-aware neighbour sampler and the
live stream's frame function).

The numpy copies (colormap, terminal, PNG) must give JAX's bytes.  The
views run in torch on a state that JAX stepped 20 times and
interop.state_from_numpy carried over: the values within 1e-12 relative
at f64 and 5e-4 at f32 (the scaling of tests/test_hypersonic2d.py), the
mask identical, `render_rgba` identical at f64 and within one level at
f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.io import fourspl as jfourspl
from fluidsims_tpu.io import png as jpng
from fluidsims_tpu.render import colormap as jcm
from fluidsims_tpu.render import terminal as jterm
from fluidsims_tpu.render import views as jviews
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu_torch import interop
from fluidsims_tpu_torch.io import png as tpng
from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
from fluidsims_tpu_torch.render import colormap as tcm
from fluidsims_tpu_torch.render import terminal as tterm
from fluidsims_tpu_torch.render import views as tviews
from fluidsims_tpu_torch.solvers import hypersonic2d as th2

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = {"float64": 1e-12, "float32": 5e-4}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


_STATES = {}


def carried(dtype):
    """(JAX cfg, JAX state, port cfg, port state): 64x32 after 20 JAX
    steps, carried over by interop."""
    if dtype not in _STATES:
        jc = jh2.default_config(nx=64, ny=32, dtype=dtype)
        tc = th2.default_config(nx=64, ny=32, dtype=dtype)
        s = jax.jit(lambda st: jh2.run(jc, st, 20))(jh2.init(jc))
        ts = interop.state_from_numpy(
            [np.asarray(f) for f in s.U], np.asarray(s.mask),
            np.asarray(s.t), dtype=getattr(torch, dtype), device=CPU)
        _STATES[dtype] = (jc, s, tc, ts)
    return _STATES[dtype]


# ------------------------------ numpy copies --------------------------------


def test_colormaps_byte_equal():
    t = np.concatenate([np.linspace(-0.2, 1.2, 997), [np.nan, 0.5, 1.0]])
    for name in ("jet", "mhd_cmap"):
        a = getattr(jcm, name)(t)
        b = getattr(tcm, name)(t)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    rgb = jcm.jet(t[:30].reshape(5, 6))
    np.testing.assert_array_equal(jcm.to_rgba(rgb, 7), tcm.to_rgba(rgb, 7))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_terminal_renderers_equal(seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((13, 21))
    for kw in ({}, {"normalize": False}, {"dither": True},
               {"ramp": jterm.RAMP_EIGHTHS, "dither": True}):
        assert tterm.render_ramp(f, **kw) == jterm.render_ramp(f, **kw)
    for kw in ({}, {"threshold": 0.3}, {"normalize": False}):
        assert (tterm.render_halfblocks(f, **kw)
                == jterm.render_halfblocks(f, **kw))
    bands = rng.integers(0, 257, (7, 9))
    assert tterm.render_palette256(bands) == jterm.render_palette256(bands)
    np.testing.assert_array_equal(tterm.autocontrast(f),
                                  jterm.autocontrast(f))
    np.testing.assert_array_equal(tterm.hash_dither(11, 17, 8),
                                  jterm.hash_dither(11, 17, 8))
    assert tterm.RAMP_BLOCKS == jterm.RAMP_BLOCKS
    assert tterm.RAMP_EIGHTHS == jterm.RAMP_EIGHTHS


@pytest.mark.parametrize("channels", [3, 4])
def test_png_bytes_equal(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (9, 14, channels), dtype=np.uint8)
    jpng.write_png(tmp_path / "j.png", img)
    tpng.write_png(tmp_path / "t.png", img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    with pytest.raises(ValueError):
        tpng.write_png(tmp_path / "bad.png", img[..., 0])


# ---------------------------------- views -----------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dy, dx", [(0, -1), (0, 1), (-1, 0), (1, 0),
                                    (0, -2), (2, 0)])
def test_neighbor_matches_jax(dtype, dy, dx):
    from fluidsims_tpu.ops import euler2d as je2
    from fluidsims_tpu_torch.ops import euler2d as te2

    jc, s, tc, ts = carried(dtype)
    jn = jh2._neighbor(jc, s.U, s.mask, je2.cons_to_prim(s.U, jc.gamma),
                       dy, dx)
    tn = th2._neighbor(tc, ts.U, ts.mask, te2.cons_to_prim(ts.U, tc.gamma),
                       dy, dx)
    for a, b in zip(jn, tn):
        assert rel(b.numpy(), a) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", tviews.VIEW_MODES)
def test_views_match_jax(dtype, mode):
    jc, s, tc, ts = carried(dtype)
    jv = jviews.render_value(jc, s, mode)
    tv = tviews.render_value(tc, ts, mode)
    assert tv.dtype == getattr(torch, dtype)
    assert rel(tv.numpy(), jv) <= TOL[dtype]
    # masked and non-finite cells are 0, as in JAX
    assert (tv.numpy()[np.asarray(s.mask)] == 0).all()
    jn = np.asarray(jviews.normalize_masked(jv, s.mask))
    tn = tviews.normalize_masked(tv, ts.mask).numpy()
    assert rel(tn, jn) <= TOL[dtype]
    t, solid = tviews.normalized_to_host(tc, ts, mode)
    np.testing.assert_array_equal(solid, np.asarray(s.mask))
    np.testing.assert_array_equal(t, tn)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", tviews.VIEW_MODES)
def test_render_rgba_matches_jax(dtype, mode):
    jc, s, tc, ts = carried(dtype)
    a = jviews.render_rgba(jc, s, mode)
    b = tviews.render_rgba(tc, ts, mode)
    assert a.shape == b.shape == (32, 64, 4) and b.dtype == np.uint8
    diff = np.abs(a.astype(int) - b.astype(int))
    if dtype == "float64":
        np.testing.assert_array_equal(a, b)
    else:
        assert diff.max() <= 1
    solid = np.asarray(s.mask)
    assert (b[solid] == np.array([110, 110, 110, 255])).all()


def test_unknown_view_raises():
    _, _, tc, ts = carried("float64")
    with pytest.raises(ValueError, match="unknown view mode"):
        tviews.render_value(tc, ts, "nope")


def _jax_stream_frame(cfg, st, mode, serve_max):
    """JAX's `hypersonic2d --serve` frame body (fluidsims_tpu/cli.py) after
    its run, on a JAX state."""
    fy = max(1, -(-cfg.ny // serve_max))
    fx = max(1, -(-cfg.nx // serve_max))
    hc, wc = cfg.ny // fy, cfg.nx // fx
    v = jviews.render_value(cfg, st, mode)
    t = jviews.normalize_masked(v, st.mask)
    t = jnp.where(st.mask, 0.0, jnp.clip(t, 0.0, 1.0))
    t = t[: hc * fy, : wc * fx].reshape(hc, fy, wc, fx).mean((1, 3))
    return np.asarray(jfourspl.quantize_frame_device(t[::-1][None],
                                                     gamma=0.65))


@pytest.mark.parametrize("mode", ["schlieren", "log_rho", "mach"])
@pytest.mark.parametrize("serve_max", [64, 16, 7])
def test_stream_frame_matches_jax(mode, serve_max):
    jc, s, tc, ts = carried("float64")
    frame_fn, (wc, hc) = tviews.stream_frame_fn(
        tc, lambda st, n: st, mode, 4, serve_max)
    out, q = frame_fn(ts)
    assert out is ts and q.dtype == torch.uint8
    assert tuple(q.shape) == (1, hc, wc)
    ref = _jax_stream_frame(jc, s, mode, serve_max)
    assert ref.shape == (1, hc, wc)
    np.testing.assert_array_equal(q.numpy(), ref)


def test_stream_frame_runs_the_given_steps():
    _, _, tc, ts = carried("float64")
    calls = []

    def run(st, n):
        calls.append(n)
        return th2.run(tc, st, n,
                       core=functools.partial(hk.step_core_plain, tc),
                       wavespeed=functools.partial(hk.inflow_wavespeed_plain,
                                                   tc))

    frame_fn, _ = tviews.stream_frame_fn(tc, run, "schlieren", 3, 32)
    out, _ = frame_fn(ts)
    assert calls == [3]
    assert float(out.t) > float(ts.t)
