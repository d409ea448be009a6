"""Port vs JAX: the `.4spl` container, the quantizers and the th3cs export.

The port keeps its own copy of the container (fluidsims_tpu_torch.io.
fourspl): its writer gives the JAX writer's bytes, its reader round-trips
them, its torch quantizer is byte-identical to JAX's on the shapes and
exact-threshold values of tests/test_fourspl.py, and a small th3cs export
matches JAX's in everything but at most one index step on at most 0.1% of
voxels (f32 arithmetic differs across compilers).
"""

import struct

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.io import fourspl as jf
from fluidsims_tpu.solvers import hypersonic3d as jh
from fluidsims_tpu.solvers import th3cs as jth3cs
from fluidsims_tpu_torch.io import fourspl as tf
from fluidsims_tpu_torch.solvers import hypersonic3d as th
from fluidsims_tpu_torch.solvers import th3cs as tth3cs

torch.set_num_threads(1)
CPU = torch.device("cpu")


def tiny(mod, frames=3, d=4, h=5, w=6, seed=0):
    rng = np.random.default_rng(seed)
    return mod.Splat4DVideo(
        width=w, height=h, depth=d, frames=frames,
        palette=mod.heat_palette(256),
        indices=rng.integers(0, 256, (frames, d, h, w), dtype=np.uint8),
    )


def test_constants_and_palette_match():
    assert (tf.MAGIC, tf.FLAG_F32_PRECISION, tf.END_SENTINEL) == \
        (jf.MAGIC, jf.FLAG_F32_PRECISION, jf.END_SENTINEL)
    for p in (2, 16, 256):
        np.testing.assert_array_equal(tf.heat_palette(p), jf.heat_palette(p))
    np.testing.assert_array_equal(tf.gamma_thresholds(0.65),
                                  jf.gamma_thresholds(0.65))


@pytest.mark.parametrize("seed", [0, 3])
def test_writer_bytes_match_jax_and_roundtrip(tmp_path, seed):
    tv, jv = tiny(tf, seed=seed), tiny(jf, seed=seed)
    pt, pj = tmp_path / "t.4spl", tmp_path / "j.4spl"
    tf.write_4spl(pt, tv)
    jf.write_4spl(pj, jv)
    assert pt.read_bytes() == pj.read_bytes()
    r = tf.read_4spl(pt)
    assert (r.width, r.height, r.depth, r.frames, r.p_size, r.flags) == \
        (6, 5, 4, 3, 256, tf.FLAG_F32_PRECISION)
    np.testing.assert_array_equal(r.indices, tv.indices)
    np.testing.assert_array_equal(r.palette, tv.palette)
    np.testing.assert_array_equal(r.colors(), tv.palette[:, 8:12])
    data = pt.read_bytes()
    _, idxoffset, end = struct.unpack("<IQI", data[-16:])
    assert idxoffset == 32 + 256 * 48 and end == tf.END_SENTINEL


def test_reader_rejects_bad_magic_and_writer_bad_shape(tmp_path):
    p = tmp_path / "bad.4spl"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        tf.read_4spl(p)
    v = tiny(tf)
    v.indices = v.indices[:, :, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        tf.write_4spl(tmp_path / "x.4spl", v)


def test_quantize_device_matches_jax_and_host_bytes():
    rng = np.random.default_rng(7)
    for shape in ((16, 16, 16), (8, 32, 8)):
        vol = (rng.random(shape, dtype=np.float32) * rng.uniform(0.1, 50)
               + rng.uniform(-5, 5)).astype(np.float32)
        host = tf.quantize_frame(vol, gamma=0.65)
        np.testing.assert_array_equal(host, jf.quantize_frame(vol, 0.65))
        dev = tf.quantize_frame_device(torch.from_numpy(vol), 0.65)
        assert dev.dtype == torch.uint8
        jdev = np.asarray(jax.jit(
            lambda v: jf.quantize_frame_device(v, 0.65))(vol))
        np.testing.assert_array_equal(dev.numpy(), jdev)
        np.testing.assert_array_equal(dev.numpy(), host)
    # exact-boundary values: v_norm landing on representable thresholds
    tau = tf.gamma_thresholds(0.65)
    vol = np.concatenate([tau, tau, np.array([0.0, 1.0], np.float32)])
    vol = vol.reshape(1, 16, -1)
    jdev = np.asarray(jax.jit(lambda v: jf.quantize_frame_device(v, 0.65))(vol))
    dev = tf.quantize_frame_device(torch.from_numpy(vol), 0.65).numpy()
    np.testing.assert_array_equal(dev, jdev)
    np.testing.assert_array_equal(dev, tf.quantize_frame(vol, 0.65))
    # a float64 field quantizes as its float32 rounding does
    v64 = np.linspace(-1.0, 3.0, 300).reshape(3, 10, 10)
    np.testing.assert_array_equal(
        tf.quantize_frame_device(torch.from_numpy(v64)).numpy(),
        tf.quantize_frame(v64.astype(np.float32)))


def test_quantize_frame_gamma():
    f = np.linspace(0.0, 1.0, 256).reshape(16, 16)
    q = tf.quantize_frame(f, gamma=0.65)
    assert q.dtype == np.uint8 and q.min() == 0 and q.max() == 255
    assert q[8, 0] > 127


def test_export_matches_jax(tmp_path):
    cfg_j = jh.default_config(12)
    pj, pt = tmp_path / "j.4spl", tmp_path / "t.4spl"
    jv = jth3cs.export_4spl(pj, cfg_j, frames=2, steps_per_frame=1,
                            use_native=False, impl="xla")
    cfg_t = th.default_config(12)
    tv = tth3cs.export_4spl(pt, cfg_t, frames=2, steps_per_frame=1,
                            device=CPU, engine="torch")
    bj, bt = pj.read_bytes(), pt.read_bytes()
    assert len(bj) == len(bt) == 32 + 256 * 48 + 2 * 12 ** 3 + 16
    assert bt[:32 + 256 * 48] == bj[:32 + 256 * 48]       # header, palette
    assert bt[-12:] == bj[-12:]                           # offset, sentinel
    d = np.abs(tv.indices.astype(int) - jv.indices.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    r = tf.read_4spl(pt)
    np.testing.assert_array_equal(r.indices, tv.indices)
    assert len(np.unique(r.indices[-1])) > 1


def test_export_cuda_engine_needs_a_gpu(tmp_path):
    with pytest.raises(ValueError, match="CUDA device"):
        tth3cs.export_4spl(tmp_path / "x.4spl", th.default_config(8),
                           frames=1, steps_per_frame=1, device=CPU,
                           engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        tth3cs.make_frame_fn(th.default_config(8), 1, engine="xla")


def test_stream_frames_keeps_order():
    seen = []

    class W:
        def append(self, v):
            seen.append(int(v[0]))

    def frame_fn(s):
        return s + 1, torch.tensor([s + 1], dtype=torch.uint8)

    calls = []
    out = tth3cs.stream_frames(frame_fn, 0, 7, W(),
                               on_frame=lambda i, n: calls.append((i, n)),
                               window=3)
    assert out == 7 and seen == list(range(1, 8))
    assert calls == [(i, 7) for i in range(7)]
