"""th3cs's per-frame exporter (solvers/th3cs.Exporter, video_exporter) on
the CPU at n = 12: its frames and its file are those of the benchmark's
plain reference (portbench/reference/th3cs-sphere.py, loaded from its
file), the streamed and the batch exports still write the same bytes (no
frames: an empty finished video), the exporter keeps its window and
finishes its video, the benchmark's program over several videos leaves
one finished `.4spl` at the path, and each frame's four `fst.th3cs.*`
spans are recorded."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import struct
import zlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidsims_tpu_torch.io import fourspl
from fluidsims_tpu_torch.io.live4spl import Stream4splWriter
from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from fluidsims_tpu_torch.solvers import th3cs

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N = 12
SPF = 2
SPANS = ("fst.th3cs.vis", "fst.th3cs.quantize", "fst.th3cs.collect",
         "fst.th3cs.write")


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "th3cs_test_" + path.stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case():
    """(the port's 3-D config, its seeded perturbed state, the reference
    and the reference's state) of configuration th3cs-sphere at n = 12."""
    torch.set_num_threads(1)
    conf = json.loads((ROOT / "portbench/configs/th3cs-sphere.json")
                      .read_text())
    traffic = {"n": N, "dtype": "float32", "steps_per_frame": SPF}
    ref = _load("portbench/reference/th3cs-sphere.py").Reference(
        conf, traffic, CPU)
    g = torch.Generator().manual_seed(2**31 + 11)
    noise = [torch.randn(ref.noise_shape, generator=g)
             for _ in range(ref.noise_fields)]
    # the configuration file's physics: its keys that the config shares
    physics = {f.name: conf[f.name]
               for f in dataclasses.fields(h3.Hypersonic3DConfig)
               if f.name in conf}
    cfg = h3.Hypersonic3DConfig(nx=N, ny=N, nz=N, dx=1 / N, dy=1 / N,
                                dz=1 / N, dtype="float32", **physics)
    s = h3.init(cfg, CPU)
    fields = ref.perturb({k: getattr(s, k) for k in h3.Hypersonic3DState
                          ._fields if k != "solid"}, noise)
    return cfg, s._replace(**fields), ref, ref.init(torch.float32, noise)


def _video(indices) -> fourspl.Splat4DVideo:
    d, h, w = indices[0].shape
    return fourspl.Splat4DVideo(width=w, height=h, depth=d,
                                frames=len(indices),
                                palette=fourspl.heat_palette(256),
                                indices=np.stack(indices))


def _footer_ok(path) -> fourspl.Splat4DVideo:
    """The file's footer: the CRC-32 of its index bytes, their offset and
    the end sentinel; returns the video read back."""
    data = Path(path).read_bytes()
    crc, off, end = struct.unpack(fourspl.FOOTER_FMT, data[-16:])
    assert end == fourspl.END_SENTINEL and off == 32 + 256 * 48
    assert crc == zlib.crc32(data[off:-16]) & 0xFFFFFFFF
    return fourspl.read_4spl(path)


def test_exporter_frames_and_file_are_the_references(case, tmp_path):
    cfg, state, ref, want = case
    path = tmp_path / "th3cs.4spl"
    seen = []
    with th3cs.video_exporter(path, cfg, SPF, engine="torch", window=2,
                              on_frame=seen.append) as ex:
        vols = []
        for _ in range(3):
            state = ex.push(state)
            want = ref.frame(want, SPF, torch.float32)
            assert torch.equal(state.xi, want["xi"])
            vols.append(want["vol"].numpy())
    assert seen == [0, 1, 2] and ex.pushed == 3
    fourspl.write_4spl(tmp_path / "ref.4spl", _video(vols))
    assert path.read_bytes() == (tmp_path / "ref.4spl").read_bytes()
    assert _footer_ok(path).flags == 0x0004


def test_streamed_export_is_the_batch_export(tmp_path):
    cfg = h3.default_config(N)
    batch, stream = tmp_path / "batch.4spl", tmp_path / "stream.4spl"
    th3cs.export_4spl(batch, cfg, frames=5, steps_per_frame=1, device=CPU,
                      engine="torch")
    th3cs.export_4spl_streamed(stream, cfg, frames=5, steps_per_frame=1,
                               device=CPU, engine="torch")
    assert stream.read_bytes() == batch.read_bytes()


def test_streamed_export_of_no_frames_is_an_empty_finished_video(tmp_path):
    path = tmp_path / "none.4spl"
    th3cs.export_4spl_streamed(path, h3.default_config(N), frames=0,
                               device=CPU, engine="torch")
    got = _footer_ok(path)
    assert (got.frames, got.width, got.p_size) == (0, N, 256)


def test_exporter_keeps_its_window_and_finishes_its_video(tmp_path):
    path = tmp_path / "v.4spl"
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (3, 4, 5), dtype=np.uint8)
              for _ in range(5)]
    done = []

    def frame_fn(k):
        return k + 1, torch.from_numpy(frames[k])

    ex = th3cs.Exporter(frame_fn, Stream4splWriter(path, 5, 4, 3),
                        window=3, on_frame=done.append)
    k = 0
    for _ in range(4):
        k = ex.push(k)
    # the window holds the last two frames pushed
    assert done == [0, 1] and ex.pushed == 4
    ex.flush()
    assert done == [0, 1, 2, 3]
    k = ex.push(k)
    ex.close()
    assert done == [0, 1, 2, 3, 4]
    assert path.read_bytes() == _write(tmp_path, frames)
    # an exception inside the export finishes the video, the frames in
    # flight dropped
    with pytest.raises(RuntimeError):
        with th3cs.Exporter(frame_fn, Stream4splWriter(path, 5, 4, 3),
                            window=2) as ex:
            k = 0
            for _ in range(4):
                k = ex.push(k)
            raise RuntimeError("stop")
    assert _footer_ok(path).frames == 3
    with pytest.raises(ValueError, match="window"):
        th3cs.Exporter(frame_fn, [], window=0)


def test_videos_end_to_end_leave_one_finished_file(case, tmp_path,
                                                   monkeypatch):
    """The benchmark's program (portbench/adapters/th3cs-sphere.py) over
    2.5 videos of 2 frames: each frame read back from the file is the
    reference's, each finished video is moved aside and removed on the
    program's thread, and the last video closed is the one file left."""
    cfg, state, ref, want = case
    adapter = _load("portbench/adapters/th3cs-sphere.py")
    monkeypatch.setattr(adapter, "CACHE", tmp_path)
    conf = json.loads((ROOT / "portbench/configs/th3cs-sphere.json")
                      .read_text())
    conf["export"] = dict(conf["export"], frames_per_video=2)
    traffic = {"n": N, "dtype": "float32", "steps_per_frame": SPF}
    prog = adapter.Program(conf, traffic, CPU, ref)
    prog.solid = state.solid
    s = adapter.State(state, None)
    for i in range(5):
        s = prog.run(s, SPF)
        want = ref.frame(want, SPF, torch.float32)
        assert s.frame == i % 2
        assert torch.equal(prog.fields(s)["vol"], want["vol"]), i
    prog.exporter.close()
    got = _footer_ok(prog.path)
    assert got.frames == 1
    np.testing.assert_array_equal(got.indices[0], want["vol"].numpy())
    assert prog.videos == 2
    prog.remover.join()
    assert list(tmp_path.glob("th3cs-*/*")) == [prog.path]


def _write(tmp_path, frames) -> bytes:
    out = tmp_path / "want.4spl"
    fourspl.write_4spl(out, _video(frames))
    return out.read_bytes()


def test_each_frame_records_the_four_spans(case, tmp_path):
    cfg, state, _, _ = case
    ex = th3cs.video_exporter(tmp_path / "s.4spl", cfg, SPF, engine="torch",
                              window=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            state = ex.push(state)
        ex.close()
    ev = [e for e in prof.events() if e.name.startswith("fst.th3cs.")]
    # write: three frames and the video's footer
    assert Counter(e.name for e in ev) == dict(
        {n: 3 for n in SPANS}, **{"fst.th3cs.write": 4})
    # the schlieren and its quantization follow a frame's steps; collect
    # and write are apart, one after the other
    for e in ev:
        assert e.cpu_parent is None or not e.cpu_parent.name.startswith(
            "fst.th3cs."), e.name
    order = [e.name for e in sorted(ev, key=lambda e: e.time_range.start)]
    assert order[:2] == ["fst.th3cs.vis", "fst.th3cs.quantize"]
    assert order[-3:] == ["fst.th3cs.collect", "fst.th3cs.write",
                          "fst.th3cs.write"]
