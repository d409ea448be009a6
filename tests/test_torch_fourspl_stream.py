"""Port vs JAX: the live `.4spl` stream (io/live4spl), the native writer
(io/fourspl_native over the port's native/fourspl.c) and the `--serve`
subcommands.

The streamed file is byte-identical to the batch export and to the JAX
package's writers on the same frames, readable mid-write (a torn read
clamps to the complete frames), and served by `serve_dir` with caching
off, as tests/test_fourspl.py:124-210 holds JAX's; `th3cs --serve` and
`hypersonic2d --serve` stream to a polling client and exit cleanly on
SIGTERM, as tests/test_cli_smoke.py's twins.  Every HTTP request goes to
127.0.0.1 with proxies off.
"""

import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fluidsims_tpu.io import fourspl as jfourspl
from fluidsims_tpu.io import live4spl as jlive
from fluidsims_tpu_torch.core import native
from fluidsims_tpu_torch.io import fourspl, fourspl_native
from fluidsims_tpu_torch.io.live4spl import (Stream4splWriter,
                                             read_4spl_partial, serve_dir)
from fluidsims_tpu_torch.solvers import hypersonic3d as h3
from fluidsims_tpu_torch.solvers import th3cs

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def video(seed, frames=3, d=4, h=5, w=6):
    rng = np.random.default_rng(seed)
    return fourspl.Splat4DVideo(
        width=w, height=h, depth=d, frames=frames,
        palette=fourspl.heat_palette(256),
        indices=rng.integers(0, 256, (frames, d, h, w), dtype=np.uint8))


def test_streamed_export_matches_batch_and_jax_writers(tmp_path):
    cfg = h3.default_config(12)
    batch, stream = tmp_path / "batch.4spl", tmp_path / "stream.4spl"
    vid = th3cs.export_4spl(batch, cfg, frames=3, steps_per_frame=2,
                            device=CPU, engine="torch")
    seen = []

    def on_frame(i, total):
        seen.append((i, total))
        part = read_4spl_partial(stream)
        assert part.frames == i + 1          # published immediately
        assert part.width == part.height == part.depth == 12
        np.testing.assert_array_equal(part.indices[i], vid.indices[i])

    th3cs.export_4spl_streamed(stream, cfg, frames=3, steps_per_frame=2,
                               device=CPU, engine="torch", on_frame=on_frame)
    assert seen == [(0, 3), (1, 3), (2, 3)]
    data = stream.read_bytes()
    assert data == batch.read_bytes()
    # the JAX package's writers give the same bytes for the same frames
    jfourspl.write_4spl(tmp_path / "j.4spl", vid)
    assert (tmp_path / "j.4spl").read_bytes() == data
    with jlive.Stream4splWriter(tmp_path / "js.4spl", 12, 12, 12,
                                jfourspl.heat_palette(256)) as w:
        for f in vid.indices:
            w.append(f)
    assert (tmp_path / "js.4spl").read_bytes() == data
    # and the Python writer of the port
    fourspl.write_4spl(tmp_path / "py.4spl", vid)
    assert (tmp_path / "py.4spl").read_bytes() == data

    # a torn read (mid-frame bytes) clamps to the complete frames
    torn = tmp_path / "torn.4spl"
    torn.write_bytes(data[: 32 + 256 * 48 + 2 * 12 ** 3 + 100])
    part = read_4spl_partial(torn)
    assert part.frames == 2
    np.testing.assert_array_equal(part.indices, vid.indices[:2])
    jpart = jlive.read_4spl_partial(torn)
    np.testing.assert_array_equal(part.indices, jpart.indices)


def test_writer_rejects_wrong_geometry_and_bad_magic(tmp_path):
    with Stream4splWriter(tmp_path / "w.4spl", 4, 4, 4) as w:
        w.append(np.zeros((4, 4, 4), np.uint8))
        with pytest.raises(AssertionError):
            w.append(np.zeros((5, 4, 4), np.uint8))
    assert read_4spl_partial(tmp_path / "w.4spl").frames == 1
    bad = tmp_path / "bad.4spl"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        read_4spl_partial(bad)


def test_serve_dir_serves_viewer_and_growing_stream(tmp_path):
    viewer = ROOT / "viewer" / "index.html"
    (tmp_path / "index.html").write_bytes(viewer.read_bytes())
    srv, _ = serve_dir(tmp_path, 0)
    try:
        port = srv.server_address[1]

        def get(name):
            with LOCAL.open(f"http://127.0.0.1:{port}/{name}",
                            timeout=10) as r:
                return r.status, dict(r.headers), r.read()

        st, hdr, body = get("index.html")
        assert st == 200 and b"live" in body
        assert "no-store" in hdr.get("Cache-Control", "")
        assert hdr.get("Access-Control-Allow-Origin") == "*"
        w = Stream4splWriter(tmp_path / "volume.4spl", 4, 4, 4)
        w.append(np.full((4, 4, 4), 7, np.uint8))
        st, _, body1 = get("volume.4spl")
        assert st == 200
        w.append(np.full((4, 4, 4), 9, np.uint8))
        st, _, body2 = get("volume.4spl")
        assert len(body2) == len(body1) + 64   # the new frame is visible
        w.finish()
        st, _, body3 = get("volume.4spl")
        assert len(body3) == len(body2) + 16   # and the footer
    finally:
        srv.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_writer_matches_python_and_jax(tmp_path, seed):
    assert fourspl_native.native_available()
    v = video(seed)
    fourspl_native.write_4spl_native(tmp_path / "n.4spl", v)
    fourspl.write_4spl(tmp_path / "p.4spl", v)
    jfourspl.write_4spl(tmp_path / "j.4spl", v)
    n = (tmp_path / "n.4spl").read_bytes()
    assert n == (tmp_path / "p.4spl").read_bytes()
    assert n == (tmp_path / "j.4spl").read_bytes()
    assert fourspl_native.write_4spl_best(tmp_path / "b.4spl", v) == "native"
    assert (tmp_path / "b.4spl").read_bytes() == n


def test_native_library_is_built_into_build_not_native(tmp_path):
    cc = shutil.which("cc")
    src = native.source_path("fourspl")
    assert src == ROOT / "fluidsims_tpu_torch" / "native" / "fourspl.c"
    lib = native.compile_c(cc, src, ("-O2",))
    assert lib.parent == ROOT / "build" / "fluidsims_tpu_torch"
    assert lib.name.startswith("libfourspl_") and lib.is_file()
    assert native.compile_c(cc, src, ("-O2",)) == lib
    assert native.compile_c(cc, src, ("-O1",)) != lib
    assert native.load_c("fourspl", (("-fno-such-flag-at-all",),)) is None


def test_fallback_to_the_python_writer_says_so(tmp_path, monkeypatch):
    monkeypatch.setattr(fourspl_native, "native_available", lambda: False)
    v = video(3)
    assert fourspl_native.write_4spl_best(tmp_path / "b.4spl", v) == "python"
    fourspl.write_4spl(tmp_path / "p.4spl", v)
    assert ((tmp_path / "b.4spl").read_bytes()
            == (tmp_path / "p.4spl").read_bytes())


def test_cli_th3cs_batch_export(tmp_path, capsys):
    from fluidsims_tpu_torch import cli

    out = tmp_path / "t.4spl"
    assert cli.main(["th3cs", "--device", "cpu", "--n", "12", "--frames",
                     "2", "--steps-per-frame", "1", "--out", str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    vid = fourspl.read_4spl(out)
    assert vid.frames == 2 and vid.indices.shape[1:] == (12, 12, 12)


def _serve(tmp_path, argv, want_frames=2, timeout=180.0):
    """Spawn `python -m fluidsims_tpu_torch.cli ARGV` (a --serve run), poll
    its stream over HTTP until `want_frames` complete frames show, then
    SIGTERM it.  Returns (exit code, stdout lines, frames seen)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidsims_tpu_torch.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=tmp_path)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=pump, daemon=True).start()
    frames = 0
    try:
        deadline = time.time() + timeout
        port = None
        while time.time() < deadline and port is None:
            for line in lines:
                m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
                if m:
                    port = int(m.group(1))
                    break
            if proc.poll() is not None:
                raise AssertionError(f"serve exited early rc="
                                     f"{proc.returncode}: " + "".join(lines))
            time.sleep(0.1)
        assert port is not None, "no live-viewer URL printed"
        snap = tmp_path / "snap.4spl"
        while time.time() < deadline and frames < want_frames:
            try:
                with LOCAL.open(f"http://127.0.0.1:{port}/volume.4spl",
                                timeout=5) as r:
                    snap.write_bytes(r.read())
                frames = read_4spl_partial(snap).frames
            except (urllib.error.URLError, ValueError, OSError):
                pass   # not created yet / torn header: poll again
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    return rc, lines, frames


def test_cli_th3cs_serve_end_to_end(tmp_path):
    out = tmp_path / "served.4spl"
    rc, lines, frames = _serve(tmp_path, [
        "th3cs", "--device", "cpu", "--n", "12", "--frames", "3",
        "--steps-per-frame", "1", "--serve", "--port", "0", "--out",
        str(out)])
    assert frames >= 2, f"only {frames} frames streamed"
    assert rc == 0, "".join(lines)
    assert any("engine=torch" in line for line in lines)
    vid = read_4spl_partial(out)   # the exported (possibly partial) stream
    assert vid.frames >= 2 and vid.indices.shape[1:] == (12, 12, 12)


def test_cli_hypersonic2d_serve_end_to_end(tmp_path):
    out = tmp_path / "h2.4spl"
    rc, lines, frames = _serve(tmp_path, [
        "hypersonic2d", "--device", "cpu", "--impl", "torch", "--nx", "64",
        "--ny", "32", "--serve", "--frames", "3", "--steps-per-frame", "1",
        "--serve-max", "32", "--port", "0", "--out", str(out)])
    assert frames >= 2, f"only {frames} frames streamed"
    assert rc == 0, "".join(lines)
    assert any("impl=torch" in line for line in lines)
    vid = read_4spl_partial(out)
    # depth-1 volume, y mean-pooled 32 -> 32, x 64 -> 32
    assert vid.frames >= 2 and vid.indices.shape[1:] == (1, 32, 32)
