"""Live-streaming `.4spl` writer + HTTP server for the web viewer (a copy
of fluidsims_tpu.io.live4spl on the port's io/fourspl).

The reference's interactive 3-D volume view is a raylib orbit-camera
window fed directly from device memory
(tau_hypersonic_3d_cuda.cu:1416-1497,1735-1758); a headless host has no
window, so the live path streams the running simulation to the web
viewer instead (SURVEY §7: "interactive = host-side viewer process
consuming streamed frames").

The `.4spl` container is already incremental — fixed-size uint8 frames
after the palette (io/fourspl.py) — so streaming is: write header (with
frames=0) + palette once, append each frame's index bytes as the solver
produces them, and patch the header's frame-count u32 (offset 20) after
every append.  A reader that catches the file mid-append clamps to the
complete frames present (the viewer does; `read_4spl_partial` here is
the tested host-side equivalent).  `finish()` writes the standard CRC32
footer, after which the file is byte-identical to a batch `write_4spl`.

`serve_dir` is a ThreadingHTTPServer with no-store cache headers so the
viewer's poll loop (viewer/index.html?live=1) always re-fetches the
growing file.
"""

from __future__ import annotations

import struct
import threading
import zlib
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import fourspl

__all__ = ["Stream4splWriter", "read_4spl_partial", "serve_dir"]


class Stream4splWriter:
    """Append-per-frame `.4spl` writer (header patched as frames land)."""

    _FRAMES_OFFSET = 20  # u32 frame count within the 32-byte header

    def __init__(self, path, width: int, height: int, depth: int,
                 palette: np.ndarray | None = None,
                 flags: int = fourspl.FLAG_F32_PRECISION):
        self.width, self.height, self.depth = width, height, depth
        self.palette = (palette if palette is not None
                        else fourspl.heat_palette())
        self.flags = flags
        self.frames = 0
        self._crc = 0
        self._f = open(path, "wb+")
        header = struct.pack(
            fourspl.HEADER_FMT, fourspl.MAGIC, *fourspl.VERSION,
            width, height, depth, 0, self.palette.shape[0], flags)
        self._f.write(header)
        self._f.write(np.ascontiguousarray(
            self.palette, np.float32).tobytes())
        self._idx_offset = self._f.tell()
        self._f.flush()

    def append(self, frame: np.ndarray) -> None:
        """Append one (depth, height, width) uint8 frame and publish it
        (header frame count patched + flushed)."""
        buf = np.ascontiguousarray(frame, np.uint8)
        assert buf.shape == (self.depth, self.height, self.width), buf.shape
        b = buf.tobytes()
        self._f.seek(0, 2)
        self._f.write(b)
        self._crc = zlib.crc32(b, self._crc)
        self.frames += 1
        self._f.seek(self._FRAMES_OFFSET)
        self._f.write(struct.pack("<I", self.frames))
        self._f.flush()

    def finish(self) -> None:
        """Write the footer; the file becomes identical to write_4spl."""
        self._f.seek(0, 2)
        self._f.write(struct.pack(fourspl.FOOTER_FMT,
                                  self._crc & 0xFFFFFFFF,
                                  self._idx_offset, fourspl.END_SENTINEL))
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._f.closed:
            self.finish()
        return False


def read_4spl_partial(path) -> fourspl.Splat4DVideo:
    """Read a possibly-still-growing stream: clamps the frame count to
    the complete frames actually present (the viewer's defense)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, v0, v1, v2, v3, w, h, d, frames, p_size, flags) = struct.unpack(
        fourspl.HEADER_FMT, data[:32])
    if magic != fourspl.MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x}")
    idx_off = 32 + p_size * 48
    per_frame = w * h * d
    avail = (len(data) - idx_off) // per_frame if per_frame else 0
    frames = max(0, min(frames, avail))
    pal = np.frombuffer(data, np.float32, count=p_size * 12,
                        offset=32).reshape(p_size, 12).copy()
    idx = np.frombuffer(data, np.uint8, count=frames * per_frame,
                        offset=idx_off).reshape(frames, d, h, w).copy()
    return fourspl.Splat4DVideo(width=w, height=h, depth=d, frames=frames,
                                palette=pal, indices=idx, flags=flags,
                                version=(v0, v1, v2, v3))


class _NoCacheHandler(SimpleHTTPRequestHandler):
    def end_headers(self):
        self.send_header("Cache-Control", "no-store, must-revalidate")
        self.send_header("Access-Control-Allow-Origin", "*")
        super().end_headers()

    def log_message(self, *args):  # quiet
        pass


def serve_dir(directory, port: int = 0):
    """Serve `directory` over HTTP with caching disabled; returns the
    running (server, thread) — call server.shutdown() to stop.  port=0
    picks a free port (server.server_address[1])."""

    def handler(*args, **kw):
        return _NoCacheHandler(*args, directory=str(directory), **kw)

    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t
