"""Dependency-free PNG writer for frame export (a copy of
fluidsims_tpu.io.png).

The reference's raylib demos upload the colormapped field as an RGBA
texture every frame (tau_hypersonic_cuda.cu:1892-1933, tau_mhd.c:177-202);
a headless host has no window, so the equivalent export surface is a
PNG file per frame (CLI --png, numbered with --stride), built from the same view
-> normalize -> colormap pipeline.  Pure stdlib (zlib + struct).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png"]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 array as a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[-1] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {rgb.shape}")
    rgb = rgb.astype(np.uint8, copy=False)
    h, w, ch = rgb.shape
    color_type = 2 if ch == 3 else 6

    # filter byte 0 (None) per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * ch)], axis=1
    ).tobytes()

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
