"""`.4spl` palettized volume-video container (reader + writer).

The port's own copy of fluidsims_tpu.io.fourspl (numpy), with the on-device
quantizer on torch tensors.  The format is reimplemented from the extern "C"
declarations of the reference (th3cs.cu:21-63) and the viewer's parser
(viewer.html:67-96):

  header  (32 B): u32 magic, u8 version[4], u32 width, height, depth,
                  frames, pSize, flags   (little-endian; w at offset 8)
  palette (pSize * 48 B): 12 f32 per entry —
                  mu_x, sigma_x, mu_y, sigma_y, mu_z, sigma_z,
                  mu_t, sigma_t, r, g, b, alpha
  indices (width*height*depth*frames B): one palette byte per voxel,
                  frame-major, voxel order (z*height + y)*width + x
  footer  (16 B): u32 checksum, u64 idxoffset, u32 end

The footer's checksum is CRC32 of the index bytes; `end` is the sentinel
0x4C505334 ("4SPL").
"""

from __future__ import annotations

import functools
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["MAGIC", "FLAG_F32_PRECISION", "Splat4DVideo", "heat_palette",
           "write_4spl", "read_4spl", "gamma_thresholds", "quantize_frame",
           "quantize_frame_device"]

MAGIC = 0x4C505334          # "4SPL" little-endian
VERSION = (1, 0, 0, 0)
END_SENTINEL = 0x4C505334
FLAG_F32_PRECISION = 0x04   # th3cs.cu:1226 ("Float32 Precision")
HEADER_FMT = "<I4BIIIIII"   # 32 bytes
FOOTER_FMT = "<IQI"


@dataclass
class Splat4DVideo:
    width: int
    height: int
    depth: int
    frames: int
    palette: np.ndarray        # (pSize, 12) float32
    indices: np.ndarray        # (frames, depth, height, width) uint8
    flags: int = FLAG_F32_PRECISION
    version: tuple = VERSION

    @property
    def p_size(self) -> int:
        return self.palette.shape[0]

    def colors(self) -> np.ndarray:
        """(pSize, 4) rgba from the palette records."""
        return self.palette[:, 8:12]


def heat_palette(p_size: int = 256) -> np.ndarray:
    """Thermal palette black->red->yellow->white (th3cs.cu:1144-1150), as
    (pSize, 12) Splat4D records with unit sigmas."""
    t = np.arange(p_size) / (p_size - 1.0)
    r = np.minimum(1.0, t * 2.5)
    g = np.clip(t * 2.5 - 0.5, 0.0, 1.0)
    b = np.clip(t * 2.5 - 1.5, 0.0, 1.0)
    pal = np.zeros((p_size, 12), np.float32)
    pal[:, 1] = pal[:, 3] = pal[:, 5] = pal[:, 7] = 1.0  # sigmas
    pal[:, 8] = r
    pal[:, 9] = g
    pal[:, 10] = b
    pal[:, 11] = 1.0
    return pal


def write_4spl(path, video: Splat4DVideo) -> None:
    idx = np.ascontiguousarray(video.indices, dtype=np.uint8)
    shape = (video.frames, video.depth, video.height, video.width)
    if idx.shape != shape:
        raise ValueError(f"indices have shape {idx.shape}, header says {shape}")
    pal = np.ascontiguousarray(video.palette, dtype=np.float32)

    header = struct.pack(
        HEADER_FMT, MAGIC, *video.version,
        video.width, video.height, video.depth, video.frames,
        video.p_size, video.flags,
    )
    idx_bytes = idx.tobytes()
    idxoffset = len(header) + pal.nbytes
    footer = struct.pack(
        FOOTER_FMT, zlib.crc32(idx_bytes) & 0xFFFFFFFF, idxoffset,
        END_SENTINEL,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(pal.tobytes())
        f.write(idx_bytes)
        f.write(footer)


def read_4spl(path) -> Splat4DVideo:
    with open(path, "rb") as f:
        data = f.read()
    (magic, v0, v1, v2, v3, w, h, d, frames, p_size, flags) = struct.unpack(
        HEADER_FMT, data[:32]
    )
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x}")
    pal = np.frombuffer(data, np.float32, count=p_size * 12, offset=32)
    pal = pal.reshape(p_size, 12).copy()
    idx_off = 32 + p_size * 48
    n_vox = w * h * d * frames
    idx = np.frombuffer(data, np.uint8, count=n_vox, offset=idx_off)
    idx = idx.reshape(frames, d, h, w).copy()
    return Splat4DVideo(width=w, height=h, depth=d, frames=frames,
                        palette=pal, indices=idx, flags=flags,
                        version=(v0, v1, v2, v3))


def gamma_thresholds(gamma: float = 0.65, levels: int = 256) -> np.ndarray:
    """tau_k = (k/(levels-1))**(1/gamma) for k = 1..levels-1, computed in
    f64 and rounded once to f32.  index(v) = #{k : v_norm >= tau_k}
    reproduces trunc(v_norm**gamma * 255) up to one index at
    representation boundaries, with no pow or divide in the per-voxel
    path, which keeps the host and device quantizers byte-identical
    (sub, mul and compare round exactly on both)."""
    k = np.arange(1, levels, dtype=np.float64)
    return ((k / (levels - 1)) ** (1.0 / gamma)).astype(np.float32)


def quantize_frame(field: np.ndarray, gamma: float = 0.65) -> np.ndarray:
    """Per-frame min/max normalize + gamma + 8-bit quantize
    (th3cs.cu:1199-1222), as a threshold comparison (gamma_thresholds)."""
    f = np.asarray(field, np.float32)
    mn = f.min()
    rng = np.maximum(np.float32(f.max() - mn), np.float32(1e-12))
    ts = gamma_thresholds(gamma) * rng          # f32 multiplies
    idx = np.searchsorted(ts, (f - mn).ravel(), side="right")
    return idx.astype(np.uint8).reshape(f.shape)


@functools.lru_cache(maxsize=8)
def _thresholds_on(gamma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gamma_thresholds(gamma)).to(device)


def quantize_frame_device(field: torch.Tensor, gamma: float = 0.65):
    """quantize_frame on the tensor's device: byte-identical to the host
    version.  `searchsorted(ts, v, right=True)` counts the thresholds
    ts_k <= v, the count the host version takes, without the
    (voxels, 255) comparison block; only the uint8 indices need to cross
    to the host."""
    f = field.to(torch.float32)
    mn = torch.amin(f)
    rng = torch.clamp_min(torch.amax(f) - mn, 1e-12)
    ts = _thresholds_on(gamma, f.device) * rng
    idx = torch.searchsorted(ts, (f - mn).reshape(-1), right=True)
    return idx.to(torch.uint8).reshape(f.shape)
