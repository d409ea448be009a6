"""Terminal renderers: unicode ramps, half-blocks, auto-contrast + dither
(a NumPy copy of fluidsims_tpu.render.terminal).

Behavioral spec across the reference demos:
  * block ramp ' ░▒▓█' (js_cuda.cu:257, tau_lbm.cu:210, sim.c:188)
  * vertical-eighth ramp with mean±2σ auto-contrast and hash dither
    (tau_shallow_water.cu:550-639, tau_burgers.cu:528-651)
  * half-block double-vertical-resolution mode ▀▄█
    (tau_gray_scott.cu:208-235, tau_sph.cu:87-88)

Pure NumPy → strings on host arrays; no curses dependency.  The CLI's
frame functions copy a field to the host once a frame and hand it here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RAMP_BLOCKS", "RAMP_EIGHTHS", "render_ramp", "render_halfblocks",
           "render_palette256", "autocontrast", "hash_dither"]

RAMP_BLOCKS = " ░▒▓█"
RAMP_EIGHTHS = " ▁▂▃▄▅▆▇█"


def render_palette256(bands: np.ndarray, levels: int = 256,
                      num_pairs: int = 240) -> str:
    """256-color dynamic-palette renderer (init_colors_dynamic /
    band_to_pair / show_iso, js_cuda3d.cu:471-532).

    `bands` holds integer intensity bands in [0, levels]; each nonzero
    band maps linearly onto `num_pairs` xterm-256 palette slots spread
    over color indices 16..231 (the reference's init_pair table) and is
    drawn with the ' ░▒▓█' ramp character for its intensity.  Band 0 is
    the unstyled background, exactly like pair 0.
    """
    b = np.asarray(bands).astype(np.int64)
    # band_to_pair (js_cuda3d.cu:505-517)
    pair = 1 + (b - 1) * (num_pairs - 1) // max(1, levels - 1)
    pair = np.clip(pair, 1, num_pairs)
    # init_colors_dynamic COLORS>=256 branch (:487-492)
    cidx = 16 + np.rint((pair - 1) * (231 - 16)
                        / max(1, num_pairs - 1)).astype(np.int64)
    ramp_i = np.clip(b * (len(RAMP_BLOCKS) - 1) // max(1, levels), 0,
                     len(RAMP_BLOCKS) - 1)

    lines = []
    for row in range(b.shape[0]):
        parts = []
        for col in range(b.shape[1]):
            if b[row, col] == 0:
                parts.append("\x1b[0m ")
            else:
                parts.append(f"\x1b[38;5;{cidx[row, col]}m"
                             f"{RAMP_BLOCKS[ramp_i[row, col]]}")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def autocontrast(field: np.ndarray):
    """mean ± 2σ normalization (tau_shallow_water.cu:588-599)."""
    mean = field.mean()
    sd = field.std()
    lo, hi = mean - 2.0 * sd, mean + 2.0 * sd
    inv = 1.0 / (hi - lo) if hi > lo else 1.0
    return (field - lo) * inv


def hash_dither(h: int, w: int, levels: int) -> np.ndarray:
    """Per-pixel hash dither (hashpx, tau_burgers.cu:536-542)."""
    j, i = np.meshgrid(np.arange(h, dtype=np.uint32),
                       np.arange(w, dtype=np.uint32), indexing="ij")
    hsh = np.uint32(1469598103) ^ (j * np.uint32(1315423911)
                                   + i * np.uint32(2654435761))
    hsh ^= hsh >> np.uint32(13)
    hsh *= np.uint32(0x5BD1E995)
    hsh ^= hsh >> np.uint32(15)
    return ((hsh & np.uint32(0xFFFF)).astype(np.float64) / 65535.0 - 0.5) * (
        0.5 / levels
    )


def render_ramp(field: np.ndarray, ramp: str = RAMP_BLOCKS,
                normalize: bool = True, dither: bool = False) -> str:
    """Field -> multiline string through a character ramp."""
    f = np.asarray(field, np.float64)
    if normalize:
        mn, mx = f.min(), f.max()
        f = (f - mn) / max(mx - mn, 1e-30)
    if dither:
        f = f + hash_dither(*f.shape, len(ramp) - 1)
    idx = np.clip((f * (len(ramp) - 1) + 0.5).astype(int), 0, len(ramp) - 1)
    return "\n".join("".join(ramp[k] for k in row) for row in idx)


def render_halfblocks(field: np.ndarray, threshold: float = 0.5,
                      normalize: bool = True) -> str:
    """Double vertical resolution via ▀▄█ (tau_gray_scott.cu:208-235):
    each text row shows two field rows."""
    f = np.asarray(field, np.float64)
    if normalize:
        mn, mx = f.min(), f.max()
        f = (f - mn) / max(mx - mn, 1e-30)
    h = f.shape[0] // 2
    top = f[0:2 * h:2] > threshold
    bot = f[1:2 * h:2] > threshold
    chars = np.where(top & bot, "█",
                     np.where(top, "▀", np.where(bot, "▄", " ")))
    return "\n".join("".join(row) for row in chars)
