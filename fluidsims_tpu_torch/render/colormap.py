"""Colormaps used by the reference renderers, vectorized (a NumPy copy of
fluidsims_tpu.render.colormap).

  * jet-like get_color (tau_hypersonic_cuda.cu:692-704, tau_hypersonic.c:676)
  * MHD cmap (tau_mhd.c:177)
  * thermal heat palette lives in io/fourspl.py (th3cs.cu:1144-1150)
"""

from __future__ import annotations

import numpy as np

__all__ = ["jet", "mhd_cmap", "to_rgba"]


def jet(t: np.ndarray) -> np.ndarray:
    """(…,) in [0,1] -> (…, 3) uint8, blue->green->red ramp."""
    t = np.clip(np.asarray(t, np.float64), 0.0, 1.0)
    r = 255.0 * np.clip(3.0 * t - 1.0, 0.0, 1.0)
    g = 255.0 * np.clip(2.0 - 4.0 * np.abs(t - 0.5), 0.0, 1.0)
    b = 255.0 * np.clip(2.0 - 3.0 * t, 0.0, 1.0)
    return np.stack([r, g, b], -1).astype(np.uint8)


def mhd_cmap(a: np.ndarray) -> np.ndarray:
    """tau_mhd.c:177 colormap."""
    a = np.clip(np.asarray(a, np.float64), 0.0, 1.0)
    r = 255.0 * np.clip(1.5 * a - 0.2, 0.0, 1.0)
    g = 255.0 * np.sin(np.pi * a)
    b = 255.0 * np.clip(1.2 - 1.4 * a, 0.0, 1.0)
    return np.stack([r, g, b], -1).astype(np.uint8)


def to_rgba(rgb: np.ndarray, alpha: int = 255) -> np.ndarray:
    a = np.full(rgb.shape[:-1] + (1,), alpha, np.uint8)
    return np.concatenate([rgb, a], -1)
