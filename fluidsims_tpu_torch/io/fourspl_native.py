"""ctypes binding to the native `.4spl` writer (port of
fluidsims_tpu.io.fourspl_native).

The source is the port's own copy, fluidsims_tpu_torch/native/fourspl.c,
built with the system C compiler (-O2 -shared -fPIC) at first use into
build/fluidsims_tpu_torch/ (core/native.py).  Where no C compiler builds
it, `write_4spl_best` falls back to the pure-Python writer of io/fourspl.py
and says so in its return value; both write the same bytes.  The native
writer implements the extern "C" API the reference's th3cs.cu links
against (th3cs.cu:21-63).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..core.native import load_c
from . import fourspl as fpy

__all__ = ["native_available", "write_4spl_native", "write_4spl_best"]


@functools.lru_cache(maxsize=None)
def _load():
    """The typed library, or None where no C compiler can build it."""
    lib = load_c("fourspl")
    if lib is None:
        return None
    lib.fourspl_write_file.restype = ctypes.c_bool
    lib.fourspl_write_file.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def write_4spl_native(path, video: fpy.Splat4DVideo) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native fourspl library unavailable (no C "
                           "compiler built native/fourspl.c)")
    pal = np.ascontiguousarray(video.palette, np.float32)
    idx = np.ascontiguousarray(video.indices, np.uint8)
    ok = lib.fourspl_write_file(
        str(path).encode(),
        video.width, video.height, video.depth, video.frames,
        video.p_size, video.flags,
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if not ok:
        raise IOError(f"native 4spl write failed: {path}")


def write_4spl_best(path, video: fpy.Splat4DVideo) -> str:
    """Write with the native library when available, else pure Python.
    Returns the writer that wrote the file: 'native' or 'python'."""
    if native_available():
        write_4spl_native(path, video)
        return "native"
    fpy.write_4spl(path, video)
    return "python"
