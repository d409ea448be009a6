"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled at first use, in one nvcc call, into a shared
library with a plain C interface, which is loaded with ctypes.  No PyTorch
header is included, so a build takes seconds rather than the minutes of
`torch.utils.cpp_extension.load`.

The library lands in `build/fluidsims_tpu_torch/` beside the package,
named by a hash of the sources, the flags and the nvcc path, so an edited
source or flag builds anew and an unchanged one loads the cached file.

Flags: sm_90a (Hopper), -O3, no `--use_fast_math` (the step relies on
`isfinite` and IEEE division and square root), and `-fmad=false` so that
every multiply and add rounds on its own as in the plain PyTorch version:
the wavespeed kernel must match it bitwise.  `-Xptxas -v` writes each
kernel's registers and spills into the build log.

A failed build raises KernelBuildError with nvcc's output.  Nothing here
falls back to another engine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["KernelBuildError", "NVCC_FLAGS", "build_dir", "find_nvcc",
           "load_library", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed; the message carries its output."""


def build_dir() -> Path:
    return _PKG.parent / "build" / "fluidsims_tpu_torch"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/$CUDA_PATH, then $PATH, then /usr/local/cuda."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels of fluidsims_tpu_torch "
        "need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update("\0".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(nvcc: str) -> Path:
    return build_dir() / f"libfst_kernels_{_digest(nvcc)}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if not cached on disk) and load the kernel library."""
    nvcc = find_nvcc()
    lib = _lib_path(nvcc)
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(lib))


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the loaded build."""
    path = _lib_path(find_nvcc()).with_suffix(".log")
    return path.read_text() if path.is_file() else ""
