"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled at first use into a shared library with a
plain C interface, which is loaded with ctypes: one nvcc process per source,
all started together, then one link.  No PyTorch header is included, so a
build takes seconds rather than the minutes of
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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["KernelBuildError", "NVCC_FLAGS", "build_dir", "find_nvcc",
           "load_library", "build_log", "ptxas_usage"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmpdir:
            objs = [Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
            compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                         str(obj), str(src)]
                        for src, obj in zip(_sources(), objs)]
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                    str(Path(tmpdir) / lib.name), *map(str, objs)]
            log = "".join(_run_all(compiles)) + "".join(_run_all([link]))
            lib.with_suffix(".log").write_text(log)
            # atomic: a concurrent loader sees all or nothing
            os.replace(Path(tmpdir) / lib.name, lib)
    return ctypes.CDLL(str(lib))


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their output, or KernelBuildError naming
    the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return logs


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the loaded build."""
    path = _lib_path(find_nvcc()).with_suffix(".log")
    return path.read_text() if path.is_file() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_usage(fragment: str, log: str | None = None) -> list[dict]:
    """ptxas's report (build_log, or `log`) for every kernel whose mangled
    name holds `fragment`: its registers a thread, static shared memory,
    stack frame and spill stores and loads, in bytes."""
    out, cur, spill = [], None, (0, 0, 0)
    for line in (build_log() if log is None else log).splitlines():
        if m := _ENTRY.search(line):
            cur, spill = m.group(1), (0, 0, 0)
        elif m := _SPILL.search(line):
            spill = tuple(int(g) for g in m.groups())
        elif (m := _REGS.search(line)) and cur is not None:
            if fragment in cur:
                out.append({"kernel": cur, "registers": int(m.group(1)),
                            "static_smem": int(m.group(2) or 0),
                            "stack": spill[0], "spill_stores": spill[1],
                            "spill_loads": spill[2]})
            cur = None
    return out
