"""Build and load the port's C sources (`native/*.c`) with the system C
compiler.

Each source is compiled at first use into `build/fluidsims_tpu_torch/`
beside the package (never into `native/`), named by a hash of the source,
the compiler and the flags, so an edited source or flag builds anew and an
unchanged one loads the cached file.  The compilers are tried in order (cc,
gcc, clang) and, for each, the flag sets in order; `load_c` returns None
where none of them builds the source, and the caller says what it does
then.
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

from ..kernels._build import build_dir

__all__ = ["COMPILERS", "source_path", "compile_c", "load_c"]

COMPILERS = ("cc", "gcc", "clang")


def source_path(name: str) -> Path:
    """The package's copy of `native/<name>.c`."""
    return Path(__file__).resolve().parents[1] / "native" / f"{name}.c"


def compile_c(cc: str, src: Path, flags: tuple, libs: tuple = ()) -> Path:
    """Build `src` with `cc` and `flags` into the build directory (once per
    source, compiler and flags) and return the library's path."""
    h = hashlib.sha256("\0".join((cc, *flags, *libs)).encode() + b"\0"
                       + src.read_bytes())
    lib = build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = Path(tmp) / lib.name
            subprocess.run([cc, *flags, "-shared", "-fPIC", str(src), "-o",
                            str(out), *libs], check=True, capture_output=True)
            os.replace(out, lib)  # atomic: a concurrent loader sees all
    return lib


@functools.lru_cache(maxsize=None)
def load_c(name: str, flag_sets: tuple = (("-O2",),),
           libs: tuple = ()) -> ctypes.CDLL | None:
    """`native/<name>.c` built and loaded, or None where no compiler of
    COMPILERS builds it with any of `flag_sets`."""
    src = source_path(name)
    for flags in flag_sets:
        for cc_name in COMPILERS:
            cc = shutil.which(cc_name)
            if cc is None:
                continue
            try:
                return ctypes.CDLL(str(compile_c(cc, src, flags, libs)))
            except (subprocess.CalledProcessError, OSError):
                continue
    return None
