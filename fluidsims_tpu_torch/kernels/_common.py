"""What every kernel wrapper module shares: its launch counter, the
device test that sends CPU tensors to the plain PyTorch versions, the
checks of the tensors a wrapper hands to its kernel, and the launch report
and scratch of the tiled cooperative kernels (csrc/tiles.cuh, csrc/
p2g_tiles.cuh)."""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["LaunchCounter", "on_cpu", "check_tensors", "TILE_WORDS",
           "TileLaunch", "P2GLaunch", "tile_launch", "tile_scratch",
           "grid_syncs", "raise_if"]

# Words of a tiled kernel's slots (csrc/tiles.cuh kTileWords): 3 grid-max
# slots of (bits, NaN flag), then the count of grid syncs the last launch
# made.
TILE_WORDS = 2 * 3 + 1


class LaunchCounter(dict):
    """Launches of each kernel since the last reset(): one per wrapper call
    that launched on the GPU.  A dict of kernel name -> count."""

    def __init__(self, *names: str):
        super().__init__((name, 0) for name in names)

    def reset(self) -> None:
        for name in self:
            self[name] = 0


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes the plain version), False
    for a CUDA tensor (it launches the kernel); raises on any other
    device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}; use cpu or cuda")
    return False


def check_tensors(tensors: dict, shape: tuple, dtype: torch.dtype,
                  device: torch.device) -> None:
    """Raise unless every named tensor lies on `device`, has `dtype` and
    `shape` and is contiguous."""
    for name, f in tensors.items():
        if f.device != device:
            raise ValueError(f"{name} on {f.device}, expected {device}")
        if f.dtype != dtype:
            raise TypeError(f"{name} is {f.dtype}, config says {dtype}")
        if tuple(f.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(f.shape)}, config "
                             f"says {tuple(shape)}")
        if not f.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class TileLaunch(ctypes.Structure):
    """Mirror of fst::TileLaunch (csrc/tiles.cuh): what a tiled kernel's
    grid query reports of a launch, as the launch computes it."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("grid", "threads", "tile_x", "tile_y", "halo",
                 "smem_bytes")]

    def asdict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


# The P2Gs' designs (csrc/p2g_tiles.cuh kP2GAtomic, kP2GTiled), which the
# wrappers' private `_p2g` and grid queries may name for checks; None picks
# from the particles (kP2GTiledFrom).
P2G_DESIGNS = {"atomic": 0, "tiled": 1}


class P2GLaunch(ctypes.Structure):
    """Mirror of fst::P2GLaunch (csrc/p2g_tiles.cuh): what a P2G's grid
    query reports of a launch: the design, blocks, threads a block, the
    tile of base nodes, particles a chunk, dynamic shared memory a block,
    the grid syncs of a launch and the int32 words of scratch it needs."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("design", "grid", "threads", "tile_x", "tile_y", "chunk",
                 "smem_bytes", "grid_syncs")] + [("scratch_ints",
                                                   ctypes.c_longlong)]

    def asdict(self) -> dict:
        out = TileLaunch.asdict(self)
        out["design"] = {v: k for k, v in P2G_DESIGNS.items()}[self.design]
        return out


def raise_if(code: int, lib, what: str) -> None:
    """Raise RuntimeError naming `what` and the CUDA error, unless `code` is
    0."""
    if code:
        raise RuntimeError(
            f"{what} failed: CUDA error {code} "
            f"({lib.fst_cuda_error_string(code).decode()})")


def tile_launch(lib, query: str, *args, kind=TileLaunch):
    """The report (a `kind`: TileLaunch or P2GLaunch) that the library's
    grid query `query` gives for `args` (its arguments before the report);
    raises if the query fails."""
    out = kind()
    raise_if(getattr(lib, query)(*args, ctypes.byref(out)), lib, query)
    return out


@functools.lru_cache(maxsize=None)
def tile_scratch(kernel: str | tuple, numel: int, dtype: torch.dtype,
                 device: torch.device, stream: int) -> tuple:
    """(scratch of `numel` elements, TILE_WORDS slot words) of the tiled
    kernel `kernel`'s launches on one stream (`kernel` a name, or a tuple
    of the name and the launch shape where only launches of one shape may
    share them): a launch uses them only while it runs, and the next
    launch on that stream starts after it ends, so one stream never has two
    launches on them at once; another stream gets its own.  Both start
    zeroed, so that a kernel may keep a part at 0 between its launches (the
    P2Gs' tile counts)."""
    return (torch.zeros(numel, dtype=dtype, device=device),
            torch.zeros(TILE_WORDS, dtype=torch.int64, device=device))


def grid_syncs(words: torch.Tensor) -> int:
    """The grid syncs that the last launch on these slot words made, as
    the kernel counted them (waits for the launch)."""
    return int(words[TILE_WORDS - 1])
