"""What every kernel wrapper module shares: its launch counter, the
device test that sends CPU tensors to the plain PyTorch versions, and the
checks of the tensors a wrapper hands to its kernel."""

from __future__ import annotations

import torch

__all__ = ["LaunchCounter", "on_cpu", "check_tensors", "GRID_MAX_WORDS"]

# Words of the grid-max scratch of the K-step τ-clock kernels
# (csrc/grid_reduce.cuh): 3 slots of (bits, NaN flag).
GRID_MAX_WORDS = 6


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
