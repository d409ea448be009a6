"""What every kernel wrapper module shares: its launch counter and the
device test that sends CPU tensors to the plain PyTorch versions."""

from __future__ import annotations

import torch

__all__ = ["LaunchCounter", "on_cpu"]


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
