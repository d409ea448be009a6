"""Device resolution for the port (counterpart of core/platform.py).

The JAX package points its backend at an environment variable; the port
takes an explicit device name instead.  Asking for CUDA where there is none
is an error: nothing here substitutes the CPU, so a run that names the GPU
either runs on it or fails.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_block_engine"]


def resolve_device(name: str | torch.device) -> torch.device:
    """`"cpu"`, `"cuda"` or `"cuda:N"` -> torch.device; raises RuntimeError
    when a CUDA device is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no CUDA build of torch or no visible GPU)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {str(dev)!r}; use cpu or cuda")
    return dev


def resolve_block_engine(engine: str, device, block_k: int,
                         max_block_k: int) -> str:
    """The engine ('cuda' or 'torch') of a solver whose 'cuda' engine runs
    a K-step kernel of at most `max_block_k` steps a launch.  'auto' gives
    'cuda' on a CUDA device and 'torch' on the CPU; 'cuda' on the CPU
    raises, as does a `block_k` past `max_block_k` for the 'cuda' engine."""
    if engine == "torch":
        return "torch"
    if torch.device(device).type != "cuda":
        if engine == "cuda":
            raise ValueError("engine='cuda' runs the CUDA kernels and needs "
                             f"CUDA tensors, got {device}; use engine='torch'")
        return "torch"
    if block_k > max_block_k:
        raise ValueError(f"block_k={block_k}: the CUDA K-step kernel takes "
                         f"1 <= block_k <= {max_block_k}")
    return "cuda"
