"""Configuration base machinery shared by every solver.

Port of fluidsims_tpu.core.config: each solver gets a frozen dataclass with
the same field names and defaults as its JAX twin and two-stage validation
(tau_hypersonic_cuda.cu:1482-1639).  `torch_dtype` takes the place of the
JAX `jax_dtype` property.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["BaseConfig", "ConfigError", "torch_dtype_of"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class ConfigError(ValueError):
    """Raised when a config fails physics/consistency validation."""


def torch_dtype_of(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string ("float32" / "float64")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ConfigError(
            f"dtype {name!r} is not supported; use one of {sorted(_DTYPES)}"
        ) from None


@dataclass(frozen=True)
class BaseConfig:
    """Frozen, hashable config. Subclasses add fields + `validate()`."""

    def validate(self) -> None:  # pragma: no cover - overridden
        pass

    def __post_init__(self):
        self.validate()

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype_of(getattr(self, "dtype", "float32"))

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            raise ConfigError(f"{type(self).__name__}: {msg}")
