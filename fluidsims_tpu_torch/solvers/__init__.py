"""Solver modules, one per JAX solver module of the same name.

Each exposes a frozen Config dataclass, `init(cfg, device) -> state` and
`step(cfg, state) -> state`; states are NamedTuples of tensors laid out as
in the JAX package.
"""
