"""Checkpoint / resume for simulation states (port of
fluidsims_tpu.core.checkpoint, npz only).

The reference has NO checkpointing (SURVEY.md §5: interactive 'R' re-inits
from scratch, tau_hypersonic_cuda.cu:1825-1828); this is deliberate new
capability.  States are NamedTuples of tensors, possibly nested (`Cons`
inside `Hypersonic2DState`, `ConsM` inside `MHDState`).  They are
flattened depth-first, as `jax.tree_util` flattens them, into one .npz:
`leaf_0`, `leaf_1`, ... in that order, `__state_class__` (the state class
name, as the JAX package writes it) and `__treedef__` (this package's own
structure string).  The two packages' states have the same fields in the
same order, so a file passes between them: the structure strings differ,
and because the class names match, each side's loader warns and goes on to
its per-leaf checks.

Restoring casts each leaf to the template leaf's dtype and places it on
the template leaf's device.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

__all__ = ["save_state", "load_state", "flatten", "unflatten", "structure"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(state) -> list:
    """The leaves of a (nested) NamedTuple / tuple / list state,
    depth-first in field order; None holds no leaf."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for x in state for leaf in flatten(x)]
    return [state]


def structure(state) -> str:
    """The state's structure, one `*` a leaf, e.g.
    `Hypersonic2DState(U=Cons(rho=*, mx=*, my=*, E=*), mask=*, t=*)`."""
    if state is None:
        return "None"
    if _is_namedtuple(state):
        inner = ", ".join(f"{f}={structure(x)}"
                          for f, x in zip(state._fields, state))
        return f"{type(state).__name__}({inner})"
    if isinstance(state, tuple):
        return "(" + ", ".join(structure(x) for x in state) + ")"
    if isinstance(state, list):
        return "[" + ", ".join(structure(x) for x in state) + "]"
    return "*"


def unflatten(template, leaves: list):
    """A state shaped as `template` holding `leaves` (in flatten's order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def save_state(path, state) -> None:
    """Write a state of tensors to one .npz (each leaf copied to the
    host)."""
    payload = {f"leaf_{i}": x.detach().cpu().numpy()
               for i, x in enumerate(flatten(state))}
    payload["__treedef__"] = np.frombuffer(
        json.dumps(structure(state)).encode(), dtype=np.uint8)
    # version-independent identity: the state class name, which a
    # wrong-solver checkpoint with coincidentally matching leaf shapes
    # cannot fake
    payload["__state_class__"] = np.frombuffer(
        type(state).__name__.encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_state(path, like, strict: bool = True):
    """Load a state saved by save_state (either package's); `like` gives the
    structure, and each leaf's dtype and device, to restore into.

    `strict=False` downgrades the structure-mismatch error of a legacy file
    (one without `__state_class__`) to a warning; the per-leaf count and
    shape checks still apply."""
    with np.load(path) as data:
        return _load(data, like, strict)


def _load(data, like, strict: bool):
    leaves = flatten(like)
    n = len(leaves)
    if "__state_class__" in data:
        saved_cls = bytes(data["__state_class__"]).decode()
        if saved_cls != type(like).__name__:
            raise ValueError(
                f"checkpoint holds a {saved_cls} state but the template is "
                f"{type(like).__name__} — refusing to resume a different "
                "solver's checkpoint")
    if "__treedef__" in data:
        # A file of the JAX package holds JAX's treedef repr, never equal
        # to this package's string.  Where the state class above already
        # verified, a mismatch is a warning (the per-leaf checks below are
        # the authoritative ones); a legacy file without __state_class__
        # has no other structural check, so there it is an error.
        saved_td = json.loads(bytes(data["__treedef__"]).decode())
        mine = structure(like)
        if saved_td != mine:
            msg = ("checkpoint structure string differs from the template "
                   f"state;\n  saved:    {saved_td}\n  template: {mine}")
            if "__state_class__" in data or not strict:
                warnings.warn(msg + "\nvalidating leaf count and shapes "
                              "instead")
            else:
                raise ValueError(
                    msg + "\n(legacy checkpoint without __state_class__: "
                    "same-shape field permutations are undetectable; pass "
                    "strict=False to load_state — or --load-lenient on the "
                    "CLI — to accept it anyway)")
    restored = []
    for i, ref in enumerate(leaves):
        if f"leaf_{i}" not in data:
            raise ValueError(
                f"checkpoint has {i} leaves but the template state has {n}")
        a = data[f"leaf_{i}"]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {tuple(a.shape)} does not match "
                f"template shape {tuple(ref.shape)}")
        restored.append(torch.from_numpy(np.array(a)).to(
            device=ref.device, dtype=ref.dtype))
    if f"leaf_{n}" in data:
        raise ValueError("checkpoint has more leaves than the template state")
    return unflatten(like, restored)
