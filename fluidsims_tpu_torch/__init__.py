"""fluidsims_tpu_torch — the PyTorch + CUDA port of fluidsims_tpu.

The JAX package `fluidsims_tpu` is the reference; this package mirrors its
layout module by module (`core/`, `ops/`, `solvers/`, `kernels/`) so each
counterpart is found by path, and keeps its public layouts: `Cons`/`Prim`
are NamedTuples of `(ny, nx)` tensors, configs are frozen dataclasses with
the same fields and defaults.

Ported so far: the flagship 2-D hypersonic Euler solver
(`solvers.hypersonic2d`), whose cell update and CFL wavespeed reduction run
as hand-written CUDA kernels on the GPU (`kernels.hypersonic2d_cuda`,
sources in `csrc/`).  Kernels build with nvcc at first use; on CPU tensors
every kernel wrapper takes its plain PyTorch version.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
