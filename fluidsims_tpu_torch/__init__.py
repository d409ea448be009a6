"""fluidsims_tpu_torch — the PyTorch + CUDA port of fluidsims_tpu.

The JAX package `fluidsims_tpu` is the reference; this package mirrors its
layout module by module (`core/`, `ops/`, `solvers/`, `kernels/`) so each
counterpart is found by path, and keeps its public layouts: `Cons`/`Prim`
are NamedTuples of `(ny, nx)` tensors, configs are frozen dataclasses with
the same fields and defaults.

Ported so far: the flagship 2-D hypersonic Euler solver
(`solvers.hypersonic2d`), whose cell update and CFL wavespeed reduction run
as hand-written CUDA kernels on the GPU (`kernels.hypersonic2d_cuda`), and
2-D SPH (`solvers.sph`, `ops.cell_dense`), whose binning, density and
forces + integrate run as three more (`kernels.sph_cuda`), and the 3-D
hypersonic solver (`solvers.hypersonic3d`, `ops.weno`) with its `.4spl`
export (`solvers.th3cs`, `io.fourspl`), whose cell update and masked
max-wavespeed reduction run as two more (`kernels.hypersonic3d_cuda`),
and Gray–Scott (`solvers.gray_scott`) and the D2Q9 LBM (`solvers.lbm`,
`ops.shift`), each stepped by a one-step and a K-step kernel
(`kernels.gray_scott_cuda`, `kernels.lbm_cuda`), Burgers, shallow water
and GLM-MHD (`solvers.burgers`, `solvers.shallow_water`, `solvers.mhd`),
each stepped by a cooperative K-step kernel, and the 3-D stable fluids
(`solvers.stam3d`, `ops.gather`), whose Jacobi sweep, advection and
set_bnd run as three more (`kernels.stam3d_cuda`), and the 2-D stable
fluids (`solvers.stam2d`), whose whole Jacobi solve and exact advection
run as two more (`kernels.stam2d_cuda`), and FLIP/APIC
(`solvers.flip_apic`), whose atomic P2G, grid phase and G2P run as three
more (`kernels.flip_cuda`), and MLS-MPM (`solvers.mpm`), whose P2G and
G2P (with the grid update) run as two more (`kernels.mpm_cuda`), and the
prime-graph n-body layout (`solvers.nbody_graph`, `ops.cell_list`), whose
exact all-pairs repulsion runs as one more (`kernels.nbody_cuda`), with
its native Barnes–Hut host engine (`solvers.nbody_native`, the port's own
`native/nbody_bh.c`) and terminal views (`render.points`,
`core.interactive`); the sources are in `csrc/`.  Around them: the
flagship's view modes (`render.views`, `render.colormap`,
`render.terminal`), PNG frames (`io.png`), the live `.4spl` stream
(`io.live4spl`, `io.fourspl_native`), checkpoints (`core.checkpoint`),
metrics (`core.metrics`), the CPU reference solvers
(`solvers.hypersonic2d_cpu`, `solvers.hypersonic2d_cpu_native`,
`solvers.stam2d_cpu`) and all 16 subcommands of the CLI (`cli`), each
solver one with the JAX CLI's common flags.  Kernels build
with nvcc at first use; on
CPU tensors every kernel wrapper takes its plain PyTorch version.  Entry points
(`init`, `interop.*_from_numpy`) put their tensors on the GPU unless
given a device.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
