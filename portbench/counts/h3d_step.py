"""Kernel #2, `hypersonic3d_step` (fluidsims_tpu_torch/csrc/
hypersonic3d_step.cu): the operations and bytes the algorithm needs for one
step, whatever implements it.

Operations a cell, counted from the CUDA source with each face once (the
constant of chip_smoke.py): per axis six fields x ~76 for the WENO pair,
~12 floors and one HLLC (~250), and ~150 for the update, decode, repair,
Landau-Teller and sponges; every cell is computed.  Bytes: the six
primitive fields and the solid mask of the grid read once, six fields
written once.  The halo-3 padded copy the kernel reads is the
implementation's, not the algorithm's, and is not counted."""

OPS_PER_CELL = 2300


def ops(work: dict) -> float:
    return work["cells"] * OPS_PER_CELL


def nbytes(work: dict) -> float:
    return work["cells"] * (6 * work["itemsize"] + 1) \
        + work["cells"] * 6 * work["itemsize"]
