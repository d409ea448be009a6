"""Kernel #1, `hypersonic2d_step` (fluidsims_tpu_torch/csrc/
hypersonic2d_step.cu): the operations and bytes the algorithm needs for one
step, whatever implements it.

Operations a fluid cell, counted from the CUDA source with each predict and
face once (the constant of chip_smoke.py): two MUSCL-Hancock predicts (~227
each: 7 primitive decodes, 5 encodes, 4 limited slopes, 2 fluxes, 2 half
steps), two HLLC solves (~97 each), ~140 for the ghosts, the update, the
diffusion and the repair.  Solid cells copy their state.  Bytes: the four
conserved fields and the mask read once, the four fields written once."""

OPS_PER_FLUID_CELL = 2 * 227 + 2 * 97 + 140


def ops(work: dict) -> float:
    return work["fluid_cells"] * OPS_PER_FLUID_CELL


def nbytes(work: dict) -> float:
    return work["cells"] * (8 * work["itemsize"] + 1)
