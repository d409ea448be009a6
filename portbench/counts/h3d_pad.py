"""Kernel p4, `hypersonic3d_pad` (fluidsims_tpu_torch/csrc/
hypersonic3d_pad.cu): the operations and bytes the algorithm needs for one
step's prologue, whatever implements it.

The prologue turns the six encoded fields of the grid into the six
primitive fields of the grid padded by a halo of 3 on every side, the
boundary state resolved (inflow, outflow ghosts, periodic y and z, the wall
state in solid cells).  Bytes: the six encoded fields of the grid read
once, the padded solid mask read once, six padded fields written once.
Operations: 9 a padded cell (the decode: three exp, three sinh, three
multiplies by u_ref; the ghost columns' and wall cells' few more not
counted; the constant of chip_smoke.py)."""

HALO = 3
OPS_PER_PADDED_CELL = 9


def padded_cells(work: dict) -> int:
    nz, ny, nx = work["shape"]
    return (nz + 2 * HALO) * (ny + 2 * HALO) * (nx + 2 * HALO)


def ops(work: dict) -> float:
    return padded_cells(work) * OPS_PER_PADDED_CELL


def nbytes(work: dict) -> float:
    return work["cells"] * 6 * work["itemsize"] \
        + padded_cells(work) * (1 + 6 * work["itemsize"])
