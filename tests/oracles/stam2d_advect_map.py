"""A numpy model of the stam2d advection kernel's launch
(fluidsims_tpu_torch/csrc/stam2d_advect.cu), with its block shape read
from the source's launch, for the CPU tests: the kernel runs only on the
card.

`launch_map(n, block)` lists the cell each thread of the launch writes
(one a thread, none past the field's edge), and `advect_map(...)` applies
the kernel's arithmetic thread by thread, in its order and its dtype, to
numpy arrays.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

SRC = (Path(__file__).resolve().parents[2] / "fluidsims_tpu_torch" / "csrc"
       / "stam2d_advect.cu").read_text()


BLOCK = tuple(int(v) for v in re.search(
    r"const dim3 block\((\d+), (\d+)\);", SRC).groups())


def launch_map(n: int, block=BLOCK):
    """(row, column) of every thread that writes: blocks (ceil(n / bx),
    ceil(n / by)), thread (tx, ty) at row by_i by + ty and column bx_i bx
    + tx, the threads past the edge idle."""
    bx, by = block
    gx, gy = -(-n // bx), -(-n // by)
    byi, bxi, ty, tx = np.meshgrid(np.arange(gy), np.arange(gx),
                                   np.arange(by), np.arange(bx),
                                   indexing="ij")
    j = (byi * by + ty).ravel()
    i = (bxi * bx + tx).ravel()
    live = (j < n) & (i < n)
    return j[live], i[live]


def advect_map(qs, uu, vv, eta, xp, yp, dt, eta_min, deta):
    """The fields of qs advected as the launch does it (vectorised over
    its threads): dt, eta_min and deta rounded to the dtype once, as the
    host hands them to the kernel."""
    T = uu.dtype.type
    n = uu.shape[0]
    dt, eta_min, deta = T(dt), T(eta_min), T(deta)
    half, hi, one = T(0.5), T(n + 0.5), T(1)
    outs = [np.full_like(q, np.nan) for q in qs]
    pads = [np.pad(q, 1) for q in qs]
    j, i = launch_map(n)
    bx = eta[i] - dt * uu[j, i] / xp[i]
    by = eta[j] - dt * vv[j, i] / yp[j]
    sx = (bx - eta_min) / deta + half
    ty = (by - eta_min) / deta + half
    sx = np.where(sx < half, half, np.where(sx > hi, hi, sx))
    ty = np.where(ty < half, half, np.where(ty > hi, hi, ty))
    ci = np.floor(sx).astype(np.int64)
    cj = np.floor(ty).astype(np.int64)
    s1 = sx - ci.astype(T)
    t1 = ty - cj.astype(T)
    s0, t0 = one - s1, one - t1
    for out, qp in zip(outs, pads):
        k = (qp[cj, ci], qp[cj + 1, ci], qp[cj, ci + 1], qp[cj + 1, ci + 1])
        out[j, i] = s0 * (t0 * k[0] + t1 * k[1]) + s1 * (t0 * k[2] + t1 * k[3])
    return outs
