"""The kernels' operations and bytes (portbench/counts/) at the cells'
shapes, pinned; the least times they give are the kernel table's bounds
in PERF.md (#1, #2 ops-bound, #2's bytes unpadded; p4 bytes-bound, its
output padded)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, peaks

# workload -> (cells, fluid cells, {kernel: (ops, bytes, least ms)})
PINNED = {
    "h2d-capsule-f64-8192x1024": (8388608, 8351275, {
        "h2d_step": (6580804700, 545259520, 0.19355307941176472)}),
    "h3d-sphere-f32-256": (16777216, 15678080, {
        "h3d_step": (38587596800, 822083584, 0.575934280597015),
        "h3d_pad": (161862552, 852271384, 0.25440936835820893)}),
    "h2d-capsule-f32-8192x1024": (8388608, 8351275, {
        "h2d_step": (6580804700, 276824064, 0.09822096567164179)}),
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_counts_at_the_cells_shapes(workload):
    cells, fluid, kernels = PINNED[workload]
    cell = harness.Cell(harness.ROOT, workload)
    work = cell.reference.Reference(cell.cfg, cell.traffic, "cpu").work()
    dtype = cell.traffic["dtype"]
    assert work["dtype"] == dtype
    assert work["itemsize"] == torch.finfo(getattr(torch, dtype)).bits // 8
    assert (work["cells"], work["fluid_cells"]) == (cells, fluid)
    rooflines = {m["name"].removesuffix("_roofline")
                 for m in cell.metrics("per_layer")
                 if m["name"].endswith("_roofline")}
    assert rooflines == set(kernels) <= set(cell.adapter.KERNELS)
    for k, (ops, nbytes, least_ms) in kernels.items():
        c = cell.counts(k)
        assert c.ops(work) == ops and c.nbytes(work) == nbytes, k
        assert peaks.least_seconds(ops, nbytes, dtype) * 1e3 == \
            pytest.approx(least_ms, rel=1e-12)


def test_the_3d_step_counts_the_unpadded_grid():
    c = harness.Cell(harness.ROOT, "h3d-sphere-f32-256").counts("h3d_step")
    work = {"cells": 64 ** 3, "fluid_cells": 0, "itemsize": 4}
    # six fields and the mask read, six fields written, each once
    assert c.nbytes(work) == 64 ** 3 * (6 * 4 + 1 + 6 * 4)


# the upstream's 64^3 grid, which no cell runs (PERF.md's kernel table:
# 0.00900 and 0.0044 ms): kernel -> (ops, bytes, least ms)
PINNED_64 = {"h3d_step": (602931200, 12845056, 0.00899897313432836),
             "h3d_pad": (3087000, 14866456, 0.004437748059701492)}


def test_the_3d_kernels_at_the_upstream_grid():
    cell = harness.Cell(harness.ROOT, "h3d-sphere-f32-256")
    work = {"cells": 64 ** 3, "shape": (64, 64, 64), "itemsize": 4}
    for k, (ops, nbytes, least_ms) in PINNED_64.items():
        c = cell.counts(k)
        assert c.ops(work) == ops and c.nbytes(work) == nbytes, k
        assert peaks.least_seconds(ops, nbytes, "float32") * 1e3 == \
            pytest.approx(least_ms, rel=1e-12)


def test_the_3d_prologue_counts_the_padded_grid():
    c = harness.Cell(harness.ROOT, "h3d-sphere-f32-256").counts("h3d_pad")
    work = {"cells": 8 * 16 * 32, "shape": (8, 16, 32), "itemsize": 8}
    padded = 14 * 22 * 38
    # six fields of the grid read; the padded mask read, six padded
    # fields written
    assert c.nbytes(work) == 8 * 16 * 32 * 6 * 8 + padded * (1 + 6 * 8)
    assert c.ops(work) == padded * 9
