"""The stam3d set_bnd kernel's index map, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/stam3d_set_bnd.cu) runs one launch
whose blockIdx.z is (axis, field), whose blocks are kSetBndX threads along
a face row by kSetBndRows rows, and whose threads each write both walls of
their axis from one 32-bit decode.  It cannot run here, so the map is
rebuilt in numpy from the source's arithmetic (block shape and the number
of (axis, field) pairs read from the source) and checked: for n in {1, 2,
3, 24, 37, 192} every face-interior cell of every field is written exactly
once and no edge, corner or interior cell ever; every read is the interior
neighbour along the axis, which no thread writes (so the update is safe in
place); and the map applied with the kernel's signs is bitwise equal to
set_bnd_plain and to JAX's set_bnd.  Other block shapes (those a sweep
would build) give the same cover.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import stam3d as js3
from fluidsims_tpu_torch.kernels import stam3d_cuda as sc

torch.set_num_threads(1)
SRC = (Path(__file__).resolve().parents[1] / "fluidsims_tpu_torch" / "csrc"
       / "stam3d_set_bnd.cu").read_text()


def _macro(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


BLOCK = (_macro("FST_SET_BND_X"), _macro("FST_SET_BND_ROWS"))
PAIRS = int(re.search(r"constexpr int kSetBndPairs = (\d+);", SRC).group(1))
SIZES = [1, 2, 3, 24, 37, 192]


def launch_map(n: int, block=BLOCK):
    """(field, dst, src, negate) of every write the launch makes, flat
    indices into an (n+2)^3 volume, from the kernel's arithmetic: blocks
    (ceil(n / bx), ceil(n / rows), PAIRS), thread (tx, ty) at b = bx_i bx
    + tx + 1, a = by_i rows + ty + 1, both walls of axis z >> 2 of field
    z & 3."""
    bx, rows = block
    gx, gy = -(-n // bx), -(-n // rows)
    z, by, bxi, ty, tx = np.meshgrid(np.arange(PAIRS), np.arange(gy),
                                     np.arange(gx), np.arange(rows),
                                     np.arange(bx), indexing="ij")
    b = (bxi * bx + tx + 1).ravel()
    a = (by * rows + ty + 1).ravel()
    z = z.ravel()
    live = (a <= n) & (b <= n)
    a, b, z = a[live], b[live], z[live]
    axis, field = z >> 2, z & 3
    N = n + 2
    base = np.select([axis == 0, axis == 1],
                     [(a * N + b) * N, a * N * N + b], a * N + b)
    stride = np.select([axis == 0, axis == 1], [1, N], N * N)
    dst = np.concatenate([base, base + (n + 1) * stride])
    src = np.concatenate([base + stride, base + n * stride])
    field = np.concatenate([field, field])
    neg = np.concatenate([field[:len(base)] == axis] * 2)
    return field, dst, src, neg


def cell_kind(n: int, flat: np.ndarray) -> np.ndarray:
    """0 interior, 1 face interior, 2 edge, 3 corner: the number of a
    cell's coordinates on the ring."""
    N = n + 2
    k, j, i = flat // (N * N), flat // N % N, flat % N
    return sum(((c == 0) | (c == N - 1)).astype(int) for c in (k, j, i))


@pytest.mark.parametrize("block", [BLOCK, (64, 4), (128, 1), (16, 16)])
@pytest.mark.parametrize("n", SIZES)
def test_map_covers_each_face_cell_once(n, block):
    field, dst, src, _ = launch_map(n, block)
    N = n + 2
    # every write a face-interior cell, every read an interior one
    assert (cell_kind(n, dst) == 1).all()
    assert (cell_kind(n, src) == 0).all()
    # each field's 6 n^2 face-interior cells, each exactly once
    counts = np.zeros((4, N ** 3), dtype=np.int64)
    np.add.at(counts, (field, dst), 1)
    faces = np.flatnonzero(cell_kind(n, np.arange(N ** 3)) == 1)
    assert faces.size == 6 * n * n
    assert (counts[:, faces] == 1).all()
    assert counts.sum() == 4 * 6 * n * n
    # the read is the wall cell's neighbour inward along its axis
    d = np.abs(dst - src)
    assert np.isin(d, [1, N, N * N]).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_map_with_signs_is_set_bnd_plain_bitwise(dtype, n):
    g = torch.Generator().manual_seed(n)
    fields = [torch.randn((n + 2,) * 3, generator=g, dtype=dtype)
              for _ in range(4)]
    fields[0].view(-1)[::5] = -0.0
    fields[3].view(-1)[::7] = float("nan")
    got = [f.clone() for f in fields]
    field, dst, src, neg = launch_map(n)
    flat = [f.view(-1) for f in got]
    for f in range(4):
        m = field == f
        v = flat[f][torch.from_numpy(src[m])]
        flat[f][torch.from_numpy(dst[m])] = torch.where(
            torch.from_numpy(neg[m]), -v, v)
    ref = sc.set_bnd_plain(*[f.clone() for f in fields])
    it = torch.int32 if dtype == torch.float32 else torch.int64
    for a, b in zip(got, ref):
        assert torch.equal(a.view(it), b.view(it))


@pytest.mark.parametrize("n", [1, 3, 24])
def test_map_matches_jax_set_bnd(n):
    rng = np.random.default_rng(n)
    fields = [rng.standard_normal((n + 2,) * 3) for _ in range(4)]
    ref = [np.asarray(f) for f in js3.set_bnd(*map(jnp.asarray, fields))]
    got = [f.copy().reshape(-1) for f in fields]
    field, dst, src, neg = launch_map(n)
    for f in range(4):
        m = field == f
        v = got[f][src[m]]
        got[f][dst[m]] = np.where(neg[m], -v, v)
    for a, b in zip(got, ref):
        assert np.array_equal(a.reshape(b.shape), b)
