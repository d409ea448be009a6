"""The split of the n-body repulsion kernel's sums, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/nbody_repulsion.cu) gives each thread
several targets, stages the sources a tile at a time, sums each tile's
pairs with fused multiply-adds into a partial that it adds to the running
total, and applies the repulsion factor once.  The kernel cannot run
here, so a plain torch model of that order of work
(tests/oracles/nbody_tiles.py) is held to the plain version
(kernels/nbody_cuda.py repulsion_exact_plain) and to JAX's
(fluidsims_tpu/solvers/nbody_graph.py::_repulsion_exact), per body of the
size of its terms, sum_j |w_ij| |d_ij| in f64 (`nbody_cuda.term_scale`):
1e-5 (f32) and 1e-12 (f64), the kernel's bars on the card.  2-D and 3-D,
f32 and f64, n = 1, 2, 257 and 4099 seeded bodies at scale 100 (two of
them coincident where n > 3), every target and rows 1::3, with the
source's block shape and with others whose nt is not a whole number of
threads x targets and whose last tile is ragged.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.solvers import nbody_graph as jng
from fluidsims_tpu_torch.kernels import nbody_cuda as nk
from fluidsims_tpu_torch.solvers import nbody_graph as tng
from tests.oracles import nbody_tiles as tiles

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "float64": 1e-12}
SIZES = (1, 2, 257, 4099)


def bodies(n: int, dims: int, dtype: str, seed: int = 5):
    """(port config, positions): n seeded bodies at scale 100, two of
    them coincident where n > 3 (chip_smoke.py's nbody_inputs)."""
    cfg = tng.GraphLayoutConfig(max_number=max(n, 2), dims=dims, dtype=dtype)
    p = np.random.default_rng(seed + n).normal(scale=100.0, size=(n, dims))
    if n > 3:
        p[n // 2] = p[1]
    return cfg, torch.tensor(p, dtype=cfg.torch_dtype)


def body_err(cfg, got, ref, pos, rows=None) -> float:
    """max over targets of |got_i - ref_i|_inf / sum_j |w_ij| |d_ij|, the
    scale in f64 on the positions the forces were computed from."""
    scale = nk.term_scale(cfg, pos.double(),
                          None if rows is None else rows.double())
    err = (torch.as_tensor(np.asarray(got, np.float64))
           - torch.as_tensor(np.asarray(ref, np.float64))).abs().amax(-1)
    return float((err / scale.clamp_min(1e-300)).max())


def rows_of(pos, with_rows: bool):
    """rows 1::3 (the one body where n = 1: the kernel takes nt >= 1), or
    None for every target."""
    if not with_rows:
        return None
    return (pos[1::3] if pos.shape[0] > 1 else pos[:1]).contiguous()


@functools.lru_cache(maxsize=None)
def modelled(dims: int, dtype: str, n: int, with_rows: bool):
    """(cfg, pos, rows, the model's forces, its info) of one case, once
    for both tests that read it."""
    cfg, pos = bodies(n, dims, dtype)
    rows = rows_of(pos, with_rows)
    return (cfg, pos, rows, *tiles.repulsion_tiles(cfg, pos, rows))


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dims", [2, 3])
def test_tiles_match_plain(dims, dtype, n, with_rows):
    cfg, pos, rows, got, info = modelled(dims, dtype, n, with_rows)
    assert got.dtype == pos.dtype and bool(torch.isfinite(got).all())
    assert info["tiles"] == -(-n // tiles.THREADS[pos.dtype])
    ref = nk.repulsion_exact_plain(cfg, pos, rows)
    assert body_err(cfg, got, ref, pos, rows) <= TOL[dtype]


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dims", [2, 3])
def test_tiles_match_jax(dims, dtype, n, with_rows):
    cfg, pos, rows, got, _ = modelled(dims, dtype, n, with_rows)
    jc = jng.GraphLayoutConfig(max_number=max(n, 2), dims=dims, dtype=dtype)
    ref = jng._repulsion_exact(jc, jnp.asarray(pos.numpy()),
                               None if rows is None
                               else jnp.asarray(rows.numpy()))
    assert body_err(cfg, got, np.asarray(ref), pos, rows) <= TOL[dtype]


# (threads, targets) other than the source's: nt = 257 or 4099 is then no
# whole number of a block's targets, and n no whole number of tiles
SHAPES = [(32, 3), (64, 1), (128, 2), (96, 4)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_other_shapes_match_plain(dtype, shape):
    threads, targets = shape
    for n in (257, 4099):
        cfg, pos = bodies(n, 2, dtype)
        assert n % (threads * targets) and n % threads
        got, info = tiles.repulsion_tiles(cfg, pos, None, threads, targets)
        assert info["last_tile"] == n % threads
        ref = nk.repulsion_exact_plain(cfg, pos)
        assert body_err(cfg, got, ref, pos) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_targets_past_a_whole_block(dtype):
    """nt = threads x targets + 1 and - 1, and rows fewer than one block's
    threads: every target written once, none past nt."""
    T, K = tiles.THREADS[getattr(torch, dtype)], tiles.TARGETS[
        getattr(torch, dtype)]
    for nt in (T * K - 1, T * K + 1, T // 2 + 1):
        cfg, pos = bodies(nt + 50, 3, dtype)
        rows = pos[:nt].contiguous()
        got, info = tiles.repulsion_tiles(cfg, pos, rows)
        assert got.shape == (nt, 3) and info["blocks"] == -(-nt // (T * K))
        ref = nk.repulsion_exact_plain(cfg, pos, rows)
        assert body_err(cfg, got, ref, pos, rows) <= TOL[dtype]
    idx = tiles.slots(T * K + 1, T, K)
    assert idx.shape == (2, T, K) and int((idx >= 0).sum()) == T * K + 1
    # block 1: only thread 0's first slot takes a target
    assert int(idx[1, 0, 0]) == T * K and int((idx[1] >= 0).sum()) == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coincident_bodies_add_exactly_zero(dtype):
    """d = 0 gives a zero term with no branch: two bodies at one point
    push each other by exactly nothing, and a third feels both."""
    cfg = tng.GraphLayoutConfig(max_number=3, dtype=dtype)
    pos = torch.tensor([[1.5, -2.0], [1.5, -2.0], [40.0, 3.0]],
                       dtype=cfg.torch_dtype)
    got, _ = tiles.repulsion_tiles(cfg, pos[:2])
    assert bool((got == 0).all())
    got, _ = tiles.repulsion_tiles(cfg, pos)
    ref = nk.repulsion_exact_plain(cfg, pos)
    assert body_err(cfg, got, ref, pos) <= TOL[dtype]
    assert torch.equal(got[0], got[1])


def test_softening_zero_self_pair_is_not_finite():
    """At softening 0 the self pair's rsqrt(0) = inf meets d = 0: the
    model, like the plain version, gives a non-finite force (the kernel's
    f64 rsqrt must keep it so)."""
    cfg = tng.GraphLayoutConfig(max_number=4, dtype="float64", softening=0.0)
    pos = torch.tensor(np.random.default_rng(0).normal(size=(4, 2)))
    got, _ = tiles.repulsion_tiles(cfg, pos)
    ref = nk.repulsion_exact_plain(cfg, pos)
    assert not bool(torch.isfinite(got).any())
    assert not bool(torch.isfinite(ref).any())


def test_source_shape():
    """The source's block shape: whole warps, and a tile a whole number of
    unrolled steps (the kernel's static_assert)."""
    for dt in (torch.float32, torch.float64):
        assert tiles.THREADS[dt] % 32 == 0
        assert tiles.THREADS[dt] % tiles.UNROLL == 0
        assert tiles.TARGETS[dt] >= 1
