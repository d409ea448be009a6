"""The FLIP G2P kernel's node window and grouped raster, on the CPU.

The kernel (fluidsims_tpu_torch/csrc/flip_g2p.cu) loads each node of the
projected field once, from a plus-shaped window of 12 about the particle's
cell, takes a shifted sample's nodes from fixed window slots where its
floor is the centre's +- 1 and from memory otherwise, and adds the raster
once a group of a warp's lanes in one cell. The kernel cannot run here, so
a plain torch model of that (tests/oracles/g2p_window.py) is held to the
plain version (kernels/flip_cuda.py g2p_plain): every node of every sample
is the node flip_apic._sample gathers, and a node the window gives is the
one its slot was loaded from; the outputs are bitwise those of g2p_plain,
f32 and f64; and the grouped raster equals the plain raster. Positions
(chip_smoke.g2p_positions, as the card's checks take them): uniform,
exactly on nodes, +-h across nodes (whose floors fall past the window, so
that memory gives some nodes), on and past the walls, 2,000 crowded into
one cell, and NaN. The model's samples are also held to JAX's `_sample`.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import g2p_positions
from fluidsims_tpu.solvers import flip_apic as jf
from fluidsims_tpu_torch.kernels import flip_cuda as fk
from fluidsims_tpu_torch.solvers import flip_apic as tf
from tests.oracles import g2p_window as gw

torch.set_num_threads(1)
KINDS = ["uniform", "nodes", "crossing", "walls", "crowded"]
DTYPES = ["float32", "float64"]
GRIDS = [16, 37, 128]
SHIFTS = {"new": (0, 0), "x+": (1, 0), "x-": (-1, 0), "y+": (0, 1),
          "y-": (0, -1)}


def case(kind: str, n: int, dtype: str, seed: int = 5):
    """(cfg, pos, vel, (u_prev, v_prev, u_proj, v_proj)) as torch tensors
    from seeded numpy."""
    rng = np.random.default_rng(seed + n)
    n_p = 4096
    cfg = tf.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
    arrays = (g2p_positions(kind, n, n_p, rng), rng.standard_normal((n_p, 2)),
              *(rng.standard_normal((n, n)) for _ in range(4)))
    t = [torch.tensor(a, dtype=cfg.torch_dtype) for a in arrays]
    return cfg, t[0], t[1], tuple(t[2:])


def gathered(monkeypatch, f_u, f_v, px, py, n):
    """The (row, col) pairs flip_apic._sample gathers, in the model's node
    order (f00, f01, f10, f11 of u, then of v)."""
    seen = []
    real = tf.gather2d

    def spy(f, j, i):
        seen.append((j, i))
        return real(f, j, i)

    monkeypatch.setattr(tf, "gather2d", spy)
    tf._sample(f_u, f_v, px, py, n)
    monkeypatch.undo()
    # bil's order: (j0, i0), (j0, i1), (j1, i0), (j1, i1)
    order = [0, 2, 1, 3]
    return [seen[4 * f + k] for f in (0, 1) for k in order]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    it = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def test_model_reads_the_shipped_design():
    assert gw.THREADS % gw.WARP == 0 and gw.F64_THREADS % gw.WARP == 0


@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_nodes_are_plain_sample_nodes(monkeypatch, dtype, kind, n):
    cfg, pos, _, (u_prev, v_prev, u_proj, v_proj) = case(kind, n, dtype)
    px, py = pos[:, 0], pos[:, 1]
    s = gw.samples(u_proj, v_proj, u_prev, v_prev, px, py, n)
    h = torch.tensor(1.0 / (n - 1), dtype=cfg.torch_dtype)
    for name, (dx, dy) in SHIFTS.items():
        want = gathered(monkeypatch, u_proj, v_proj, px + dx * h,
                        py + dy * h, n)
        for node, (j, i) in zip(s[name][2], want):
            assert torch.equal(node.r, j) and torch.equal(node.c, i), name
            # a node the window gives is the node its slot was loaded from
            assert torch.equal(node.slot_r, node.r), name
            assert torch.equal(node.slot_c, node.c), name
    want = gathered(monkeypatch, u_prev, v_prev, px, py, n)
    for node, (j, i) in zip(s["old"][2], want):
        assert torch.equal(node.r, j) and torch.equal(node.c, i)
        assert not bool(node.in_window.any())
    # the window gives the centre's nodes where it is centred
    centred = (s["old"][2][0].c >= 1) & (s["old"][2][0].c <= n - 3)
    assert all(torch.equal(q.in_window, centred) for q in s["new"][2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_crossing_takes_nodes_past_the_window_from_memory(dtype):
    """Rounding of (p +- h)(n - 1) puts some floors on or two nodes from
    the centre's: where the window is centred, those samples read memory
    and the window gives the rest."""
    for n in GRIDS:
        cfg, pos, _, (u_prev, v_prev, u_proj, v_proj) = case(
            "crossing", n, dtype)
        s = gw.samples(u_proj, v_proj, u_prev, v_prev, pos[:, 0],
                       pos[:, 1], n)
        centred = s["new"][2][0].in_window
        shifted = [q for k in ("x+", "x-", "y+", "y-") for q in s[k][2]]
        from_memory = sum(int((centred & ~q.in_window).sum())
                          for q in shifted)
        total = len(shifted) * int(centred.sum())
        assert 0 < from_memory < total // 4, (n, from_memory, total)


@pytest.mark.parametrize("flip", [None, 0.5])
@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_outputs_bitwise_equal_g2p_plain(dtype, kind, n, flip):
    cfg, pos, vel, fields = case(kind, n, dtype)
    got = gw.g2p(cfg, pos, vel, *fields, flip)
    ref = fk.g2p_plain(cfg, pos, vel, *fields, flip)
    for a, b in zip(got[:5], ref):
        assert bits_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_raster_equals_plain_raster(dtype, kind):
    cfg, pos, vel, fields = case(kind, 37, dtype)
    out = fk.g2p_plain(cfg, pos, vel, *fields)
    nx, ny = out[0][:, 0], out[0][:, 1]
    density, adds = gw.raster_groups(cfg.grid, nx, ny)
    assert torch.equal(density, tf._raster(cfg.grid, nx, ny))
    assert int(density.sum()) == pos.shape[0]
    assert adds <= pos.shape[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_crowded_cell_is_one_add_a_warp(dtype):
    """2,000 particles in one raster cell: 63 warps, one add each (the
    last warp's 16 lanes one group), and the count of every particle."""
    cfg, pos, _, _ = case("crowded", 37, dtype)
    crowd = pos[:2000]
    density, adds = gw.raster_groups(37, crowd[:, 0], crowd[:, 1])
    assert torch.equal(density, tf._raster(37, crowd[:, 0], crowd[:, 1]))
    assert int(density.max()) == 2000 and adds == 63
    density, adds = gw.raster_groups(37, pos[:, 0], pos[:, 1])
    assert torch.equal(density, tf._raster(37, pos[:, 0], pos[:, 1]))
    assert adds < pos.shape[0] - 1900


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_positions_stay_in_the_grid(dtype):
    """A NaN coordinate's floor converts to 0 on the card; the plain
    version cannot gather there (int64 of NaN), so the model's NaN
    particles are held to NaN outputs and in-grid nodes, and the rest to
    g2p_plain on the finite particles alone."""
    cfg, pos, vel, fields = case("uniform", 37, dtype)
    pos[::7, 0] = float("nan")
    pos[3::11, 1] = float("nan")
    bad = torch.isnan(pos).any(1)
    got = gw.g2p(cfg, pos, vel, *fields)
    for name, (su, sv, nodes) in got[5].items():
        for q in nodes:
            assert bool(((q.r >= 0) & (q.r < 37) & (q.c >= 0)
                         & (q.c < 37)).all()), name
    for out in got[:4]:
        assert bool(torch.isnan(out[bad]).any(1).all())
    ok = ~bad
    ref = fk.g2p_plain(cfg.replace(particles=int(ok.sum())), pos[ok],
                       vel[ok], *fields)
    for a, b in zip(got[:4], ref[:4]):
        assert bits_equal(a[ok], b)
    # a NaN position rasters to cell (0, 0) on both
    assert int(got[4].sum()) == pos.shape[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_samples_match_jax_sample(dtype):
    cfg, pos, _, (u_prev, v_prev, u_proj, v_proj) = case("uniform", 37,
                                                         dtype)
    n = 37
    tol = {"float32": 1e-5, "float64": 1e-12}[dtype]
    s = gw.samples(u_proj, v_proj, u_prev, v_prev, pos[:, 0], pos[:, 1], n)
    h = np.asarray(1.0 / (n - 1), dtype=dtype)
    p = pos.numpy()
    fn = jax.jit(lambda *a: jf._sample(*a, n))
    for name, (dx, dy) in SHIFTS.items():
        ju, jv = fn(u_proj.numpy(), v_proj.numpy(), p[:, 0] + dx * h,
                    p[:, 1] + dy * h)
        for got, ref in ((s[name][0], ju), (s[name][1], jv)):
            ref = np.asarray(ref, np.float64)
            err = np.abs(got.numpy().astype(np.float64) - ref).max()
            assert err <= tol * np.abs(ref).max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_hands_the_kernel_pair_aligned_particles(dtype):
    """The kernel reads an (x, y) pair as one vector: a particle field
    whose data starts off a pair's boundary is copied, others pass as
    they are."""
    big = torch.arange(2 * 64 + 1, dtype=dtype)
    aligned = big[:128].view(64, 2)
    off = big[1:].view(64, 2)
    assert fk._pair_aligned(aligned) is aligned
    moved = fk._pair_aligned(off)
    assert moved is not off and torch.equal(moved, off)
    assert moved.data_ptr() % (2 * moved.element_size()) == 0
