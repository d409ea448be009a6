"""Port vs JAX: SPH (solvers/sph.py and ops/cell_dense.py).

The same initial state (bitwise equal: both packages draw it with the same
numpy generator) goes through the JAX engines and their ports: the 'torch'
engine against JAX's XLA engine, the 'cuda' engine (on CPU tensors its
kernels' plain versions) against JAX's Pallas engine as the JAX tests run
it (interpret mode) where no cell overflows and, since it keeps every
pair, against the exact engines and the float64 all-pairs oracle where
cells hold more than K particles, and the 'exact' engine against JAX's
exact engine and the oracle.  Tolerances are the JAX suite's own
(tests/test_sph.py).
"""

import jax
import numpy as np
import pytest
import torch

from fluidsims_tpu.kernels import sph_pallas as jsp
from fluidsims_tpu.ops import cell_dense as jcd
from fluidsims_tpu.solvers import sph as js
from fluidsims_tpu_torch import cli, interop
from fluidsims_tpu_torch.ops import cell_dense as tcd
from fluidsims_tpu_torch.solvers import sph as ts
from tests.oracles.sph_oracle import SPHOracle

torch.set_num_threads(1)
CPU = torch.device("cpu")


def both(**kw):
    """(JAX config, port config, JAX init state, port state moved over by
    interop)."""
    jc = js.SPHConfig(**kw)
    tc = interop.sph_config_from_dict(jc.asdict())
    sj = js.init(jc)
    st = interop.sph_state_from_numpy(*(np.asarray(f) for f in sj),
                                      dtype=tc.torch_dtype, device=CPU)
    return jc, tc, sj, st


def max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b.numpy()).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_bitwise(dtype):
    jc = js.SPHConfig(n=1000, seed=11, dtype=dtype)
    tc = ts.SPHConfig(n=1000, seed=11, dtype=dtype)
    sj, st = js.init(jc), ts.init(tc, CPU)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    back = interop.sph_state_to_numpy(st)
    for a, b in zip(sj, back):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_config_fields_and_engine_map():
    jf = [f for f in js.SPHConfig().asdict() if f != "engine"]
    tf = [f for f in ts.SPHConfig().asdict() if f != "engine"]
    assert jf == tf
    for d in ("float32", "float64"):
        a, b = js.SPHConfig(n=4096, dtype=d), ts.SPHConfig(n=4096, dtype=d)
        assert (a.mass, a.h, tuple(a.grid())) == (b.mass, b.h, tuple(b.grid()))
    for j, t in (("pallas", "cuda"), ("xla", "torch"), ("exact", "exact"),
                 ("auto", "auto")):
        cfg = interop.sph_config_from_dict(js.SPHConfig(engine=j).asdict())
        assert cfg.engine == t
    with pytest.raises(ValueError):
        ts.SPHConfig(engine="pallas")
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        interop.sph_state_from_numpy(np.zeros((4, 3)), np.zeros((4, 3)), 1, 0,
                                     0, 0, dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("n,cap", [(200, 0), (512, 8), (4096, 0)])
def test_binning_bitwise(n, cap):
    jc, tc, sj, st = both(n=n, seed=3, cell_capacity=cap)
    # a stirred state, so cells hold mixed particle indices
    rng = np.random.default_rng(n)
    pos = np.clip(np.asarray(sj.pos) + 0.05 * rng.standard_normal((n, 2)),
                  0.0, 1.0).astype(np.float32)
    g = jc.grid()
    jr, jok, jov = jcd.bin_rank(g, jax.numpy.asarray(pos))
    tr, tok, tov = tcd.bin_rank(tc.grid(), torch.tensor(pos))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert int(jov) == int(tov) and (int(tov) > 0) == (cap == 8)
    jcl = jcd.bin_particles(g, jax.numpy.asarray(pos))
    tcl = tcd.bin_particles(tc.grid(), torch.tensor(pos))
    for name in ("didx", "ok", "occ", "inv"):
        np.testing.assert_array_equal(np.asarray(getattr(jcl, name)),
                                      getattr(tcl, name).numpy(), err_msg=name)
    assert int(jcl.overflow) == int(tcl.overflow)
    # scatter -> gather round trip of the stored particles
    back = tcd.gather_result(tc.grid(), tcl,
                             tcd.scatter_field(tc.grid(), tcl, torch.tensor(pos)))
    np.testing.assert_array_equal(back.numpy()[tok.numpy()], pos[tok.numpy()])


@pytest.mark.parametrize("oy,ox", [(-1, 1), (0, 0), (1, -1), (2, 0)])
def test_shift_cells_matches_jax(oy, ox):
    a = np.arange(5 * 4 * 3, dtype=np.float64).reshape(5, 4, 3)
    got = tcd.shift_cells(torch.tensor(a), oy, ox).numpy()
    np.testing.assert_array_equal(np.asarray(jcd.shift_cells(a, oy, ox)), got)
    b = a[..., 0]
    np.testing.assert_array_equal(np.asarray(jcd.grid_shift(b, oy, ox)),
                                  tcd.grid_shift(torch.tensor(b), oy, ox).numpy())


def test_torch_engine_matches_xla_f64():
    jc, tc, sj, st = both(n=256, rain=False, use_xsph=True, visc_substeps=2,
                          dtype="float64")
    jstep = jax.jit(lambda s: js._step_xla(jc, s))
    for _ in range(3):
        sj, st = jstep(sj), ts.step(tc, st)
    assert ts.resolve_engine(tc, CPU) == "torch"
    assert max_abs(sj.pos, st.pos) <= 1e-12
    assert max_abs(sj.vel, st.vel) <= 1e-12
    assert abs(float(sj.t) - float(st.t)) <= 1e-12 * float(sj.t)


def test_torch_engine_matches_xla_f32_rain():
    jc, tc, sj, st = both(n=1024, rain=True, seed=7, dtau=1e-2)
    jstep = jax.jit(lambda s: js._step_xla(jc, s))
    for _ in range(5):
        sj, st = jstep(sj), ts.step(tc, st)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=2e-6)
    np.testing.assert_allclose(st.vel.numpy(), np.asarray(sj.vel), atol=2e-5)
    np.testing.assert_allclose(float(st.tau), float(sj.tau), rtol=1e-6)
    assert float(st.rain_carry) == pytest.approx(float(sj.rain_carry), abs=1e-5)
    assert int(st.step_idx) == int(sj.step_idx) == 5


def test_cuda_engine_plain_matches_pallas_interpret():
    jc, tc, sj, st = both(n=1024, rain=True, seed=7, dtau=1e-2, engine="pallas")
    assert tc.engine == "cuda" and ts.resolve_engine(tc, CPU) == "cuda"
    jstep = jsp.make_step_pallas(jc, interpret=True)
    for _ in range(5):
        sj, st = jstep(sj), ts.step(tc, st)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=2e-6)
    np.testing.assert_allclose(st.vel.numpy(), np.asarray(sj.vel), atol=2e-5)
    np.testing.assert_allclose(float(st.tau), float(sj.tau), rtol=1e-6)


def test_cuda_engine_overflow_fallback_matches_pallas():
    """A pool with cells past K (cell_capacity=8): JAX's Pallas engine
    drops those particles from the pair sums and integrates them with
    gravity alone, the port's 'cuda' engine keeps every pair, so it
    matches JAX's exact engine instead, and reports no overflow."""
    jc, tc, sj, st = both(n=512, rain=False, seed=3, cell_capacity=8,
                          engine="pallas")
    n_past = int(ts.overflow_count(tc.replace(engine="torch"), st))
    assert n_past == int(js.overflow_count(jc, sj)) > 0
    assert int(ts.overflow_count(tc, st)) == 0
    a = js.step(jc.replace(engine="exact"), sj)
    b = ts.step(tc, st)
    np.testing.assert_allclose(b.pos.numpy(), np.asarray(a.pos), atol=2e-6)
    np.testing.assert_allclose(b.vel.numpy(), np.asarray(a.vel), atol=2e-5)
    capped = jsp.make_step_pallas(jc, interpret=True)(sj)
    assert np.abs(np.asarray(capped.vel) - b.vel.numpy()).max() > 1e-3


def test_cuda_engine_keeps_every_pair_f64():
    """The 'cuda' engine (its kernels' plain versions on CPU tensors) on a
    pool with cells past K equals the port's and JAX's exact engines and
    the float64 all-pairs oracle within 1e-12 over 2 steps."""
    kw = dict(n=512, rain=False, seed=3, cell_capacity=8, visc_substeps=2,
              dtype="float64")
    jc, tc, sj, st = both(engine="exact", **kw)
    cc = tc.replace(engine="cuda")
    assert int(ts.overflow_count(cc.replace(engine="torch"), st)) > 0
    orc = SPHOracle(jc, np.asarray(sj.pos), np.asarray(sj.vel),
                    float(sj.t), float(sj.tau))
    jstep = jax.jit(lambda s: js.step(jc, s))
    se = st
    for _ in range(2):
        sj, st, se = jstep(sj), ts.step(cc, st), ts.step(tc, se)
        orc.step()
    for ref in (se.pos.numpy(), np.asarray(sj.pos), orc.pos):
        assert np.abs(st.pos.numpy() - ref).max() < 1e-12
    for ref in (se.vel.numpy(), np.asarray(sj.vel), orc.vel):
        assert np.abs(st.vel.numpy() - ref).max() < 1e-12
    np.testing.assert_allclose(float(st.tau), orc.tau, rtol=1e-12)
    assert int(ts.overflow_count(cc, st)) == 0


def test_exact_engine_matches_jax_and_oracle_f64():
    kw = dict(n=256, rain=False, use_xsph=True, xsph_eps=0.25,
              visc_substeps=2, dtype="float64", engine="exact")
    jc, tc, sj, st = both(**kw)
    orc = SPHOracle(jc, np.asarray(sj.pos), np.asarray(sj.vel),
                    float(sj.t), float(sj.tau))
    jstep = jax.jit(lambda s: js.step(jc, s))
    for _ in range(2):
        sj, st = jstep(sj), ts.step(tc, st)
        orc.step()
    assert max_abs(sj.pos, st.pos) < 1e-13
    assert max_abs(sj.vel, st.vel) < 1e-13
    assert np.abs(st.pos.numpy() - orc.pos).max() < 1e-13
    assert np.abs(st.vel.numpy() - orc.vel).max() < 1e-13
    np.testing.assert_allclose(float(st.t), orc.t, rtol=1e-12)
    np.testing.assert_allclose(float(st.tau), orc.tau, rtol=1e-12)
    assert int(ts.overflow_count(tc, st)) == 0


@pytest.mark.parametrize("nspawn", [0.0, 5.0, 40.0, 64.0])
def test_rain_slot_collisions_bitwise_f64(nspawn):
    """n = 8 slots for up to 64 spawns: many spawns hash to one slot, and
    the highest active k must win, as JAX's scatter leaves it."""
    jc = js.SPHConfig(n=8, dtype="float64", rain=True, seed=5)
    tc = ts.SPHConfig(n=8, dtype="float64", rain=True, seed=5)
    rng = np.random.default_rng(1)
    pos, vel = rng.random((8, 2)), rng.standard_normal((8, 2))
    seed = 69420 + 17
    jp, jv = js._rain(jc, jax.numpy.asarray(pos), jax.numpy.asarray(vel),
                      jax.numpy.asarray(int(nspawn), jax.numpy.int32), seed)
    tp, tv = ts._rain(tc, torch.tensor(pos), torch.tensor(vel),
                      torch.tensor(nspawn, dtype=torch.float64),
                      torch.tensor(seed, dtype=torch.int32))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tp.numpy() != pos).any() == (nspawn > 0)


def test_resolve_engine_mirrors_jax():
    cuda = torch.device("cuda")   # only its type is read
    for eng in ("torch", "exact"):
        assert ts.resolve_engine(ts.SPHConfig(n=1024, engine=eng), cuda) == eng
    assert ts.resolve_engine(ts.SPHConfig(n=1024), CPU) == "torch"
    for d in ("float32", "float64"):
        assert ts.resolve_engine(ts.SPHConfig(n=1024, dtype=d), cuda) == "cuda"
    assert ts.resolve_engine(ts.SPHConfig(n=1024, use_xsph=True), cuda) == "torch"
    assert ts.resolve_engine(ts.SPHConfig(n=1024, engine="cuda"), CPU) == "cuda"
    # the cuda engine keeps every pair: no overflow, with or without a card
    pool = ts.init(ts.SPHConfig(n=512, cell_capacity=8), CPU)
    for dev in (CPU, cuda):
        assert ts.resolve_engine(ts.SPHConfig(n=512, cell_capacity=8), dev) \
            == ("cuda" if dev is cuda else "torch")
    assert int(ts.overflow_count(ts.SPHConfig(n=512, cell_capacity=8,
                                              engine="cuda"), pool)) == 0
    assert int(ts.overflow_count(ts.SPHConfig(n=512, cell_capacity=8,
                                              engine="torch"), pool)) > 0
    with pytest.raises(ValueError, match="XSPH"):
        ts.resolve_engine(ts.SPHConfig(n=1024, engine="cuda", use_xsph=True),
                          CPU)
    # JAX's choices for the same configs off-TPU
    assert js.resolve_engine(js.SPHConfig(n=1024)) == "xla"
    assert js.resolve_engine(js.SPHConfig(n=1024, use_xsph=True)) == "xla"


def test_observables_match_jax():
    jc, tc, sj, st = both(n=512, seed=3)
    for _ in range(3):
        st = ts.step(tc, st)
    pos = st.pos.numpy()
    rho_t = ts.raster_density(tc, st.pos, 16, 12, chunk=50)
    rho_j = js.raster_density(jc, jax.numpy.asarray(pos), 16, 12, chunk=50)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(
        ts.rasterize_counts(tc, st.pos, 20, 10).numpy(),
        np.asarray(js.rasterize_counts(jc, jax.numpy.asarray(pos), 20, 10)))


def test_init_defaults_to_gpu():
    cfg = ts.SPHConfig(n=64)
    if torch.cuda.is_available():
        assert ts.init(cfg).pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ts.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            interop.sph_state_from_numpy(np.zeros((2, 2)), np.zeros((2, 2)),
                                         1, 0, 0, 0, dtype=torch.float32)


def test_cli_sph_cpu_torch(capsys):
    out = cli.main(["sph", "--device", "cpu", "--engine", "torch", "--n", "256",
                    "--steps", "2"])
    assert out == 0
    text = capsys.readouterr().out
    assert "engine=torch" in text and "M particle-steps/s" in text
    assert "overflow:" in text and "t = " in text
