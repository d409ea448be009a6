"""Port vs JAX: configs, device resolution and the clocks of
fluidsims_tpu_torch.core.

The clock functions are scalar arithmetic on 0-d tensors; at float64 they
must agree with the JAX package bitwise (same operations, same order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsims_tpu.core import clock as jclock
from fluidsims_tpu.core.config import ConfigError as JConfigError
from fluidsims_tpu.solvers import hypersonic2d as jh2
from fluidsims_tpu_torch.core import clock as tclock
from fluidsims_tpu_torch.core.config import ConfigError as TConfigError
from fluidsims_tpu_torch.core.config import torch_dtype_of
from fluidsims_tpu_torch.core.device import resolve_device
from fluidsims_tpu_torch.core.stepper import benchmark, run_split, run_steps
from fluidsims_tpu_torch.solvers import hypersonic2d as th2

torch.set_num_threads(1)


def f64_bits(x) -> int:
    return int(np.asarray(x, np.float64).view(np.int64))


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jh2.Hypersonic2DConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(th2.Hypersonic2DConfig)]
    assert jf == tf
    assert th2.Hypersonic2DConfig().nu_max == jh2.Hypersonic2DConfig().nu_max


@pytest.mark.parametrize("kw", [
    {"nx": 2048, "ny": 1024},
    {"nx": 96, "ny": 48, "dtype": "float64"},
    {"nx": 8192, "ny": 1024, "gamma": 1.4, "cfl": 0.4},
])
def test_default_config_matches_jax(kw):
    j = jh2.default_config(**kw)
    t = th2.default_config(**kw)
    assert t.asdict() == j.asdict()
    assert t.replace(cfl=0.1).asdict() == j.replace(cfl=0.1).asdict()


@pytest.mark.parametrize("kw", [
    {"nx": -4},
    {"ny": 0},
    {"gamma": 1.0},
    {"gamma": 0.5},
    {"cfl": 0.0},
    {"cfl": -0.25},
    {"visc_nu": -1e-3},
    {"inflow_mach": 0.0},
    {"steps_per_frame": 0},
    {"geom_theta": 0.0},
    {"geom_Rn": 10.0, "geom_Rb": 1.0},  # Rb < Rn*cos(theta)
    {"geom_x0": float("nan")},
])
def test_invalid_configs_raise_like_jax(kw):
    with pytest.raises(JConfigError):
        jh2.Hypersonic2DConfig(**kw)
    with pytest.raises(TConfigError):
        th2.Hypersonic2DConfig(**kw)


def test_torch_dtype():
    assert th2.Hypersonic2DConfig().torch_dtype == torch.float32
    assert th2.Hypersonic2DConfig(dtype="float64").torch_dtype == torch.float64
    assert torch_dtype_of("float32") == torch.float32
    with pytest.raises(TConfigError):
        torch_dtype_of("int8")


def test_resolve_device_never_substitutes_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("meta")


@pytest.mark.parametrize("maxs", [27.3, 1.05, 1e-15, 0.0, float("nan"),
                                  float("inf"), 3.3e5])
@pytest.mark.parametrize("cfl,nu_max", [(0.25, 5e-2), (0.4, 0.0), (0.3, 1e-13)])
def test_cfl_dt_bitwise_f64(maxs, cfl, nu_max):
    j = jclock.cfl_dt(jnp.asarray(maxs, jnp.float64), cfl, dx=1.0, nu_max=nu_max)
    t = tclock.cfl_dt(torch.tensor(maxs, dtype=torch.float64), cfl, dx=1.0,
                      nu_max=nu_max)
    assert f64_bits(j) == f64_bits(t.numpy())


@pytest.mark.parametrize("t0,dtau,dt_cfl", [
    (1e-3, 1e-2, 1.0), (0.7, 3e-2, 1e-3), (2.5, 5e-2, 0.125), (1e-3, 1e-7, 1e-9)])
def test_tau_ticks_bitwise_f64(t0, dtau, dt_cfl):
    jc = jclock.tau_clock(t0, dtau, jnp.float64)
    tc = tclock.tau_clock(t0, dtau, torch.float64)
    jcfl = jnp.asarray(dt_cfl, jnp.float64)
    tcfl = torch.tensor(dt_cfl, dtype=torch.float64)
    for _ in range(3):
        (jc, jdt), (tc, tdt) = jclock.tau_tick(jc, jcfl), tclock.tau_tick(tc, tcfl)
        assert f64_bits(jdt) == f64_bits(tdt.numpy())
        for a, b in zip(jc, tc):
            assert f64_bits(a) == f64_bits(b.numpy())
    for _ in range(5):
        jc, jdt = jclock.tau_tick_feedback(jc, jcfl)
        tc, tdt = tclock.tau_tick_feedback(tc, tcfl)
        assert f64_bits(jdt) == f64_bits(tdt.numpy())
        for a, b in zip(jc, tc):
            assert f64_bits(a) == f64_bits(b.numpy())


@pytest.mark.parametrize("dt_over_cfl", [2.0, 1.1, 1.0999, 0.9, 0.85, 0.5, 1e-9])
@pytest.mark.parametrize("dtau", [1e-2, 4.9e-2, 1.05e-7])
def test_dtau_feedback_bitwise_f64(dt_over_cfl, dtau):
    dt_cfl = 3e-3
    args = (dtau, dt_over_cfl * dt_cfl, dt_cfl)
    j = jclock.dtau_feedback(*(jnp.asarray(a, jnp.float64) for a in args))
    t = tclock.dtau_feedback(*(torch.tensor(a, dtype=torch.float64) for a in args))
    assert f64_bits(j) == f64_bits(t.numpy())


def test_run_steps_and_benchmark_keys():
    from fluidsims_tpu.core import stepper as jstepper

    assert run_steps(lambda x: x + 1, torch.tensor(0), 5).item() == 5
    state = (torch.zeros(3), torch.tensor(0.0))
    res = benchmark(lambda s: (s[0] + 1.0, s[1] + 0.5), state, steps=4,
                    warmup_steps=2, cells=3)
    jres = jstepper.benchmark(lambda s: (s[0] + 1.0, s[1] + 0.5),
                              (jnp.zeros(3), jnp.asarray(0.0)), steps=4,
                              warmup_steps=2, cells=3)
    assert set(res) == set(jres)
    assert res["steps"] == 4 and res["cells"] == 3 and res["wall_s"] > 0
    assert res["mcells_per_sec"] == 3 * 4 / res["wall_s"] / 1e6


@pytest.mark.parametrize("n, k, want", [(23, 8, (2, 7)), (32, 16, (2, 0)),
                                        (5, 16, (0, 5)), (7, 1, (0, 7)),
                                        (0, 4, (0, 0))])
def test_run_split(n, k, want):
    """n // k block calls (k steps each), then n % k one-step calls."""
    calls = []

    def block(x):
        calls.append("block")
        return x + k

    def one(x):
        calls.append("step")
        return x + 1

    assert run_split(block, one, k, 0, n) == n
    assert (calls.count("block"), calls.count("step")) == want
    assert calls == sorted(calls)  # every block call before the steps


def test_benchmark_run_fn_runs_the_steps_in_one_call():
    calls = []

    def run_fn(st, n):
        calls.append(n)
        return st + n

    res = benchmark(None, torch.zeros(2), steps=6, warmup_steps=3, cells=2,
                    run_fn=run_fn)
    assert calls == [3, 6]
    assert res["steps"] == 6 and res["mcells_per_sec"] > 0
