"""The CUDA kernel wrappers off the GPU: they import without CUDA, take
their plain versions for CPU tensors without counting a launch, check what
they are given, and the build raises when nvcc is absent instead of
falling back.  The kernels themselves are checked against their plain
versions on a GPU by chip_smoke.py, which needs no JAX.
"""

import numpy as np
import pytest
import torch

from fluidsims_tpu_torch.core.clock import cfl_dt
from fluidsims_tpu_torch.kernels import _build
from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
from fluidsims_tpu_torch.ops.euler2d import Cons
from fluidsims_tpu_torch.solvers import hypersonic2d as h2

torch.set_num_threads(1)


def small(dtype="float32", nx=48, ny=24):
    return h2.default_config(nx=nx, ny=ny, dtype=dtype)


def test_imports_without_cuda_and_counts_start_at_zero():
    hk.reset_launches()
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0}
    assert set(_build.CSRC.glob("*.cu")) == {
        _build.CSRC / f for f in (
            "hypersonic2d_step.cu", "hypersonic2d_wavespeed.cu",
            "sph_bin.cu", "sph_density.cu", "sph_forces.cu")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = small(dtype)
    hk.reset_launches()
    s = h2.init(cfg, torch.device("cpu"))
    s.U.rho[:, 0] = 3.0
    U2 = Cons(*(f.clone() for f in s.U))
    w = hk.inflow_wavespeed(cfg, s.U, s.mask)
    w2 = hk.inflow_wavespeed_plain(cfg, U2, s.mask)
    assert w.shape == () and w.dtype == cfg.torch_dtype
    assert torch.equal(w, w2)
    for a, b in zip(s.U, U2):
        assert torch.equal(a, b)
    dt = cfl_dt(w, cfg.cfl, nu_max=cfg.nu_max)
    out = hk.step_core(cfg, s.U, s.mask, dt)
    ref = hk.step_core_plain(cfg, s.U, s.mask, dt)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0}


def test_unsupported_device_raises():
    cfg = small()
    s = h2.init(cfg, torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        hk.inflow_wavespeed(cfg, s.U, s.mask)


def test_wrapper_checks():
    cfg = small()
    s = h2.init(cfg, torch.device("cpu"))
    dt = torch.tensor(1e-3)
    hk._check(cfg, s.U, s.mask, dt)  # accepted
    with pytest.raises(TypeError):
        hk._check(cfg, Cons(*(f.double() for f in s.U)), s.mask, dt)
    with pytest.raises(ValueError, match="shape"):
        hk._check(cfg, Cons(*(f[:, :-1] for f in s.U)), s.mask, dt)
    with pytest.raises(ValueError, match="contiguous"):
        hk._check(cfg, Cons(*(f.t().contiguous().t() for f in s.U)), s.mask, dt)
    with pytest.raises(ValueError, match="mask"):
        hk._check(cfg, s.U, s.mask.float(), dt)
    with pytest.raises(ValueError, match="dt"):
        hk._check(cfg, s.U, s.mask, torch.ones(2))


def test_params_match_plain_inflow():
    cfg = small("float32")
    p = hk._params(cfg)
    infl = h2.inflow_cons(cfg)
    assert (p.ny, p.nx) == (cfg.ny, cfg.nx)
    assert p.gm1 == cfg.gamma - 1.0
    for a, b in zip(p.infl, infl):
        assert np.float32(a) == b.numpy() and float(np.float32(a)) == a


def test_build_flags():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    assert "-fmad=false" in flags


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    hk.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library()
    with pytest.raises(_build.KernelBuildError):
        hk.load()


def test_build_reports_nvcc_failure(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such GPU' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    _build.load_library.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="no such GPU"):
        _build.load_library()
    assert not list((tmp_path / "build").glob("*.so"))
