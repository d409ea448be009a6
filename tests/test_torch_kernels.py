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
from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk3
from fluidsims_tpu_torch.ops.euler2d import Cons
from fluidsims_tpu_torch.solvers import hypersonic2d as h2
from fluidsims_tpu_torch.solvers import hypersonic3d as h3

torch.set_num_threads(1)


def small(dtype="float32", nx=48, ny=24):
    return h2.default_config(nx=nx, ny=ny, dtype=dtype)


def test_imports_without_cuda_and_counts_start_at_zero():
    hk.reset_launches()
    assert hk.LAUNCHES == {"step": 0, "wavespeed": 0}
    assert set(_build.CSRC.glob("*.cu")) == {
        _build.CSRC / f for f in (
            "hypersonic2d_step.cu", "hypersonic2d_wavespeed.cu",
            "hypersonic3d_step.cu", "hypersonic3d_wavespeed.cu",
            "hypersonic3d_pad.cu", "sph_bin.cu", "sph_density.cu", "sph_forces.cu",
            "gray_scott_step.cu", "gray_scott_multistep.cu", "lbm_step.cu",
            "lbm_multistep.cu", "burgers_multistep.cu",
            "shallow_water_multistep.cu", "mhd_multistep.cu",
            "stam3d_jacobi.cu", "stam3d_advect.cu", "stam3d_set_bnd.cu",
            "stam2d_lin_solve.cu", "stam2d_advect.cu", "flip_p2g.cu",
            "flip_grid.cu", "flip_g2p.cu", "mpm_p2g.cu", "mpm_g2p.cu",
            "nbody_repulsion.cu")}


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


def test_ptxas_usage_reads_each_kernel_of_the_log():
    """ptxas_usage picks a kernel's registers, static shared memory, stack
    and spills out of nvcc's -Xptxas -v log (chip_smoke.py reports them
    for the tiled kernels)."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN3fst24burgers_multistep_kernelIfEEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN3fst24burgers_multistep_kernelIfEEv\n"
        "    16 bytes stack frame, 8 bytes spill stores, "
        "12 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 472 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3fst16lin_solve_kernelIdEEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN3fst16lin_solve_kernelIdEEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 96 bytes smem, "
        "400 bytes cmem[0]\n")
    (b,) = _build.ptxas_usage("burgers_multistep", log)
    assert (b["registers"], b["static_smem"], b["stack"], b["spill_stores"],
            b["spill_loads"]) == (64, 0, 16, 8, 12)
    (s,) = _build.ptxas_usage("lin_solve", log)
    assert (s["registers"], s["static_smem"], s["spill_stores"]) == (40, 96, 0)
    assert _build.ptxas_usage("sw_multistep", log) == []


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


# ------------------------------- 3-D kernels -------------------------------

def small3(dtype="float32"):
    return h3.Hypersonic3DConfig(nx=14, ny=10, nz=8, dx=1 / 14, dy=1 / 10,
                                 dz=1 / 8, sponge_n=4, sponge_out_n=3,
                                 dtype=dtype)


def padded3(cfg):
    s = h3.init(cfg, torch.device("cpu"))
    sp = h3.solid_pad_of(cfg, torch.device("cpu"))
    q = h3._decode(cfg, *s[:6])
    q = q._replace(u=q.u + 3.0)
    return s, h3._padded_prims(cfg, q, sp), sp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_3d_cpu_tensors_take_plain_version_uncounted(dtype):
    cfg = small3(dtype)
    hk3.reset_launches()
    s, qp, sp = padded3(cfg)
    dt = torch.tensor(1e-4, dtype=cfg.torch_dtype)
    gain = torch.tensor(0.5, dtype=cfg.torch_dtype)
    out = hk3.step_core(cfg, qp, sp, dt, gain)
    ref = hk3.step_core_plain(cfg, qp, sp, dt, gain)
    for a, b in zip(out, ref):
        assert a.shape == (8, 10, 14) and torch.equal(a, b)
    w = hk3.wavespeed(cfg, out, s.solid)
    assert w.shape == () and w.dtype == cfg.torch_dtype
    assert torch.equal(w, hk3.wavespeed_plain(cfg, out, s.solid))
    assert hk3.LAUNCHES == {"step": 0, "wavespeed": 0, "pad": 0}


def test_3d_unsupported_device_raises():
    cfg = small3()
    m = torch.zeros((8, 10, 14), dtype=torch.bool, device="meta")
    q = h3.PrimT(*(torch.zeros((8, 10, 14), device="meta") for _ in range(6)))
    with pytest.raises(ValueError, match="unsupported device"):
        hk3.wavespeed(cfg, q, m)


def test_3d_wrapper_checks():
    cfg = small3()
    s, qp, sp = padded3(cfg)
    dt = torch.tensor(1e-4)
    hk3._check_fields(cfg, qp, sp, hk3._padded_shape(cfg), "qp",
                      (("dt", dt), ("gain", dt)))  # accepted
    with pytest.raises(TypeError):
        hk3._check_fields(cfg, h3.PrimT(*(f.double() for f in qp)), sp,
                          hk3._padded_shape(cfg), "qp")
    with pytest.raises(ValueError, match="shape"):
        hk3._check_fields(cfg, h3.PrimT(*(f[:, :, :-1] for f in qp)), sp,
                          hk3._padded_shape(cfg), "qp")
    with pytest.raises(ValueError, match="contiguous"):
        hk3._check_fields(cfg, h3.PrimT(*(f.transpose(0, 2).contiguous()
                                          .transpose(0, 2) for f in qp)),
                          sp, hk3._padded_shape(cfg), "qp")
    with pytest.raises(ValueError, match="mask"):
        hk3._check_fields(cfg, qp, sp.float(), hk3._padded_shape(cfg), "qp")
    with pytest.raises(ValueError, match="mask"):
        hk3._check_fields(cfg, s[:6], sp, (8, 10, 14), "q1")
    with pytest.raises(ValueError, match="dt"):
        hk3._check_fields(cfg, qp, sp, hk3._padded_shape(cfg), "qp",
                          (("dt", torch.ones(2)),))


def test_3d_params_match_the_plain_constants():
    cfg = small3("float32")
    p = hk3._params(cfg, 5)
    assert (p.nz, p.ny, p.nx, p.nx_global, p.x0) == (8, 10, 14, 14, 5)
    assert (p.sponge_n, p.sponge_out_n) == (4, 3)
    assert p.gm1 == cfg.gamma_floor - 1.0
    assert p.R_theta_v == cfg.R * cfg.theta_v
    assert p.tau_vib == cfg.tau_vib and tuple(p.d) == (cfg.dx, cfg.dy, cfg.dz)
    assert tuple(p.inv_d) == (1.0 / cfg.dx, 1.0 / cfg.dy, 1.0 / cfg.dz)
    infl = h3.inflow_prim(cfg)
    for a, b in zip(p.infl, infl):
        assert np.float32(a) == b.numpy()
    assert p.tgt_ev == h3.evib_eq_py(cfg, cfg.inflow_p / (cfg.inflow_r * cfg.R))


def test_3d_load_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    _build.load_library.cache_clear()
    hk3.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        hk3.load()
