"""The port's 3-D hypersonic step against the independent float64 oracle
(tests/oracles/hypersonic3d_oracle.py), as tests/test_hypersonic3d.py
holds the JAX package to it: 10 steps at 10x8x8, < 1e-10 relative."""

import numpy as np
import torch

from fluidsims_tpu_torch.solvers import hypersonic3d as th
from tests.oracles.hypersonic3d_oracle import Oracle3D

torch.set_num_threads(1)


def test_matches_loop_oracle_f64():
    # t0=5e-3 puts the inflow ramp gain at ~0.25+ so the sponge drives real
    # dynamics (shock formation, WENO + wall branches) within a few steps
    cfg = th.Hypersonic3DConfig(
        nx=10, ny=8, nz=8, dx=1.0 / 10, dy=1.0 / 8, dz=1.0 / 8,
        sponge_n=3, sponge_out_n=3, t0=5e-3, dtau0=5e-3, dtype="float64",
    )
    s = th.init(cfg, torch.device("cpu"))
    orc = Oracle3D(cfg)

    # a uniform +x velocity in both, so the outlet's reversed-flow branch
    # is well determined
    u0 = 0.05
    fl = ~s.solid
    phix = s.phix.clone()
    phix[fl] = float(np.arcsinh(u0 / cfg.u_ref))
    s = s._replace(phix=phix)
    orc.q[..., 1] = np.where(fl.numpy(), u0, orc.q[..., 1])

    for _ in range(10):
        s = th.step(cfg, s)
        orc.step()
    assert float(s.phix.abs().max()) > 1e-3

    got = np.stack([
        s.xi.exp().numpy(),
        cfg.u_ref * np.sinh(s.phix.numpy()),
        cfg.u_ref * np.sinh(s.phiy.numpy()),
        cfg.u_ref * np.sinh(s.phiz.numpy()),
        s.lam.exp().numpy(),
        s.zet.exp().numpy(),
    ], axis=-1)
    fl = ~s.solid.numpy()
    ref = orc.q
    scale = np.maximum(np.abs(ref[fl]), 1e-3)
    rel = np.abs(got[fl] - ref[fl]) / scale
    assert float(rel.max()) < 1e-10, f"max rel err {rel.max()}"
    np.testing.assert_allclose(float(s.t), orc.t, rtol=1e-10)
    np.testing.assert_allclose(float(s.dtau), orc.dtau, rtol=1e-10)
