"""Port: the long-horizon f32 gate of tests/test_long_horizon.py.

The flagship at default_config(128, 64) runs 1000 plain PyTorch steps in
f32 and in f64; the regression snapshots (f64 sums on the host) at 500
and 1000 steps must agree to 2e-6 relative on sum_rho, sum_E and sum_mx,
with equal fluid cells, positivity and max Mach within 1e-2
(tests/analytic_gates.py).
"""

import torch

from tests import analytic_gates as ag

torch.set_num_threads(1)


def test_flagship_1000_step_f32_drift_vs_f64():
    ag.long_horizon(torch.device("cpu")).check()
