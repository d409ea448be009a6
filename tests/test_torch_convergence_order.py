"""Port: the order-of-accuracy gate of tests/test_convergence_order.py.

A smooth density pulse in the uniform Mach-0.1 inflow state is an exact
contact; the flagship's plain PyTorch step at 100, 200 and 400 cells
(40 steps per 100 cells, one final time) must converge at order > 1.7,
with u and p uniform to 1e-3 (tests/analytic_gates.py).
"""

import torch

from tests import analytic_gates as ag

torch.set_num_threads(1)


def test_contact_advection_is_second_order():
    ag.convergence(torch.device("cpu")).check()
