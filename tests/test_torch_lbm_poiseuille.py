"""Port: the Poiseuille gate of tests/test_lbm.py.

Body-forced D2Q9 channel flow from rest, 20,000 plain PyTorch steps on
32x34 f32, must relax to the exact parabola within 2% of its peak
(tests/analytic_gates.py).
"""

import torch

from tests import analytic_gates as ag

torch.set_num_threads(1)


def test_poiseuille_matches_analytic():
    ag.poiseuille(torch.device("cpu")).check()
