"""WENO5 reconstruction (Jiang–Shu weights).

Port of fluidsims_tpu.ops.weno.  Behavioral spec: weno5_left/weno5_right
of the 3-D reference solver (tau_hypersonic_3d_cuda.cu:534-563): classic
5-point WENO with eps=1e-6 and linear weights (0.1, 0.6, 0.3); the
right-biased variant is the mirror.  Vectorized over whole grids.

Every quotient whose dividend is a Python number is taken tensor by tensor:
`c / tensor` in torch multiplies by a rounded reciprocal, one rounding more
than JAX's division and the CUDA kernel's.
"""

from __future__ import annotations

import torch

__all__ = ["weno5_left", "weno5_right", "weno5_lr_slab", "WENO_EPS"]

WENO_EPS = 1e-6


def _recip_sq(t):
    """1 / (t * t), divided as JAX divides."""
    return torch.div(torch.ones_like(t), t * t)


def weno5_left(v0, v1, v2, v3, v4):
    """Left-biased WENO5 face value from 5 upwind samples."""
    p0 = (2.0 * v0 - 7.0 * v1 + 11.0 * v2) * (1.0 / 6.0)
    p1 = (-1.0 * v1 + 5.0 * v2 + 2.0 * v3) * (1.0 / 6.0)
    p2 = (2.0 * v2 + 5.0 * v3 - 1.0 * v4) * (1.0 / 6.0)

    d0, e0 = v0 - 2.0 * v1 + v2, v0 - 4.0 * v1 + 3.0 * v2
    d1, e1 = v1 - 2.0 * v2 + v3, v1 - v3
    d2, e2 = v2 - 2.0 * v3 + v4, 3.0 * v2 - 4.0 * v3 + v4
    b0 = (13.0 / 12.0) * (d0 * d0) + 0.25 * (e0 * e0)
    b1 = (13.0 / 12.0) * (d1 * d1) + 0.25 * (e1 * e1)
    b2 = (13.0 / 12.0) * (d2 * d2) + 0.25 * (e2 * e2)

    def alpha(w, b):
        t = WENO_EPS + b
        return torch.div(torch.full_like(t, w), t * t)

    a0 = alpha(0.1, b0)
    a1 = alpha(0.6, b1)
    a2 = alpha(0.3, b2)
    s = a0 + a1 + a2
    return (a0 * p0 + a1 * p1 + a2 * p2) / s


def weno5_right(v0, v1, v2, v3, v4):
    """Right-biased WENO5 (mirror of the left-biased stencil)."""
    return weno5_left(v4, v3, v2, v1, v0)


def weno5_lr_slab(fp, axis: int, halo: int = 3):
    """Both face reconstructions (L, R) for every face of a `halo`-padded
    cell array, with the cross-face/cross-side arithmetic shared.

    Equivalent to calling weno5_left / weno5_right on the 6 shifted cell
    windows (to ~1 ulp: alpha = w * (1/(eps+beta)^2) instead of
    w / (eps+beta)^2).  The smoothness indicators and their reciprocal
    squares are computed once per cell and shared by both sides
    (beta_R(face k) = (S2, S1, S0) at face k+1), and the candidate
    polynomials pair up (p1_R(k) = p2_L(k), p2_R(k) = p1_L(k)).

    `fp` has extent n + 2*halo along `axis` (halo >= 3); returns (L, R)
    tensors of extent n + 1 (one per face).  The CUDA step kernel
    (csrc/hypersonic3d.cuh: weno_weights, weno_left, weno_right)
    evaluates the same expressions in the same order, the weights once a
    cell and each side of a face once."""
    if halo < 3:
        raise ValueError("weno5_lr_slab needs halo >= 3")
    n = fp.shape[axis] - 2 * halo

    def s(off, length):
        # slice by PADDED offset: cell i sits at padded offset i + halo
        return torch.narrow(fp, axis, halo - 3 + off, length)

    # Face k (k = 0..n) sits between cells c = k-1 and c+1 = k; off 0
    # addresses cell -3 (the first cell face 0's stencils reach).
    c13 = 13.0 / 12.0
    # D[j] = (13/12) * d2_{j-2}^2 over cells j-2 in [-2, n+1]
    d2 = s(0, n + 4) - 2.0 * s(1, n + 4) + s(2, n + 4)
    D = c13 * d2 * d2
    # per-cell edge/central forms over i = j-1 in [-1, n] (length n+2)
    cd = s(3, n + 2) - s(1, n + 2)                        # v_{i+1} - v_{i-1}
    C = 0.25 * cd * cd
    gd = s(0, n + 2) - 4.0 * s(1, n + 2) + 3.0 * s(2, n + 2)
    G = 0.25 * gd * gd                                    # (v_{i-2}-4v_{i-1}+3v_i)
    fd = 3.0 * s(2, n + 2) - 4.0 * s(3, n + 2) + s(4, n + 2)
    F = 0.25 * fd * fd                                    # (3v_i-4v_{i+1}+v_{i+2})
    # candidate polynomials per face k = 0..n (left cell c = k-1)
    A = (2.0 * s(0, n + 1) - 7.0 * s(1, n + 1)
         + 11.0 * s(2, n + 1)) * (1.0 / 6.0)              # p0_L (cell c)
    M = (-s(1, n + 1) + 5.0 * s(2, n + 1)
         + 2.0 * s(3, n + 1)) * (1.0 / 6.0)               # p1_L = p2_R
    N = (2.0 * s(2, n + 1) + 5.0 * s(3, n + 1)
         - s(4, n + 1)) * (1.0 / 6.0)                     # p2_L = p1_R
    B = (11.0 * s(3, n + 1) - 7.0 * s(4, n + 1)
         + 2.0 * s(5, n + 1)) * (1.0 / 6.0)               # p0_R (cell c+1)

    def sub(a, j0, length):
        return torch.narrow(a, axis, j0, length)

    # shared beta arrays over i = j-1 in [-1, n] (length n+2):
    #   S0_i = D_{i-1} + G_i, S1_i = D_i + C_i, S2_i = D_{i+1} + F_i
    S0 = sub(D, 0, n + 2) + G
    S1 = sub(D, 1, n + 2) + C
    S2 = sub(D, 2, n + 2) + F
    inv = [_recip_sq(WENO_EPS + S) for S in (S0, S1, S2)]

    # left-biased face k: betas at cell i = c = k-1 -> j = k (slice [0:n+1])
    a0 = 0.1 * sub(inv[0], 0, n + 1)
    a1 = 0.6 * sub(inv[1], 0, n + 1)
    a2 = 0.3 * sub(inv[2], 0, n + 1)
    L = (a0 * A + a1 * M + a2 * N) / (a0 + a1 + a2)

    # right-biased face k reuses the SAME betas at i = c+1 with 0<->2 swap
    r0 = 0.1 * sub(inv[2], 1, n + 1)
    r1 = 0.6 * sub(inv[1], 1, n + 1)
    r2 = 0.3 * sub(inv[0], 1, n + 1)
    R = (r0 * B + r1 * N + r2 * M) / (r0 + r1 + r2)
    return L, R
