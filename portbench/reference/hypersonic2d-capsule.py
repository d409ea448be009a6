"""Plain PyTorch reference of the 2-D capsule flow (configuration
`hypersonic2d-capsule`): a frozen, self-contained copy of the whole-grid
MUSCL-Hancock + HLLC step with 4th-order diffusion, as the upstream
tau_hypersonic_cuda.cu states it (mask :740-770, inflow :772-784, CFL dt
:786-847 and :1852-1869, predict :849-962, HLLC :964-1030, update,
diffusion and repair :1032-1176).

It imports nothing of the program: the solid mask, the halo padding, the
inflow state and dt are worked out here from the configuration file.  Every
function takes the dtype it computes in, so the same code gives the
reference (the configuration's precision) and the lower-precision control.

Interface the harness uses (see portbench/README.md):
  FIELDS, CLOCK               names of the state's grid fields and scalars
  Reference(cfg, traffic, device)
    .solid                    bool (ny, nx), True = solid
    .scales                   {field: scale} for the comparison
    .noise_shape              shape of each seeded noise field
    .init(dtype, noise)       the perturbed initial state, a dict
    .frame(state, n, dtype)   n steps from a state dict, a new dict
"""

from __future__ import annotations

import functools
import math

import torch

FIELDS = ("rho", "mx", "my", "E")
CLOCK = ("t",)

EPS_RHO = 1e-25
EPS_P = 1e-25
_TINY = 1e-14
PAD = 2


class Config:
    """The run's constants: the configuration file's physics, the
    traffic's grid, and the geometry scaled to the grid by the upstream's
    rule (cy = ny/2, Rb = ny/12, Rn = ny/24, x0 = 125 nx/8192)."""

    def __init__(self, cfg: dict, traffic: dict):
        self.nx, self.ny = int(traffic["nx"]), int(traffic["ny"])
        for k in ("gamma", "cfl", "visc_nu", "visc_rho", "visc_e",
                  "inflow_mach", "geom_theta"):
            setattr(self, k, float(cfg[k]))
        g = cfg["geometry_per_grid"]
        self.geom_x0 = g["x0_per_nx"] * self.nx
        self.geom_cy = g["cy_per_ny"] * self.ny
        self.geom_Rb = g["Rb_per_ny"] * self.ny
        self.geom_Rn = g["Rn_per_ny"] * self.ny
        self.nu_max = max(self.visc_nu, self.visc_rho, self.visc_e)
        self.amplitude = float(cfg["perturbation"]["amplitude"])


# ----------------------------- gas dynamics --------------------------------

def _where(sel, a, b):
    return tuple(torch.where(sel, x, y) for x, y in zip(a, b))


def cons_to_prim(c, g):
    rho = torch.clamp_min(c[0], EPS_RHO)
    inv = torch.reciprocal(rho)
    u = c[1] * inv
    v = c[2] * inv
    kin = 0.5 * rho * (u * u + v * v)
    p = (g - 1.0) * torch.clamp_min(c[3] - kin, EPS_P)
    return (rho, u, v, p)


def prim_to_cons(q, g):
    rho = torch.clamp_min(q[0], EPS_RHO)
    pr = torch.clamp_min(q[3], EPS_P)
    return (rho, rho * q[1], rho * q[2],
            pr / (g - 1.0) + 0.5 * rho * (q[1] * q[1] + q[2] * q[2]))


def sound_speed(q, g):
    return torch.sqrt(g * torch.clamp_min(q[3], EPS_P)
                      / torch.clamp_min(q[0], EPS_RHO))


def flux(c, g, axis):
    q = cons_to_prim(c, g)
    if axis == 0:
        un = q[1]
        return (c[1], c[1] * un + q[3], c[2] * un, (c[3] + q[3]) * un)
    un = q[2]
    return (c[2], c[1] * un, c[2] * un + q[3], (c[3] + q[3]) * un)


def wall_ghost(q):
    return (q[0], -q[1], -q[2], q[3])


def clamp_prim(q):
    return (torch.clamp_min(q[0], EPS_RHO), q[1], q[2],
            torch.clamp_min(q[3], EPS_P))


def inflow_prim(c: Config, dtype, device):
    def s(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return (s(1.0), s(c.inflow_mach * math.sqrt(c.gamma)), s(0.0), s(1.0))


def inflow_cons(c: Config, dtype, device):
    return prim_to_cons(inflow_prim(c, dtype, device), c.gamma)


def _minmod(a, b):
    pick_a = torch.abs(a) < torch.abs(b)
    return torch.where(a * b > 0.0, torch.where(pick_a, a, b), 0.0)


def _mc(dl, dc, dr):
    return _minmod(_minmod(dl, dr), _minmod(_minmod(dc, 2.0 * dl),
                                            _minmod(dc, 2.0 * dr)))


def _positive_faces(qm, qc, qp):
    """Contract both faces toward the centre while either is not positive
    (8 rounds, :373-398)."""
    def blend(a, sel):
        half = tuple(0.5 * (x + y) for x, y in zip(a, qc))
        return _where(sel, half, a)

    for _ in range(8):
        bad = ((qm[0] <= EPS_RHO) | (qp[0] <= EPS_RHO)
               | (qm[3] <= EPS_P) | (qp[3] <= EPS_P))
        qm = blend(qm, bad)
        qp = blend(qp, bad)
    return clamp_prim(qm), clamp_prim(qp)


def reconstruct_faces(qm, qc, qp):
    s = tuple(_mc(c - m, 0.5 * (p - m), p - c) for m, c, p in zip(qm, qc, qp))
    qL = tuple(c - 0.5 * d for c, d in zip(qc, s))
    qR = tuple(c + 0.5 * d for c, d in zip(qc, s))
    return _positive_faces(qL, qc, qR)


def half_step_predict(q, dF, half_dt, g):
    c = prim_to_cons(q, g)
    c = tuple(x - half_dt * d for x, d in zip(c, dF))
    return clamp_prim(cons_to_prim(c, g))


def _safe_div(num, den):
    return num / torch.where(torch.abs(den) < _TINY, 1.0, den)


def hlle(UL, UR, g, axis):
    L, R = cons_to_prim(UL, g), cons_to_prim(UR, g)
    uL, uR = L[1 + axis], R[1 + axis]
    aL, aR = sound_speed(L, g), sound_speed(R, g)
    SL = torch.minimum(uL - aL, uR - aR)
    SR = torch.maximum(uL + aL, uR + aR)
    FL, FR = flux(UL, g, axis), flux(UR, g, axis)
    denom = SR - SL
    degenerate = tuple(0.5 * (a + b) for a, b in zip(FL, FR))
    inv = _safe_div(torch.ones_like(denom), denom)
    interior = tuple(inv * ((SR * fl + (-SL) * fr) + (SL * SR) * (ur - ul))
                     for fl, fr, ul, ur in zip(FL, FR, UL, UR))
    mid = _where(torch.abs(denom) < _TINY, degenerate, interior)
    return _where(SL >= 0.0, FL, _where(SR <= 0.0, FR, mid))


def hllc(UL, UR, g, axis):
    """HLLC with a per-face HLLE fallback on degenerate or non-finite star
    states (:519-606)."""
    L, R = cons_to_prim(UL, g), cons_to_prim(UR, g)
    unL, unR = L[1 + axis], R[1 + axis]
    utL, utR = L[2 - axis], R[2 - axis]
    aL, aR = sound_speed(L, g), sound_speed(R, g)
    SL = torch.minimum(unL - aL, unR - aR)
    SR = torch.maximum(unL + aL, unR + aR)
    FL, FR = flux(UL, g, axis), flux(UR, g, axis)
    rhoL, rhoR, pL, pR = L[0], R[0], L[3], R[3]

    num = pR - pL + rhoL * unL * (SL - unL) - rhoR * unR * (SR - unR)
    den = rhoL * (SL - unL) - rhoR * (SR - unR)
    SM = _safe_div(num, den)
    bad = (torch.abs(den) < _TINY) | ~torch.isfinite(num) | ~torch.isfinite(den)
    bad |= ~torch.isfinite(SM)
    pStar = torch.clamp_min(pL + rhoL * (SL - unL) * (SM - unL), EPS_P)
    dLS, dRS = SL - SM, SR - SM
    bad |= (torch.abs(dLS) < _TINY) | (torch.abs(dRS) < _TINY)
    rhoStarL = rhoL * _safe_div(SL - unL, dLS)
    rhoStarR = rhoR * _safe_div(SR - unR, dRS)
    bad |= ~(rhoStarL > 0.0) | ~(rhoStarR > 0.0)
    bad |= ~torch.isfinite(rhoStarL) | ~torch.isfinite(rhoStarR)
    EStarL = _safe_div((SL - unL) * UL[3] - pL * unL + pStar * SM, dLS)
    EStarR = _safe_div((SR - unR) * UR[3] - pR * unR + pStar * SM, dRS)
    bad |= ~torch.isfinite(EStarL) | ~torch.isfinite(EStarR)

    def star(rs, ut, es):
        mn, mt = rs * SM, rs * ut
        return (rs, mn, mt, es) if axis == 0 else (rs, mt, mn, es)

    UsL, UsR = star(rhoStarL, utL, EStarL), star(rhoStarR, utR, EStarR)
    FsL = tuple(f + SL * (us - u) for f, us, u in zip(FL, UsL, UL))
    FsR = tuple(f + SR * (us - u) for f, us, u in zip(FR, UsR, UR))
    st = _where(SM >= 0.0, FsL, FsR)
    interior = _where(bad, hlle(UL, UR, g, axis), st)
    return _where(SL >= 0.0, FL, _where(SR <= 0.0, FR, interior))


# ------------------------------- geometry ----------------------------------

def _segment(px, py, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    t = torch.clamp((apx * abx + apy * aby) / (abx * abx + aby * aby + 1e-30),
                    0.0, 1.0)
    return torch.sqrt((px - (ax + t * abx)) ** 2 + (py - (ay + t * aby)) ** 2)


def _xb(Rb, Rn, theta):
    xt = Rn * (1.0 - math.sin(theta))
    return xt + (Rb - Rn * math.cos(theta)) / max(math.tan(theta), 1e-30)


def build_solid(c: Config, dtype, device):
    """The rounded sphere-cone capsule (:633-686, 740-765): signed distance
    minus Rb, clipped behind the base plane, < 0 is solid."""
    Rb, Rn, th = c.geom_Rb, c.geom_Rn, c.geom_theta
    x = torch.arange(c.nx, dtype=dtype, device=device) - c.geom_x0
    y = torch.arange(c.ny, dtype=dtype, device=device) - c.geom_cy
    Y, X = torch.meshgrid(y, x, indexing="ij")
    r = torch.abs(Y)
    st, ct, tt = math.sin(th), math.cos(th), math.tan(th)
    xt, rt = Rn * (1.0 - st), Rn * ct
    xb = _xb(Rb, Rn, th)
    dxn = X - Rn
    r_sphere = torch.sqrt(torch.clamp_min(Rn * Rn - dxn * dxn, 0.0))
    r_cone = rt + (X - xt) * tt
    rprof = torch.where(X < 0.0, -1.0, torch.where(
        X <= xt, r_sphere, torch.where(X <= xb, r_cone, -1.0)))
    inside = (X >= 0.0) & (X <= xb) & (r <= rprof)
    d = torch.minimum(
        torch.minimum(torch.abs(torch.sqrt((X - Rn) ** 2 + r * r) - Rn),
                      _segment(X, r, xt, rt, xb, Rb)),
        torch.minimum(_segment(X, Y, xb, -Rb, xb, Rb),
                      torch.sqrt((X - xb) ** 2 + (r - Rb) ** 2)))
    sd = torch.where(inside, -d, d) - Rb
    return torch.maximum(sd, X - xb) < 0.0


# --------------------------------- step ------------------------------------

def _pad(c: Config, U, mask):
    """Halo-2 copy with the boundaries resolved: y edge-clamped, x < 0 the
    inflow, x >= nx the last column; the mask edge-clamped in y and False
    in the x pads."""
    H, W = mask.shape
    dev = mask.device
    infl = inflow_cons(c, U[0].dtype, dev)
    yi = torch.arange(-PAD, H + PAD, device=dev).clamp(0, H - 1)
    xi = torch.arange(0, W + PAD, device=dev).clamp(max=W - 1)
    Up = tuple(torch.cat([v.expand(H + 2 * PAD, PAD),
                          f.index_select(0, yi).index_select(1, xi)], dim=1)
               for f, v in zip(U, infl))
    xpad = torch.zeros((H + 2 * PAD, PAD), dtype=torch.bool, device=dev)
    return Up, torch.cat([xpad, mask.index_select(0, yi), xpad], dim=1)


def _win(f, y0, x0, h, w):
    return f[y0:y0 + h, x0:x0 + w]


def _cwin(c, y0, x0, h, w):
    return tuple(_win(f, y0, x0, h, w) for f in c)


def _core(c: Config, Up, Mp, dt):
    """Predict -> HLLC faces -> conservative update + diffusion -> repair
    on the padded block; returns the interior's new state."""
    hp, wp = Up[0].shape
    H, W = hp - 2 * PAD, wp - 2 * PAD
    g = c.gamma
    half_dt = 0.5 * dt
    Pp = cons_to_prim(Up, g)

    def predict(axis):
        if axis == 0:
            h, w, y0, x0, dy, dx = H, W + 2, PAD, PAD - 1, 0, 1
        else:
            h, w, y0, x0, dy, dx = H + 2, W, PAD - 1, PAD, 1, 0
        qc = _cwin(Pp, y0, x0, h, w)
        ghost = prim_to_cons(wall_ghost(qc), g)

        def nbr(sgn):
            Un = _cwin(Up, y0 + sgn * dy, x0 + sgn * dx, h, w)
            return _where(_win(Mp, y0 + sgn * dy, x0 + sgn * dx, h, w),
                          ghost, Un)

        qL, qR = reconstruct_faces(cons_to_prim(nbr(-1), g), qc,
                                   cons_to_prim(nbr(+1), g))
        FL = flux(prim_to_cons(qL, g), g, axis)
        FR = flux(prim_to_cons(qR, g), g, axis)
        dF = tuple(b - a for a, b in zip(FL, FR))
        pL = clamp_prim(half_step_predict(qL, dF, half_dt, g))
        pR = clamp_prim(half_step_predict(qR, dF, half_dt, g))
        return prim_to_cons(pL, g), prim_to_cons(pR, g)

    def faces(axis):
        lo, hi = predict(axis)
        if axis == 0:
            a = (PAD, PAD - 1, H, W + 1)
            b = (PAD, PAD, H, W + 1)
            UL_in = tuple(f[:, :-1] for f in hi)
            UR_in = tuple(f[:, 1:] for f in lo)
        else:
            a = (PAD - 1, PAD, H + 1, W)
            b = (PAD, PAD, H + 1, W)
            UL_in = tuple(f[:-1, :] for f in hi)
            UR_in = tuple(f[1:, :] for f in lo)
        fluidA, fluidB = ~_win(Mp, *a), ~_win(Mp, *b)
        ghostA = prim_to_cons(wall_ghost(_cwin(Pp, *b)), g)
        ghostB = prim_to_cons(wall_ghost(_cwin(Pp, *a)), g)
        F = hllc(_where(fluidA, UL_in, ghostA), _where(fluidB, UR_in, ghostB),
                 g, axis)
        return _where(fluidA | fluidB, F, tuple(torch.zeros_like(f)
                                                 for f in F))

    Fx = faces(0)
    Gy = faces(1)
    Uc = _cwin(Up, PAD, PAD, H, W)
    maskc = _win(Mp, PAD, PAD, H, W)
    center = _cwin(Pp, PAD, PAD, H, W)
    Un = tuple(u - dt * (f[:, 1:] - f[:, :-1]) - dt * (gy[1:, :] - gy[:-1, :])
               for u, f, gy in zip(Uc, Fx, Gy))

    ghost_c = prim_to_cons(wall_ghost(center), g)

    def dnbr(dy, dx):
        return _where(_win(Mp, PAD + dy, PAD + dx, H, W), ghost_c,
                      _cwin(Up, PAD + dy, PAD + dx, H, W))

    def d2(dy, dx):
        m2, m1 = dnbr(-2 * dy, -2 * dx), dnbr(-dy, -dx)
        p1, p2 = dnbr(dy, dx), dnbr(2 * dy, 2 * dx)
        return tuple((-a + 16.0 * b - 30.0 * cc + 16.0 * d - e) * (1.0 / 12.0)
                     for a, b, cc, d, e in zip(m2, m1, Uc, p1, p2))

    lap = tuple(a + b for a, b in zip(d2(0, 1), d2(1, 0)))
    Un = (Un[0] + (c.visc_rho * dt) * lap[0],
          Un[1] + (c.visc_nu * dt) * lap[1],
          Un[2] + (c.visc_nu * dt) * lap[2],
          Un[3] + (c.visc_e * dt) * lap[3])
    Un = (torch.clamp_min(Un[0], EPS_RHO),) + Un[1:]
    pp = cons_to_prim(Un, g)
    bad = ((pp[3] <= EPS_P) | ~torch.isfinite(pp[3]) | ~torch.isfinite(pp[0])
           | ~torch.isfinite(pp[1]) | ~torch.isfinite(pp[2]))
    Un = _where(bad, prim_to_cons(clamp_prim(pp), g), Un)
    return _where(maskc, Uc, Un)


def max_wavespeed(c: Config, U, mask):
    q = cons_to_prim(U, c.gamma)
    a = sound_speed(q, c.gamma)
    s = torch.maximum(torch.abs(q[1]) + a, torch.abs(q[2]) + a)
    s = torch.where(torch.isfinite(s), s, 1e-12)
    s = torch.where(mask, 1e-12, s)
    return torch.clamp_min(torch.amax(s), 1e-12)


def cfl_dt(c: Config, maxs):
    maxs = torch.clamp_min(torch.where(torch.isfinite(maxs), maxs, 1e-12),
                           1e-12)
    dt = torch.div(torch.full_like(maxs, c.cfl), maxs)
    if c.nu_max > 1e-12:
        dt = torch.clamp_max(dt, 0.25 / c.nu_max)
    return dt


def step(c: Config, U, mask, t):
    """Inflow column -> CFL dt on the device -> padded cell update."""
    fluid0 = ~mask[:, 0]
    U = tuple(f.clone() for f in U)
    for f, v in zip(U, inflow_cons(c, U[0].dtype, mask.device)):
        f[:, 0] = torch.where(fluid0, v, f[:, 0])
    dt = cfl_dt(c, max_wavespeed(c, U, mask))
    Up, Mp = _pad(c, U, mask)
    return _core(c, Up, Mp, dt), t + dt


class Reference:
    # standard normal fields of the seeded perturbation: density, pressure
    noise_fields = 2

    def __init__(self, cfg: dict, traffic: dict, device):
        self.c = Config(cfg, traffic)
        self.device = torch.device(device)
        self.dtype = getattr(torch, traffic["dtype"])
        self.noise_shape = (self.c.ny, self.c.nx)
        rho, mx, my, E = (float(v) for v in inflow_cons(
            self.c, torch.float64, "cpu"))
        self.scales = {"rho": rho, "mx": abs(mx), "my": abs(mx), "E": E}

    @functools.cached_property
    def solid(self):
        return build_solid(self.c, self.dtype, self.device)

    def work(self) -> dict:
        """The units of work the rate and the kernels' counts use: every
        cell of the grid, the fluid cells, and the stated precision."""
        return {"cells": self.solid.numel(),
                "fluid_cells": int((~self.solid).sum()),
                "itemsize": self.dtype.itemsize,
                "dtype": str(self.dtype).removeprefix("torch.")}

    def perturb(self, state: dict, noise) -> dict:
        """The seeded free-stream perturbation: density and pressure of the
        fluid cells scaled by 1 + amplitude * noise, velocity kept."""
        c = self.c
        U = tuple(state[k] for k in FIELDS)
        q = cons_to_prim(U, c.gamma)
        a = c.amplitude
        q = (q[0] * (1.0 + a * noise[0].to(q[0].dtype)), q[1], q[2],
             q[3] * (1.0 + a * noise[1].to(q[0].dtype)))
        out = _where(self.solid, U, prim_to_cons(q, c.gamma))
        return dict(zip(FIELDS, out), t=state["t"])

    def init(self, dtype, noise) -> dict:
        """Inflow everywhere, the stagnant (rho, 0, 0, p) in solid cells
        (:767-769), then the perturbation."""
        c, dev = self.c, self.device
        infl = inflow_prim(c, dtype, dev)
        shape = self.noise_shape

        def full(v):
            return v.expand(shape).contiguous()

        zero = torch.zeros(shape, dtype=dtype, device=dev)
        fluid = prim_to_cons(tuple(full(v) for v in infl), c.gamma)
        solid = prim_to_cons((full(infl[0]), zero, zero, full(infl[3])),
                             c.gamma)
        U = _where(self.solid, solid, fluid)
        state = dict(zip(FIELDS, U), t=torch.zeros((), dtype=dtype,
                                                   device=dev))
        return self.perturb(state, noise)

    def frame(self, state: dict, n: int, dtype) -> dict:
        U = tuple(state[k].to(dtype) for k in FIELDS)
        t = state["t"].to(dtype)
        for _ in range(n):
            U, t = step(self.c, U, self.solid, t)
        return dict(zip(FIELDS, U), t=t)
