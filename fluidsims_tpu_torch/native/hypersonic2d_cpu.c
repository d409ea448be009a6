/* Native CPU 2-D hypersonic solver (MUSCL-Hancock + HLLC, slip walls).
 *
 * Host-side counterpart of solvers/hypersonic2d_cpu.py and
 * the auto-vectorizable analog of the reference's SIMD build (behavioral
 * spec: tau_hypersonic.c:117-671, tau_hypersonic_simd.c:5-11 "bit-for-bit
 * math order preserved"): the per-cell arithmetic and the face-update
 * application order match the vectorized NumPy implementation exactly
 * (subtract pass over low cells, then add pass over high cells, x axis
 * then y axis), so the two agree to the last bit modulo libm.
 *
 * Build: cc -O3 -shared -fPIC hypersonic2d_cpu.c -o libhypersonic2d_cpu.so -lm
 * (solvers/hypersonic2d_cpu_native.py of fluidsims_tpu_torch builds it at
 * first use into build/).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define EPS_RHO 1e-10
#define EPS_P 1e-10

typedef struct H2Sim {
    int w, h;
    double gamma, cfl, mach;
    double t;
    double *U;     /* (h, w, 4): rho, mx, my, E */
    uint8_t *mask;
    /* work buffers */
    double *Unew;
    double *predL, *predR; /* (h, w, 4) prim */
    double *Fface;         /* max(h,w)-1 faces per line * other dim * 4 */
    double infl_prim[4], infl_cons[4];
} H2Sim;

static inline double dmax(double a, double b) { return a > b ? a : b; }
static inline double dmin(double a, double b) { return a < b ? a : b; }

static inline void cons_to_prim(const H2Sim *s, const double *c, double *q) {
    double rho = dmax(c[0], EPS_RHO);
    double u = c[1] / rho, v = c[2] / rho;
    double eint = c[3] - 0.5 * rho * (u * u + v * v);
    q[0] = rho;
    q[1] = u;
    q[2] = v;
    q[3] = (s->gamma - 1.0) * dmax(eint, EPS_P);
}

static inline void prim_to_cons(const H2Sim *s, const double *q, double *c) {
    double rho = dmax(q[0], EPS_RHO);
    double p = dmax(q[3], EPS_P);
    c[0] = rho;
    c[1] = rho * q[1];
    c[2] = rho * q[2];
    c[3] = p / (s->gamma - 1.0) + 0.5 * rho * (q[1] * q[1] + q[2] * q[2]);
}

/* slip wall: v_n -> -v_n, v_t unchanged; via the same prim/cons roundtrip
 * (and its clamps) as the reference path */
static inline void reflect_slip(const H2Sim *s, const double *cons,
                                double nx, double ny, double *out_cons) {
    double q[4];
    cons_to_prim(s, cons, q);
    double vn = -(q[1] * nx + q[2] * ny);
    double ut = -q[1] * ny + q[2] * nx;
    double q2[4] = {q[0], vn * nx - ut * ny, vn * ny + ut * nx, q[3]};
    prim_to_cons(s, q2, out_cons);
}

/* flux from CONSERVED state: the primitive roundtrip (with its clamps and
 * the (rho*u)/rho division) is part of the reference arithmetic */
static inline void flux(const H2Sim *s, const double *c, int axis,
                        double *F) {
    double q[4];
    cons_to_prim(s, c, q);
    double un = axis == 0 ? q[1] : q[2];
    double p = q[3];
    if (axis == 0) {
        F[0] = c[1];
        F[1] = c[1] * un + p;
        F[2] = c[2] * un;
    } else {
        F[0] = c[2];
        F[1] = c[1] * un;
        F[2] = c[2] * un + p;
    }
    F[3] = (c[3] + p) * un;
}

static inline double minmod(double a, double b) {
    if (a * b <= 0.0) return 0.0;
    return fabs(a) < fabs(b) ? a : b;
}

static inline double mc_lim(double dl, double dc, double dr) {
    double mm1 = minmod(dl, dr);
    double mm2 = minmod(dc, 2.0 * dl);
    double mm3 = minmod(dc, 2.0 * dr);
    return minmod(mm1, minmod(mm2, mm3));
}

/* neighbor_or_wall: cons state of cell (y+dy, x+dx) with BCs resolved */
static inline void neighbor_or_wall(const H2Sim *s, int x, int y, int dx,
                                    int dy, double nx, double ny,
                                    double *out) {
    int w = s->w, h = s->h;
    int yn = y + dy;
    if (yn < 0) yn = 0;
    if (yn >= h) yn = h - 1;
    int xn = x + dx;
    if (xn < 0) {
        memcpy(out, s->infl_cons, sizeof(double) * 4);
        return;
    }
    int xc = xn >= w ? w - 1 : xn;
    if (xn < w && s->mask[(size_t)yn * w + xc]) {
        reflect_slip(s, s->U + ((size_t)y * w + x) * 4, nx, ny, out);
        return;
    }
    memcpy(out, s->U + ((size_t)yn * w + xc) * 4, sizeof(double) * 4);
}

static void reconstruct_and_predict(H2Sim *s, int axis, double half_dt) {
    int w = s->w, h = s->h;
    int dx = axis == 0 ? 1 : 0, dy = axis == 0 ? 0 : 1;
    double nx = axis == 0 ? 1.0 : 0.0, ny = axis == 0 ? 0.0 : 1.0;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            size_t i = ((size_t)y * w + x) * 4;
            double cm[4], cp[4], qm[4], qc[4], qp[4];
            neighbor_or_wall(s, x, y, -dx, -dy, nx, ny, cm);
            neighbor_or_wall(s, x, y, dx, dy, nx, ny, cp);
            cons_to_prim(s, cm, qm);
            cons_to_prim(s, s->U + i, qc);
            cons_to_prim(s, cp, qp);

            double qL[4], qR[4];
            for (int k = 0; k < 4; k++) {
                double sl = mc_lim(qc[k] - qm[k], 0.5 * (qp[k] - qm[k]),
                                   qp[k] - qc[k]);
                qL[k] = qc[k] - 0.5 * sl;
                qR[k] = qc[k] + 0.5 * sl;
            }
            for (int it = 0; it < 8; it++) {
                int bad = qL[0] <= EPS_RHO || qR[0] <= EPS_RHO
                          || qL[3] <= EPS_P || qR[3] <= EPS_P;
                if (!bad) break;
                for (int k = 0; k < 4; k++) {
                    qL[k] = 0.5 * (qL[k] + qc[k]);
                    qR[k] = 0.5 * (qR[k] + qc[k]);
                }
            }
            qL[0] = dmax(qL[0], EPS_RHO);
            qR[0] = dmax(qR[0], EPS_RHO);
            qL[3] = dmax(qL[3], EPS_P);
            qR[3] = dmax(qR[3], EPS_P);

            /* Hancock predictor from the cell's own face fluxes */
            double cL[4], cR[4], FL[4], FR[4];
            prim_to_cons(s, qL, cL);
            prim_to_cons(s, qR, cR);
            flux(s, cL, axis, FL);
            flux(s, cR, axis, FR);
            double *pL = s->predL + i, *pR = s->predR + i;
            for (int k = 0; k < 4; k++) {
                double dF = FR[k] - FL[k];
                cL[k] = cL[k] - half_dt * dF;
                cR[k] = cR[k] - half_dt * dF;
            }
            cons_to_prim(s, cR, pR);
            pR[0] = dmax(pR[0], EPS_RHO);
            pR[3] = dmax(pR[3], EPS_P);
            cons_to_prim(s, cL, pL);
            pL[0] = dmax(pL[0], EPS_RHO);
            pL[3] = dmax(pL[3], EPS_P);
        }
}

static inline void hllc(const H2Sim *s, const double *qL, const double *qR,
                        int axis, double *out) {
    double g = s->gamma;
    double UL[4], UR[4], FL[4], FR[4];
    prim_to_cons(s, qL, UL);
    prim_to_cons(s, qR, UR);
    int nidx = axis == 0 ? 1 : 2, tidx = axis == 0 ? 2 : 1;
    double unL = qL[nidx], unR = qR[nidx];
    double utL = qL[tidx], utR = qR[tidx];
    double rhoL = qL[0], rhoR = qR[0], pL = qL[3], pR = qR[3];
    double aL = sqrt(g * dmax(pL, EPS_P) / dmax(rhoL, EPS_RHO));
    double aR = sqrt(g * dmax(pR, EPS_P) / dmax(rhoR, EPS_RHO));
    double SL = dmin(unL - aL, unR - aR);
    double SR = dmax(unL + aL, unR + aR);
    flux(s, UL, axis, FL);
    flux(s, UR, axis, FR);

    if (SL >= 0.0) {
        memcpy(out, FL, sizeof(double) * 4);
        return;
    }
    if (SR <= 0.0) {
        memcpy(out, FR, sizeof(double) * 4);
        return;
    }

    double den = rhoL * (SL - unL) - rhoR * (SR - unR);
    if (fabs(den) < 1e-300) den = 1e-300;
    double SM = (pR - pL + rhoL * unL * (SL - unL) - rhoR * unR * (SR - unR))
                / den;
    double pStar = dmax(pL + rhoL * (SL - unL) * (SM - unL), EPS_P);

    const double *qs;
    const double *Ub, *Fb;
    double S, un, ut;
    if (SM >= 0.0) {
        qs = qL; Ub = UL; Fb = FL; S = SL; un = unL; ut = utL;
    } else {
        qs = qR; Ub = UR; Fb = FR; S = SR; un = unR; ut = utR;
    }
    double dS = S - SM;
    if (fabs(dS) < 1e-300) dS = 1e-300;
    double rs = qs[0] * (S - un) / dS;
    double es = ((S - un) * Ub[3] - qs[3] * un + pStar * SM) / dS;
    double Ustar[4];
    Ustar[0] = rs;
    if (axis == 0) {
        Ustar[1] = rs * SM;
        Ustar[2] = rs * ut;
    } else {
        Ustar[1] = rs * ut;
        Ustar[2] = rs * SM;
    }
    Ustar[3] = es;
    for (int k = 0; k < 4; k++) out[k] = Fb[k] + S * (Ustar[k] - Ub[k]);
}

static inline double dt_cell_speed(const H2Sim *s, size_t i) {
    double q[4];
    cons_to_prim(s, s->U + i * 4, q);
    double a = sqrt(s->gamma * dmax(q[3], EPS_P) / dmax(q[0], EPS_RHO));
    return dmax(fabs(q[1]) + a, fabs(q[2]) + a);
}

#if defined(__AVX2__)
/* Hand-vectorized wavespeed scan.
 *
 * Design: the state layout is cell-interleaved (h, w, 4), so four
 * consecutive cells are sixteen consecutive doubles.  Instead of
 * gathering each field across strided positions, issue four contiguous
 * 32-byte loads -- one whole cell per register -- and transpose the 4x4
 * register block into per-field vectors with unpack/permute moves
 * (contiguous loads keep the access pattern inside one cache line pair;
 * there are no gather instructions in this file).  Solid cells are
 * handled by blending their lanes to the reduction seed rather than
 * branching to scalar code, so blocks straddling the obstacle rim still
 * run vectorized; only fully-solid blocks are skipped.  Each lane
 * performs the exact arithmetic sequence of dt_cell_speed(), and the
 * reduction is a pure max, so the result is bitwise equal to the scalar
 * loop (asserted against the NumPy port in tests/test_hypersonic2d_cpu
 * .py; same equality contract the reference pair claims for itself). */

typedef struct {
    __m256d rho, mx, my, E;
} CellBlock4;

static inline CellBlock4 load_cell_block4(const double *cell0) {
    __m256d c0 = _mm256_loadu_pd(cell0);      /* rho0 mx0 my0 E0 */
    __m256d c1 = _mm256_loadu_pd(cell0 + 4);
    __m256d c2 = _mm256_loadu_pd(cell0 + 8);
    __m256d c3 = _mm256_loadu_pd(cell0 + 12);
    __m256d lo01 = _mm256_unpacklo_pd(c0, c1); /* rho0 rho1 my0 my1 */
    __m256d hi01 = _mm256_unpackhi_pd(c0, c1); /* mx0  mx1  E0  E1  */
    __m256d lo23 = _mm256_unpacklo_pd(c2, c3);
    __m256d hi23 = _mm256_unpackhi_pd(c2, c3);
    CellBlock4 b;
    b.rho = _mm256_permute2f128_pd(lo01, lo23, 0x20);
    b.my = _mm256_permute2f128_pd(lo01, lo23, 0x31);
    b.mx = _mm256_permute2f128_pd(hi01, hi23, 0x20);
    b.E = _mm256_permute2f128_pd(hi01, hi23, 0x31);
    return b;
}

/* max cell wavespeed over cells [0, nvec) (nvec % 4 == 0), seeded */
static double simd_max_wavespeed(const H2Sim *s, size_t nvec, double seed) {
    const __m256d vgam = _mm256_set1_pd(s->gamma);
    const __m256d vgm1 = _mm256_set1_pd(s->gamma - 1.0);
    const __m256d vhalf = _mm256_set1_pd(0.5);
    const __m256d veps_r = _mm256_set1_pd(EPS_RHO);
    const __m256d veps_p = _mm256_set1_pd(EPS_P);
    const __m256d vseed = _mm256_set1_pd(seed);
    const __m256d vmag =
        _mm256_castsi256_pd(_mm256_set1_epi64x(0x7fffffffffffffffLL));
    __m256d acc = vseed;
    for (size_t i = 0; i < nvec; i += 4) {
        uint32_t mbits;
        memcpy(&mbits, s->mask + i, 4);
        if (mbits == 0x01010101u) continue; /* whole block inside solid */
        CellBlock4 b = load_cell_block4(s->U + i * 4);
        __m256d rho = _mm256_max_pd(b.rho, veps_r);
        __m256d u = _mm256_div_pd(b.mx, rho);
        __m256d v = _mm256_div_pd(b.my, rho);
        __m256d ke = _mm256_mul_pd(
            _mm256_mul_pd(vhalf, rho),
            _mm256_add_pd(_mm256_mul_pd(u, u), _mm256_mul_pd(v, v)));
        __m256d p = _mm256_mul_pd(
            vgm1, _mm256_max_pd(_mm256_sub_pd(b.E, ke), veps_p));
        __m256d a = _mm256_sqrt_pd(_mm256_div_pd(
            _mm256_mul_pd(vgam, _mm256_max_pd(p, veps_p)),
            _mm256_max_pd(rho, veps_r)));
        __m256d spd = _mm256_max_pd(
            _mm256_add_pd(_mm256_and_pd(u, vmag), a),
            _mm256_add_pd(_mm256_and_pd(v, vmag), a));
        if (mbits) { /* rim block: silence solid lanes, keep fluid lanes */
            __m256d keep = _mm256_castsi256_pd(_mm256_set_epi64x(
                s->mask[i + 3] ? 0 : -1LL, s->mask[i + 2] ? 0 : -1LL,
                s->mask[i + 1] ? 0 : -1LL, s->mask[i + 0] ? 0 : -1LL));
            spd = _mm256_blendv_pd(vseed, spd, keep);
        }
        acc = _mm256_max_pd(acc, spd);
    }
    /* horizontal max: fold the 128-bit halves, then the 64-bit pairs */
    acc = _mm256_max_pd(acc, _mm256_permute2f128_pd(acc, acc, 0x01));
    acc = _mm256_max_pd(acc, _mm256_permute_pd(acc, 0x5));
    return _mm256_cvtsd_f64(acc);
}
#endif

static double compute_dt(const H2Sim *s) {
    size_t n = (size_t)s->w * s->h;
    double smax = 1e-12;
    size_t i = 0;

#if defined(__AVX2__)
    size_t nvec = n & ~(size_t)3;
    if (nvec) {
        double vm = simd_max_wavespeed(s, nvec, smax);
        if (vm > smax) smax = vm;
        i = nvec;
    }
#endif

    for (; i < n; i++) {
        if (s->mask[i]) continue;
        double sp = dt_cell_speed(s, i);
        if (sp > smax) smax = sp;
    }
    return s->cfl * 1.0 / smax;
}

static void step_once(H2Sim *s) {
    int w = s->w, h = s->h;
    double dt = compute_dt(s);
    double half_dt = 0.5 * dt;

    for (int y = 0; y < h; y++)
        if (!s->mask[(size_t)y * w])
            memcpy(s->U + (size_t)y * w * 4, s->infl_cons,
                   sizeof(double) * 4);

    memcpy(s->Unew, s->U, sizeof(double) * (size_t)h * w * 4);

    for (int axis = 0; axis < 2; axis++) {
        double nx = axis == 0 ? 1.0 : 0.0, ny = axis == 0 ? 0.0 : 1.0;
        reconstruct_and_predict(s, axis, half_dt);

        int nfy = axis == 0 ? h : h - 1;
        int nfx = axis == 0 ? w - 1 : w;
        /* face (fy, fx) sits between lo=(fy,fx) and hi=(fy+dy, fx+dx) */
        int dx = axis == 0 ? 1 : 0, dy = axis == 0 ? 0 : 1;
        for (int fy = 0; fy < nfy; fy++)
            for (int fx = 0; fx < nfx; fx++) {
                size_t lo = (size_t)fy * w + fx;
                size_t hi = (size_t)(fy + dy) * w + (fx + dx);
                int mL = s->mask[lo], mR = s->mask[hi];
                double qLf[4], qRf[4], gh[4];
                if (mL) {
                    reflect_slip(s, s->U + hi * 4, nx, ny, gh);
                    cons_to_prim(s, gh, qLf);
                } else {
                    memcpy(qLf, s->predR + lo * 4, sizeof(double) * 4);
                }
                if (mR) {
                    reflect_slip(s, s->U + lo * 4, nx, ny, gh);
                    cons_to_prim(s, gh, qRf);
                } else {
                    memcpy(qRf, s->predL + hi * 4, sizeof(double) * 4);
                }
                qLf[0] = dmax(qLf[0], EPS_RHO);
                qLf[3] = dmax(qLf[3], EPS_P);
                qRf[0] = dmax(qRf[0], EPS_RHO);
                qRf[3] = dmax(qRf[3], EPS_P);
                double *F = s->Fface + ((size_t)fy * nfx + fx) * 4;
                if (mL && mR) {
                    F[0] = F[1] = F[2] = F[3] = 0.0;
                } else {
                    hllc(s, qLf, qRf, axis, F);
                }
            }
        /* subtract pass over low cells, then add pass over high cells —
         * same application order as the vectorized reference */
        for (int fy = 0; fy < nfy; fy++)
            for (int fx = 0; fx < nfx; fx++) {
                size_t lo = (size_t)fy * w + fx;
                if (s->mask[lo]) continue;
                const double *F = s->Fface + ((size_t)fy * nfx + fx) * 4;
                for (int k = 0; k < 4; k++)
                    s->Unew[lo * 4 + k] -= dt * F[k];
            }
        for (int fy = 0; fy < nfy; fy++)
            for (int fx = 0; fx < nfx; fx++) {
                size_t hi = (size_t)(fy + dy) * w + (fx + dx);
                if (s->mask[hi]) continue;
                const double *F = s->Fface + ((size_t)fy * nfx + fx) * 4;
                for (int k = 0; k < 4; k++)
                    s->Unew[hi * 4 + k] += dt * F[k];
            }
    }

    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            size_t i = (size_t)y * w + x;
            double *c = s->Unew + i * 4;
            c[0] = dmax(c[0], EPS_RHO);
            double q[4];
            cons_to_prim(s, c, q);
            if (q[3] <= EPS_P) {
                q[3] = dmax(q[3], EPS_P);
                prim_to_cons(s, q, c);
            }
            if (!s->mask[i])
                memcpy(s->U + i * 4, c, sizeof(double) * 4);
        }
    s->t += dt;
}

/* -------------------------------- C API --------------------------------- */

H2Sim *h2_create(int w, int h, double gamma, double cfl, double mach) {
    if (w <= 4 || h <= 4) return NULL;
    H2Sim *s = (H2Sim *)calloc(1, sizeof(H2Sim));
    s->w = w;
    s->h = h;
    s->gamma = gamma;
    s->cfl = cfl;
    s->mach = mach;
    s->t = 0.0;
    size_t n4 = (size_t)w * h * 4;
    s->U = (double *)malloc(sizeof(double) * n4);
    s->Unew = (double *)malloc(sizeof(double) * n4);
    s->predL = (double *)malloc(sizeof(double) * n4);
    s->predR = (double *)malloc(sizeof(double) * n4);
    s->Fface = (double *)malloc(sizeof(double) * n4);
    s->mask = (uint8_t *)malloc((size_t)w * h);

    double a = sqrt(gamma);
    s->infl_prim[0] = 1.0;
    s->infl_prim[1] = mach * a;
    s->infl_prim[2] = 0.0;
    s->infl_prim[3] = 1.0;
    prim_to_cons(s, s->infl_prim, s->infl_cons);

    int cx = w / 3, cy = h / 2, r = h / 6;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int ddx = x - cx, ddy = y - cy;
            s->mask[(size_t)y * w + x] = ddx * ddx + ddy * ddy < r * r;
        }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            size_t i = (size_t)y * w + x;
            double q[4];
            memcpy(q, s->infl_prim, sizeof q);
            if (s->mask[i]) {
                q[1] = 0.0;
                q[2] = 0.0;
            }
            prim_to_cons(s, q, s->U + i * 4);
        }
    return s;
}

void h2_destroy(H2Sim *s) {
    if (!s) return;
    free(s->U);
    free(s->Unew);
    free(s->predL);
    free(s->predR);
    free(s->Fface);
    free(s->mask);
    free(s);
}

void h2_get(const H2Sim *s, double *U, uint8_t *mask, double *t) {
    if (U) memcpy(U, s->U, sizeof(double) * (size_t)s->w * s->h * 4);
    if (mask) memcpy(mask, s->mask, (size_t)s->w * s->h);
    if (t) *t = s->t;
}

void h2_set(H2Sim *s, const double *U, double t) {
    memcpy(s->U, U, sizeof(double) * (size_t)s->w * s->h * 4);
    s->t = t;
}

void h2_step(H2Sim *s, int n_steps) {
    for (int i = 0; i < n_steps; i++) step_once(s);
}
