// One cell update of the flagship 2-D hypersonic solver: BC padding +
// MUSCL-Hancock predict + HLLC faces + conservative update + 4th-order
// diffusion + positivity repair, i.e. `pad_bc` + `step_core_padded` of
// fluidsims_tpu_torch/solvers/hypersonic2d.py, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/hypersonic2d_pallas.py::
// _band_kernel (pallas_call at :156).  That kernel ran the same core on a
// VMEM-resident row band whose halo-2 padded copy the host built each step
// (Pallas blocks cannot overlap); here no padded copy exists: `load_bc`
// resolves the boundary conditions by index arithmetic with exactly the
// pad_bc semantics (y edge-clamped for fields and mask; x < 0 the inflow
// constant; x >= nx the last column; the mask False in the x pads).
//
// Design: one block a tile of Geo::tx x Geo::ty cells (a size for float
// and one for double), one thread a cell of the
// tile.  The block stages the four conserved fields and the mask of the
// tile plus a halo of 2 in shared memory, then per axis (x, then y):
// one MUSCL-Hancock predict per fluid cell over the tile plus one ring
// along the axis, into shared memory; one HLLC solve per face, into a
// shared flux array of that axis.  Then each cell's conservative update
// (x faces, then y faces, as the plain version sums them), the 5-tap
// diffusion from the staged fields and the repair.  So the function's
// work is done once: 2 predicts and 2 HLLC solves a cell, plus the halo's
// ring (tx + 2 of tx predicts along x, ty + 2 of ty along y).  A face
// between a fluid cell and a solid one takes the fluid cell's wall ghost,
// a face between two solid cells is never read, and solid cells copy
// their input.  Every value is formed from the same inputs by the same
// expressions in the same order as in a cell-by-cell evaluation, so the
// results do not depend on the tile.  dt is read from a one-element device
// tensor.
//
// What bounds it on an H100: arithmetic, not bytes.  At 2048^2 f32 a step
// streams ~67 MB of fields + 4 MB of mask in and 67 MB out (~41 us at
// 3.35 TB/s); a fluid cell costs ~790 operations (HYP2D_STEP_OPS_PER_
// FLUID_CELL in chip_smoke.py), ~50 of them IEEE divisions and 4 square
// roots, unfused (-fmad=false).  Registers limit occupancy (ptxas' counts
// are in the build log, which chip_smoke.py prints with the launch's
// tiling); __launch_bounds__ asks for Geo::min_blocks blocks an SM.
#include "euler2d.cuh"
#include "tiles.cuh"

namespace fst {
namespace {

// The tile of each dtype, and the halo.  The sweep of tools/
// tune_tiles_torch.py (--set hypersonic), one build a candidate with
// -DFST_HYP2D_TILE_X=... (float) and -DFST_HYP2D_F64_TILE_X=... (double),
// chose them at the main runs' shapes (PERF.md): float 16x16 (the least
// ring for 256 threads); double 16x8, whose 128-thread blocks keep more
// warps an SM at ~94 registers than 256-thread ones (~11% faster than
// 32x8 at 8192x1024).
#ifndef FST_HYP2D_TILE_X
#define FST_HYP2D_TILE_X 16
#endif
#ifndef FST_HYP2D_TILE_Y
#define FST_HYP2D_TILE_Y 16
#endif
#ifndef FST_HYP2D_F64_TILE_X
#define FST_HYP2D_F64_TILE_X 16
#endif
#ifndef FST_HYP2D_F64_TILE_Y
#define FST_HYP2D_F64_TILE_Y 8
#endif
constexpr int kHalo = 2;

// The geometry of a T tile: tx x ty cells, one thread a cell; the staged
// window (the tile plus the halo, wx cells a row); the predicted cells of
// an axis (the tile plus one ring along it); the faces of each axis; the
// blocks an SM that __launch_bounds__ asks registers for (768 threads an
// SM for float, at most 85 registers a thread; 512 for double, 128); the
// dynamic shared memory a block.
template <typename T>
struct Geo {
  static constexpr int tx = sizeof(T) == 4 ? FST_HYP2D_TILE_X
                                           : FST_HYP2D_F64_TILE_X;
  static constexpr int ty = sizeof(T) == 4 ? FST_HYP2D_TILE_Y
                                           : FST_HYP2D_F64_TILE_Y;
  static constexpr int threads = tx * ty;
  static_assert(threads % 32 == 0 && threads <= 1024,
                "a tile is a whole number of warps, at most 1024 cells");
  static constexpr int wx = tx + 2 * kHalo;
  static constexpr int win = wx * (ty + 2 * kHalo);
  static constexpr int pred_x = (tx + 2) * ty, pred_y = tx * (ty + 2);
  static constexpr int pred = pred_x > pred_y ? pred_x : pred_y;
  static constexpr int fx = (tx + 1) * ty, fy = tx * (ty + 1);
  static constexpr int min_blocks =
      (sizeof(T) == 4 ? 768 : 512) / threads > 1
          ? (sizeof(T) == 4 ? 768 : 512) / threads : 1;
  static constexpr size_t smem =
      sizeof(T) * (4 * win + 8 * pred + 4 * fx + 4 * fy) + win;
};

template <typename T>
struct StepArgs {
  const T* __restrict__ f[4];          // rho, mx, my, E  (ny, nx) row-major
  const uint8_t* __restrict__ mask;    // bool (ny, nx), 1 = solid
  const T* __restrict__ dt;            // one element, on the device
  T* __restrict__ out[4];
  int ny, nx;
  Gas<T> gas;
  T visc_rho, visc_nu, visc_e;
  Q4<T> infl;
};

// Field value at logical (y, x) with the BCs of pad_bc (x >= nx: the last
// column, so also the cells of a ragged tile past the grid).
template <typename T>
__device__ __forceinline__ Q4<T> load_bc(const StepArgs<T>& A, int y, int x) {
  if (x < 0) return A.infl;
  const int yc = min(max(y, 0), A.ny - 1);
  const int xc = min(x, A.nx - 1);
  const size_t i = (size_t)yc * A.nx + xc;
  return {__ldg(A.f[0] + i), __ldg(A.f[1] + i), __ldg(A.f[2] + i),
          __ldg(A.f[3] + i)};
}

template <typename T>
__device__ __forceinline__ bool solid_bc(const StepArgs<T>& A, int y, int x) {
  if (x < 0 || x >= A.nx) return false;
  const int yc = min(max(y, 0), A.ny - 1);
  return __ldg(A.mask + (size_t)yc * A.nx + x) != 0;
}

// The block's shared memory: four fields a Q4 array, component-major, so
// that consecutive threads touch consecutive words.
template <typename T>
struct Q4Array {
  T* c[4];
  __device__ __forceinline__ Q4<T> get(int i) const {
    return {c[0][i], c[1][i], c[2][i], c[3][i]};
  }
  __device__ __forceinline__ void put(int i, Q4<T> q) const {
    c[0][i] = q.r; c[1][i] = q.a; c[2][i] = q.b; c[3][i] = q.e;
  }
};

template <typename T>
struct Tile {
  Q4Array<T> u;       // Geo::win: the staged fields
  Q4Array<T> lo, hi;  // Geo::pred: predicted face states of an axis
  Q4Array<T> fx;      // Geo::fx: x-face fluxes, face (ly, j) left of cell j
  Q4Array<T> fy;      // Geo::fy: y-face fluxes, face (j, lx) below row j
  uint8_t* m;         // Geo::win: the staged mask
};

template <typename T>
__device__ Tile<T> carve(unsigned char* base) {
  using G = Geo<T>;
  Tile<T> t;
  T* p = reinterpret_cast<T*>(base);
  for (int k = 0; k < 4; ++k) t.u.c[k] = p + k * G::win;
  p += 4 * G::win;
  for (int k = 0; k < 4; ++k) t.lo.c[k] = p + k * G::pred;
  p += 4 * G::pred;
  for (int k = 0; k < 4; ++k) t.hi.c[k] = p + k * G::pred;
  p += 4 * G::pred;
  for (int k = 0; k < 4; ++k) t.fx.c[k] = p + k * G::fx;
  p += 4 * G::fx;
  for (int k = 0; k < 4; ++k) t.fy.c[k] = p + k * G::fy;
  p += 4 * G::fy;
  t.m = reinterpret_cast<uint8_t*>(p);
  return t;
}

template <typename T>
__device__ __forceinline__ T slope(T m, T c, T p) {
  return mc_limiter(c - m, T(0.5) * (p - m), p - c);
}

template <typename T>
__device__ __forceinline__ Q4<T> blend(Q4<T> a, Q4<T> c) {
  return {T(0.5) * (a.r + c.r), T(0.5) * (a.a + c.a), T(0.5) * (a.b + c.b),
          T(0.5) * (a.e + c.e)};
}

template <typename T>
__device__ __forceinline__ Q4<T> half_step(Q4<T> q, Q4<T> dF, T half_dt,
                                           Gas<T> g) {
  Q4<T> c = prim_to_cons(q, g);
  c = {c.r - half_dt * dF.r, c.a - half_dt * dF.a, c.b - half_dt * dF.b,
       c.e - half_dt * dF.e};
  return clamp_prim(cons_to_prim(c, g));
}

// The no-slip wall ghost of conserved state U: what a solid neighbour
// shows a fluid cell, in its predict, its faces and its diffusion.
template <typename T>
__device__ __forceinline__ Q4<T> ghost_of(Q4<T> U, Gas<T> g) {
  return prim_to_cons(wall_ghost(cons_to_prim(U, g)), g);
}

// MUSCL-Hancock predicted (low, high) face states, in conserved variables,
// of the fluid cell with state Uc along AXIS (predict_axis of the solver),
// from its neighbours' states and solid flags along the axis.
template <typename T, int AXIS>
__device__ void predict(Q4<T> Uc, Q4<T> Um, bool sm, Q4<T> Up, bool sp,
                        T half_dt, Gas<T> g, Q4<T>* lo, Q4<T>* hi) {
  const Q4<T> qc = cons_to_prim(Uc, g);
  const Q4<T> ghost = prim_to_cons(wall_ghost(qc), g);
  const Q4<T> qm = cons_to_prim(sm ? ghost : Um, g);
  const Q4<T> qp = cons_to_prim(sp ? ghost : Up, g);

  // reconstruct_faces: MC-limited slopes to the two faces ...
  const T sr = slope(qm.r, qc.r, qp.r), sa = slope(qm.a, qc.a, qp.a);
  const T sb = slope(qm.b, qc.b, qp.b), se = slope(qm.e, qc.e, qp.e);
  Q4<T> qL = {qc.r - T(0.5) * sr, qc.a - T(0.5) * sa, qc.b - T(0.5) * sb,
              qc.e - T(0.5) * se};
  Q4<T> qR = {qc.r + T(0.5) * sr, qc.a + T(0.5) * sa, qc.b + T(0.5) * sb,
              qc.e + T(0.5) * se};
  // ... then enforce_positive_faces.  The Python version runs 8 masked
  // rounds; a round leaves a valid pair untouched and it stays valid, so
  // stopping at the first valid round gives the same values.
  for (int it = 0; it < 8; ++it) {
    const bool bad = (qL.r <= eps_rho<T>()) || (qR.r <= eps_rho<T>()) ||
                     (qL.e <= eps_p<T>()) || (qR.e <= eps_p<T>());
    if (!bad) break;
    qL = blend(qL, qc);
    qR = blend(qR, qc);
  }
  qL = clamp_prim(qL);
  qR = clamp_prim(qR);

  const Q4<T> cL = prim_to_cons(qL, g), cR = prim_to_cons(qR, g);
  const Q4<T> FL = flux_of<T, AXIS>(cL, cons_to_prim(cL, g));
  const Q4<T> FR = flux_of<T, AXIS>(cR, cons_to_prim(cR, g));
  const Q4<T> dF = {FR.r - FL.r, FR.a - FL.a, FR.b - FL.b, FR.e - FL.e};
  *lo = prim_to_cons(clamp_prim(half_step(qL, dF, half_dt, g)), g);
  *hi = prim_to_cons(clamp_prim(half_step(qR, dF, half_dt, g)), g);
}

// One axis: the predicts of the tile plus one ring along AXIS into lo and
// hi, then one HLLC solve a face into F.
template <typename T, int AXIS>
__device__ void axis_fluxes(const Tile<T>& t, Q4Array<T> F, T half_dt,
                            Gas<T> g) {
  using G = Geo<T>;
  constexpr int tx = G::tx, wx = G::wx;
  // cells along the axis a line, lines of the tile across it
  constexpr int n = AXIS == 0 ? tx : G::ty;
  constexpr int lines = AXIS == 0 ? G::ty : tx;
  constexpr int stride = AXIS == 0 ? 1 : wx;
  // predicted cell k: AXIS 0, k = ly (tx + 2) + (lx + 1); AXIS 1,
  // k = (ly + 1) tx + lx; for lx or ly in [-1, n] along the axis
  for (int k = threadIdx.x; k < (n + 2) * lines; k += G::threads) {
    const int a = AXIS == 0 ? k % (n + 2) - 1 : k / tx - 1;
    const int b = AXIS == 0 ? k / (n + 2) : k % tx;
    const int w = AXIS == 0 ? (b + kHalo) * wx + a + kHalo
                            : (a + kHalo) * wx + b + kHalo;
    if (t.m[w]) continue;  // a solid cell's faces take the wall ghost
    Q4<T> lo, hi;
    predict<T, AXIS>(t.u.get(w), t.u.get(w - stride), t.m[w - stride] != 0,
                     t.u.get(w + stride), t.m[w + stride] != 0, half_dt, g,
                     &lo, &hi);
    t.lo.put(k, lo);
    t.hi.put(k, hi);
  }
  __syncthreads();
  // face f between cells j - 1 and j along the axis, j in [0, n]: AXIS 0,
  // f = ly (tx + 1) + j; AXIS 1, f = j tx + lx
  for (int f = threadIdx.x; f < (n + 1) * lines; f += G::threads) {
    const int j = AXIS == 0 ? f % (n + 1) : f / tx;
    const int b = AXIS == 0 ? f / (n + 1) : f % tx;
    const int wr = AXIS == 0 ? (b + kHalo) * wx + j + kHalo
                             : (j + kHalo) * wx + b + kHalo;
    const int wl = wr - stride;
    const int kr = AXIS == 0 ? b * (n + 2) + j + 1 : (j + 1) * tx + b;
    const int kl = AXIS == 0 ? kr - 1 : kr - tx;
    const bool sl = t.m[wl] != 0, sr = t.m[wr] != 0;
    Q4<T> flux = {T(0), T(0), T(0), T(0)};  // two solid sides: never read
    if (!(sl && sr)) {
      const Q4<T> UL = sl ? ghost_of(t.u.get(wr), g) : t.hi.get(kl);
      const Q4<T> UR = sr ? ghost_of(t.u.get(wl), g) : t.lo.get(kr);
      flux = hllc<T, AXIS>(UL, UR, g);
    }
    F.put(f, flux);
  }
}

template <typename T>
__device__ __forceinline__ T d2(T a, T b, T c, T d, T e) {
  return (-a + T(16) * b - T(30) * c + T(16) * d - e) * T(1.0 / 12.0);
}

template <typename T>
__global__ void __launch_bounds__(Geo<T>::threads, Geo<T>::min_blocks)
step_kernel(const StepArgs<T> A) {
  using G = Geo<T>;
  constexpr int tx = G::tx, kWX = G::wx;
  extern __shared__ __align__(16) unsigned char fst_smem[];
  const Tile<T> t = carve<T>(fst_smem);
  const int ox = blockIdx.x * tx, oy = blockIdx.y * G::ty;
  const Gas<T> g = A.gas;

  // the tile plus its halo, with the BCs resolved
  for (int i = threadIdx.x; i < G::win; i += G::threads) {
    const int wy = i / kWX, wx = i - wy * kWX;
    const int y = oy + wy - kHalo, x = ox + wx - kHalo;
    t.u.put(i, load_bc(A, y, x));
    t.m[i] = solid_bc(A, y, x);
  }
  const T dt = *A.dt;
  const T half_dt = T(0.5) * dt;
  __syncthreads();
  axis_fluxes<T, 0>(t, t.fx, half_dt, g);
  __syncthreads();  // the y predicts reuse lo and hi
  axis_fluxes<T, 1>(t, t.fy, half_dt, g);
  __syncthreads();

  const int ly = threadIdx.x / tx, lx = threadIdx.x - ly * tx;
  const int y = oy + ly, x = ox + lx;
  if (x >= A.nx || y >= A.ny) return;
  const size_t i = (size_t)y * A.nx + x;
  const int w = (ly + kHalo) * kWX + lx + kHalo;
  const Q4<T> Uc = t.u.get(w);
  if (t.m[w]) {  // solid cells keep their state
    A.out[0][i] = Uc.r; A.out[1][i] = Uc.a; A.out[2][i] = Uc.b;
    A.out[3][i] = Uc.e;
    return;
  }
  const Q4<T> Fx0 = t.fx.get(ly * (tx + 1) + lx);
  const Q4<T> Fx1 = t.fx.get(ly * (tx + 1) + lx + 1);
  const Q4<T> Gy0 = t.fy.get(ly * tx + lx);
  const Q4<T> Gy1 = t.fy.get((ly + 1) * tx + lx);

  // conservative update
  Q4<T> Un = {
      Uc.r - dt * (Fx1.r - Fx0.r) - dt * (Gy1.r - Gy0.r),
      Uc.a - dt * (Fx1.a - Fx0.a) - dt * (Gy1.a - Gy0.a),
      Uc.b - dt * (Fx1.b - Fx0.b) - dt * (Gy1.b - Gy0.b),
      Uc.e - dt * (Fx1.e - Fx0.e) - dt * (Gy1.e - Gy0.e)};

  // diffusion (4th-order 5-tap, halo 2); a solid neighbour takes the
  // centre's wall ghost
  const Q4<T> ghost_c = ghost_of(Uc, g);
  auto dnbr = [&](int d) {
    return t.m[w + d] ? ghost_c : t.u.get(w + d);
  };
  const Q4<T> xm2 = dnbr(-2), xm1 = dnbr(-1), xp1 = dnbr(1), xp2 = dnbr(2);
  const Q4<T> ym2 = dnbr(-2 * kWX), ym1 = dnbr(-kWX), yp1 = dnbr(kWX),
              yp2 = dnbr(2 * kWX);
  const Q4<T> lap = {
      d2(xm2.r, xm1.r, Uc.r, xp1.r, xp2.r) + d2(ym2.r, ym1.r, Uc.r, yp1.r, yp2.r),
      d2(xm2.a, xm1.a, Uc.a, xp1.a, xp2.a) + d2(ym2.a, ym1.a, Uc.a, yp1.a, yp2.a),
      d2(xm2.b, xm1.b, Uc.b, xp1.b, xp2.b) + d2(ym2.b, ym1.b, Uc.b, yp1.b, yp2.b),
      d2(xm2.e, xm1.e, Uc.e, xp1.e, xp2.e) + d2(ym2.e, ym1.e, Uc.e, yp1.e, yp2.e)};
  Un.r = Un.r + (A.visc_rho * dt) * lap.r;
  Un.a = Un.a + (A.visc_nu * dt) * lap.a;
  Un.b = Un.b + (A.visc_nu * dt) * lap.b;
  Un.e = Un.e + (A.visc_e * dt) * lap.e;

  // positivity / finiteness repair
  Un.r = nmax(Un.r, eps_rho<T>());
  const Q4<T> pp = cons_to_prim(Un, g);
  const bool bad = (pp.e <= eps_p<T>()) || !isfinite(pp.e) ||
                   !isfinite(pp.r) || !isfinite(pp.a) || !isfinite(pp.b);
  if (bad) Un = prim_to_cons(clamp_prim(pp), g);

  A.out[0][i] = Un.r; A.out[1][i] = Un.a; A.out[2][i] = Un.b;
  A.out[3][i] = Un.e;
}

// The launch of a step on an (ny, nx) grid (the report of the library's
// launch query, fst::TileLaunch): blocks (one a tile), threads a block,
// the tile, the halo and the dynamic shared memory a block.
template <typename T>
int make_launch(int ny, int nx, TileLaunch* L) {
  using G = Geo<T>;
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((nx + G::tx - 1) / G::tx) *
                          ((ny + G::ty - 1) / G::ty);
  *L = {(int)tiles, G::threads, G::tx, G::ty, kHalo, (int)G::smem};
  return 0;
}

template <typename T>
int launch_step(const T* rho, const T* mx, const T* my, const T* E,
                const uint8_t* mask, const T* dt, T* o_rho, T* o_mx, T* o_my,
                T* o_E, const Hyp2DParams* p, int device, void* stream) {
  TileLaunch L;
  int code = make_launch<T>(p->ny, p->nx, &L);
  if (code != 0) return code;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool raised[kMaxDevices] = {};
  code = allow_smem(step_kernel<T>, (size_t)L.smem_bytes, device, raised);
  if (code != 0) return code;
  StepArgs<T> A;
  A.f[0] = rho; A.f[1] = mx; A.f[2] = my; A.f[3] = E;
  A.mask = mask;
  A.dt = dt;
  A.out[0] = o_rho; A.out[1] = o_mx; A.out[2] = o_my; A.out[3] = o_E;
  A.ny = p->ny;
  A.nx = p->nx;
  A.gas = {T(p->gamma), T(p->gm1)};
  A.visc_rho = T(p->visc_rho);
  A.visc_nu = T(p->visc_nu);
  A.visc_e = T(p->visc_e);
  A.infl = {T(p->infl[0]), T(p->infl[1]), T(p->infl[2]), T(p->infl[3])};
  const dim3 grid((p->nx + L.tile_x - 1) / L.tile_x,
                  (p->ny + L.tile_y - 1) / L.tile_y);
  step_kernel<T><<<grid, L.threads, (size_t)L.smem_bytes,
                   (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of a step on an (ny, nx) grid (fst::TileLaunch), computed as
// the step's launch computes it.
int fst_hyp2d_step_launch_f32(int ny, int nx, fst::TileLaunch* out) {
  return fst::make_launch<float>(ny, nx, out);
}

int fst_hyp2d_step_launch_f64(int ny, int nx, fst::TileLaunch* out) {
  return fst::make_launch<double>(ny, nx, out);
}

int fst_hyp2d_step_f32(const float* rho, const float* mx, const float* my,
                       const float* E, const uint8_t* mask, const float* dt,
                       float* o_rho, float* o_mx, float* o_my, float* o_E,
                       const fst::Hyp2DParams* p, int device, void* stream) {
  return fst::launch_step<float>(rho, mx, my, E, mask, dt, o_rho, o_mx, o_my,
                                 o_E, p, device, stream);
}

int fst_hyp2d_step_f64(const double* rho, const double* mx, const double* my,
                       const double* E, const uint8_t* mask, const double* dt,
                       double* o_rho, double* o_mx, double* o_my, double* o_E,
                       const fst::Hyp2DParams* p, int device, void* stream) {
  return fst::launch_step<double>(rho, mx, my, E, mask, dt, o_rho, o_mx, o_my,
                                  o_E, p, device, stream);
}

const char* fst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
