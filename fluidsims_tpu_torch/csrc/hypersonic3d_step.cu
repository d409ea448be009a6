// One cell update of the 3-D hypersonic solver: WENO5 faces -> HLLC with
// wall mirroring -> conservative update -> repair -> Landau-Teller ->
// sponges, i.e. `step_core_padded` of fluidsims_tpu_torch/solvers/
// hypersonic3d.py (slab sponges), for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/hypersonic3d_pallas.py::
// _band_kernel (pallas_call at :135).  That kernel ran the same core on
// a VMEM-resident z band assembled from three overlapping blocks, with
// y tiles padded to 8 rows and dense wall fluxes and sponges, all forced
// by Mosaic.  None of that is carried over: this kernel reads the halo-3
// padded primitives that `_padded_prims` builds in torch, computes the
// function per face and cell, and applies each sponge only in its x slab.
//
// Design: one block a tile of kTX x kTY x kTZ cells, one thread a cell of
// the tile.  For each axis in turn (x, then y, then z, so that dU sums in
// the plain version's order) the block
//  1. stages the tile's padded primitives and solid flags, with a halo of
//     3 along that axis only, in shared memory;
//  2. reconstructs: each cell of the tile plus one ring along the axis
//     forms its three reciprocal smoothness weights once a field
//     (weno_weights) and from them the left state of the face right of it
//     and the right state of the face left of it (weno_left, weno_right),
//     so each face's (L, R) pair is formed once;
//  3. solves each face once: a face with any solid among the six cells
//     around it takes the floored first-order pair, then HLLC; a face
//     touching a solid cell is not one flux, since each side solves its
//     own mirrored problem, so its HLLC is skipped and
//  4. each cell takes its faces' fluxes, or its own mirrored problem at a
//     face that touches a solid (minus face hllc_wall_flux(q, left=false),
//     plus face left=true), once a side, and adds -(Fp - Fm) / d to its dU
//     (kept in shared memory).
// Then each cell's U1 = U0 + dt dU, the repair to inflow, Landau-Teller and
// the sponges.  Every value is formed from the same inputs by the same
// expressions in the same order as in a cell-by-cell evaluation, so the
// results do not depend on the tile.  dt and the inflow gain are read from
// one-element device tensors.
//
// What bounds it on an H100: arithmetic.  A cell costs ~2,300 operations
// (HYP3D_STEP_OPS_PER_CELL in chip_smoke.py): per axis 6 fields x ~76 for
// the WENO pair (~32 for a cell's weights, 3 divisions; ~44 for a face's
// candidate polynomials and weighted sums, 2 divisions), ~12 floors and
// one HLLC (~250), and ~150 for U0, the update, the decode, repair,
// Landau-Teller and sponges.  At 256^3 f32 that is ~39 GFLOP, 0.58 ms at
// 67 TFLOP/s, against ~0.85 GB of traffic (0.25 ms at 3.35 TB/s).  The
// ring costs (kT + 2) / kT of the reconstruction and (kT + 1) / kT of the
// solves along each axis.  Registers limit occupancy (ptxas' counts are in
// the build log, which chip_smoke.py prints with the launch's tiling).
#include "hypersonic3d.cuh"
#include "tiles.cuh"

namespace fst {

// What the step's launch query reports (mirrored by kernels/
// hypersonic3d_cuda.py Tile3Launch): the blocks (one a tile), threads a
// block, the tile, the halo along the staged axis and the dynamic shared
// memory a block, as the launch computes them.
struct Tile3Launch {
  int grid, threads, tile_x, tile_y, tile_z, halo, smem_bytes;
};

namespace {

// The tile, one for float and double (the main runs are float): the sweep
// of tools/tune_tiles_torch.py (--set hypersonic), one build a candidate
// with -DFST_HYP3D_TILE_X=... and so on, found 8x8x8 fastest at 64^3 and
// 256^3 (PERF.md): 512 threads of at most 64 registers keep two blocks an
// SM, and a longer line along z costs less ring than 8x8x4's.
#ifndef FST_HYP3D_TILE_X
#define FST_HYP3D_TILE_X 8
#endif
#ifndef FST_HYP3D_TILE_Y
#define FST_HYP3D_TILE_Y 8
#endif
#ifndef FST_HYP3D_TILE_Z
#define FST_HYP3D_TILE_Z 8
#endif
constexpr int kTX = FST_HYP3D_TILE_X;
constexpr int kTY = FST_HYP3D_TILE_Y;
constexpr int kTZ = FST_HYP3D_TILE_Z;
constexpr int kHalo = 3;
constexpr int kThreads = kTX * kTY * kTZ;
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "a tile is a whole number of warps, at most 1024 cells");

// Along AXIS: the tile's cells a line (n), its lines (m), the staged window
// (n + 6 cells a line) and the faces (n + 1 a line).
template <int AXIS>
struct Along {
  static constexpr int n = AXIS == 0 ? kTX : AXIS == 1 ? kTY : kTZ;
  static constexpr int m = kThreads / n;
  static constexpr int win = (n + 2 * kHalo) * m;
  static constexpr int faces = (n + 1) * m;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kWin = cmax(Along<0>::win, cmax(Along<1>::win, Along<2>::win));
constexpr int kFaces =
    cmax(Along<0>::faces, cmax(Along<1>::faces, Along<2>::faces));

// Blocks an SM that __launch_bounds__ asks registers for: 768 threads an
// SM for float (at most 85 registers a thread), 512 for double (128).
template <typename T>
struct MinBlocks {
  static constexpr int want = (sizeof(T) == 4 ? 768 : 512) / kThreads;
  static constexpr int value = want > 1 ? want : 1;
};

// Shared memory: the staged primitives (6 x kWin), each face's L and R (6
// x kFaces each; a face's flux overwrites its L), dU (6 x kThreads), the
// staged solid flags (kWin).
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (6 * kWin + 12 * kFaces + 6 * kThreads) + kWin;
}

template <typename T>
struct Step3Args {
  const T* __restrict__ q[6];          // padded prims (nz+6, ny+6, nx+6)
  const uint8_t* __restrict__ solid;   // padded solid mask, 1 = solid
  const T* __restrict__ dt;            // one element, on the device
  const T* __restrict__ gain;          // one element, on the device
  T* __restrict__ out[6];              // (nz, ny, nx)
  int nz, ny, nx;                      // interior cells
  int nx_global, x0, sponge_n, sponge_out_n;
  Gas3<T> gas;
  T inv_d[3];
  T infl[6];
  T tau_vib, sponge_strength, sponge_out_strength, tgt_r, tgt_p, tgt_ev;
  T inflow_vel[3];
};

template <typename T>
struct Tile3 {
  T* q[6];     // kWin: staged primitives of the current axis
  T* L[6];     // kFaces: left states, then fluxes
  T* R[6];     // kFaces: right states
  T* dU[6];    // kThreads: each cell's sum over the axes done
  uint8_t* s;  // kWin: staged solid flags
};

template <typename T>
__device__ Tile3<T> carve(unsigned char* base) {
  Tile3<T> t;
  T* p = reinterpret_cast<T*>(base);
  for (int k = 0; k < 6; ++k) t.q[k] = p + k * kWin;
  p += 6 * kWin;
  for (int k = 0; k < 6; ++k) t.L[k] = p + k * kFaces;
  p += 6 * kFaces;
  for (int k = 0; k < 6; ++k) t.R[k] = p + k * kFaces;
  p += 6 * kFaces;
  for (int k = 0; k < 6; ++k) t.dU[k] = p + k * kThreads;
  p += 6 * kThreads;
  t.s = reinterpret_cast<uint8_t*>(p);
  return t;
}

// Indices along AXIS.  A line's cross index c counts the tile's lines with
// x fastest (along x: y then z; along y: x then z; along z: x then y), so
// that consecutive threads take consecutive x in device memory.  Window
// position p in [0, n + 6) is the line's cell p - 3; face j in [0, n] lies
// between its cells j - 1 and j.
template <int AXIS>
__device__ __forceinline__ int win_index(int p, int c) {
  using G = Along<AXIS>;
  return AXIS == 0 ? c * (G::n + 2 * kHalo) + p : p * G::m + c;
}

template <int AXIS>
__device__ __forceinline__ int face_index(int j, int c) {
  using G = Along<AXIS>;
  return AXIS == 0 ? c * (G::n + 1) + j : j * G::m + c;
}

// Tile cell (lx, ly, lz) of thread t, x fastest.
__device__ __forceinline__ void cell_of(int t, int* lx, int* ly, int* lz) {
  *lx = t % kTX;
  *ly = (t / kTX) % kTY;
  *lz = t / (kTX * kTY);
}

template <int AXIS>
__device__ __forceinline__ void line_of(int lx, int ly, int lz, int* p,
                                        int* c) {
  if (AXIS == 0) {
    *p = lx;
    *c = ly + kTY * lz;
  } else if (AXIS == 1) {
    *p = ly;
    *c = lx + kTX * lz;
  } else {
    *p = lz;
    *c = lx + kTX * ly;
  }
}

// All of the tile's work along AXIS: adds -(Fp - Fm) * inv_d to each
// cell's dU (sets it along x).
template <typename T, int AXIS>
__device__ void axis_update(const Step3Args<T>& A, const Tile3<T>& t,
                            int ox, int oy, int oz) {
  using G = Along<AXIS>;
  constexpr int n = G::n, m = G::m, wn = n + 2 * kHalo;
  const Gas3<T>& g = A.gas;
  const ptrdiff_t pnx = (ptrdiff_t)A.nx + 6, pny = (ptrdiff_t)A.ny + 6;

  // 1. stage: window position p of line c is padded cell o + p along the
  // axis; coordinates past the padded grid (a ragged tile) are clamped,
  // and only cells past the interior read them
  for (int i = threadIdx.x; i < G::win; i += kThreads) {
    const int p = AXIS == 0 ? i % wn : i / m;
    const int c = AXIS == 0 ? i / wn : i % m;
    int X, Y, Z;
    if (AXIS == 0) {
      X = ox + p;
      Y = oy + c % kTY + kHalo;
      Z = oz + c / kTY + kHalo;
    } else if (AXIS == 1) {
      X = ox + c % kTX + kHalo;
      Y = oy + p;
      Z = oz + c / kTX + kHalo;
    } else {
      X = ox + c % kTX + kHalo;
      Y = oy + c / kTX + kHalo;
      Z = oz + p;
    }
    X = min(X, A.nx + 5);
    Y = min(Y, A.ny + 5);
    Z = min(Z, A.nz + 5);
    const ptrdiff_t gi = ((ptrdiff_t)Z * pny + Y) * pnx + X;
#pragma unroll
    for (int f = 0; f < 6; ++f) t.q[f][i] = __ldg(A.q[f] + gi);
    t.s[i] = __ldg(A.solid + gi);
  }
  __syncthreads();

  // 2. reconstruct: cell k of the line (k in [-1, n], window position
  // k + 3) forms L of face k + 1 and R of face k, where those faces are
  // solved from WENO states (no solid among the six cells around them)
  for (int i = threadIdx.x; i < (n + 2) * m; i += kThreads) {
    const int k = AXIS == 0 ? i % (n + 2) - 1 : i / m - 1;
    const int c = AXIS == 0 ? i / (n + 2) : i % m;
    const int p = k + kHalo;
    bool s6[7];  // solid flags of cells k - 3 .. k + 3 (positions p-3..p+3)
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      const int pd = p + d - 3;
      s6[d] = pd >= 0 && pd < wn && t.s[win_index<AXIS>(pd, c)] != 0;
    }
    bool deg_m = false, deg_p = false;  // a solid among cells -3..+2 / -2..+3
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      deg_m = deg_m || s6[d];
      deg_p = deg_p || s6[d + 1];
    }
    const bool want_l = k < n && !deg_p;
    const bool want_r = k >= 0 && !deg_m;
    if (!want_l && !want_r) continue;
    const int fl = face_index<AXIS>(k + 1, c), fr = face_index<AXIS>(k, c);
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      T v[5];
#pragma unroll
      for (int d = 0; d < 5; ++d) v[d] = t.q[f][win_index<AXIS>(p + d - 2, c)];
      const WenoWeights<T> w = weno_weights(v);
      if (want_l) t.L[f][fl] = weno_left(v, w);
      if (want_r) t.R[f][fr] = weno_right(v, w);
    }
  }
  __syncthreads();

  // 3. solve each face that does not touch a solid once; its flux
  // overwrites its L
  for (int i = threadIdx.x; i < G::faces; i += kThreads) {
    const int j = AXIS == 0 ? i % (n + 1) : i / m;
    const int c = AXIS == 0 ? i / (n + 1) : i % m;
    const int pl = j + kHalo - 1;  // window position of the left cell
    if (t.s[win_index<AXIS>(pl, c)] || t.s[win_index<AXIS>(pl + 1, c)])
      continue;
    bool deg = false;  // a solid among the six cells around the face
#pragma unroll
    for (int d = -2; d <= 3; ++d) deg = deg || t.s[win_index<AXIS>(pl + d, c)];
    Q6<T> Lq, Rq;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      Lq.f[f] = deg ? t.q[f][win_index<AXIS>(pl, c)] : t.L[f][i];
      Rq.f[f] = deg ? t.q[f][win_index<AXIS>(pl + 1, c)] : t.R[f][i];
    }
    const Q6<T> F = hllc_flux<T, AXIS>(floor_prim(Lq), floor_prim(Rq), g);
#pragma unroll
    for (int f = 0; f < 6; ++f) t.L[f][i] = F.f[f];
  }
  __syncthreads();

  // 4. each cell's two faces; a face that touches a solid takes this
  // cell's own mirrored problem
  int lx, ly, lz, p, c;
  cell_of(threadIdx.x, &lx, &ly, &lz);
  line_of<AXIS>(lx, ly, lz, &p, &c);
  const int w = win_index<AXIS>(p + kHalo, c);
  const int stride = AXIS == 0 ? 1 : m;
  const bool sc = t.s[w] != 0;
  const bool wall_m = t.s[w - stride] || sc;
  const bool wall_p = sc || t.s[w + stride];
  Q6<T> qc;
#pragma unroll
  for (int f = 0; f < 6; ++f) qc.f[f] = t.q[f][w];
  const int im = face_index<AXIS>(p, c), ip = face_index<AXIS>(p + 1, c);
  Q6<T> Fm, Fp;
  if (wall_m) {
    Fm = hllc_wall_flux<T, AXIS>(qc, false, g);
  } else {
#pragma unroll
    for (int f = 0; f < 6; ++f) Fm.f[f] = t.L[f][im];
  }
  if (wall_p) {
    Fp = hllc_wall_flux<T, AXIS>(qc, true, g);
  } else {
#pragma unroll
    for (int f = 0; f < 6; ++f) Fp.f[f] = t.L[f][ip];
  }
  const T inv_d = A.inv_d[AXIS];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T contrib = (-(Fp.f[k] - Fm.f[k])) * inv_d;
    t.dU[k][threadIdx.x] =
        AXIS == 0 ? contrib : t.dU[k][threadIdx.x] + contrib;
  }
  __syncthreads();  // the next axis restages q and s and rewrites L and R
}

template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
step3_kernel(const Step3Args<T> A) {
  extern __shared__ __align__(16) unsigned char fst_smem[];
  const Tile3<T> t = carve<T>(fst_smem);
  const int ox = blockIdx.x * kTX, oy = blockIdx.y * kTY,
            oz = blockIdx.z * kTZ;
  axis_update<T, 0>(A, t, ox, oy, oz);
  axis_update<T, 1>(A, t, ox, oy, oz);
  axis_update<T, 2>(A, t, ox, oy, oz);

  int lx, ly, lz;
  cell_of(threadIdx.x, &lx, &ly, &lz);
  const int x = ox + lx, y = oy + ly, z = oz + lz;
  if (x >= A.nx || y >= A.ny || z >= A.nz) return;
  const Gas3<T>& g = A.gas;
  Q6<T> qc, dU;
  {
    // the cell in the z staging, window position lz + 3 of line lx + kTX ly
    const int w = win_index<2>(lz + kHalo, lx + kTX * ly);
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      qc.f[f] = t.q[f][w];
      dU.f[f] = t.dU[f][threadIdx.x];
    }
  }

  const T dt = *A.dt;
  const Q6<T> U0 = prim_to_cons(qc, g);
  Q6<T> U1;
#pragma unroll
  for (int k = 0; k < 6; ++k) U1.f[k] = U0.f[k] + dt * dU.f[k];
  Q6<T> q = cons_to_prim(U1, g);

  // non-finite / non-physical repair -> inflow
  bool bad = (q.f[R_] <= T(0)) || (q.f[P_] <= T(0)) || (q.f[EV_] < T(0));
#pragma unroll
  for (int k = 0; k < 6; ++k) bad = bad || !isfinite(q.f[k]);
  if (bad) {
#pragma unroll
    for (int k = 0; k < 6; ++k) q.f[k] = A.infl[k];
  }

  // Landau-Teller relaxation
  const T T1 = q.f[P_] / (q.f[R_] * g.R);
  const T ev_eq = evib_eq(T1, g);
  const T relax = dt / A.tau_vib;
  q.f[EV_] = nmax(q.f[EV_] + (ev_eq - q.f[EV_]) * relax, T(0));

  // sponges, each in its slab of global x
  const int xg = A.x0 + x;
  if (A.sponge_n > 0 && xg >= 0 && xg < A.sponge_n) {
    const T sramp = clip01(T(1) - T(xg) / T(A.sponge_n));
    const T k = A.sponge_strength * (sramp * sramp);
    const T gain = *A.gain;
    q.f[R_] = nmax(q.f[R_] + k * (A.tgt_r - q.f[R_]), rp_floor<T>());
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T tgt = gain * A.inflow_vel[a];
      q.f[1 + a] = q.f[1 + a] + k * (tgt - q.f[1 + a]);
    }
    q.f[P_] = nmax(q.f[P_] + k * (A.tgt_p - q.f[P_]), rp_floor<T>());
    q.f[EV_] = nmax(q.f[EV_] + k * (A.tgt_ev - q.f[EV_]), T(0));
  }
  const int out_lo = A.nx_global - A.sponge_out_n;
  if (A.sponge_out_n > 0 && xg >= out_lo && xg < A.nx_global) {
    const T xo = T(xg) - T(out_lo);
    const T oramp = clip01(xo / T(A.sponge_out_n));  // xo >= 0 in the slab
    const T k = A.sponge_out_strength * (oramp * oramp);
    q.f[R_] = nmax(q.f[R_] + k * (A.tgt_r - q.f[R_]), rp_floor<T>());
#pragma unroll
    for (int a = 1; a <= 3; ++a) q.f[a] = q.f[a] + k * (T(0) - q.f[a]);
    q.f[P_] = nmax(q.f[P_] + k * (A.tgt_p - q.f[P_]), rp_floor<T>());
    q.f[EV_] = nmax(q.f[EV_] + k * (A.tgt_ev - q.f[EV_]), T(0));
  }

  const size_t o = ((size_t)z * A.ny + y) * A.nx + x;
#pragma unroll
  for (int k = 0; k < 6; ++k) A.out[k][o] = q.f[k];
}

// The launch of a step on an (nz, ny, nx) window (the report of the
// library's launch query): blocks (one a tile), threads a block, the tile,
// the halo and the dynamic shared memory a block.
template <typename T>
int make_launch(int nz, int ny, int nx, Tile3Launch* L) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((nx + kTX - 1) / kTX) *
                          ((ny + kTY - 1) / kTY) * ((nz + kTZ - 1) / kTZ);
  *L = {(int)tiles, kThreads, kTX, kTY, kTZ, kHalo, (int)smem_bytes<T>()};
  return 0;
}

template <typename T>
int launch_step3(const T* const* q, const uint8_t* solid, const T* dt,
                 const T* gain, T* const* out, const Hyp3DParams* p,
                 int device, void* stream) {
  Tile3Launch L;
  int code = make_launch<T>(p->nz, p->ny, p->nx, &L);
  if (code != 0) return code;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool raised[kMaxDevices] = {};
  code = allow_smem(step3_kernel<T>, (size_t)L.smem_bytes, device, raised);
  if (code != 0) return code;
  Step3Args<T> A;
  for (int k = 0; k < 6; ++k) {
    A.q[k] = q[k];
    A.out[k] = out[k];
    A.infl[k] = T(p->infl[k]);
  }
  A.solid = solid;
  A.dt = dt;
  A.gain = gain;
  A.nz = p->nz;
  A.ny = p->ny;
  A.nx = p->nx;
  A.nx_global = p->nx_global;
  A.x0 = p->x0;
  A.sponge_n = p->sponge_n;
  A.sponge_out_n = p->sponge_out_n;
  A.gas = gas3_of<T>(*p);
  for (int a = 0; a < 3; ++a) A.inv_d[a] = T(p->inv_d[a]);
  A.tau_vib = T(p->tau_vib);
  A.sponge_strength = T(p->sponge_strength);
  A.sponge_out_strength = T(p->sponge_out_strength);
  A.tgt_r = T(p->tgt_r);
  A.tgt_p = T(p->tgt_p);
  A.tgt_ev = T(p->tgt_ev);
  for (int a = 0; a < 3; ++a) A.inflow_vel[a] = T(p->infl[1 + a]);
  const dim3 grid((p->nx + kTX - 1) / kTX, (p->ny + kTY - 1) / kTY,
                  (p->nz + kTZ - 1) / kTZ);
  step3_kernel<T><<<grid, L.threads, (size_t)L.smem_bytes,
                    (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of a step on an (nz, ny, nx) window (fst::Tile3Launch),
// computed as the step's launch computes it.
int fst_hyp3d_step_launch_f32(int nz, int ny, int nx,
                              fst::Tile3Launch* out) {
  return fst::make_launch<float>(nz, ny, nx, out);
}

int fst_hyp3d_step_launch_f64(int nz, int ny, int nx,
                              fst::Tile3Launch* out) {
  return fst::make_launch<double>(nz, ny, nx, out);
}

int fst_hyp3d_step_f32(const float* r, const float* u, const float* v,
                       const float* w, const float* p, const float* ev,
                       const uint8_t* solid, const float* dt,
                       const float* gain, float* o_r, float* o_u, float* o_v,
                       float* o_w, float* o_p, float* o_ev,
                       const fst::Hyp3DParams* prm, int device, void* stream) {
  const float* q[6] = {r, u, v, w, p, ev};
  float* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_step3<float>(q, solid, dt, gain, out, prm, device, stream);
}

int fst_hyp3d_step_f64(const double* r, const double* u, const double* v,
                       const double* w, const double* p, const double* ev,
                       const uint8_t* solid, const double* dt,
                       const double* gain, double* o_r, double* o_u,
                       double* o_v, double* o_w, double* o_p, double* o_ev,
                       const fst::Hyp3DParams* prm, int device, void* stream) {
  const double* q[6] = {r, u, v, w, p, ev};
  double* out[6] = {o_r, o_u, o_v, o_w, o_p, o_ev};
  return fst::launch_step3<double>(q, solid, dt, gain, out, prm, device,
                                   stream);
}

}  // extern "C"
