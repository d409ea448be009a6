// K τ-clock steps of 2-D viscous Burgers per launch, periodic in x and y,
// for float and double: the per-cell form of
// fluidsims_tpu_torch/solvers/burgers.py::step, MUSCL, Cole–Hopf (1-D) and
// any number of viscosity substeps included.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/resident_multistep.py::
// make_resident_multistep.kernel (pallas_call at :72) as instantiated for
// Burgers (burgers_resident_pallas.py:46-54): the whole (phi_u, phi_v)
// state resident in VMEM, grid=(), fori_loop over K steps, periodic wraps
// as pltpu.rolls, the CFL max an exact global reduction each step.
//
// What bounds it on an H100.  Neither bytes nor syncs once they are cut:
// arithmetic issue.  The state a step must read and write is 2 MB at 512^2
// (in the 50 MB L2) and 128 MB at 4096^2 (~0.08 ms a step at 3.35 TB/s),
// but a cell-step issues some 300-400 instructions: two sinh (~20 each)
// and two asinh (~50), seven IEEE divisions (~10), the faces, the update
// and the Laplacian, all with -fmad=false.  At 512^2 a step costs ~14 us
// (tools/tune_tiles_torch.py, PERF.md), of which the one grid sync is a
// few; past L2 the same arithmetic, not the traffic, sets the pace.
//
// What the first design lost.  It was a grid-stride loop over the cells
// with a grid sync between phases: 1 + K (1 + visc_substeps) syncs a
// launch (33 at K = 16), and each phase wrote whole fields (the decoded
// u0, v0 and one or two (u, v) pairs) to device memory for the next phase
// to read back: ~10 fields a step past L2.  Each face flux was computed by
// both its cells, with MUSCL four sinh a face, twice.
//
// The design.  The grid is cut into tiles of kTileX x kTileY cells
// (tiles.cuh: 32 x 32 for float and double, clipped to the grid; the
// grid query reports them); a persistent cooperative
// grid (grid_reduce.cuh) walks them, several a block when there are more
// tiles than resident blocks (512 threads a block when every tile gets a
// block of its own, else 256; float held to 64 registers, double to 128:
// tiles.cuh's tile_grid).  A step of a tile runs in shared memory
// (tiles.cuh):
//   1. load the tile and a halo of `halo` cells (periodic, wrap1) of the
//      step's source buffer, coalesced along rows: without MUSCL the
//      decoded (u, v) the step before carried on (step 0: the input's
//      decode, made by the launch's prologue), with MUSCL (phi_u, phi_v),
//      decoded u = u0 sinh(phi) on the window;
//   2. each x and y face flux once (Rusanov; MUSCL faces from phi);
//   3. the convective update on the tile plus a ring of `first` cells;
//   4. `first` viscosity substeps, each shrinking the valid ring by one;
//   5. encode asinh(u / u0) on the tile, decode it again (the bits the
//      next step reads), fold the wavespeed max into the next step's slot
//      (one atomic a block), and write the decode to the other buffer, or
//      phi on the last step and with MUSCL.
// So a cell-step makes two sinh and two asinh, as the first design did.
// The halo is the flux stencil's reach plus the substeps of the pass: a
// cell's update reads the faces on both its sides, and the face between
// cells i and i+1 reads cells i-1 .. i+2 with MUSCL (reach 2) and cells i,
// i+1 without (reach 1); each viscosity substep reads one cell further.
// So halo = reach + first.  A pass holds at most MAX_HALO cells of halo
// (the wrapper's plan): with more substeps than fit (visc_substeps >
// MAX_HALO - reach) the first pass writes the (u, v) of the tile to a
// scratch pair, and later passes, a grid sync apart, run up to MAX_HALO
// substeps each on a window of that pair; the last encodes.  Cells past
// the grid's edge in a ragged last tile, and every window cell of a grid
// narrower than the halo (ny = 1 in Cole–Hopf mode), hold the wrapped
// cell's value and are computed from wrapped neighbours with the same
// operations, so they carry that cell's bits; only cells inside the grid
// are written.

// One grid sync a step.  The CFL max of the state a step reads is the only
// grid-wide dependency left.  A launch clears the three max slots, syncs,
// folds the input's max into slot 0 (the prologue, which also writes the
// input's decode to the buffer of "step -1") and syncs (2 syncs); step s
// reads the max of its state from slot s % 3, folds the max of the state
// it writes into slot (s + 1) % 3, clears slot (s + 2) % 3, and ends with
// one sync (none after the last step): K + 1 syncs a launch (plus K for
// each pass past the first).  The kernel counts the syncs it makes
// (tiles.cuh CountedGrid) into the last word of its slots, which
// chip_smoke.py reads back and holds to that number.  Why that is safe:
//   - the state ping-pongs: step 0 reads the input (or the prologue's
//     decode, in the buffer of parity -1) and step s >= 1 the buffer step
//     s - 1 wrote; step s writes the output when K - 1 - s is even, else
//     the scratch pair, so it never writes the buffer it reads, and never
//     the input.  A buffer read in step s is written again in step
//     s + 1 at the earliest, after the sync that ends step s, by which
//     every block has finished its reads of it; and the writes of step s
//     are read in step s + 1, after that same sync.
//   - slot (s + 1) % 3 takes adds in step s and is read in step s + 1,
//     across the sync that ends step s; slot (s + 2) % 3, cleared in step
//     s, was last read in step s - 1 (before the sync that ended it) and
//     takes adds only in step s + 1 (after the sync that ends step s).
//   - within a step, the passes' (u, v) scratch pairs ping-pong the same
//     way across the sync between passes.
// A window is re-read from device memory each step, not kept in a block:
// a tile's halo is written by other blocks.  Fields written during the
// launch are read with plain loads, not __ldg.
//
// Same bits.  Every value is computed by the plain version's operations
// in its order (the library is built with -fmad=false), a halo cell by
// the same operations on the same inputs as its owner, and the max is
// exact: one launch of K steps is bitwise equal to K launches of one.  sinh
// and asinh are CUDA's, not PyTorch's, so a step agrees with the plain
// version to a few ulps, not bitwise.
#include "tiles.cuh"

namespace fst {

// Host-side parameters, in double, formed by kernels/burgers_cuda.py.
struct BurgersParams {
  int ny, nx, k;
  int muscl, one_d, visc_substeps;
  int first;           // viscosity substeps of the first pass
  int per_pass;        // of each later pass, at most (MAX_HALO)
  double u0;       // velocity scale of the codec
  double dx, dy;   // divisors of the wavespeed and the flux differences
  double inv_dy;   // 0 in 1-D mode or for ny = 1
  double cfl, dtau;
  double inv_dx2, inv_dy2;  // viscosity (inv_dy2 = 0 in 1-D mode)
  double nu;
};

namespace {

constexpr int kBurgersFields = 8;  // shared-memory fields of a window

template <typename T>
struct BurgersArgs {
  const T *pu_in, *pv_in, *t_in, *tau_in;
  T *pu_out, *pv_out, *t_out, *tau_out;
  T* scratch;  // Pu, Pv[, Wa_u, Wa_v, Wb_u, Wb_v], each ny * nx
  unsigned long long* slots;  // kTileWords words
  int ny, nx, k, muscl, one_d, nsub;
  int tile_x, tile_y, tiles_x, tiles, reach, first, per_pass, window;
  T u0, dx, dy, inv_dy, cfl, dtau, inv_dx2, inv_dy2, nu, nsub_t;
};

template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
  return a * b > T(0) ? (fabs(a) < fabs(b) ? a : b) : T(0);
}

// MUSCL face states of the face between q0 and qp (qm left of q0, qpp
// right of qp): (left state, right state), as _muscl_faces.
template <typename T>
__device__ __forceinline__ void muscl(T qm, T q0, T qp, T qpp, T* l, T* r) {
  const T sL = T(0.5) * minmod(q0 - qm, qp - q0);
  const T sR = T(0.5) * minmod(qpp - qp, qp - q0);
  *l = q0 + sL;
  *r = qp - sR;
}

// Rusanov flux of (u, v) through a face with states L and R; x faces when
// xdir, else y faces (_rusanov_faces).
template <typename T>
__device__ __forceinline__ void rusanov(bool xdir, T uL, T vL, T uR, T vR,
                                        T* Fu, T* Fv) {
  T FLu, FLv, FRu, FRv, a;
  if (xdir) {
    FLu = (T(0.5) * uL) * uL;
    FLv = uL * vL;
    FRu = (T(0.5) * uR) * uR;
    FRv = uR * vR;
    a = nan_max(fabs(uL), fabs(uR));
  } else {
    FLu = uL * vL;
    FLv = (T(0.5) * vL) * vL;
    FRu = uR * vR;
    FRv = (T(0.5) * vR) * vR;
    a = nan_max(fabs(vL), fabs(vR));
  }
  *Fu = T(0.5) * (FLu + FRu) - (T(0.5) * a) * (uR - uL);
  *Fv = T(0.5) * (FLv + FRv) - (T(0.5) * a) * (vR - vL);
}

// Flux through the face between window cells c and c + d (d = 1 for an x
// face, the window's row stride for a y face), into F[c].
template <typename T>
__device__ __forceinline__ void face_flux(const BurgersArgs<T>& a, bool xdir,
                                          const T* pu, const T* pv,
                                          const T* U, const T* V, int c,
                                          int d, T* Fu, T* Fv) {
  T uL, vL, uR, vR;
  if (a.muscl) {
    T pUL, pUR, pVL, pVR;
    muscl(pu[c - d], pu[c], pu[c + d], pu[c + 2 * d], &pUL, &pUR);
    muscl(pv[c - d], pv[c], pv[c + d], pv[c + 2 * d], &pVL, &pVR);
    uL = a.u0 * sinh(pUL);
    vL = a.u0 * sinh(pVL);
    uR = a.u0 * sinh(pUR);
    vR = a.u0 * sinh(pVR);
  } else {
    uL = U[c];
    vL = V[c];
    uR = U[c + d];
    vR = V[c + d];
  }
  rusanov(xdir, uL, vL, uR, vR, Fu + c, Fv + c);
}

// Loads fields ga, gb over the window into sa, sb.
template <typename T>
__device__ __forceinline__ void load_window(const BurgersArgs<T>& a,
                                            const Window& w, const T* ga,
                                            const T* gb, T* sa, T* sb) {
  const T* const g[2] = {ga, gb};
  T* const sd[2] = {sa, sb};
  load_periodic<2>(w, a.ny, a.nx, g, sd);
}

// `count` viscosity substeps on the window's (u, v) in (su, sv), valid on
// the ring `r0` cells inside the window's edge; the intermediate substeps
// ping-pong through (tu, tv).  The last substep, on the tile, hands each
// cell's (un, vn) to last(ly, lx, un, vn).
template <typename T, typename Last>
__device__ __forceinline__ void substeps(const BurgersArgs<T>& a,
                                         const Window& w, int r0, int count,
                                         T coef, T* su, T* sv, T* tu, T* tv,
                                         Last last) {
  const int wx = w.wx;
  for (int j = 1; j <= count; ++j) {
    const int r = r0 + j;
    const bool fin = j == count;
    for_region(r, w.wy - r, r, wx - r, wx, [&](int ly, int lx, int c) {
      const T uc = su[c], vc = sv[c];
      const T lap_u = ((su[c + 1] - T(2) * uc) + su[c - 1]) * a.inv_dx2 +
                      ((su[c + wx] - T(2) * uc) + su[c - wx]) * a.inv_dy2;
      const T lap_v = ((sv[c + 1] - T(2) * vc) + sv[c - 1]) * a.inv_dx2 +
                      ((sv[c + wx] - T(2) * vc) + sv[c - wx]) * a.inv_dy2;
      const T un = uc + coef * lap_u;
      const T vn = vc + coef * lap_v;
      if (fin) {
        last(ly, lx, un, vn);
      } else {
        tu[c] = un;
        tv[c] = vn;
      }
    });
    __syncthreads();
    T* s0 = su;
    T* s1 = sv;
    su = tu;
    sv = tv;
    tu = s0;
    tv = s1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreadsWide, TileBlocksPerSM<T>::value)
burgers_multistep_kernel(BurgersArgs<T> a) {
  CountedGrid grid = counted_grid();
  extern __shared__ __align__(16) unsigned char fst_smem[];
  T* sm = reinterpret_cast<T*>(fst_smem);
  T* sPu = sm;
  T* sPv = sm + a.window;
  T* sU = sm + 2 * a.window;
  T* sV = sm + 3 * a.window;
  T* sFu = sm + 4 * a.window;  // x faces
  T* sFv = sm + 5 * a.window;
  T* sGu = sm + 6 * a.window;  // y faces
  T* sGv = sm + 7 * a.window;

  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  T* Pu = a.scratch;
  T* Pv = Pu + n;
  T* W[2][2] = {{Pv + n, Pv + 2 * n}, {Pv + 3 * n, Pv + 4 * n}};
  const int R = a.reach;
  // Without MUSCL the steps pass the decoded (u, v) on, not phi: only the
  // last step writes phi (buffer of step s: the output when K - 1 - s is
  // even, else the scratch pair; the input's decode is "step -1")
  const bool carry = !a.muscl;
  const bool in_out = (a.k & 1) == 0;

  if (gtid == 0)
    for (int j = 0; j < kMaxSlots; ++j) grid_max_clear(a.slots, j);
  grid.sync();
  {
    T* cu = in_out ? a.pu_out : Pu;
    T* cv = in_out ? a.pv_out : Pv;
    LocalMax<T> lm;
    for (size_t i = gtid; i < n; i += stride) {
      const T u = a.u0 * sinh(a.pu_in[i]);
      const T v = a.u0 * sinh(a.pv_in[i]);
      lm.add(fabs(u) / a.dx + fabs(v) * a.inv_dy);
      if (carry) {
        cu[i] = u;
        cv[i] = v;
      }
    }
    block_max_add(a.slots, 0, lm);
  }
  grid.sync();

  T t = *a.t_in, tau = *a.tau_in;
  const T growth = exp(a.dtau);
  const T* pu = carry ? (in_out ? a.pu_out : Pu) : a.pu_in;
  const T* pv = carry ? (in_out ? a.pv_out : Pv) : a.pv_in;
  for (int s = 0; s < a.k; ++s) {
    const bool to_out = ((a.k - 1 - s) & 1) == 0;
    T* qu = to_out ? a.pu_out : Pu;
    T* qv = to_out ? a.pv_out : Pv;
    const bool more = s + 1 < a.k;  // the next step needs this one's max
    const T smax =
        nan_max(slot_max_read<T>(a.slots, s % kMaxSlots), T(1e-12));
    const T dt = nan_min(t * a.dtau, a.cfl / smax);
    const T coef = a.nu * (dt / a.nsub_t);
    if (gtid == 0) grid_max_clear(a.slots, (s + 2) % kMaxSlots);
    LocalMax<T> lm;

    // the owned cells of the final pass: encode, write phi (or, carried
    // to the next step, its decode), fold the max of the decode
    auto encode = [&](const Window& w, int ly, int lx, T un, T vn) {
      const long long i = owned_index(w, ly, lx, ny, nx);
      if (i < 0) return;
      const T pun = asinh(un / a.u0);
      const T pvn = asinh(vn / a.u0);
      if (!more || !carry) {
        qu[i] = pun;
        qv[i] = pvn;
      }
      if (more) {
        const T u = a.u0 * sinh(pun);
        const T v = a.u0 * sinh(pvn);
        if (carry) {
          qu[i] = u;
          qv[i] = v;
        }
        lm.add(fabs(u) / a.dx + fabs(v) * a.inv_dy);
      }
    };
    int left = a.nsub - a.first;  // substeps after the first pass

    // first pass: decode, fluxes, convective update, `first` substeps
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const Window w =
          window_of(tile, a.tiles_x, a.tile_x, a.tile_y, R + a.first);
      const int wx = w.wx, wy = w.wy;
      if (carry) {
        load_window(a, w, pu, pv, sU, sV);
      } else {
        load_window(a, w, pu, pv, sPu, sPv);
        __syncthreads();
        for_region(0, wy, 0, wx, wx, [&](int, int, int c) {
          sU[c] = a.u0 * sinh(sPu[c]);
          sV[c] = a.u0 * sinh(sPv[c]);
        });
      }
      __syncthreads();
      // x face c is between cells c and c + 1, y face c between c and
      // c + wx: the faces of the update region [R, wy - R) x [R, wx - R)
      for_region(R, wy - R, R - 1, wx - R, wx, [&](int, int, int c) {
        face_flux(a, true, sPu, sPv, sU, sV, c, 1, sFu, sFv);
      });
      if (!a.one_d)
        for_region(R - 1, wy - R, R, wx - R, wx, [&](int, int, int c) {
          face_flux(a, false, sPu, sPv, sU, sV, c, wx, sGu, sGv);
        });
      __syncthreads();
      for_region(R, wy - R, R, wx - R, wx, [&](int, int, int c) {
        T u = sU[c] - (dt * (sFu[c] - sFu[c - 1])) / a.dx;
        T v = sV[c] - (dt * (sFv[c] - sFv[c - 1])) / a.dx;
        if (!a.one_d) {
          u = u - (dt * (sGu[c] - sGu[c - wx])) / a.dy;
          v = v - (dt * (sGv[c] - sGv[c - wx])) / a.dy;
        }
        sU[c] = u;
        sV[c] = v;
      });
      __syncthreads();
      substeps(a, w, R, a.first, coef, sU, sV, sPu, sPv,
               [&](int ly, int lx, T un, T vn) {
                 if (left == 0) {
                   encode(w, ly, lx, un, vn);
                   return;
                 }
                 const long long i = owned_index(w, ly, lx, ny, nx);
                 if (i < 0) return;
                 W[0][0][i] = un;
                 W[0][1][i] = vn;
               });
    }

    // later passes (visc_substeps > first only): up to per_pass substeps
    // on a window of the previous pass's (u, v), a grid sync apart
    for (int p = 1; left > 0; ++p) {
      const int count = left < a.per_pass ? left : a.per_pass;
      left -= count;
      grid.sync();
      const T* wu = W[(p - 1) & 1][0];
      const T* wv = W[(p - 1) & 1][1];
      T* du = W[p & 1][0];
      T* dv = W[p & 1][1];
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const Window w =
            window_of(tile, a.tiles_x, a.tile_x, a.tile_y, count);
        load_window(a, w, wu, wv, sU, sV);
        __syncthreads();
        substeps(a, w, 0, count, coef, sU, sV, sPu, sPv,
                 [&](int ly, int lx, T un, T vn) {
                   if (left == 0) {
                     encode(w, ly, lx, un, vn);
                     return;
                   }
                   const long long i = owned_index(w, ly, lx, ny, nx);
                   if (i < 0) return;
                   du[i] = un;
                   dv[i] = vn;
                 });
      }
    }

    if (more) {
      block_max_add(a.slots, (s + 1) % kMaxSlots, lm);
      grid.sync();
    }
    t = t * growth;
    tau = tau + a.dtau;
    pu = qu;
    pv = qv;
  }
  if (gtid == 0) {
    *a.t_out = t;
    *a.tau_out = tau;
  }
  grid.write_syncs(a.slots);
}

// Dynamic shared memory of a block: the window's fields.
template <typename T>
size_t smem_bytes(int tile_x, int tile_y, int halo) {
  return (size_t)kBurgersFields * (tile_x + 2 * halo) * (tile_y + 2 * halo) *
         sizeof(T);
}

// The launch's args and dynamic shared memory from the host parameters;
// cudaErrorInvalidValue for parameters the kernel does not take.
template <typename T>
int make_args(const BurgersParams* p, BurgersArgs<T>* a, size_t* smem) {
  const int reach = p->muscl ? 2 : 1;
  // a later pass's window (halo <= per_pass) must fit the first's
  if (p->k < 1 || p->visc_substeps < 1 || p->ny < 1 || p->nx < 1 ||
      p->first < 1 || p->first > p->visc_substeps || p->per_pass < 1 ||
      (p->first < p->visc_substeps && p->per_pass > reach + p->first))
    return (int)cudaErrorInvalidValue;
  const int halo = reach + p->first;
  const int tile_x = tile_of(kTileX, p->nx), tile_y = tile_of(kTileY, p->ny);
  const int window = (tile_x + 2 * halo) * (tile_y + 2 * halo);
  a->ny = p->ny;
  a->nx = p->nx;
  a->k = p->k;
  a->muscl = p->muscl;
  a->one_d = p->one_d;
  a->nsub = p->visc_substeps;
  a->tile_x = tile_x;
  a->tile_y = tile_y;
  a->tiles_x = (p->nx + tile_x - 1) / tile_x;
  a->tiles = a->tiles_x * ((p->ny + tile_y - 1) / tile_y);
  a->reach = reach;
  a->first = p->first;
  a->per_pass = p->per_pass;
  a->window = window;
  a->u0 = T(p->u0);
  a->dx = T(p->dx);
  a->dy = T(p->dy);
  a->inv_dy = T(p->inv_dy);
  a->cfl = T(p->cfl);
  a->dtau = T(p->dtau);
  a->inv_dx2 = T(p->inv_dx2);
  a->inv_dy2 = T(p->inv_dy2);
  a->nu = T(p->nu);
  a->nsub_t = T(p->visc_substeps);
  *smem = smem_bytes<T>(tile_x, tile_y, halo);
  return 0;
}

// The launch of these parameters: make_args's tile, halo and shared memory,
// and tile_grid's blocks and threads.
template <typename T>
int grid_for(const BurgersParams* p, int device, TileLaunch* out) {
  BurgersArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  *out = {0, 0, a.tile_x, a.tile_y, a.reach + a.first, (int)smem};
  return tile_grid(burgers_multistep_kernel<T>, a.tiles, smem, device, out);
}

template <typename T>
int launch(const T* pu, const T* pv, const T* t, const T* tau, T* pu_out,
           T* pv_out, T* t_out, T* tau_out, T* scratch,
           unsigned long long* slots, const BurgersParams* p, int grid,
           int threads, int device, void* stream) {
  BurgersArgs<T> a{};
  size_t smem = 0;
  const int err = make_args(p, &a, &smem);
  if (err != 0) return err;
  if (!threads_ok(threads, kTileThreadsWide))
    return (int)cudaErrorInvalidValue;
  a.pu_in = pu;
  a.pv_in = pv;
  a.t_in = t;
  a.tau_in = tau;
  a.pu_out = pu_out;
  a.pv_out = pv_out;
  a.t_out = t_out;
  a.tau_out = tau_out;
  a.scratch = scratch;
  a.slots = slots;
  return on_device(device, [&] {
    return launch_cooperative_on(burgers_multistep_kernel<T>, a, grid,
                                 device, stream, smem, threads);
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch of these parameters on `device` (fst::TileLaunch): the wrapper
// asks once per (config, device) and passes the grid and threads to every
// launch.
int fst_burgers_multistep_grid_f32(const fst::BurgersParams* p, int device,
                                   fst::TileLaunch* out) {
  return fst::grid_for<float>(p, device, out);
}

int fst_burgers_multistep_grid_f64(const fst::BurgersParams* p, int device,
                                   fst::TileLaunch* out) {
  return fst::grid_for<double>(p, device, out);
}

// `slots`: kTileWords words; the launch leaves the count of its grid syncs
// in the last.
int fst_burgers_multistep_f32(const float* pu, const float* pv,
                              const float* t, const float* tau, float* pu_out,
                              float* pv_out, float* t_out, float* tau_out,
                              float* scratch, unsigned long long* slots,
                              const fst::BurgersParams* p, int grid,
                              int threads, int device, void* stream) {
  return fst::launch<float>(pu, pv, t, tau, pu_out, pv_out, t_out, tau_out,
                            scratch, slots, p, grid, threads, device, stream);
}

int fst_burgers_multistep_f64(const double* pu, const double* pv,
                              const double* t, const double* tau,
                              double* pu_out, double* pv_out, double* t_out,
                              double* tau_out, double* scratch,
                              unsigned long long* slots,
                              const fst::BurgersParams* p, int grid,
                              int threads, int device, void* stream) {
  return fst::launch<double>(pu, pv, t, tau, pu_out, pv_out, t_out, tau_out,
                             scratch, slots, p, grid, threads, device,
                             stream);
}

}  // extern "C"
