// SPH pressure-gradient + Monaghan viscosity forces, gravity, and the
// symplectic Euler step with restitution walls, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/sph_pallas.py::
// _forces_kernel (pallas_call at :267), which fused the same forces and
// integrate over (4, K, 128)-lane VMEM blocks with sentinel slots and halo
// blocks.  Every member of the 3x3 neighbour cells enters a particle's
// sums.  A pair is skipped when it is the particle itself (by index) and
// when r^2 >= (2h)^2 or r^2 <= 1e-16 (sph_pallas.py:158-160).  The
// pressure term is -m (p_i/rho_i^2 + p_j/rho_j^2) from the density
// kernel's per-particle p/rho^2, the viscosity term Monaghan's (:166-181),
// both times gradW.  Then gravity and the fused integrate (:190-203) with
// dt read from device memory, as the TPU kernel read it from SMEM: dt
// never goes to the host.  No particle is left out of the pair sums: the
// TPU engine integrated the particles past a cell's K slots with gravity
// alone (sph_pallas.py:319-327); with no cell capacity there are none.
// Output pos and vel (n, 2) in particle order, written for the receivers
// at sorted positions [r0, r1) (every particle by default); a receiver's
// neighbours are every member of its 3x3 cells, wherever those are sorted.
//
// What bounds it on an H100: the pair arithmetic, ~45 operations a
// candidate within 2h with an IEEE square root and two or three divisions
// under -fmad=false (~280 candidates a particle on the initial state, ~31
// a cell; ~1,200 on the evolved state at 65,536, ~250 at 2^20), the
// latency of that chain, and the lanes of a warp that idle while others
// take a candidate within 2h (about one in three passes): at 2^20 the
// first design issued about as fast as that divergence allows.  The bytes
// (the sorted state in, pos and vel out) are ~1/20 of the operations' time.
//
// What the first design lost.  One thread a particle in 128-thread blocks
// of 128 sorted positions walked its 3x3 cells member by member, each
// candidate a dependent chain of a 16-byte and an 8-byte gather from
// device memory, the square root and the divisions.  At 65,536 particles
// that is ~16 warps an SM (512 blocks on 132 SMs), a quarter of what an SM
// holds, and nothing hid the chain: 39x its bound.
//
// The design.  A block takes kGroup = kThreads / kLanes consecutive
// sorted positions (128 threads; kLanes lanes a particle chosen at launch
// from n, forces_lanes: 8 at 65,536, 2 at 2^20), a run of cells of one
// grid row or, where the run crosses a row, one run a row after another.  The 3x3 cells of a run of
// cells gxa .. gxb of row gy together are three contiguous ranges of the
// sorted order (sph.cuh NeighbourRows), which the block stages into shared
// memory in chunks of kChunk<T> candidates ((x, y, vx, vy) and (rho,
// p/rho^2) each: FST_SPH_STAGE_BYTES a block, 1,024 f32 / 512 f64), in a
// loop, so a neighbourhood larger than a chunk is walked in full: there is
// no cap on a cell.  A particle's own 3x3 cells are a contiguous part of
// each range (cell_entries), which its kLanes adjacent threads of a warp
// walk: lane l the entries l, l + kLanes, ... of each part, chunk by
// chunk; so kLanes x the warps of the first design share the chains.  The
// lanes' sums are combined by an xor butterfly of warp shuffles, a fixed order,
// so two launches on the same input give the same bits; the order differs
// from the first design's (and from the plain version's index_add_), so a
// result agrees with them to rounding.  Lane 0 adds gravity, integrates
// and writes.  The candidate arithmetic, the own-index skip, the r^2 test
// and the `ok` mask are the first design's, expression by expression; the
// q < 1 and viscosity branches form both sides and select one (add_pair),
// the same values.  Measured and dropped (tools/tune_tiles_torch.py,
// PERF.md): one block a cell (the evolved state at 65,536 holds ~140 a cell
// on ~470 cells: too few blocks, each running its particles a group after
// another); a run staged cell by cell (half the lanes idle where cells
// hold ~30, at 2^20); candidates filtered and compacted a warp at a time
// before the pair terms (the ballots and the queue cost more than the
// divergence they removed).
#include "sph.cuh"

namespace fst {

namespace {

// Threads a block, the staged bytes a block, and the lanes a particle:
// the largest power of two in [FST_SPH_MIN_LANES, FST_SPH_MAX_LANES] whose
// n x lanes stays within FST_SPH_LANE_THREADS (lanes_for).  More lanes
// give more warps where n particles give too few (65,536: 8 lanes, 0.25
// ms a launch against 0.58 with one); where they give plenty (2^20), the
// lanes only add setup, and 2 did best (PERF.md, tools/tune_tiles_torch.py
// sweep).
#ifndef FST_SPH_FORCES_THREADS
#define FST_SPH_FORCES_THREADS 128
#endif
#ifndef FST_SPH_STAGE_BYTES
#define FST_SPH_STAGE_BYTES 24576
#endif
#ifndef FST_SPH_MIN_LANES
#define FST_SPH_MIN_LANES 2
#endif
#ifndef FST_SPH_MAX_LANES
#define FST_SPH_MAX_LANES 8
#endif
#ifndef FST_SPH_LANE_THREADS
#define FST_SPH_LANE_THREADS 524288
#endif
constexpr int kThreads = FST_SPH_FORCES_THREADS;
static_assert(kThreads % 32 == 0, "whole warps");
static_assert(FST_SPH_MIN_LANES >= 1 && FST_SPH_MAX_LANES <= 8 &&
                  FST_SPH_MIN_LANES <= FST_SPH_MAX_LANES,
              "lanes a particle in [1, 8]");

// The lanes a particle of a launch over n particles (a power of two).
inline int forces_lanes(int n) {
  return lanes_for(n, FST_SPH_MIN_LANES, FST_SPH_MAX_LANES,
                   FST_SPH_LANE_THREADS);
}

// Candidates a staged chunk holds: the stage's bytes over a candidate's.
template <typename T>
constexpr int kChunk = FST_SPH_STAGE_BYTES / (int)(sizeof(V4<T>) +
                                                   sizeof(V2<T>));

// The pair term of a candidate at (dx, dy), r2 from the receiver that
// passed the r^2 test, added to (px, py): the first design's expressions,
// both sides of its q < 1 and dot < 0 tests formed and one selected (the
// same values, and no branch for a warp's lanes to diverge on).
template <typename T>
__device__ __forceinline__ void add_pair(const SPHParams& p, const V4<T>& me,
                                         T rho_i, T pt_i, const V4<T>& ob,
                                         const V2<T>& oj, T dx, T dy, T r2,
                                         T& px, T& py) {
  const T inv_h = T(p.inv_h), alpha = T(p.alpha), two_h = T(p.two_h);
  const T r2s = nmax(r2, T(1e-30));
  const T inv_r = T(1) / sqrt(r2s);
  const T r = r2s * inv_r;
  const T q = r * inv_h;
  const T t = T(2) - q;
  const T near = alpha * (T(-3) * q + T(2.25) * q * q);
  const T far = alpha * (T(-0.75) * (t * t));
  const T dwdq = q < T(1) ? near : far;
  const bool ok = (r > T(1e-8)) && (r < two_h);
  const T scale = ok ? dwdq * inv_h * inv_r : T(0);
  T common = T(-p.mass) * (pt_i + oj.b);
  if (p.use_visc) {
    const T dot = (me.vx - ob.vx) * dx + (me.vy - ob.vy) * dy;
    const T rho_bar = T(0.5) * (rho_i + nmax(oj.a, T(1e-30)));
    const T pi = T(p.visc_coef) * dot / ((r2 + T(p.eps_h2)) * rho_bar);
    common = dot < T(0) ? common - T(p.mass) * pi : common;
  }
  const T cc = common * scale;
  px += cc * dx;
  py += cc * dy;
}

// A range [r0, r1) of receivers keeps the blocks of the whole range, as
// the density kernel's does (sph_density.cu): block b of a launch is block
// r0 / kGroup + b of [0, n), only the particles in [r0, r1) are live and
// written, and a receiver's sums take the same bits in any range.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
forces_kernel(const V4<T>* __restrict__ fields, const V2<T>* __restrict__ rp,
              const int* __restrict__ starts, const int* __restrict__ order,
              const T* __restrict__ dt_ptr, SPHParams p, int r0, int r1,
              T* __restrict__ pos_out, T* __restrict__ vel_out) {
  extern __shared__ __align__(16) unsigned char fst_smem[];
  V4<T>* sf = reinterpret_cast<V4<T>*>(fst_smem);
  V2<T>* sr = reinterpret_cast<V2<T>*>(sf + kChunk<T>);
  constexpr int kGroup = kThreads / kLanes;  // particles a block
  const int lane = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const T four_h2 = T(p.four_h2);
  const T dt = *dt_ptr;
  const int first = (r0 / kGroup + (int)blockIdx.x) * kGroup;
  const int hi = min(first + kGroup, p.n);

  // the block's sorted positions [first, hi), row by row: [lo, e) those
  // in cells gxa .. gxb of row gy, whose 3x3 cells together are `rows`
  for (int lo = first; lo < hi;) {
    const V4<T> head = fields[lo];
    const int c0 = cell_of(head.x, head.y, p);
    const int gy = c0 / p.Gx, gxa = c0 - gy * p.Gx;
    const int e = max(min(__ldg(starts + (gy + 1) * p.Gx), hi), lo + 1);
    if (e <= r0 || lo >= r1) {  // no receiver of the range in this run
      lo = e;
      continue;
    }
    const V4<T> tail = fields[e - 1];
    const int gxb = min(max(cell_of(tail.x, tail.y, p) - gy * p.Gx, gxa),
                        p.Gx - 1);
    const NeighbourRows rows = neighbour_rows(starts, gxa, gxb, gy, p);
    const int s = lo + slot;  // this thread's particle, sorted position
    const bool live = s < e && s >= r0 && s < r1;
    V4<T> me{};
    T rho_i = T(0), pt_i = T(0);
    int self = -1;  // its own list entry
    int ea[3] = {0, 0, 0}, ee[3] = {0, 0, 0};  // its 3x3 cells' entries
    if (live) {
      me = fields[s];
      const V2<T> mine = rp[s];
      rho_i = nmax(mine.a, T(1e-30));
      pt_i = mine.b;
      self = rows.off(1) + (s - rows.b[1]);
      const int gx = cell_of(me.x, me.y, p) - gy * p.Gx;
      for (int o = 0; o < 3; ++o)
        cell_entries(rows, starts, o, gx, gy, p, &ea[o], &ee[o]);
    }
    T px = T(0), py = T(0);
    for (int k0 = 0; k0 < rows.total; k0 += kChunk<T>) {
      const int count = min(kChunk<T>, rows.total - k0);
      __syncthreads();  // the chunk before is read
      stage_chunk(rows, k0, count, [&](int i, int j) {
        sf[i] = fields[j];
        sr[i] = rp[j];
      });
      __syncthreads();
      if (!live) continue;  // all lanes of a particle alike
      for (int o = 0; o < 3; ++o) {
        const int jb = max(ea[o], k0), je = min(ee[o], k0 + count);
        for (int j = jb + lane; j < je; j += kLanes) {
          if (j == self) continue;
          const int i = j - k0;
          const V4<T> ob = sf[i];
          const T dx = me.x - ob.x;
          const T dy = me.y - ob.y;
          const T r2 = dx * dx + dy * dy;
          if (!(r2 < four_h2 && r2 > T(1e-16))) continue;
          add_pair(p, me, rho_i, pt_i, ob, sr[i], dx, dy, r2, px, py);
        }
      }
    }
    // the lanes' sums, in a fixed order: an xor butterfly
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      px += __shfl_xor_sync(0xffffffffu, px, o);
      py += __shfl_xor_sync(0xffffffffu, py, o);
    }
    if (live && lane == 0) {
      T ax = px, ay = py;
      if (p.use_grav) ay = ay - T(p.gravity);
      const T e_w = T(0.2);
      T vx = me.vx + ax * dt;
      T vy = me.vy + ay * dt;
      T x = me.x + vx * dt;
      T y = me.y + vy * dt;
      const T bx = T(p.box_x), by = T(p.box_y);
      const bool lo_x = x < T(0), hi_x = x > bx;
      const bool lo_y = y < T(0), hi_y = y > by;
      x = lo_x ? T(0) : (hi_x ? bx : x);
      y = lo_y ? T(0) : (hi_y ? by : y);
      if (lo_x || hi_x) vx = -e_w * vx;
      if (lo_y || hi_y) vy = -e_w * vy;
      const int idx = __ldg(order + s);
      pos_out[2 * idx] = x;
      pos_out[2 * idx + 1] = y;
      vel_out[2 * idx] = vx;
      vel_out[2 * idx + 1] = vy;
    }
    lo = e;
  }
}

template <typename T>
SPHBlockShape shape_of(int n) {
  return {kThreads, forces_lanes(n), kChunk<T>,
          (int)(kChunk<T> * (sizeof(V4<T>) + sizeof(V2<T>)))};
}

template <typename T, int kLanes>
void launch_lanes(const T* fields, const T* rp, const int* starts,
                  const int* order, const T* dt, const SPHParams* p, int r0,
                  int r1, T* pos_out, T* vel_out, size_t smem, void* stream) {
  forces_kernel<T, kLanes><<<range_blocks(r0, r1, kThreads / kLanes),
                             kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const V4<T>*>(fields),
      reinterpret_cast<const V2<T>*>(rp), starts, order, dt, *p, r0, r1,
      pos_out, vel_out);
}

template <typename T>
int launch_forces(const T* fields, const T* rp, const int* starts,
                  const int* order, const T* dt, const SPHParams* p, int r0,
                  int r1, T* pos_out, T* vel_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r0 < 0 || r1 > p->n || r0 > r1) return (int)cudaErrorInvalidValue;
  if (r0 == r1) return 0;
  // the lanes a particle follow the particle count, not the range
  const SPHBlockShape sh = shape_of<T>(p->n);
  const size_t smem = (size_t)sh.smem_bytes;
  switch (sh.lanes) {
    case 1:
      launch_lanes<T, 1>(fields, rp, starts, order, dt, p, r0, r1, pos_out,
                         vel_out, smem, stream);
      break;
    case 2:
      launch_lanes<T, 2>(fields, rp, starts, order, dt, p, r0, r1, pos_out,
                         vel_out, smem, stream);
      break;
    case 4:
      launch_lanes<T, 4>(fields, rp, starts, order, dt, p, r0, r1, pos_out,
                         vel_out, smem, stream);
      break;
    default:
      launch_lanes<T, 8>(fields, rp, starts, order, dt, p, r0, r1, pos_out,
                         vel_out, smem, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The blocks of the forces kernel of each dtype for n particles: threads,
// lanes a particle, candidates a staged chunk and dynamic shared memory a
// block.
void fst_sph_forces_shape_f32(int n, fst::SPHBlockShape* out) {
  *out = fst::shape_of<float>(n);
}

void fst_sph_forces_shape_f64(int n, fst::SPHBlockShape* out) {
  *out = fst::shape_of<double>(n);
}

// pos_out, vel_out (n, 2): written at order[s] for s in [r0, r1).
int fst_sph_forces_f32(const float* fields, const float* rp,
                       const int* starts, const int* order, const float* dt,
                       const fst::SPHParams* p, int r0, int r1,
                       float* pos_out, float* vel_out, int device,
                       void* stream) {
  return fst::launch_forces<float>(fields, rp, starts, order, dt, p, r0, r1,
                                   pos_out, vel_out, device, stream);
}

int fst_sph_forces_f64(const double* fields, const double* rp,
                       const int* starts, const int* order, const double* dt,
                       const fst::SPHParams* p, int r0, int r1,
                       double* pos_out, double* vel_out, int device,
                       void* stream) {
  return fst::launch_forces<double>(fields, rp, starts, order, dt, p, r0, r1,
                                    pos_out, vel_out, device, stream);
}

}  // extern "C"
