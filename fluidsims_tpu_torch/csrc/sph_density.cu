// SPH density + log-density Tait EOS per particle, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/sph_pallas.py::
// _density_kernel (pallas_call at :257).  That kernel held the particles of
// 128 cells per block in a (2, K, 128) lane-dense VMEM layout, with
// sentinel positions in empty slots and whole halo blocks on both sides, and
// summed dense (K, K) pair blocks.  Here the particles are already sorted
// by cell (sph_bin.cu), so there is no dense layout, no sentinel and no
// halo, and no cell capacity K: every member of a particle's 3x3
// neighbour cells enters its sum m W(r) (the self pair included, as in the
// reference's linked lists, tau_sph.cu:165-176).  Then, per particle, as
// sph_pallas.py:103-118 does: s = log(max(rho, 1e-6)), rho = exp(s), the
// Tait pressure (the gamma_eos == 1 branch skips the power), and p / rho^2,
// which the forces kernel adds per pair.  Output rp (r1 - r0, 2) = (rho,
// p / rho^2) of the receivers at sorted positions [r0, r1) (every particle
// by default); their neighbours are every member of their 3x3 cells,
// wherever those are sorted.
//
// What bounds it on an H100: the pair arithmetic, ~15 operations and a
// square root a candidate (~1,200 candidates a particle on the evolved
// state at 65,536, ~250 at 2^20), and the latency of that chain; the
// per-particle bytes (4 T in, 2 T out) are small beside it.
//
// What the first design lost (0.2027 ms a launch at 65,536, 15.6x its
// bound; 0.3682 at 2^20, 8.3x): one thread a particle in 128-thread blocks
// walked its 3x3 cells member by member, each candidate a 16-byte gather
// from device memory of which it used 8; ~16 warps an SM at 65,536, and
// nothing hid the chain.  It is the first design of the forces kernel,
// which PR 12 replaced.
//
// The design: the forces kernel's (sph_forces.cu), with density's own
// constants.  A block takes kGroup = kThreads / kLanes consecutive sorted
// positions, a run of cells of one grid row at a time; the 3x3 cells of a
// run are three contiguous ranges of the sorted order (sph.cuh
// NeighbourRows), staged into shared memory in chunks of kChunk<T>
// candidates in a loop (no cap on a cell).  Density stages positions only,
// (x, y): 8 bytes a candidate at f32 and 16 at f64, read from the sorted
// fields as one 8- or 16-byte load.  A particle's own 3x3 cells are a
// contiguous part of each range (cell_entries), which its kLanes adjacent
// threads walk, lane l the entries l, l + kLanes, ... chunk by chunk; the
// lanes a particle come from n (lanes_for with FST_SPH_DENSITY_*).  Both
// sides of the spline's q < 1 and q < 2 tests are formed and one is
// selected (the first design's expressions, no branch to diverge on).
// The lanes' sums combine by an xor butterfly of warp shuffles, a fixed
// order, so two launches on the same input give the same bits; the order
// differs from the first design's (a cell's part, then rho += part) and
// from the plain version's index_add_, so a result agrees with them to
// rounding.  Lane 0 does the EOS and writes rp, with the first design's
// expressions.
#include "sph.cuh"

namespace fst {
namespace {

// Threads a block, the staged bytes a block, and the lanes a particle:
// the largest power of two in [FST_SPH_DENSITY_MIN_LANES,
// FST_SPH_DENSITY_MAX_LANES] whose n x lanes stays within
// FST_SPH_DENSITY_LANE_THREADS: 8 at 65,536, 1 at 2^20, where n particles
// already give every SM its warps and a lane's setup is its own
// (tools/tune_tiles_torch.py --set sph; PERF.md).
#ifndef FST_SPH_DENSITY_THREADS
#define FST_SPH_DENSITY_THREADS 128
#endif
#ifndef FST_SPH_DENSITY_STAGE_BYTES
#define FST_SPH_DENSITY_STAGE_BYTES 8192
#endif
#ifndef FST_SPH_DENSITY_MIN_LANES
#define FST_SPH_DENSITY_MIN_LANES 1
#endif
#ifndef FST_SPH_DENSITY_MAX_LANES
#define FST_SPH_DENSITY_MAX_LANES 8
#endif
#ifndef FST_SPH_DENSITY_LANE_THREADS
#define FST_SPH_DENSITY_LANE_THREADS 524288
#endif
constexpr int kThreads = FST_SPH_DENSITY_THREADS;
static_assert(kThreads % 32 == 0, "whole warps");
static_assert(FST_SPH_DENSITY_MIN_LANES >= 1 &&
                  FST_SPH_DENSITY_MAX_LANES <= 16 &&
                  FST_SPH_DENSITY_MIN_LANES <= FST_SPH_DENSITY_MAX_LANES,
              "lanes a particle in [1, 16]");

inline int density_lanes(int n) {
  return lanes_for(n, FST_SPH_DENSITY_MIN_LANES, FST_SPH_DENSITY_MAX_LANES,
                   FST_SPH_DENSITY_LANE_THREADS);
}

// Candidates a staged chunk holds: the stage's bytes over a position's.
template <typename T>
constexpr int kChunk = FST_SPH_DENSITY_STAGE_BYTES / (int)sizeof(V2<T>);

// A range [r0, r1) of receivers keeps the blocks of the whole range: block
// b of a launch is block r0 / kGroup + b of [0, n), which walks and stages
// the runs of its kGroup sorted positions as that block does, and only the
// particles in [r0, r1) are live and written.  So a receiver's sum takes
// the same lanes, chunks and order, and gives the same bits, in any range;
// a run with no receiver in the range is skipped.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
density_kernel(const V4<T>* __restrict__ fields,
               const int* __restrict__ starts, SPHParams p, int r0, int r1,
               V2<T>* __restrict__ rp) {
  extern __shared__ __align__(16) unsigned char fst_smem[];
  V2<T>* sp = reinterpret_cast<V2<T>*>(fst_smem);
  // (x, y) of sorted position j: the first half of fields[j]
  const V2<T>* __restrict__ xy = reinterpret_cast<const V2<T>*>(fields);
  constexpr int kGroup = kThreads / kLanes;  // particles a block
  const int lane = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const T inv_h = T(p.inv_h), alpha = T(p.alpha), alpha_q = T(p.alpha_q);
  const int first = (r0 / kGroup + (int)blockIdx.x) * kGroup;
  const int hi = min(first + kGroup, p.n);

  // the block's sorted positions [first, hi), row by row: [lo, e) those
  // in cells gxa .. gxb of row gy, whose 3x3 cells together are `rows`
  for (int lo = first; lo < hi;) {
    const V2<T> head = xy[2 * lo];
    const int c0 = cell_of(head.a, head.b, p);
    const int gy = c0 / p.Gx, gxa = c0 - gy * p.Gx;
    const int e = max(min(__ldg(starts + (gy + 1) * p.Gx), hi), lo + 1);
    if (e <= r0 || lo >= r1) {  // no receiver of the range in this run
      lo = e;
      continue;
    }
    const V2<T> tail = xy[2 * (e - 1)];
    const int gxb = min(max(cell_of(tail.a, tail.b, p) - gy * p.Gx, gxa),
                        p.Gx - 1);
    const NeighbourRows rows = neighbour_rows(starts, gxa, gxb, gy, p);
    const int s = lo + slot;  // this thread's particle, sorted position
    const bool live = s < e && s >= r0 && s < r1;
    V2<T> me{};
    int ea[3] = {0, 0, 0}, ee[3] = {0, 0, 0};  // its 3x3 cells' entries
    if (live) {
      me = xy[2 * s];
      const int gx = cell_of(me.a, me.b, p) - gy * p.Gx;
      for (int o = 0; o < 3; ++o)
        cell_entries(rows, starts, o, gx, gy, p, &ea[o], &ee[o]);
    }
    // W(r) of a candidate: the first design's expressions, both sides of
    // its q < 1 and q < 2 tests formed and one selected
    auto weight = [&](const V2<T>& ob) {
      const T dx = me.a - ob.a;
      const T dy = me.b - ob.b;
      const T q = sqrt(dx * dx + dy * dy) * inv_h;
      const T q2 = q * q;
      const T t = T(2) - q;
      const T near = alpha * (T(1) - T(1.5) * q2 + T(0.75) * q2 * q);
      const T far = alpha_q * t * t * t;
      return q < T(1) ? near : (q < T(2) ? far : T(0));
    };
    T rho = T(0);
    for (int k0 = 0; k0 < rows.total; k0 += kChunk<T>) {
      const int count = min(kChunk<T>, rows.total - k0);
      __syncthreads();  // the chunk before is read
      stage_chunk(rows, k0, count, [&](int i, int j) { sp[i] = xy[2 * j]; });
      __syncthreads();
      if (!live) continue;  // all lanes of a particle alike
      for (int o = 0; o < 3; ++o) {
        const int jb = max(ea[o], k0), je = min(ee[o], k0 + count);
        for (int j = jb + lane; j < je; j += kLanes) rho += weight(sp[j - k0]);
      }
    }
    // the lanes' sums, in a fixed order: an xor butterfly
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      rho += __shfl_xor_sync(0xffffffffu, rho, o);
    if (live && lane == 0) {
      rho = T(p.mass) * rho;
      const T sl = log(nmax(rho, T(1e-6)));
      rho = exp(sl);
      const T ratio = rho * T(p.inv_rho0);
      const T powed =
          p.gamma_is_one ? ratio : exp(T(p.gamma_eos) * log(ratio));
      const T press =
          nmax(T(p.c0sq_rho0) * (powed - T(1)) / T(p.gamma_eos), T(0));
      const T rs = nmax(rho, T(1e-30));
      rp[s - r0] = {rho, press / (rs * rs)};
    }
    lo = e;
  }
}

template <typename T>
SPHBlockShape shape_of(int n) {
  return {kThreads, density_lanes(n), kChunk<T>,
          (int)(kChunk<T> * sizeof(V2<T>))};
}

template <typename T, int kLanes>
void launch_lanes(const T* fields, const int* starts, const SPHParams* p,
                  int r0, int r1, T* rp, size_t smem, void* stream) {
  density_kernel<T, kLanes><<<range_blocks(r0, r1, kThreads / kLanes),
                              kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const V4<T>*>(fields), starts, *p, r0, r1,
      reinterpret_cast<V2<T>*>(rp));
}

template <typename T>
int launch_density(const T* fields, const int* starts, const SPHParams* p,
                   int r0, int r1, T* rp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r0 < 0 || r1 > p->n || r0 > r1) return (int)cudaErrorInvalidValue;
  if (r0 == r1) return 0;
  // the lanes a particle follow the particle count, not the range
  const SPHBlockShape sh = shape_of<T>(p->n);
  const size_t smem = (size_t)sh.smem_bytes;
  switch (sh.lanes) {
    case 1:
      launch_lanes<T, 1>(fields, starts, p, r0, r1, rp, smem, stream);
      break;
    case 2:
      launch_lanes<T, 2>(fields, starts, p, r0, r1, rp, smem, stream);
      break;
    case 4:
      launch_lanes<T, 4>(fields, starts, p, r0, r1, rp, smem, stream);
      break;
    case 8:
      launch_lanes<T, 8>(fields, starts, p, r0, r1, rp, smem, stream);
      break;
    default:
      launch_lanes<T, 16>(fields, starts, p, r0, r1, rp, smem, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The blocks of the density kernel of each dtype for n particles:
// threads, lanes a particle, candidates a staged chunk and dynamic shared
// memory a block.
void fst_sph_density_shape_f32(int n, fst::SPHBlockShape* out) {
  *out = fst::shape_of<float>(n);
}

void fst_sph_density_shape_f64(int n, fst::SPHBlockShape* out) {
  *out = fst::shape_of<double>(n);
}

// rp (r1 - r0, 2): the receivers at sorted positions [r0, r1).
int fst_sph_density_f32(const float* fields, const int* starts,
                        const fst::SPHParams* p, int r0, int r1, float* rp,
                        int device, void* stream) {
  return fst::launch_density<float>(fields, starts, p, r0, r1, rp, device,
                                    stream);
}

int fst_sph_density_f64(const double* fields, const int* starts,
                        const fst::SPHParams* p, int r0, int r1, double* rp,
                        int device, void* stream) {
  return fst::launch_density<double>(fields, starts, p, r0, r1, rp, device,
                                     stream);
}

}  // extern "C"
