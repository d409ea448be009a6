// SPH binning: each particle's rank in its cell, and the particles sorted
// by cell and, inside a cell, by particle index, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/ops/rank_pallas.py::_kernel
// (pallas_call at :86), which computes rank[i] = #{j < i : cid[j] ==
// cid[i]} by one-hot matmuls on the MXU for at most 4096 cells; the JAX
// SPH engines compute the same ranks with a packed-key sort in XLA
// (ops/cell_dense.py::bin_rank).  Here it is a counting sort that stays
// deterministic, with no cell limit:
//
//  1. count_kernel: cell id per particle, atomicAdd on the cell's count;
//  2. scan_kernel (one block, warp shuffles): exclusive scan of the counts
//     into `starts` (M + 1 entries), and the counts reset to zero;
//  3. fill_kernel: each particle takes a place in its cell's bucket by
//     atomicAdd on the reset count, in an order that varies run to run;
//  4. rank_kernel (one thread per bucket slot): a member's rank is the
//     number of members of its cell with a smaller particle index, so the
//     order of step 3 does not matter.  The rank is exactly the stable
//     rank of bin_rank, and the sorted copy of (x, y, vx, vy) is the same
//     bits on every run, so the pair sums of the next two kernels repeat
//     too.  Cells are not assumed small: at the reference defaults the
//     pool piles up to ~1,000 particles a cell.
//
// Outputs: cid and rank in particle order; starts; the sorted order
// (particle index per position) and fields (n, 4).
//
// What bounds it on an H100: bytes and latency.  It reads pos and vel
// (4 T a particle) and writes 4 ints and 4 T a particle, tens of
// microseconds of traffic at 2^20 particles.  The rank step does count^2
// comparisons a cell: small while cells hold tens of particles, and the
// bin's largest cost where the reference defaults pile ~1,000 particles
// into a cell (the pool at the floor after 200 steps at 65,536
// particles); one thread per particle keeps the card full there.  The
// scan is one block, a few microseconds a chunk of 1024 cells.
#include "sph.cuh"

namespace fst {
namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_kernel(const T* __restrict__ pos, SPHParams p, int* __restrict__ cid,
             int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int c = cell_of(pos[2 * i], pos[2 * i + 1], p);
  cid[i] = c;
  atomicAdd(counts + c, 1);
}

// One block walks the cells in chunks of kScanThreads: a coalesced load,
// a warp-shuffle scan, a scan of the warp sums, and a carry to the next
// chunk.  The counts are reset to zero on the way.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ starts, int M) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) carry = 0;
  for (int c0 = 0; c0 < M; c0 += kScanThreads) {
    const int c = c0 + t;
    const int v = c < M ? counts[c] : 0;
    int x = v;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[w] = x;
    __syncthreads();
    if (w == 0) {  // exclusive scan of the warp sums
      const int s0 = warp_sum[lane];
      int y = s0;
      for (int off = 1; off < 32; off <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, off);
        if (lane >= off) y += z;
      }
      warp_sum[lane] = y - s0;
    }
    __syncthreads();
    const int base = carry;
    if (c < M) {
      starts[c] = base + warp_sum[w] + x - v;
      counts[c] = 0;
    }
    __syncthreads();
    if (t == kScanThreads - 1) carry = base + warp_sum[w] + x;
    __syncthreads();
  }
  if (t == 0) starts[M] = carry;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int* __restrict__ cid, const int* __restrict__ starts,
            int* __restrict__ cursor, int* __restrict__ bucket, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cid[i];
  bucket[starts[c] + atomicAdd(cursor + c, 1)] = i;
}

// One thread per bucket slot: its particle's rank is the number of members
// of its cell with a smaller particle index.  Neighbouring slots belong to
// one cell, so a warp reads each member once, as a broadcast.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const T* __restrict__ pos, const T* __restrict__ vel,
            const int* __restrict__ cid, const int* __restrict__ starts,
            const int* __restrict__ bucket, SPHParams p,
            int* __restrict__ order, int* __restrict__ rank,
            V4<T>* __restrict__ fields) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.n) return;
  const int idx = bucket[q];
  const int c = cid[idx];
  const int b = starts[c], e = starts[c + 1];
  int r = 0;
  for (int j = b; j < e; ++j) r += __ldg(bucket + j) < idx;
  order[b + r] = idx;
  rank[idx] = r;
  fields[b + r] = {pos[2 * idx], pos[2 * idx + 1], vel[2 * idx],
                   vel[2 * idx + 1]};
}

template <typename T>
int launch_bin(const T* pos, const T* vel, const SPHParams* p, int* cid,
               int* counts, int* starts, int* bucket, int* order, int* rank,
               T* fields, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = p->Gx * p->Gy;
  err = cudaMemsetAsync(counts, 0, sizeof(int) * M, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p->n + kThreads - 1) / kThreads;
  count_kernel<T><<<blocks, kThreads, 0, s>>>(pos, *p, cid, counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, starts, M);
  fill_kernel<<<blocks, kThreads, 0, s>>>(cid, starts, counts, bucket, p->n);
  rank_kernel<T><<<blocks, kThreads, 0, s>>>(
      pos, vel, cid, starts, bucket, *p, order, rank,
      reinterpret_cast<V4<T>*>(fields));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_sph_bin_f32(const float* pos, const float* vel,
                    const fst::SPHParams* p, int* cid, int* counts,
                    int* starts, int* bucket, int* order, int* rank,
                    float* fields, int device, void* stream) {
  return fst::launch_bin<float>(pos, vel, p, cid, counts, starts, bucket,
                                order, rank, fields, device, stream);
}

int fst_sph_bin_f64(const double* pos, const double* vel,
                    const fst::SPHParams* p, int* cid, int* counts,
                    int* starts, int* bucket, int* order, int* rank,
                    double* fields, int device, void* stream) {
  return fst::launch_bin<double>(pos, vel, p, cid, counts, starts, bucket,
                                 order, rank, fields, device, stream);
}

}  // extern "C"
