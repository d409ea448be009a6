// SPH binning: each particle's rank in its cell, and the particles sorted
// by cell and, inside a cell, by particle index, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/ops/rank_pallas.py::_kernel
// (pallas_call at :86), which computes rank[i] = #{j < i : cid[j] ==
// cid[i]} by one-hot matmuls on the MXU for at most 4096 cells; the JAX
// SPH engines compute the same ranks with a packed-key sort in XLA
// (ops/cell_dense.py::bin_rank).  Here it is a counting sort that stays
// deterministic, with no cell limit, in two launches: a cooperative one of
// three phases, two grid syncs apart (counted, tiles.cuh CountedGrid),
//
//  1. each particle's cell id; the cells' counts, one atomicAdd for each
//     cell a warp's particles fall in (__match_any_sync groups the lanes);
//  2. the cells' starts (M + 1 entries): each block scans its own slice of
//     the cells, publishes the slice's sum and adds the sums of the slices
//     before it as they are published (all blocks are resident, so none
//     waits on a block that has not started); the counts become the cells'
//     cursors, and the cells of more than kBinCountCap members are listed,
//     one place in the list taken a block;
//  3. each particle takes a slot in its cell's range, one atomicAdd on the
//     cursor for each cell a warp's particles fall in, in an order that
//     varies run to run;
//
// and a plain one that sorts each cell's members by particle index:
//
//  4. a block each kBinThreads slots: the members of the cells of at most
//     kBinCountCap members that the block's slots fall in staged in shared
//     memory (at most kBinThreads + 2 (kBinCountCap - 1) slots), each
//     ranked by counting the members below it; and a block a listed cell
//     (the first blocks, one an SM, so that they start first): a bitonic
//     sort in shared memory of up to kBinBlockCap members, or of chunks of
//     that many each, every member then ranked in the other chunks by
//     binary search; the counts and the slices' sums back to 0.
//
// A member's place in its sorted cell is its rank, exactly the stable rank
// of bin_rank, so the outputs are the same bits on every run and the pair
// sums of the next two kernels repeat too.
//
// The cells are those of the parameters' window of grid columns (sph.cuh
// SPHParams: the whole grid by default), and the n particles all lie in it.
//
// Outputs: cid and rank in particle order; starts; the sorted order
// (particle index per position) and fields (n, 4).  Scratch, kept by the
// wrapper per launch shape and stream: the counts and the slices' sums (0
// between launches), the list and the bucket of (particle, cell) slots
// (bin_layout).
//
// What bounds it on an H100: bytes and latency.  It reads pos and vel
// (4 T a particle) and writes 4 ints and 4 T a particle, ~14 us of traffic
// at 2^20 particles and under 1 us at 65,536.  The first design ran five
// launches (a memset, the count, a one-block scan over all cells, the
// fill, and a rank that looped over a cell's whole bucket a member, c^2
// loads for a cell of c: up to 382 members a cell in the pool at the floor
// after 200 steps at 65,536 particles, 54 cells of more than 256); its
// one-block scan took half its time at 2^20 (65,536 cells).  Here the scan
// spreads over every block, same-cell atomics of a warp fold into one, a
// crowded cell's members count each other from shared memory, and the
// ranks run as a plain launch of their own, a block each kBinThreads
// slots at full occupancy, where a third grid sync in the cooperative
// launch cost more than the launch (PERF.md).
#include <limits.h>

#include "sph.cuh"
#include "tiles.cuh"

// Threads a block of both launches (tools/tune_tiles_torch.py sweep --set
// bin: 512 ran 0-6% faster than 256 at the main runs' sizes, PERF.md).
#ifndef FST_BIN_THREADS
#define FST_BIN_THREADS 512
#endif
// Phase stamps, for timing the phases (tools/tune_tiles_torch.py phases
// builds with -DFST_BIN_STAMPS): block 0 of the cooperative launch writes
// %globaltimer into slot words 0-2 at its start and after each grid sync,
// every block of it its end into word 3, and every block of the second
// launch its end into word 4 (the latest).  The shipped build has none.
#ifdef FST_BIN_STAMPS
__device__ __forceinline__ unsigned long long bin_clock() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}
#define FST_BIN_STAMP(words, i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) (words)[i] = bin_clock()
#define FST_BIN_STAMP_END(words, i) \
  __syncthreads();                  \
  if (threadIdx.x == 0) atomicMax((words) + (i), bin_clock())
#else
#define FST_BIN_STAMP(words, i)
#define FST_BIN_STAMP_END(words, i)
#endif

namespace fst {

constexpr int kBinThreads = FST_BIN_THREADS;
// Cells of at most kBinCountCap members are ranked in their slots' blocks
// by counting; larger ones by a block of their own, by a bitonic sort in
// chunks of at most kBinBlockCap.
constexpr int kBinCountCap = 512;
constexpr int kBinBlockCap = 2048;
constexpr int kBinSyncs = 2;
// Dynamic shared memory a block of the second launch: its slots' cells, or
// a listed cell's chunk.
constexpr int kBinSmem = kBinBlockCap * 4;
static_assert(kBinThreads + 2 * (kBinCountCap - 1) <= kBinBlockCap,
              "a block's slots' cells fit its shared memory");

// What the bin's grid query reports (mirrored by kernels/sph_cuda.py
// BinLaunch): the blocks of the cooperative launch, threads a block, its
// grid syncs, the blocks of the second launch and the first of them that
// rank listed cells, the tiers' sizes, dynamic shared memory a block of
// the second launch and the int32 words of scratch.
struct BinLaunch {
  int grid, threads, grid_syncs, rank_grid, sort_blocks, count_cap,
      block_cap, smem_bytes;
  long long scratch_ints;
};

// The scratch of a bin of n particles over M cells with a cooperative
// launch of `grid` blocks, in int32 words: the counts (M, 0 between
// launches), the slices' sums (grid, 0 between launches), the length of
// the list, the cells of more than kBinCountCap members, and the bucket's
// (particle, cell) slots (int2, 8-byte aligned).
struct BinLayout {
  long long counts, sums, listed, list, bucket, total;
};

__host__ __device__ inline BinLayout bin_layout(long long n, long long M,
                                                int grid) {
  BinLayout l;
  l.counts = 0;
  l.sums = M;
  l.listed = l.sums + grid;
  l.list = l.listed + 1;
  l.bucket = (l.list + n / (kBinCountCap + 1) + 2) & ~1ll;
  l.total = l.bucket + 2 * n;
  return l;
}

namespace {

template <typename T>
struct BinArgs {
  const T* pos;
  const T* vel;
  SPHParams p;
  int* cid;
  int* starts;
  int* order;
  int* rank;
  V4<T>* fields;
  int* scratch;                // bin_layout(n, M, grid).total words
  unsigned long long* words;   // kTileWords; the last takes the sync count
  int grid;                    // blocks of the cooperative launch
  int sort_blocks;             // blocks of the second launch for the list
};

template <typename T>
struct BinScratch {
  int* counts;
  int* sums;
  int* listed;
  int* list;
  int2* bucket;

  __device__ __forceinline__ BinScratch(const BinArgs<T>& a) {
    const BinLayout L = bin_layout(a.p.n, (long long)a.p.Gx * a.p.Gy, a.grid);
    counts = a.scratch + L.counts;
    sums = a.scratch + L.sums;
    listed = a.scratch + L.listed;
    list = a.scratch + L.list;
    bucket = reinterpret_cast<int2*>(a.scratch + L.bucket);
  }
};

// The smallest power of two >= m (m >= 1).
__device__ __forceinline__ int pow2_at_least(int m) {
  return m <= 1 ? 1 : 1 << (32 - __clz(m - 1));
}

// Sorts s[0, P) ascending (P a power of two) by the block, the pairs of
// each step spread over its threads.
__device__ __forceinline__ void bitonic_sort(int* s, int P) {
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;  // lo: bit j clear
        const int x = s[lo], y = s[hi];
        if ((x > y) == ((lo & k) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
}

// Sorted position `at` holds particle idx, rank r in its cell.
template <typename T>
__device__ __forceinline__ void emit(const BinArgs<T>& a, int at, int idx,
                                     int r) {
  const size_t k = 2 * (size_t)idx;
  a.order[at] = idx;
  a.rank[idx] = r;
  a.fields[at] = {__ldg(a.pos + k), __ldg(a.pos + k + 1), __ldg(a.vel + k),
                  __ldg(a.vel + k + 1)};
}

// The cooperative launch: phases 1-3.
template <typename T>
__global__ void __launch_bounds__(kBinThreads) bin_kernel(BinArgs<T> a) {
  CountedGrid grid = counted_grid();
  const BinScratch<T> w(a);
  const int n = a.p.n;
  const long long M = (long long)a.p.Gx * a.p.Gy;
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one

  // 1. each particle's cell; the counts, one add a cell a warp
  FST_BIN_STAMP(a.words, 0);
  if (tid == 0) *w.listed = 0;
  for (long long w0 = tid - lane; w0 < n; w0 += stride) {
    const long long k = w0 + lane;
    int c = -1;
    if (k < n) {
      c = cell_of(__ldg(a.pos + 2 * k), __ldg(a.pos + 2 * k + 1), a.p);
      a.cid[k] = c;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    if (c >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(w.counts + c, __popc(peers));
  }
  grid.sync();
  FST_BIN_STAMP(a.words, 1);

  // 2. the starts: each block its slice of the cells (each thread a strip
  // of consecutive cells), after the sums of the slices before it, which
  // each block publishes (plus one: 0 is not yet) and waits for; the cells
  // of more than kBinCountCap members listed, a place in the list a block
  __shared__ int block_listed, list_base;
  if (threadIdx.x == 0) block_listed = 0;
  const long long slice = (M + gridDim.x - 1) / gridDim.x;
  const long long c0 = min(M, slice * blockIdx.x), c1 = min(M, c0 + slice);
  const long long per = (c1 - c0 + blockDim.x - 1) / blockDim.x;
  const long long s0 = min(c1, c0 + per * threadIdx.x), s1 = min(c1, s0 + per);
  unsigned long long mine = 0, slice_sum;
  int to_list = 0;
  for (long long c = s0; c < s1; ++c) {
    const int m = __ldcg(w.counts + c);
    mine += (unsigned)m;
    to_list += m > kBinCountCap;
  }
  const unsigned long long before = block_scan(mine, &slice_sum) - mine;
  if (threadIdx.x == 0) atomicExch(w.sums + blockIdx.x, (int)slice_sum + 1);
  if (to_list) to_list = atomicAdd(&block_listed, to_list);
  __syncthreads();
  if (threadIdx.x == 0) list_base = atomicAdd(w.listed, block_listed);
  unsigned long long prior = 0, offset;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += blockDim.x) {
    int v;
    while ((v = *(volatile int*)(w.sums + k)) == 0) {
    }
    prior += (unsigned)(v - 1);
  }
  block_scan(prior, &offset);  // its barriers publish list_base too
  unsigned long long at = offset + before;
  for (long long c = s0; c < s1; ++c) {
    const int m = __ldcg(w.counts + c);
    a.starts[c] = (int)at;
    w.counts[c] = (int)at;  // the fill's cursor
    if (m > kBinCountCap) w.list[list_base + to_list++] = (int)c;
    at += (unsigned)m;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    a.starts[M] = (int)(offset + slice_sum);
  grid.sync();
  FST_BIN_STAMP(a.words, 2);

  // 3. each particle's slot in its cell's range, one add a cell a warp
  for (long long w0 = tid - lane; w0 < n; w0 += stride) {
    const long long k = w0 + lane;
    const int c = k < n ? a.cid[k] : -1;  // this thread's own phase-1 write
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (c >= 0 && lane == leader)
      base = atomicAdd(w.counts + c, __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (c >= 0) w.bucket[base + __popc(peers & below)] = make_int2((int)k, c);
  }
  FST_BIN_STAMP_END(a.words, 3);
  grid.write_syncs(a.words);
}

// Phase 4, a listed cell by the block: a bitonic sort of its members in
// shared memory `s`, in chunks of kBinBlockCap written back sorted to the
// bucket where there are more.
template <typename T>
__device__ void rank_listed(const BinArgs<T>& a, const BinScratch<T>& w,
                            int c, int* s) {
  const int b = a.starts[c], m = a.starts[c + 1] - b;
  const int t = threadIdx.x, nt = blockDim.x;
  for (int c0 = 0; c0 < m; c0 += kBinBlockCap) {
    const int k = min(kBinBlockCap, m - c0), P = pow2_at_least(k);
    for (int i = t; i < P; i += nt)
      s[i] = i < k ? w.bucket[b + c0 + i].x : INT_MAX;
    __syncthreads();
    bitonic_sort(s, P);
    for (int i = t; i < k; i += nt) {
      if (m <= kBinBlockCap)
        emit(a, b + i, s[i], i);
      else
        w.bucket[b + c0 + i].x = s[i];
    }
    __syncthreads();
  }
  if (m <= kBinBlockCap) return;
  // a member's place in its own sorted chunk, plus the members below it in
  // each other chunk
  for (int i = t; i < m; i += nt) {
    const int v = __ldcg(&w.bucket[b + i].x), own = i / kBinBlockCap;
    int r = i - own * kBinBlockCap;
    for (int c0 = 0, ch = 0; c0 < m; c0 += kBinBlockCap, ++ch) {
      if (ch == own) continue;
      int lo = 0, hi = min(kBinBlockCap, m - c0);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(&w.bucket[b + c0 + mid].x) < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      r += lo;
    }
    emit(a, b + r, v, r);
  }
  __syncthreads();
}

// Phase 4, slots q0 .. q0 + blockDim.x - 1 by the block: the members of
// the cells of at most kBinCountCap members (the others are listed) that
// these slots fall in, staged in shared memory `win` (from the first such
// cell's start to the last one's end: at most blockDim.x + 2 (kBinCountCap
// - 1) slots), each slot's member ranked by the members below it.
template <typename T>
__device__ __forceinline__ void rank_slots(const BinArgs<T>& a,
                                           const BinScratch<T>& w,
                                           long long q0, int* win) {
  __shared__ int lo_s, hi_s;
  if (threadIdx.x == 0) {
    lo_s = INT_MAX;
    hi_s = 0;
  }
  __syncthreads();
  const long long q = q0 + threadIdx.x;
  int idx = 0, b = 0, end = 0;
  bool mine = false;
  if (q < a.p.n) {
    const int2 e = w.bucket[q];
    idx = e.x;
    b = a.starts[e.y];
    end = a.starts[e.y + 1];
    mine = end - b <= kBinCountCap;
    if (mine) {
      atomicMin(&lo_s, b);
      atomicMax(&hi_s, end);
    }
  }
  __syncthreads();
  const int lo = lo_s, hi = hi_s;
  for (int i = threadIdx.x; i < hi - lo; i += blockDim.x)
    win[i] = w.bucket[lo + i].x;
  __syncthreads();
  if (!mine) return;
  int r = 0;
  for (int j = b - lo; j < end - lo; ++j) r += win[j] < idx;
  emit(a, b + r, idx, r);
}

// The second launch: phase 4, and the counts and slices' sums back to 0.
template <typename T>
__global__ void __launch_bounds__(kBinThreads) bin_rank_kernel(BinArgs<T> a) {
  extern __shared__ __align__(16) int bin_smem[];
  const BinScratch<T> w(a);
  const long long M = (long long)a.p.Gx * a.p.Gy;
  if ((int)blockIdx.x < a.sort_blocks) {
    const int listed = *w.listed;
    for (int l = blockIdx.x; l < listed; l += a.sort_blocks)
      rank_listed(a, w, w.list[l], bin_smem);
  } else {
    const long long blk = blockIdx.x - a.sort_blocks;
    const long long tid = blk * blockDim.x + threadIdx.x;
    const long long stride = (long long)(gridDim.x - a.sort_blocks) *
                             blockDim.x;
    for (long long c = tid; c < M; c += stride) w.counts[c] = 0;
    if (tid < a.grid) w.sums[tid] = 0;
    rank_slots(a, w, blk * blockDim.x, bin_smem);
  }
  FST_BIN_STAMP_END(a.words, 4);
}

// The blocks of the second launch over n particles: sort_blocks, then one
// a kBinThreads slots.
inline int rank_grid(int n, int sort_blocks) {
  return sort_blocks + (n + kBinThreads - 1) / kBinThreads;
}

template <typename T>
int bin_query(int n, int M, int device, BinLaunch* out) {
  if (n < 1 || M < 1 || n > (1 << 30)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kBinThreads - 1) / kBinThreads;
  int grid = 0;
  const int code = cooperative_blocks(bin_kernel<T>, want, device, &grid, 0,
                                      kBinThreads);
  if (code != 0) return code;
  *out = {grid,         kBinThreads,  kBinSyncs, rank_grid(n, sms), sms,
          kBinCountCap, kBinBlockCap, kBinSmem,  bin_layout(n, M, grid).total};
  return 0;
}

template <typename T>
int launch_bin(const T* pos, const T* vel, const SPHParams* p, int* cid,
               int* starts, int* order, int* rank, T* fields, int* scratch,
               unsigned long long* words, int grid, int sort_blocks,
               int device, void* stream) {
  if (grid < 1 || sort_blocks < 1) return (int)cudaErrorInvalidValue;
  const BinArgs<T> args{pos,     vel,   *p,   cid,
                        starts,  order, rank, reinterpret_cast<V4<T>*>(fields),
                        scratch, words, grid, sort_blocks};
  return on_device(device, [&] {
    int err = launch_cooperative_on(bin_kernel<T>, args, grid, device, stream,
                                    0, kBinThreads);
    if (err != 0) return err;
    bin_rank_kernel<T><<<(unsigned)rank_grid(p->n, sort_blocks), kBinThreads,
                     kBinSmem, (cudaStream_t)stream>>>(args);
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace fst

extern "C" {

// The launches of a bin of n particles over M cells on `device`.
int fst_sph_bin_shape_f32(int n, int M, int device, fst::BinLaunch* out) {
  return fst::on_device(device, [&] {
    return fst::bin_query<float>(n, M, device, out);
  });
}

int fst_sph_bin_shape_f64(int n, int M, int device, fst::BinLaunch* out) {
  return fst::on_device(device, [&] {
    return fst::bin_query<double>(n, M, device, out);
  });
}

// `grid` and `sort_blocks` from the shape query; scratch of its
// scratch_ints words, zeroed before the first launch (the launches leave
// the counts and sums at 0).
int fst_sph_bin_f32(const float* pos, const float* vel,
                    const fst::SPHParams* p, int* cid, int* starts,
                    int* order, int* rank, float* fields, int* scratch,
                    unsigned long long* words, int grid, int sort_blocks,
                    int device, void* stream) {
  return fst::launch_bin<float>(pos, vel, p, cid, starts, order, rank,
                                fields, scratch, words, grid, sort_blocks,
                                device, stream);
}

int fst_sph_bin_f64(const double* pos, const double* vel,
                    const fst::SPHParams* p, int* cid, int* starts,
                    int* order, int* rank, double* fields, int* scratch,
                    unsigned long long* words, int grid, int sort_blocks,
                    int device, void* stream) {
  return fst::launch_bin<double>(pos, vel, p, cid, starts, order, rank,
                                 fields, scratch, words, grid, sort_blocks,
                                 device, stream);
}

}  // extern "C"
