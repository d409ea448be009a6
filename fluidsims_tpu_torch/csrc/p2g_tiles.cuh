// What the two particle-to-grid kernels share (mpm_p2g.cu, flip_p2g.cu):
// particles binned by tile, each tile's chunks sorted by cell in shared
// memory and summed in registers, one launch.  A cooperative launch of four
// phases, three grid syncs apart (counted, tiles.cuh CountedGrid):
//
//   1. zero the three output grids; each particle's tile and its rank among
//      the tile's particles: a block counts its share of the particles (a
//      contiguous range) per tile in shared memory, then adds each count to
//      the tile's global count once (for more than kP2GSharedTiles tiles,
//      one global add for each run of lanes with one tile in a warp);
//   2. block 0 scans the counts (staged in shared memory) into each tile's
//      first entry and first chunk of at most `chunk` particles (one scan
//      of (particles, chunks) packed into 64 bits) and sets the counts back
//      to 0 (they stay 0 between launches: the scratch is zeroed once when
//      it is made, kernels/_common.py tile_scratch);
//   3. each particle's index into its tile's range of the index array, and
//      the list of chunks (a block a tile);
//   4. the blocks walk the chunks.  A chunk's particles are staged in
//      shared memory and sorted by base cell (a count, scan and place over
//      the tile's cells); thread i forms the weights and values of the
//      i-th particle in that order once (the solver's `scatter`), so the
//      lanes of a warp with one base cell, a run, share all 9 targets; a
//      segmented scan over the lanes sums each run's 27 values in
//      registers, and the run's last lane adds them to the grids, one
//      global atomicAdd a target and field.
//
// Why not add in shared memory: float and double atomicAdd on shared
// memory compile to CAS loops on sm_90 (ATOMS.CAST.SPIN in the SASS,
// tools/tune_tiles_torch.py sass), which ran no faster than the first
// design's global atomics: a window of the tile's nodes in shared memory took
// 0.1328 ms of device time at 2^20 MPM particles on 512^2 (the first
// design 0.1461-0.1465), a window a warp as long (PERF.md).  A run of a
// cell's particles (~19 a cell in MPM's dense state, ~4 in FLIP's) makes
// one global add a target where the first design made one a particle.
//
// Tiles.  A particle's base node (mpm_base, or floor(pos (n - 1)) for
// FLIP), shifted by the solver's `shifted_base` into [0, g + 2) along each
// axis (MPM: bases -2 .. g - 1, which reach the grid; FLIP: bases -1 .. n,
// as the clamp leaves them), decides its tile of tile_x x tile_y cells and
// its cell in the tile: ceil((g + 2) / tile) tiles along an axis.  A
// particle with no target inside the grid (MPM only) joins no tile.  The
// targets are the solver's: global nodes, so the global coordinates alone
// decide the walls.
//
// Order.  Particle state stays in its order; only the index array is
// permuted.  Adds land in no fixed order (the ranks come from atomics), so a
// node's sum matches the plain version's to rounding, not bitwise.
#pragma once

#include "tiles.cuh"

namespace fst {

// The two designs of a launch, and the particles from which the wrapper's
// choice (design -1) is the tiled one: below, the first design (one thread
// a particle, its adds straight to the grids, which a memset zeroes first)
// ran faster, the tiled launch's four phases and three grid syncs its fixed
// cost.
constexpr int kP2GAtomic = 0, kP2GTiled = 1;
#ifndef FST_P2G_TILED_FROM
#define FST_P2G_TILED_FROM 262144
#endif
constexpr long long kP2GTiledFrom = FST_P2G_TILED_FROM;
constexpr int kP2GAtomicThreads = 256;
// Grid syncs a tiled launch makes (between the four phases).
constexpr int kP2GSyncs = 3;
// Targets a particle (3 x 3).
constexpr int kP2GTargets = 9;

// Phase stamps, for timing the phases (tools/tune_tiles_torch.py phases
// builds with -DFST_P2G_STAMPS): block 0 writes %globaltimer into slot
// words 0-3 at the start and after each grid sync, and every block its end
// into word 4 (the latest).  The shipped build has none.
#ifdef FST_P2G_STAMPS
__device__ __forceinline__ unsigned long long p2g_clock() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}
#define FST_P2G_STAMP(words, i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) (words)[i] = p2g_clock()
#define FST_P2G_STAMP_END(words) \
  __syncthreads();               \
  if (threadIdx.x == 0) atomicMax((words) + 4, p2g_clock())
#else
#define FST_P2G_STAMP(words, i)
#define FST_P2G_STAMP_END(words)
#endif

// The most tiles whose counts a block keeps in shared memory (phases 1-2).
constexpr int kP2GSharedTiles = 12288;

// What a P2G grid query reports (mirrored by kernels/_common.py
// P2GLaunch): the design, the blocks of the launch, threads a block, the
// tile, particles a chunk, dynamic shared memory a block, the grid syncs of
// a launch and the int32 words of scratch it needs (the atomic design:
// blocks for one thread a particle, no tile, chunk, shared memory, sync or
// scratch).
struct P2GLaunch {
  int design, grid, threads, tile_x, tile_y, chunk, smem_bytes, grid_syncs;
  long long scratch_ints;
};

// The tiling of a (gy, gx) grid.
struct P2GTiling {
  int gx, gy;            // nodes along x and y
  int tile_x, tile_y;    // cells (shifted base nodes) a tile
  int tiles_x, tiles;
  int chunk;             // particles a chunk
};

__host__ __device__ inline P2GTiling p2g_tiling(int gx, int gy, int tile_x,
                                                int tile_y, int chunk) {
  P2GTiling t;
  t.gx = gx;
  t.gy = gy;
  t.tile_x = tile_x;
  t.tile_y = tile_y;
  t.tiles_x = (gx + 2 + tile_x - 1) / tile_x;
  t.tiles = t.tiles_x * ((gy + 2 + tile_y - 1) / tile_y);
  t.chunk = chunk;
  return t;
}

// The tile of shifted base node (sx, sy).
__device__ __forceinline__ int p2g_tile(const P2GTiling& t, int sx, int sy) {
  return (sy / t.tile_y) * t.tiles_x + sx / t.tile_x;
}

// The int32 scratch of a launch, in words: [0] the chunks of the launch,
// [1] the most particles in one tile; the tiles' counts (0 between
// launches); their first entries (tiles + 1); their first chunks (tiles);
// each particle's (tile, rank), tile -1 for none; the index array; the
// chunks (tile, first entry, particles, unused), at most tiles + ceil(np /
// chunk).
struct P2GLayout {
  long long counts, offsets, first_chunk, keys, idx, chunks, total;
};

__host__ __device__ inline P2GLayout p2g_layout(long long np, int tiles,
                                                int chunk) {
  P2GLayout l;
  l.counts = 4;
  l.offsets = l.counts + tiles;
  l.first_chunk = l.offsets + tiles + 1;
  l.keys = (l.first_chunk + tiles + 1) & ~1ll;      // int2, 8-byte aligned
  l.idx = l.keys + 2 * np;
  l.chunks = (l.idx + np + 3) & ~3ll;               // int4, 16-byte aligned
  l.total = l.chunks + 4 * (tiles + (np + chunk - 1) / chunk);
  return l;
}

// A particle's 9 targets as the solver's `scatter` forms them: the node
// (the same for all particles of one base cell), whether it lies inside
// the grid (MPM drops the others), whether this particle adds there (FLIP:
// wt > 0), and the three values.
template <typename T>
struct P2GTargets {
  int node[kP2GTargets];
  bool inside[kP2GTargets];
  bool use[kP2GTargets];
  T v[kP2GTargets][3];
};

// What a launch reads and writes beside the solver's particles (`part`: a
// struct of the solver's with its inputs and constants, `shifted_base`,
// `tile_of`, `stage` and `scatter`).
template <typename T, typename Part>
struct P2GArgs {
  Part part;
  T* mass;       // (gy, gx) each, zeroed by the launch
  T* mom_x;
  T* mom_y;
  int* scratch;  // p2g_layout(np, tiles, chunk).total words
  unsigned long long* words;  // kTileWords; the last takes the sync count
  int np;
  P2GTiling t;
};

// Exclusive scan of a[0, n) in shared memory, in place, by the block:
// each thread a strip of consecutive entries.  Called by every thread.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
  unsigned long long sum = 0, total;
  for (int i = i0; i < i1; ++i) sum += (unsigned)a[i];
  unsigned long long before = block_scan(sum, &total) - sum;
  for (int i = i0; i < i1; ++i) {
    const int v = a[i];
    a[i] = (int)before;
    before += (unsigned)v;
  }
  __syncthreads();
}

// Phase 2, block 0: each tile's first entry and first chunk from its count
// (read from `src`: the counts, or their copy in shared memory), the counts
// set back to 0, the launch's chunks and the most particles a tile into
// scratch words 0 and 1.
__device__ __forceinline__ void p2g_scan(const P2GTiling& t, const int* src,
                                         int* stats, int* counts,
                                         int* offsets, int* first_chunk) {
  const int C = t.chunk;
  // each thread a strip of consecutive tiles; (particles << 32) | chunks
  const int per = (t.tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = min((int)threadIdx.x * per, t.tiles);
  const int t1 = min(t0 + per, t.tiles);
  const auto packed = [C](int n) {
    return ((unsigned long long)n << 32) | (unsigned)((n + C - 1) / C);
  };
  unsigned long long sum = 0;
  int most = 0;
  for (int tl = t0; tl < t1; ++tl) {
    const int n = src[tl];
    sum += packed(n);
    most = max(most, n);
  }
  unsigned long long total;
  unsigned long long before = block_scan(sum, &total) - sum;
  for (int tl = t0; tl < t1; ++tl) {
    const int n = src[tl];  // before the count is cleared: src may be counts
    offsets[tl] = (int)(before >> 32);
    first_chunk[tl] = (int)(before & 0xffffffffu);
    counts[tl] = 0;
    before += packed(n);
  }
  for (int o = 16; o > 0; o >>= 1)
    most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  if (threadIdx.x == 0) {
    offsets[t.tiles] = (int)(total >> 32);
    stats[0] = (int)(total & 0xffffffffu);
    stats[1] = 0;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMax(stats + 1, most);
}

// The run of `lane` among a warp's lanes ordered by key (lanes with one key
// adjacent): its first lane, and one past its last.
__device__ __forceinline__ void lane_run(int key, int lane, int* first,
                                         int* end) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || key != prev);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0 .. lane
  *first = 31 - __clz(heads & upto);
  const unsigned later = heads & ~upto;
  *end = later ? __ffs(later) - 1 : 32;
}

template <typename T, typename Part, int Threads>
__global__ void __launch_bounds__(Threads)
p2g_tiled_kernel(P2GArgs<T, Part> a) {
  CountedGrid grid = counted_grid();
  FST_P2G_STAMP(a.words, 0);
  extern __shared__ __align__(16) unsigned char fst_smem[];
  const P2GTiling& t = a.t;
  const P2GLayout L = p2g_layout(a.np, t.tiles, t.chunk);
  int* const stats = a.scratch;
  int* const counts = a.scratch + L.counts;
  int* const offsets = a.scratch + L.offsets;
  int* const first_chunk = a.scratch + L.first_chunk;
  int2* const keys = reinterpret_cast<int2*>(a.scratch + L.keys);
  int* const idx = a.scratch + L.idx;
  int4* const chunks = reinterpret_cast<int4*>(a.scratch + L.chunks);
  int* const shared_ints = reinterpret_cast<int*>(fst_smem);
  const bool few_tiles = t.tiles <= kP2GSharedTiles;
  const long long np = a.np;
  const long long nodes = (long long)t.gx * t.gy;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. zero the grids; each particle's (tile, rank)
  for (long long c = tid; c < nodes; c += stride) {
    a.mass[c] = T(0);
    a.mom_x[c] = T(0);
    a.mom_y[c] = T(0);
  }
  if (few_tiles) {
    // the block's particles counted a tile in shared memory, then each
    // count added to the tile's once
    int* const hist = shared_ints;
    const long long per = (np + gridDim.x - 1) / gridDim.x;
    const long long k0 = min(np, per * blockIdx.x), k1 = min(np, k0 + per);
    for (int i = threadIdx.x; i < t.tiles; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
      const int tile = a.part.tile_of(k, t);
      keys[k] = make_int2(tile, tile >= 0 ? atomicAdd(hist + tile, 1) : 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < t.tiles; i += blockDim.x) {
      const int h = hist[i];
      if (h) hist[i] = atomicAdd(counts + i, h);
    }
    __syncthreads();
    for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
      const int2 key = keys[k];
      if (key.x >= 0) keys[k].y = key.y + hist[key.x];
    }
  } else {
    for (long long w0 = tid - lane; w0 < np; w0 += stride) {
      const long long k = w0 + lane;
      const int tile = k < np ? a.part.tile_of(k, t) : -1;
      int first, end;
      lane_run(tile, lane, &first, &end);
      int rank = 0;
      if (lane == first && tile >= 0)
        rank = atomicAdd(counts + tile, end - first);
      rank = __shfl_sync(0xffffffffu, rank, first) + lane - first;
      if (k < np) keys[k] = make_int2(tile, rank);
    }
  }
  grid.sync();
  FST_P2G_STAMP(a.words, 1);

  // 2. the tiles' first entries and chunks
  if (blockIdx.x == 0) {
    const int* src = counts;
    if (few_tiles) {
#pragma unroll 4
      for (int i = threadIdx.x; i < t.tiles; i += blockDim.x)
        shared_ints[i] = counts[i];
      __syncthreads();
      src = shared_ints;
    }
    p2g_scan(t, src, stats, counts, offsets, first_chunk);
  }
  grid.sync();
  FST_P2G_STAMP(a.words, 2);

  // 3. the index array, particles grouped by tile; the chunks, a block a
  // tile
  for (long long k = tid; k < np; k += stride) {
    const int2 key = keys[k];
    if (key.x >= 0) idx[offsets[key.x] + key.y] = (int)k;
  }
  for (int tl = blockIdx.x; tl < t.tiles; tl += gridDim.x) {
    const int first = offsets[tl], n = offsets[tl + 1] - first;
    for (int j = threadIdx.x; j * t.chunk < n; j += blockDim.x)
      chunks[first_chunk[tl] + j] = make_int4(
          tl, first + j * t.chunk, min(t.chunk, n - j * t.chunk), 0);
  }
  grid.sync();
  FST_P2G_STAMP(a.words, 3);

  // 4. each chunk: staged, sorted by base cell, summed by runs of a cell
  const int C = t.chunk, cells = t.tile_x * t.tile_y;
  T* const stage = reinterpret_cast<T*>(fst_smem);  // Part::kFields x C
  int* const start = reinterpret_cast<int*>(stage + Part::kFields * C);
  int* const key = start + cells;  // a staged particle's cell in the tile
  int* const rank = key + C;       // its rank among the cell's particles
  int* const order = rank + C;     // the staged particle at a sorted place
  int* const cell = order + C;     // the cell at a sorted place
  const int nchunks = stats[0];
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int4 ch = chunks[c];
    const int ty = ch.x / t.tiles_x, tx = ch.x - ty * t.tiles_x;
    const int sx0 = tx * t.tile_x, sy0 = ty * t.tile_y;
    const int m = ch.z;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) start[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      a.part.stage(idx[ch.y + i], stage + i, C);
      int sx, sy;
      a.part.shifted_base(stage[i], stage[C + i], sx, sy);
      const int lc = (sy - sy0) * t.tile_x + (sx - sx0);
      key[i] = lc;
      rank[i] = atomicAdd(start + lc, 1);
    }
    __syncthreads();
    block_exclusive_scan(start, cells);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int at = start[key[i]] + rank[i];
      order[at] = i;
      cell[at] = key[i];
    }
    __syncthreads();
    for (int s0 = warp * 32; s0 < m; s0 += blockDim.x) {
      const int at = s0 + lane;
      const bool valid = at < m;
      int first, end;
      lane_run(valid ? cell[at] : -1, lane, &first, &end);
      const int most = __reduce_max_sync(0xffffffffu, end - first);
      const int steps = most > 1 ? 32 - __clz(most - 1) : 0;
      const unsigned run = (end == 32 ? 0xffffffffu : (1u << end) - 1u) &
                           ~((1u << first) - 1u);
      P2GTargets<T> q;
      a.part.scatter(stage + (valid ? order[at] : 0), C, q);
      unsigned adds = 0;  // the targets this lane's run adds to
#pragma unroll
      for (int j = 0; j < kP2GTargets; ++j) {
        const bool u = valid && q.inside[j] && q.use[j];
        if (!u) q.v[j][0] = q.v[j][1] = q.v[j][2] = T(0);
        if (__ballot_sync(0xffffffffu, u) & run) adds |= 1u << j;
      }
      // the run's sums by a segmented scan: its last lane holds them
      const unsigned any = __reduce_or_sync(0xffffffffu, adds);
      for (int k = 0, d = 1; k < steps; ++k, d <<= 1) {
        const bool take = lane - d >= first;
#pragma unroll
        for (int j = 0; j < kP2GTargets; ++j) {
          if (!(any & (1u << j))) continue;  // the same for the warp
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const T u = __shfl_up_sync(0xffffffffu, q.v[j][f], d);
            if (take) q.v[j][f] += u;
          }
        }
      }
      if (lane == end - 1) {
#pragma unroll
        for (int j = 0; j < kP2GTargets; ++j) {
          if (!(adds & (1u << j))) continue;
          atomicAdd(a.mass + q.node[j], q.v[j][0]);
          atomicAdd(a.mom_x + q.node[j], q.v[j][1]);
          atomicAdd(a.mom_y + q.node[j], q.v[j][2]);
        }
      }
    }
    __syncthreads();
  }
  FST_P2G_STAMP_END(a.words);
  grid.write_syncs(a.words);
}

// The first design: one thread a particle, its `stage`d fields and
// `scatter`ed targets in registers, each add straight to the grids (zeroed
// by the caller).  Writes 0 grid syncs into words.
template <typename T, typename Part>
__global__ void __launch_bounds__(kP2GAtomicThreads)
p2g_atomic_kernel(P2GArgs<T, Part> a) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) a.words[kSyncCountWord] = 0ull;
  if (k >= a.np) return;
  T s[Part::kFields];
  a.part.stage((int)k, s, 1);
  P2GTargets<T> q;
  a.part.scatter(s, 1, q);
#pragma unroll
  for (int j = 0; j < kP2GTargets; ++j) {
    if (!(q.inside[j] && q.use[j])) continue;
    atomicAdd(a.mass + q.node[j], q.v[j][0]);
    atomicAdd(a.mom_x + q.node[j], q.v[j][1]);
    atomicAdd(a.mom_y + q.node[j], q.v[j][2]);
  }
}

// The design of a launch for np particles: `design` where it names one,
// else (-1) the tiled one from kP2GTiledFrom particles.
inline int p2g_design(long long np, int design) {
  return design >= 0 ? design : (np >= kP2GTiledFrom ? kP2GTiled
                                                     : kP2GAtomic);
}

// The shape of a launch of `design` for np particles on a (gy, gx) grid
// with `fields` values a particle staged: the tiling, and in *out the
// design, threads, tile, chunk, dynamic shared memory (the staged chunk
// and its sort's arrays, or the tile counts of phases 1-2 where larger),
// grid syncs and scratch words (grid left 0 for the tiled design).
// cudaErrorInvalidValue for a shape it does not take.
template <typename T>
int p2g_shape(long long np, int gx, int gy, int design, int tile_x,
              int tile_y, int chunk, int threads, int fields, P2GLaunch* out,
              P2GTiling* tiling) {
  design = p2g_design(np, design);
  if (np < 1 || np > (1ll << 30) || gx < 1 || gy < 1 ||
      (long long)gx * gy > (1ll << 30) || tile_x < 1 || tile_y < 1 ||
      chunk < 32 || chunk % 32 != 0 || !threads_ok(threads, 1024) ||
      (design != kP2GAtomic && design != kP2GTiled))
    return (int)cudaErrorInvalidValue;
  *tiling = p2g_tiling(gx, gy, tile_x, tile_y, chunk);
  if (design == kP2GAtomic) {
    const long long blocks =
        (np + kP2GAtomicThreads - 1) / kP2GAtomicThreads;
    *out = {kP2GAtomic, (int)blocks, kP2GAtomicThreads, 0, 0, 0, 0, 0, 0};
    return 0;
  }
  const size_t sort = (size_t)fields * chunk * sizeof(T) +
                      (size_t)(tile_x * tile_y + 4 * chunk) * sizeof(int);
  const size_t counts = tiling->tiles <= kP2GSharedTiles
                            ? (size_t)tiling->tiles * sizeof(int)
                            : 0;
  const size_t smem = sort > counts ? sort : counts;
  *out = {kP2GTiled, 0,         threads, tile_x, tile_y,
          chunk,     (int)smem, kP2GSyncs,
          p2g_layout(np, tiling->tiles, chunk).total};
  return 0;
}

// p2g_shape, and for the tiled design the blocks of a cooperative launch of
// `kernel` (p2g_tiled_kernel) in out->grid: one a chunk at most, capped at
// the blocks that can be resident at once.
template <typename T, typename Kernel>
int p2g_query(Kernel kernel, long long np, int gx, int gy, int design,
              int tile_x, int tile_y, int chunk, int threads, int fields,
              int device, P2GLaunch* out) {
  P2GTiling t;
  const int err = p2g_shape<T>(np, gx, gy, design, tile_x, tile_y, chunk,
                               threads, fields, out, &t);
  if (err != 0 || out->design == kP2GAtomic) return err;
  const long long want = t.tiles + (np + chunk - 1) / chunk;
  return cooperative_blocks(kernel, want, device, &out->grid,
                            (size_t)out->smem_bytes, threads);
}

// Launches `args` as `l` says on `device`'s `stream`: the atomic design a
// memset of the grids (one where they lie one after another, as the
// wrappers hand them) and a plain launch, the tiled one a cooperative
// launch of `tiled` on `grid` blocks.  Returns the CUDA error code.
template <typename T, typename Part, typename Kernel>
int p2g_launch(Kernel tiled, const P2GArgs<T, Part>& args,
               const P2GLaunch& l, int grid, int device, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    if (l.design == kP2GTiled)
      return launch_cooperative_on(tiled, args, grid, device, stream,
                                   (size_t)l.smem_bytes, l.threads);
    cudaError_t err = cudaSetDevice(device);
    const size_t bytes = (size_t)args.t.gx * args.t.gy * sizeof(T);
    const cudaStream_t st = (cudaStream_t)stream;
    if (args.mom_x == args.mass + (size_t)args.t.gx * args.t.gy &&
        args.mom_y == args.mom_x + (size_t)args.t.gx * args.t.gy) {
      if (err == cudaSuccess)
        err = cudaMemsetAsync(args.mass, 0, 3 * bytes, st);
    } else {
      T* const grids[3] = {args.mass, args.mom_x, args.mom_y};
      for (T* g : grids)
        if (err == cudaSuccess) err = cudaMemsetAsync(g, 0, bytes, st);
    }
    if (err != cudaSuccess) return (int)err;
    p2g_atomic_kernel<T, Part><<<(unsigned)grid, kP2GAtomicThreads, 0,
                                 st>>>(args);
    return (int)cudaGetLastError();
  });
}

}  // namespace fst
