// What the tiled kernels share (burgers_multistep.cu,
// shallow_water_multistep.cu, mhd_multistep.cu, stam2d_lin_solve.cu,
// flip_grid.cu, cooperative; lbm_multistep.cu, a plain launch): the
// Burgers and shallow-water kernels' tile, the launch report of a grid
// query (TileLaunch), a grid group that counts its syncs, a tile's window
// of a grid in shared memory (wrapped or clamped at the edges), loops
// that spread a rectangle of the window over the block's threads, and a
// scan over a block's threads (block_scan: the P2Gs' and the SPH bin's,
// p2g_tiles.cuh and sph_bin.cu).
//
// A tile of tile_x x tile_y cells with a halo of `halo` cells has a window
// of (tile_x + 2 halo) x (tile_y + 2 halo) cells, row-major with row
// stride wx; window cell (ly, lx) is grid cell (oy + ly, ox + lx), wrapped
// with wrap1 (grid_reduce.cuh) on a periodic grid.  Consecutive threads
// take consecutive cells of a row, so loads from device memory are
// coalesced along rows.
#pragma once

#include "grid_reduce.cuh"

namespace fst {

// The Burgers and shallow-water K-step tile kernels run blocks of
// kStepThreads (256) threads, or of kTileThreadsWide (512) when the grid
// then still gives every tile a block of its own (few tiles, as at 512^2:
// a block runs one tile a step, and twice the threads halve the dependent
// work a thread does between barriers).  With many tiles (4096^2) the
// narrower blocks, more of them an SM, ran faster.  Blocks of
// kTileThreadsWide an SM should hold (the
// second argument of the kernels' __launch_bounds__, which caps their
// registers at 65536 / (512 x value), as for 2x as many 256-thread
// blocks): 2 for float (64 registers), 1 for double (128).  Left to
// itself ptxas gave float ~100 registers and ran slower.
constexpr int kTileThreadsWide = 512;

template <typename T>
struct TileBlocksPerSM {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

// The Burgers and shallow-water K-step kernels' tile, kTileX x kTileY
// cells, clipped to the grid (tile_of).  One value for float and double:
// the sweep of tools/tune_tiles_torch.py, which builds variants with
// -DFST_TILE_X=... -DFST_TILE_Y=..., found no tile more than 4% faster at
// the main runs' shapes (PERF.md), and 64 x 16 and 64 x 32 slower at
// 4096^2.
#ifndef FST_TILE_X
#define FST_TILE_X 32
#endif
#ifndef FST_TILE_Y
#define FST_TILE_Y 32
#endif
constexpr int kTileX = FST_TILE_X;
constexpr int kTileY = FST_TILE_Y;

// The word of a tiled kernel's slot array after the grid-max slots: the
// grid syncs the launch made, written by its first thread at the end
// (kernels/_common.py reads it back: grid_syncs).
constexpr int kSyncCountWord = 2 * kMaxSlots;
constexpr int kTileWords = kSyncCountWord + 1;

// What a tiled kernel's grid query reports (mirrored by kernels/_common.py
// TileLaunch): the blocks of the cooperative launch and threads a block,
// the tile clipped to the grid, the halo, and the dynamic shared memory a
// block, all as the launch computes them.
struct TileLaunch {
  int grid, threads, tile_x, tile_y, halo, smem_bytes;
};

// The grid group of a tiled kernel, counting its syncs; every thread makes
// the same syncs, and the first writes the count to
// slots[kSyncCountWord] at the end (write_syncs).
struct CountedGrid {
  cg::grid_group group;
  int syncs;
  __device__ __forceinline__ void sync() {
    group.sync();
    ++syncs;
  }
  __device__ __forceinline__ void write_syncs(
      unsigned long long* slots) const {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      slots[kSyncCountWord] = (unsigned long long)syncs;
  }
};

__device__ __forceinline__ CountedGrid counted_grid() {
  return {cg::this_grid(), 0};
}

// n clipped to tile: the tile's extent along an axis of n cells.
__host__ __device__ __forceinline__ int tile_of(int tile, int n) {
  return tile < n ? tile : n;
}

struct Window {
  int ox, oy, wx, wy, halo;
};

// The grid and threads a block of a K-step tile kernel's cooperative
// launch over `tiles` tiles with `smem` bytes of shared memory a block:
// kTileThreadsWide threads if every tile then gets its own resident block,
// else kStepThreads; into out->grid and out->threads.  Returns the CUDA
// error code.
template <typename Kernel>
int tile_grid(Kernel kernel, long long tiles, size_t smem, int device,
              TileLaunch* out) {
  int wide = 0;
  int err = cooperative_blocks(kernel, tiles, device, &wide, smem,
                               kTileThreadsWide);
  if (err != 0) return err;
  if (wide >= tiles) {
    out->grid = wide;
    out->threads = kTileThreadsWide;
    return 0;
  }
  out->threads = kStepThreads;
  return cooperative_blocks(kernel, tiles, device, &out->grid, smem,
                            kStepThreads);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory a block: above
// 48 KB the kernel's limit is raised to `smem`, once a device (`raised`:
// the caller's flags for this kernel).  Returns the CUDA error code.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, int device,
               bool (&raised)[kMaxDevices]) {
  const bool known = device >= 0 && device < kMaxDevices;
  if (smem <= 48 * 1024 || (known && raised[device])) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && known) raised[device] = true;
  return (int)err;
}

// A launch's threads a block, as tile_grid or a kernel's own constant gave
// them: a whole number of warps, at most `most`.
inline bool threads_ok(int threads, int most) {
  return threads >= 32 && threads % 32 == 0 && threads <= most;
}

// Runs launch() (which makes `device` current) and makes the caller's
// current device current again, so that a wrapper needs no device context
// around the call.  Returns launch()'s error code.
template <typename F>
int on_device(int device, F launch) {
  int prev = -1;
  if (cudaGetDevice(&prev) != cudaSuccess) {
    cudaGetLastError();
    prev = -1;
  }
  const int err = launch();
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return err;
}

// The window of tile `tile` (row-major over tiles_x tiles a row).
__device__ __forceinline__ Window window_of(int tile, int tiles_x,
                                            int tile_x, int tile_y,
                                            int halo) {
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  return {tx * tile_x - halo, ty * tile_y - halo, tile_x + 2 * halo,
          tile_y + 2 * halo, halo};
}

// Calls f(ly, lx, c) for every window cell of rows [y0, y1) and columns
// [x0, x1), c = ly * wx + lx, spread over the block's threads.
// A thread walks cells blockDim.x apart in row-major order, stepping its
// (row, column) by (blockDim.x / w, blockDim.x % w) with one carry: two
// divisions a call, none a cell.
template <typename F>
__device__ __forceinline__ void for_region(int y0, int y1, int x0, int x1,
                                           int wx, F f) {
  const int w = x1 - x0, cells = (y1 - y0) * w;
  if (cells <= 0) return;
  const int sy = (int)blockDim.x / w, sx = (int)blockDim.x - sy * w;
  int ry = (int)threadIdx.x / w, rx = (int)threadIdx.x - ry * w;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int ly = y0 + ry, lx = x0 + rx;
    f(ly, lx, ly * wx + lx);
    rx += sx;
    ry += sy;
    if (rx >= w) {
      rx -= w;
      ++ry;
    }
  }
}

// Loads NF fields over a window of wy x wx cells into shared memory:
// s[f][c] = g[f][index(ly, lx)] for window cell c = ly * wx + lx, or 0
// where index gives -1.  (Batches of loads in flight a thread measured
// slower: the registers they hold cost the tile kernels more than the
// latency they hide; tools/tune_tiles_torch.py, PERF.md.)
template <int NF, typename T, typename Index>
__device__ __forceinline__ void load_window(int wy, int wx, Index index,
                                            const T* const (&g)[NF],
                                            T* const (&s)[NF]) {
  for_region(0, wy, 0, wx, wx, [&](int ly, int lx, int c) {
    const long long gi = index(ly, lx);
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f][c] = gi >= 0 ? g[f][gi] : T(0);
  });
}

// load_window on a periodic ny x nx grid: window cell (ly, lx) is grid
// cell (oy + ly, ox + lx), wrapped.
template <int NF, typename T>
__device__ __forceinline__ void load_periodic(const Window& w, int ny,
                                              int nx,
                                              const T* const (&g)[NF],
                                              T* const (&s)[NF]) {
  if (w.ox >= 0 && w.ox + w.wx <= nx && w.oy >= 0 && w.oy + w.wy <= ny) {
    // the window lies inside the grid: no wrap
    const long long o = (long long)w.oy * nx + w.ox;
    load_window<NF>(w.wy, w.wx, [&](int ly, int lx) {
      return o + (long long)ly * nx + lx;
    }, g, s);
    return;
  }
  load_window<NF>(w.wy, w.wx, [&](int ly, int lx) {
    return (long long)wrap1(w.oy + ly, ny) * nx + wrap1(w.ox + lx, nx);
  }, g, s);
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024); *total gets the block's sum.  Called by every thread of the block.
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long v, unsigned long long* total) {
  __shared__ unsigned long long warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = lane < warps ? warp_sums[lane] : 0ull;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < warps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return v;
}

// i clamped to [0, n).
__device__ __forceinline__ int clamp1(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// load_window on an ny x nx grid with edge-copy boundaries, NF fields g[f]
// into s + f * stride: window cell (ly, lx) holds grid cell
// (clamp1(oy + ly, ny), clamp1(ox + lx, nx)), as shift_clamped reads past
// the edge.
template <int NF, typename T>
__device__ __forceinline__ void load_clamped(const Window& w, int ny,
                                             int nx, const T* const* g,
                                             T* s, int stride) {
  for_region(0, w.wy, 0, w.wx, w.wx, [&](int ly, int lx, int c) {
    const long long gi =
        (long long)clamp1(w.oy + ly, ny) * nx + clamp1(w.ox + lx, nx);
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f * stride + c] = g[f][gi];
  });
}

// Folds every thread's LocalMax (grid_reduce.cuh) into slot `slot` (two
// words: bits, NaN flag), the block's warps folded in shared memory first:
// one atomicMax (and at most one NaN flag) a block.  The max of
// non-negative values is exact in any order.  Called by every
// thread of the block; calls are a grid sync (hence a block barrier)
// apart.
template <typename T>
__device__ __forceinline__ void block_max_add(unsigned long long* slots,
                                              int slot, LocalMax<T> lm) {
  __shared__ T wmax[32];
  __shared__ bool wnan[32];
  T v = lm.m;
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const bool nan = __any_sync(0xffffffffu, lm.nan);
  if ((threadIdx.x & 31) == 0) {
    wmax[threadIdx.x >> 5] = v;
    wnan[threadIdx.x >> 5] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T m = wmax[0];
    bool any = wnan[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      m = fmax(m, wmax[w]);
      any = any || wnan[w];
    }
    atomicMax(slots + 2 * slot, to_bits(m));
    if (any) atomicExch(slots + 2 * slot + 1, 1ull);
  }
}

// The max of slot `slot` (NaN if its flag is set), as one 16-byte load of
// the slot's two words from L2, after the grid sync that ends its step's
// adds.
template <typename T>
__device__ __forceinline__ T slot_max_read(const unsigned long long* slots,
                                           int slot) {
  const ulonglong2 v =
      __ldcg(reinterpret_cast<const ulonglong2*>(slots + 2 * slot));
  return v.y ? T(NAN) : from_bits<T>(v.x);
}

// The index in the ny x nx grid of window cell (ly, lx) of a tile, or -1
// past the grid's edge (a ragged last tile): only such cells are written.
__device__ __forceinline__ long long owned_index(const Window& w, int ly,
                                                 int lx, int ny, int nx) {
  const int gy = w.oy + ly, gx = w.ox + lx;
  if (gy >= ny || gx >= nx) return -1;
  return (long long)gy * nx + gx;
}

}  // namespace fst
