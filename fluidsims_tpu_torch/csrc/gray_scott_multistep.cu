// K Gray–Scott steps per launch by temporal blocking in shared memory,
// periodic in x and y, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/gray_scott_pallas.py::
// _ms_kernel (pallas_call at :203), which loads a row band with K wrapped
// ghost rows and 64 wrapped ghost columns into VMEM, steps it K times with
// pltpu.roll (the garbage from the slab edge creeps one cell inward a
// step) and writes the band's interior.  Here the same ghost creep runs on
// tiles: a block loads a tile and a halo of K (its window, wrapped by index
// arithmetic, so a window may be wider than the grid), steps it K times in
// shared memory, step s computing the cells at least s from the window's
// edge (the region whose neighbours are still valid), and writes the
// tile's cells that lie inside the grid.  gs_cell (gray_scott.cuh) is the
// one-step kernel's arithmetic, so a launch is bitwise equal to K launches
// of gray_scott_step.cu and to K plain steps.
//
// What bounded the first design (0.3236 ms of device time a K=16 launch
// at 2048^2 f32, 12x its bound; 1.0962 ms a launch f64, slower than 16
// one-step launches): two copies of u and v ping-ponged on 64^2 (f32) and
// 32^2 (f64) tiles, so 1.54x and 2.24x the useful cell-steps in the halos;
// 10 shared-memory loads and 2 stores a cell-step (48 B at f32); a fixed
// 32x32 stride over the shrinking region, 69% of the passes doing work.
//
// The design.
//   * Items.  An item is a strip of Design<T>::rows rows by one 16-byte
//     vector of columns (4 floats, 2 doubles), and step s maps its items
//     over the region [s, S - s)^2 alone, band-major, so the threads idle
//     only where the region has fewer items than the block.  A strip is
//     loaded as rows + 2 vector loads a field; up and down neighbours come
//     from the thread's registers, left and right from the adjacent lanes
//     by __shfl_up/down_sync, and a lane whose neighbour is in another
//     warp or band reads shared memory.  A cell-step costs ~1.3-1.5
//     vector-lane loads, 1 store and 0.5 (f32) or 1 (f64) shuffles a
//     field, against the first design's 6 scalar loads and 1 store.  An
//     item's columns are rounded out to whole vectors, so a cell nearer
//     the edge than s may be written with garbage: no later step reads
//     it (the trapezoid: the cells of step s read only cells at least
//     s - 1 from the edge, which step s - 1 wrote last).
//   * Copies (Design<T>::copies).  f64: ONE copy of u and v, stepped in
//     place: in step s every thread forms its item's new values into
//     registers; a barrier; it stores them; a barrier.  Half the shared
//     memory of two copies holds twice the tile area (a 57^2 tile at
//     K=16, not 32^2), and the step-1 items may not outnumber the threads.
//     f32: two copies ping-ponged, each row stored into the other copy as
//     it is formed, a thread walking as many items as the step has, one
//     barrier a step; no new values held, so 1024 threads fit where one
//     copy allows 512 (measured: the notes at Design).
//   * The tile.  The window's two fields (each copy) must fit kGsSmem, and
//     in place the step-1 items must not outnumber the threads: at K=16 a
//     window of at most 114^2 (f32, 226 KB) or 90^2 (f64, 135 KB).  Among
//     the square tiles that fit, evened out over each axis of the grid,
//     the launch takes the one of least cost = waves x blocks an SM x work
//     of a tile (the cells its items compute over the K steps, plus its
//     load and store), the waves counted from the SMs and the occupancy
//     query: at 2048^2 K=16 an 82^2 tile f32 (625 tiles, 5 waves of 132)
//     and 57^2 f64 (1296, 10 waves); a small grid gets smaller tiles that
//     fill the card.  The grid query (fst_gs_multistep_shape_*) reports
//     the launch.
//
// What bounds it on an H100: the issue of the arithmetic.  27 operations
// a cell-step (no multiply-add contracted under -fmad=false: 1.81 G useful
// operations a K=16 launch at 2048^2, ~0.054 ms of f32 issue at the
// card's full rate), ~1.5x (f32) and ~1.6x (f64) of them in the halos and
// the rounded-out items, and the shared-memory traffic beside them; the
// bytes of one step (67 MB at 2048^2 f32, ~20 us) come second.  Measured
// 0.29 ms (f32) and 0.52 ms (f64) a launch: the warps of a block stall on
// the latency of the loads and shuffles and wait at the step's barriers
// (PERF.md).  1 <= K <= 32 (kernels/gray_scott_cuda.py MAX_BLOCK_K
// checks it before the launch).
#include <mutex>

#include "gray_scott.cuh"
#include "tiles.cuh"

namespace fst {

// What the grid query reports of a launch (mirrored by kernels/
// gray_scott_cuda.py GSLaunch): blocks, threads a block, the tile, the
// halo K, dynamic shared memory a block, the rows and columns of an item,
// the copies of the window, the blocks an SM the occupancy query allows,
// and the waves of the grid.
struct GSLaunch {
  int grid, threads, tile_x, tile_y, halo, smem_bytes, rows, cols, copies,
      blocks_per_sm, waves;
};

namespace {

// The design of each dtype (tools/tune_tiles_torch.py --set gs sweeps
// them; PERF.md): threads a block and the blocks an SM asked of
// __launch_bounds__ (which caps the registers at 65536 / (threads x
// blocks)), rows a strip, and copies of the window: 1, stepped in place
// (a thread holds its item's new values in registers until the barrier,
// so one item a thread and 128 registers at 512 threads); 2, ping-ponged
// (an item's rows stored into the other copy as they are formed, a thread
// walking as many items as the step has, one barrier a step).  f32: two
// copies, 1024 threads, 4 rows (0.292 ms a K=16 launch at 2048^2 against
// 0.338 for one copy at 512 x 8, which 16 warps an SM could not keep
// busy); f64: one copy, 512 threads, 8 rows (0.524 against 0.569 for two
// copies at 1024 x 4: the larger tile's smaller halo weighs more at the
// f64 rate).  FST_GS_SMEM is the shared memory a block may use (at most
// 227 KB = 232,448 bytes).
#ifndef FST_GS_THREADS
#define FST_GS_THREADS 1024
#endif
#ifndef FST_GS_MIN_BLOCKS
#define FST_GS_MIN_BLOCKS 1
#endif
#ifndef FST_GS_ROWS
#define FST_GS_ROWS 4
#endif
#ifndef FST_GS_COPIES
#define FST_GS_COPIES 2
#endif
#ifndef FST_GS_F64_THREADS
#define FST_GS_F64_THREADS 512
#endif
#ifndef FST_GS_F64_MIN_BLOCKS
#define FST_GS_F64_MIN_BLOCKS 1
#endif
#ifndef FST_GS_F64_ROWS
#define FST_GS_F64_ROWS 8
#endif
#ifndef FST_GS_F64_COPIES
#define FST_GS_F64_COPIES 1
#endif
#ifndef FST_GS_SMEM
#define FST_GS_SMEM 232448
#endif

template <typename T>
struct Design;

template <>
struct Design<float> {
  static constexpr int threads = FST_GS_THREADS;
  static constexpr int min_blocks = FST_GS_MIN_BLOCKS;
  static constexpr int rows = FST_GS_ROWS;
  static constexpr int copies = FST_GS_COPIES;
};

template <>
struct Design<double> {
  static constexpr int threads = FST_GS_F64_THREADS;
  static constexpr int min_blocks = FST_GS_F64_MIN_BLOCKS;
  static constexpr int rows = FST_GS_F64_ROWS;
  static constexpr int copies = FST_GS_F64_COPIES;
};

template <typename T>
constexpr bool design_ok() {
  return Design<T>::threads % 32 == 0 && Design<T>::threads <= 1024 &&
         (Design<T>::copies == 1 || Design<T>::copies == 2) &&
         Design<T>::rows >= 1;
}
static_assert(design_ok<float>() && design_ok<double>(),
              "whole warps, one or two copies");

constexpr int kGsSmem = FST_GS_SMEM;
constexpr int kGsMaxK = 32;
constexpr int kGsMaxTile = 256;  // the largest side the tile rule tries

// Columns an item: one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
struct alignas(16) Group {
  T v[kVec<T>];
};

struct GsShape {
  int tile_x, tile_y, tiles_x, tiles_y, sx, sy, pitch, blocks_per_sm, waves;
  size_t smem;
};

// A window row: a guard vector, the sx cells rounded up to whole vectors,
// a guard vector (the guards hold what an item at the edge reads past
// the window; no cell that a later step reads depends on them).
template <typename T>
int pitch_of(int sx) {
  const int c = kVec<T>;
  return c + (sx + c - 1) / c * c + c;
}

template <typename T>
size_t smem_of(int sx, int sy) {
  return Design<T>::copies * 2 * (size_t)sy * pitch_of<T>(sx) * sizeof(T);
}

// The items of step s on an sx x sy window: bands of Design<T>::rows rows
// over [s, sy - s) times vectors of columns over [s, sx - s).
template <typename T>
int items_of(int sx, int sy, int s) {
  const int c = kVec<T>, rows = Design<T>::rows;
  if (sy - 2 * s <= 0 || sx - 2 * s <= 0) return 0;
  const int groups = (sx - s - 1) / c + 1 - s / c;
  return (sy - 2 * s + rows - 1) / rows * groups;
}

// The window's two fields (each copy) fit kGsSmem, and in place, no step
// has more items than the block has threads.
template <typename T>
bool fits(int sx, int sy, int k) {
  if (smem_of<T>(sx, sy) > (size_t)kGsSmem) return false;
  if (Design<T>::copies == 2) return true;
  for (int s = 1; s <= k; ++s)
    if (items_of<T>(sx, sy, s) > Design<T>::threads) return false;
  return true;
}

// The work of a tile: the cells its items compute over the k steps, plus
// its window's load (two fields) and its tile's store.
template <typename T>
double tile_work(const GsShape& c, int k) {
  double cells = 0;
  for (int s = 1; s <= k; ++s)
    cells += (double)items_of<T>(c.sx, c.sy, s) * Design<T>::rows * kVec<T>;
  return cells + 2.0 * c.sx * c.sy + (double)c.tile_x * c.tile_y;
}

// One axis of n cells cut into tiles of at most `most`: the tile evened
// out over the tiles it takes.
inline void even_tiles(int n, int most, int* tile, int* tiles) {
  *tiles = (n + most - 1) / most;
  *tile = (n + *tiles - 1) / *tiles;
}

template <typename T>
__device__ __forceinline__ void load_group(const T* p, T (&a)[kVec<T>]) {
  const Group<T> g = *reinterpret_cast<const Group<T>*>(p);
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) a[j] = g.v[j];
}

template <typename T>
__device__ __forceinline__ void store_group(T* p, const T (&a)[kVec<T>]) {
  Group<T> g;
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) g.v[j] = a[j];
  *reinterpret_cast<Group<T>*>(p) = g;
}

template <typename T>
__device__ __forceinline__ void copy_group(T (&to)[kVec<T>],
                                           const T (&from)[kVec<T>]) {
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) to[j] = from[j];
}

// Loads the sx x sy window whose cell (0, 0) is grid cell (oy, ox) into su
// and sv (row pitch `pitch`), wrapped: each thread kLoadBatch cells a
// block's threads apart at a time, their loads issued before their
// stores.
constexpr int kLoadBatch = 4;

template <typename T, bool kWrap>
__device__ __forceinline__ void load_window(const T* __restrict__ u,
                                            const T* __restrict__ v, T* su,
                                            T* sv, int ny, int nx, int oy,
                                            int ox, int sx, int sy,
                                            int pitch) {
  constexpr int kThreads = Design<T>::threads;
  const int cells = sx * sy;
  for (int i0 = threadIdx.x; i0 < cells; i0 += kLoadBatch * kThreads) {
    T a[kLoadBatch], b[kLoadBatch];
    int at[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * kThreads;
      at[j] = -1;
      if (i < cells) {
        const int ly = i / sx, lx = i - ly * sx;
        const size_t g =
            kWrap ? (size_t)wrap(oy + ly, ny) * nx + wrap(ox + lx, nx)
                  : (size_t)(oy + ly) * nx + (ox + lx);
        a[j] = __ldg(u + g);
        b[j] = __ldg(v + g);
        at[j] = ly * pitch + lx;
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      if (at[j] >= 0) {
        su[at[j]] = a[j];
        sv[at[j]] = b[j];
      }
    }
  }
}

// An item of step s: a strip of `rows` rows from window row y0 by one
// vector of columns from x0; whether the lanes beside it hold this band's
// columns left and right; a lane past the items takes the first item's
// place (its cells are formed, never stored).
struct Item {
  bool live, left_in_warp, right_in_warp;
  int y0, x0;
};

__device__ __forceinline__ Item item_of(int item, int items, int groups,
                                        int g0, int s, int c, int rows,
                                        int lane) {
  Item it;
  it.live = item < items;
  const int i = it.live ? item : 0;
  const int band = i / groups, gi = i - band * groups;
  it.y0 = s + band * rows;
  it.x0 = (g0 + gi) * c;
  it.left_in_warp = it.live && lane > 0 && gi > 0;
  it.right_in_warp = it.live && lane < 31 && gi + 1 < groups;
  return it;
}

// Forms the new values of an item's rows from the window (su, sv) and
// hands row r's to put(r, u_row, v_row), in row order.  Every lane of the
// warp calls it (the shuffles).
template <typename T, typename Put>
__device__ __forceinline__ void strip(const GSConst<T>& c, const T* su,
                                      const T* sv, int pitch, int sy,
                                      const Item& it, Put put) {
  constexpr int C = kVec<T>;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int R = Design<T>::rows;
  // row r of the strip (r in [-1, R]) clamped into the window
  auto at = [&](int r) {
    return min(max(it.y0 + r, 0), sy - 1) * pitch + it.x0;
  };
  T pu[C], pv[C], cu[C], cv[C];
  load_group(su + at(-1), pu);
  load_group(sv + at(-1), pv);
  load_group(su + at(0), cu);
  load_group(sv + at(0), cv);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T du[C], dv[C];
    load_group(su + at(r + 1), du);
    load_group(sv + at(r + 1), dv);
    T ul = __shfl_up_sync(kAll, cu[C - 1], 1);
    T vl = __shfl_up_sync(kAll, cv[C - 1], 1);
    T ur = __shfl_down_sync(kAll, cu[0], 1);
    T vr = __shfl_down_sync(kAll, cv[0], 1);
    if (!it.left_in_warp) {
      ul = su[at(r) - 1];
      vl = sv[at(r) - 1];
    }
    if (!it.right_in_warp) {
      ur = su[at(r) + C];
      vr = sv[at(r) + C];
    }
    T nu[C], nv[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      gs_cell(c, cu[j], j + 1 < C ? cu[j + 1] : ur, j > 0 ? cu[j - 1] : ul,
              du[j], pu[j], cv[j], j + 1 < C ? cv[j + 1] : vr,
              j > 0 ? cv[j - 1] : vl, dv[j], pv[j], &nu[j], &nv[j]);
    put(r, nu, nv);
    copy_group(pu, cu);
    copy_group(pv, cv);
    copy_group(cu, du);
    copy_group(cv, dv);
  }
}

template <typename T>
__global__ void __launch_bounds__(Design<T>::threads, Design<T>::min_blocks)
gs_multistep_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    T* __restrict__ u_out, T* __restrict__ v_out, int ny,
                    int nx, int k, int tile_x, int tile_y, int pitch,
                    GSConst<T> c) {
  constexpr int C = kVec<T>, R = Design<T>::rows;
  constexpr int kThreads = Design<T>::threads, kCopies = Design<T>::copies;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sx = tile_x + 2 * k, sy = tile_y + 2 * k;
  const size_t plane = (size_t)sy * pitch;
  // window cell (ly, lx) of the values of the last step at su[ly * pitch
  // + lx], sv likewise; with two copies the next step's go to nu_, nv_
  T* su = reinterpret_cast<T*>(smem) + C;
  T* sv = su + plane;
  T* nu_ = su + (kCopies - 1) * 2 * plane;
  T* nv_ = nu_ + plane;
  const int tx0 = blockIdx.x * tile_x, ty0 = blockIdx.y * tile_y;
  const int ox = tx0 - k, oy = ty0 - k;

  if (ox >= 0 && ox + sx <= nx && oy >= 0 && oy + sy <= ny)
    load_window<T, false>(u, v, su, sv, ny, nx, oy, ox, sx, sy, pitch);
  else  // the window wraps
    load_window<T, true>(u, v, su, sv, ny, nx, oy, ox, sx, sy, pitch);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp_first = threadIdx.x - lane;
  for (int s = 1; s <= k; ++s) {
    const int g0 = s / C, groups = (sx - s - 1) / C + 1 - g0;
    const int y_end = sy - s;  // the region's rows: [s, y_end)
    const int items = (y_end - s + R - 1) / R * groups;
    if constexpr (kCopies == 1) {
      // one item a thread (the tile rule sees to it): its new values
      // wait in registers for the barrier
      const Item it =
          item_of(threadIdx.x, items, groups, g0, s, C, R, lane);
      T nu[R][C], nv[R][C];
      if (warp_first < items)  // the whole warp: it shuffles
        strip(c, su, sv, pitch, sy, it, [&](int r, const T(&a)[C],
                                            const T(&b)[C]) {
          copy_group(nu[r], a);
          copy_group(nv[r], b);
        });
      __syncthreads();  // every old value of step s is read
      if (it.live) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (it.y0 + r >= y_end) break;
          store_group(su + (it.y0 + r) * pitch + it.x0, nu[r]);
          store_group(sv + (it.y0 + r) * pitch + it.x0, nv[r]);
        }
      }
    } else {
      // a warp's items a pass, each row stored into the other copy as it
      // is formed
      for (int base = warp_first; base < items; base += kThreads) {
        const Item it =
            item_of(base + lane, items, groups, g0, s, C, R, lane);
        strip(c, su, sv, pitch, sy, it, [&](int r, const T(&a)[C],
                                            const T(&b)[C]) {
          if (it.live && it.y0 + r < y_end) {
            store_group(nu_ + (it.y0 + r) * pitch + it.x0, a);
            store_group(nv_ + (it.y0 + r) * pitch + it.x0, b);
          }
        });
      }
      T* t = su;
      su = nu_;
      nu_ = t;
      t = sv;
      sv = nv_;
      nv_ = t;
    }
    __syncthreads();  // step s is written
  }

  // the tile's cells inside the grid (a ragged last tile stops at its edge)
  for_region(0, tile_y, 0, tile_x, tile_x, [&](int ly, int lx, int) {
    const int gy = ty0 + ly, gx = tx0 + lx;
    if (gy >= ny || gx >= nx) return;
    const int i = (ly + k) * pitch + lx + k;
    u_out[(size_t)gy * nx + gx] = su[i];
    v_out[(size_t)gy * nx + gx] = sv[i];
  });
}

// Lets the kernel take kGsSmem bytes of dynamic shared memory a block and
// asks for the largest shared-memory carveout, once a device.  Returns the
// CUDA error code.
template <typename T>
int prepare_kernel(int device) {
  static bool done[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device]) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      gs_multistep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs_multistep_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && known) done[device] = true;
  return (int)err;
}

// The tile rule (the notes above): every square side the window of which
// fits, evened out over each axis, the one of least cost kept (the larger
// on a tie).  Needs the device current and the kernel prepared.
template <typename T>
int choose_shape(int ny, int nx, int k, int device, GsShape* out) {
  if (ny < 1 || nx < 1 || k < 1 || k > kGsMaxK)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  double best = -1.0;
  int last_x = -1, last_y = -1;
  for (int side = kGsMaxTile; side >= 1; --side) {
    GsShape c{};
    even_tiles(nx, tile_of(side, nx), &c.tile_x, &c.tiles_x);
    even_tiles(ny, tile_of(side, ny), &c.tile_y, &c.tiles_y);
    if (c.tile_x == last_x && c.tile_y == last_y) continue;
    last_x = c.tile_x;
    last_y = c.tile_y;
    c.sx = c.tile_x + 2 * k;
    c.sy = c.tile_y + 2 * k;
    if (!fits<T>(c.sx, c.sy, k)) continue;
    c.pitch = pitch_of<T>(c.sx);
    c.smem = smem_of<T>(c.sx, c.sy);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gs_multistep_kernel<T>, Design<T>::threads, c.smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) continue;
    const long long tiles = (long long)c.tiles_x * c.tiles_y;
    const long long slots = (long long)sms * per_sm;
    c.blocks_per_sm = per_sm;
    c.waves = (int)((tiles + slots - 1) / slots);
    const double cost = (double)c.waves * per_sm * tile_work<T>(c, k);
    if (best < 0.0 || cost < best) {
      best = cost;
      *out = c;
    }
  }
  return best < 0.0 ? (int)cudaErrorInvalidValue : 0;
}

// choose_shape, kept for the last (ny, nx, k, device) of each dtype: a run
// launches one shape over and over.
template <typename T>
int shape_for(int ny, int nx, int k, int device, GsShape* out) {
  static std::mutex mu;
  static int key[4] = {-1, -1, -1, -1};
  static GsShape last{};
  std::lock_guard<std::mutex> lock(mu);
  if (key[0] == ny && key[1] == nx && key[2] == k && key[3] == device) {
    *out = last;
    return 0;
  }
  int err = prepare_kernel<T>(device);
  if (err == 0) err = choose_shape<T>(ny, nx, k, device, out);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  last = *out;
  key[0] = ny;
  key[1] = nx;
  key[2] = k;
  key[3] = device;
  return 0;
}

template <typename T>
int launch_gs_multistep(const T* u, const T* v, T* u_out, T* v_out,
                        const GSParams* p, int device, void* stream) {
  return on_device(device, [&] {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    GsShape s{};
    const int err = shape_for<T>(p->ny, p->nx, p->k, device, &s);
    if (err != 0) return err;
    const dim3 grid(s.tiles_x, s.tiles_y);
    gs_multistep_kernel<T><<<grid, Design<T>::threads, s.smem,
                             (cudaStream_t)stream>>>(
        u, v, u_out, v_out, p->ny, p->nx, p->k, s.tile_x, s.tile_y, s.pitch,
        gs_const<T>(*p));
    return (int)cudaGetLastError();
  });
}

template <typename T>
int gs_multistep_shape(int ny, int nx, int k, int device, GSLaunch* out) {
  return on_device(device, [&] {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    GsShape s{};
    const int err = shape_for<T>(ny, nx, k, device, &s);
    if (err != 0) return err;
    *out = {s.tiles_x * s.tiles_y, Design<T>::threads, s.tile_x, s.tile_y,
            k, (int)s.smem, Design<T>::rows, kVec<T>, Design<T>::copies,
            s.blocks_per_sm, s.waves};
    return 0;
  });
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_gs_multistep_f32(const float* u, const float* v, float* u_out,
                         float* v_out, const fst::GSParams* p, int device,
                         void* stream) {
  return fst::launch_gs_multistep<float>(u, v, u_out, v_out, p, device,
                                         stream);
}

int fst_gs_multistep_f64(const double* u, const double* v, double* u_out,
                         double* v_out, const fst::GSParams* p, int device,
                         void* stream) {
  return fst::launch_gs_multistep<double>(u, v, u_out, v_out, p, device,
                                          stream);
}

int fst_gs_multistep_shape_f32(int ny, int nx, int k, int device,
                               fst::GSLaunch* out) {
  return fst::gs_multistep_shape<float>(ny, nx, k, device, out);
}

int fst_gs_multistep_shape_f64(int ny, int nx, int k, int device,
                               fst::GSLaunch* out) {
  return fst::gs_multistep_shape<double>(ny, nx, k, device, out);
}

}  // extern "C"
