// K D2Q9 steps per launch by temporal blocking in shared memory, x
// periodic and y bounded, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/lbm_pallas.py::_ms_kernel
// (pallas_call at :259), which loads a 9-field row band with K wrapped
// ghost rows and 64 wrapped ghost columns into VMEM, steps it K times with
// pltpu.roll and writes the band's interior.  Its wrapped rows are right
// only because rows 0 and ny-1 are walls (lbm_pallas.py:24-30).  This
// kernel does not rely on that: rows outside [0, ny) are out of bounds, as
// in the plain version's `oob` rule, so a solid map without walls is
// stepped as solvers/lbm.py::step steps it.  1 <= K <= 16
// (kernels/lbm_cuda.py MAX_BLOCK_K checks it before the launch).
//
// What bounded the first design (0.70 ms a K=8 launch at 2048x1024 f32,
// 87 us a step against the one-step kernel's 67 us): two copies of the
// packets on a 32^2 tile (16^2 f64) with a halo of K, so 1.7x (2.5x)
// collisions a useful cell-step in the ghost creep; two barriers a step
// (collide in place, then pull); a load of flag[src] in each of the 9
// pulls of every cell-step; 168 KB of shared memory for one block of 512
// threads an SM.
//
// The design.  One block a tile of tile_x x tile_y cells, its window (the
// tile and a halo of K: sx x sy cells) in shared memory as ONE copy of
// the 9 packet planes, stepped in place:
//   * Streaming is a moving frame.  After the collision of step s (s = 0
//     .. K-1) the post-collision packet q of window cell c sits at
//     P[q][c - s d_q], d_q = ey_q sx + ex_q: the place it read its
//     pre-collision packet q from.  The pull of step s + 1 reads packet q
//     of cell c at P[q][c - (s + 1) d_q] (the upstream cell's post, where
//     the upstream cell wrote it), and a link that bounces (upstream cell
//     solid or outside [0, ny)) reads the cell's own post[OPP[q]] of step
//     s at P[OPP[q]][c + s d_q].  Each place is read and written by one
//     cell within a step (the upstream cell of a bounced link never runs,
//     so nobody writes the place the bounce reads), so a step is one pass
//     with one barrier after it: pull, collide in registers, store in
//     place.  The places stay inside the window: the region stepped at s
//     is the window less a ring of s cells, and the frame moves s cells.
//   * The link masks are formed once a launch, when the tile is loaded:
//     9 bits a cell (one a bouncing link, bit 0 for a cell that never
//     runs: solid or outside [0, ny)), as the TPU kernel hoists
//     src_is_solid (lbm_pallas.py:182-186).  No solid byte is read in the
//     step loop.
//   * Step 0 reads its packets from device memory, so the load, the masks
//     and the first collision are one pass.  The last pull (step K) goes
//     to device memory without a collision: the output is the streamed
//     state, as a launch of lbm_step.cu leaves it.  A solid cell is never
//     stepped in shared memory: K reflections leave f[q] (K even) or
//     f[OPP[q]] (K odd), read from device memory for the output.
//   K barriers a launch (the parent: 2K + 1).
//
// The collision is the one-step kernel's arithmetic (lbm_collide, lbm.cuh)
// and streaming moves values, so a launch is bitwise equal to K launches
// of lbm_step.cu and to K plain steps.
//
// Tile.  The window, 9 sizeof(T) + 2 bytes a cell, must fit the shared
// memory a block may use (kLbmSmem, at most 227 KB = 232,448 bytes, opted
// in with cudaFuncSetAttribute): the tile is the largest square that fits
// with its halo of K, clipped to the grid and evened out over the tiles of
// each axis.  At K = 8: at most 62^2 f32 (a 78^2 window, 231 KB; 61^2 on
// 2048x1024) and 40^2 f64 (56^2, 232 KB); ghost creep 1.3x / 1.5x.
// kLbmThreads (1024) a block, both dtypes; the shape query
// (fst_lbm_multistep_shape_*) reports tile, halo, threads and shared
// memory.  The constants come from tools/tune_tiles_torch.py (`--set lbm`,
// which builds variants with -DFST_LBM_...): 512 threads, two or three
// blocks an SM (half or a third of the shared memory, smaller tiles) and
// f64 at 128 registers a thread all ran slower.
//
// What bounds it now: instructions (0.31 ms a K=8 launch at 2048x1024
// f32, 6.8x the byte bound).  Per launch the bytes of one step (73 bytes a
// cell at f32, 153 MB at 2048x1024, ~46 us at 3.35 TB/s) against K steps of
// ~160 operations a fluid cell (the collision's two true divisions under
// -fmad=false among them) plus 9 shared-memory loads and stores, on
// 1.3-1.5x the useful cells; one block an SM, so a block's load and store
// are not hidden behind another block's steps.
#include "lbm.cuh"
#include "tiles.cuh"

namespace fst {
namespace {

#ifndef FST_LBM_SMEM
#define FST_LBM_SMEM 232448
#endif
// Threads a block, both dtypes (its __launch_bounds__, which caps the
// registers at 65536 / threads: 64 at 1024).
#ifndef FST_LBM_THREADS
#define FST_LBM_THREADS 1024
#endif
constexpr int kLbmSmem = FST_LBM_SMEM;
constexpr int kLbmThreads = FST_LBM_THREADS;
constexpr int kLbmMaxK = 16;
constexpr uint16_t kIdle = 1;  // mask bit 0: the cell is never stepped

template <typename T>
struct LbmShape {
  int tile_x, tile_y, tiles_x, tiles_y, sx, sy, threads;
  size_t smem;
};

template <typename T>
constexpr int cell_bytes() {
  return 9 * (int)sizeof(T) + (int)sizeof(uint16_t);
}

// One axis of n cells cut into tiles of at most `most`: the tile evened
// out over the tiles it takes.
inline void even_tiles(int n, int most, int* tile, int* tiles) {
  *tiles = (n + most - 1) / most;
  *tile = (n + *tiles - 1) / *tiles;
}

template <typename T>
int make_shape(int ny, int nx, int k, LbmShape<T>* s) {
  if (ny < 1 || nx < 1 || k < 1 || k > kLbmMaxK)
    return (int)cudaErrorInvalidValue;
  int side = 1;
  while ((side + 1) * (side + 1) * cell_bytes<T>() <= kLbmSmem) ++side;
  const int tile = side - 2 * k;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  even_tiles(nx, tile_of(tile, nx), &s->tile_x, &s->tiles_x);
  even_tiles(ny, tile_of(tile, ny), &s->tile_y, &s->tiles_y);
  s->sx = s->tile_x + 2 * k;
  s->sy = s->tile_y + 2 * k;
  s->threads = kLbmThreads;
  s->smem = (size_t)s->sx * s->sy * cell_bytes<T>();
  return threads_ok(s->threads, 1024) ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
__global__ void __launch_bounds__(kLbmThreads)
lbm_multistep_kernel(const T* __restrict__ f,
                     const uint8_t* __restrict__ solid, T* __restrict__ out,
                     int ny, int nx, int k, int tile_x, int tile_y,
                     LBMConst<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sx = tile_x + 2 * k, sy = tile_y + 2 * k;
  const int ss = sx * sy;
  T* P = reinterpret_cast<T*>(smem);  // 9 planes of the window
  uint16_t* mask = reinterpret_cast<uint16_t*>(P + 9 * ss);
  const int tx0 = blockIdx.x * tile_x, ty0 = blockIdx.y * tile_y;
  const int x0 = tx0 - k, y0 = ty0 - k;
  const size_t plane = (size_t)ny * nx;

  // step 0: load, link masks, collision; post q at P[q][c]
  for_region(0, sy, 0, sx, sx, [&](int ly, int lx, int cc) {
    const int gy = y0 + ly;
    uint16_t m = kIdle;
    if (gy >= 0 && gy < ny) {
      int gx = (x0 + lx) % nx;
      gx = gx < 0 ? gx + nx : gx;
      const size_t g = (size_t)gy * nx + gx;
      if (!__ldg(solid + g)) {
        m = 0;
#pragma unroll
        for (int q = 1; q < 9; ++q) {
          const int uy = gy - ey_of(q);
          int ux = gx - ex_of(q);
          ux = ux < 0 ? ux + nx : (ux >= nx ? ux - nx : ux);
          if (uy < 0 || uy >= ny || __ldg(solid + (size_t)uy * nx + ux))
            m |= (uint16_t)(1u << q);
        }
        T fl[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) fl[q] = __ldg(f + q * plane + g);
        lbm_collide(c, fl, fl);
#pragma unroll
        for (int q = 0; q < 9; ++q) P[q * ss + cc] = fl[q];
      }
    }
    mask[cc] = m;
  });
  __syncthreads();

  // steps 1 .. k-1: pull, collide in registers, store in place
  for (int s = 1; s < k; ++s) {
    for_region(s, sy - s, s, sx - s, sx, [&](int ly, int lx, int cc) {
      const unsigned m = mask[cc];
      if (m & kIdle) return;
      T fl[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int d = ey_of(q) * sx + ex_of(q);
        fl[q] = (m >> q) & 1u ? P[opp_of(q) * ss + cc + (s - 1) * d]
                              : P[q * ss + cc - s * d];
      }
      lbm_collide(c, fl, fl);
#pragma unroll
      for (int q = 0; q < 9; ++q)
        P[q * ss + cc - s * (ey_of(q) * sx + ex_of(q))] = fl[q];
    });
    __syncthreads();
  }

  // step k's pull, into the tile's cells inside the grid
  for_region(k, sy - k, k, sx - k, sx, [&](int ly, int lx, int cc) {
    const int gy = ty0 + ly - k, gx = tx0 + lx - k;
    if (gy >= ny || gx >= nx) return;  // past a ragged tile's edge
    const size_t g = (size_t)gy * nx + gx;
    const unsigned m = mask[cc];
    if (m & kIdle) {  // solid: k reflections of its packets
#pragma unroll
      for (int q = 0; q < 9; ++q)
        out[q * plane + g] = __ldg(f + (k & 1 ? opp_of(q) : q) * plane + g);
      return;
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int d = ey_of(q) * sx + ex_of(q);
      out[q * plane + g] = (m >> q) & 1u ? P[opp_of(q) * ss + cc + (k - 1) * d]
                                         : P[q * ss + cc - k * d];
    }
  });
}

// Lets the kernel take kLbmSmem bytes of dynamic shared memory a block and
// asks for the largest shared-memory carveout (so that a budget of half
// the SM holds two blocks an SM), once a device.  Returns the CUDA error
// code.
template <typename T>
int prepare_kernel(int device) {
  static bool done[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device]) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      lbm_multistep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLbmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lbm_multistep_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && known) done[device] = true;
  return (int)err;
}

template <typename T>
int launch_lbm_multistep(const T* f, const uint8_t* solid, T* out,
                         const LBMParams* p, int device, void* stream) {
  LbmShape<T> s{};
  const int err = make_shape<T>(p->ny, p->nx, p->k, &s);
  if (err != 0) return err;
  return on_device(device, [&] {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int prepared = prepare_kernel<T>(device);
    if (prepared != 0) return prepared;
    const dim3 grid(s.tiles_x, s.tiles_y);
    lbm_multistep_kernel<T><<<grid, s.threads, s.smem,
                              (cudaStream_t)stream>>>(
        f, solid, out, p->ny, p->nx, p->k, s.tile_x, s.tile_y,
        lbm_const<T>(*p));
    return (int)cudaGetLastError();
  });
}

// The launch's shape (fst::TileLaunch: blocks, threads, tile, the halo K,
// dynamic shared memory), as launch_lbm_multistep computes it.
template <typename T>
int lbm_multistep_shape(int ny, int nx, int k, TileLaunch* out) {
  LbmShape<T> s{};
  const int err = make_shape<T>(ny, nx, k, &s);
  if (err != 0) return err;
  *out = {s.tiles_x * s.tiles_y, s.threads, s.tile_x, s.tile_y, k,
          (int)s.smem};
  return 0;
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_lbm_multistep_f32(const float* f, const uint8_t* solid, float* out,
                          const fst::LBMParams* p, int device, void* stream) {
  return fst::launch_lbm_multistep<float>(f, solid, out, p, device, stream);
}

int fst_lbm_multistep_f64(const double* f, const uint8_t* solid, double* out,
                          const fst::LBMParams* p, int device, void* stream) {
  return fst::launch_lbm_multistep<double>(f, solid, out, p, device, stream);
}

int fst_lbm_multistep_shape_f32(int ny, int nx, int k, fst::TileLaunch* out) {
  return fst::lbm_multistep_shape<float>(ny, nx, k, out);
}

int fst_lbm_multistep_shape_f64(int ny, int nx, int k, fst::TileLaunch* out) {
  return fst::lbm_multistep_shape<double>(ny, nx, k, out);
}

}  // extern "C"
