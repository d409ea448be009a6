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
// stepped as solvers/lbm.py::step steps it.
//
//   * Each block loads a (T + 2K)^2 tile of the 9 packets and a flag per
//     cell (0 fluid, 1 solid, 2 outside [0, ny)), x wrapping by index.
//   * Step s = 1..K, in two phases: every fluid cell of [s-1, T+2K-s+1)
//     collides in place (lbm_collide, lbm.cuh), then every cell of
//     [s, T+2K-s) pulls into the second copy: a solid cell its own
//     f[OPP[q]], a fluid cell packet q of its upstream cell, or its own
//     post[OPP[q]] when the upstream cell is solid or out of bounds.  The
//     valid region shrinks one cell a step (the ghost creep).
//   * It writes the T^2 interior, the cells that lie inside the grid.
//
// The collision is the one-step kernel's arithmetic and the pull moves
// the same values as its push, so a launch is bitwise equal to K launches
// of lbm_step.cu.
//
// Tile.  Two copies of 9 (T + 2K)^2 packet planes and the flags must fit
// the 227 KB a block can use (232,448 bytes, opted in with
// cudaFuncSetAttribute): T is the largest of 32, 16, 8 that fits.  f32:
// T = 32 up to K = 12 (2 x 9 x 48^2 x 4 B + 48^2 = 168 KB at K = 8), then
// T = 16 up to K = 20.  f64: T = 32 up to K = 4, T = 16 up to K = 12
// (148 KB at K = 8), T = 8 up to K = 16.  The kernel takes 1 <= K <= 16
// (kernels/lbm_cuda.py MAX_BLOCK_K checks it before the launch).
//
// What bounds it on an H100: per launch the bytes of one step (73 bytes a
// cell at f32, 153 MB at 2048x1024, ~46 us at 3.35 TB/s) against K steps
// of 160 operations a fluid cell, 1.5-1.7x of them redundant in the halos
// at T = 32, K = 8 (~0.04 ms of useful f32 work a launch): about even.  One
// 512-thread block fills an SM at f32; the two __syncthreads a step, the
// shared-memory traffic (18 reads and 18 writes a cell-step) and the low
// occupancy are what a faster version would look at.
#include "lbm.cuh"

namespace fst {
namespace {

constexpr int kMaxSmem = 232448;  // 227 KB, the H100's per-block maximum
constexpr int kThreadsX = 16, kThreadsY = 32;

template <typename T>
int smem_bytes(int tile, int k) {
  const int S = tile + 2 * k;
  return 2 * 9 * S * S * (int)sizeof(T) + S * S;
}

template <typename T>
int pick_tile(int k) {
  const int tiles[3] = {32, 16, 8};
  for (int tile : tiles)
    if (smem_bytes<T>(tile, k) <= kMaxSmem) return tile;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
lbm_multistep_kernel(const T* __restrict__ f,
                     const uint8_t* __restrict__ solid, T* __restrict__ out,
                     int ny, int nx, int k, int tile, LBMConst<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = tile + 2 * k;
  const int SS = S * S;
  T* a = reinterpret_cast<T*>(smem);  // 9 planes: current packets
  T* b = a + 9 * SS;                  // 9 planes: next packets
  uint8_t* flag = reinterpret_cast<uint8_t*>(b + 9 * SS);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.y * tile - k, x0 = blockIdx.x * tile - k;
  const size_t plane = (size_t)ny * nx;

  for (int ly = ty; ly < S; ly += kThreadsY) {
    const int gy = y0 + ly;
    const bool inside = gy >= 0 && gy < ny;
    for (int lx = tx; lx < S; lx += kThreadsX) {
      const int i = ly * S + lx;
      if (!inside) {
        flag[i] = 2;
        continue;
      }
      int gx = (x0 + lx) % nx;
      gx = gx < 0 ? gx + nx : gx;
      const size_t g = (size_t)gy * nx + gx;
      flag[i] = __ldg(solid + g) ? 1 : 0;
#pragma unroll
      for (int q = 0; q < 9; ++q) a[q * SS + i] = __ldg(f + q * plane + g);
    }
  }
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    // collide in place: the fluid cells whose packets step s pulls
    for (int ly = s - 1 + ty; ly < S - s + 1; ly += kThreadsY) {
      for (int lx = s - 1 + tx; lx < S - s + 1; lx += kThreadsX) {
        const int i = ly * S + lx;
        if (flag[i] != 0) continue;
        T fl[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) fl[q] = a[q * SS + i];
        lbm_collide(c, fl, fl);
#pragma unroll
        for (int q = 0; q < 9; ++q) a[q * SS + i] = fl[q];
      }
    }
    __syncthreads();
    // stream (pull) with on-link bounce-back into the other copy
    for (int ly = s + ty; ly < S - s; ly += kThreadsY) {
      for (int lx = s + tx; lx < S - s; lx += kThreadsX) {
        const int i = ly * S + lx;
        const uint8_t fi = flag[i];
        if (fi == 2) continue;
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const int src = i - ey_of(q) * S - ex_of(q);
          const bool own = fi == 1 || flag[src] != 0;
          b[q * SS + i] = own ? a[opp_of(q) * SS + i] : a[q * SS + src];
        }
      }
    }
    __syncthreads();
    T* t = a; a = b; b = t;
  }

  for (int ly = ty; ly < tile; ly += kThreadsY) {
    const int gy = blockIdx.y * tile + ly;
    if (gy >= ny) break;
    for (int lx = tx; lx < tile; lx += kThreadsX) {
      const int gx = blockIdx.x * tile + lx;
      if (gx >= nx) break;
      const int i = (ly + k) * S + lx + k;
      const size_t g = (size_t)gy * nx + gx;
#pragma unroll
      for (int q = 0; q < 9; ++q) out[q * plane + g] = a[q * SS + i];
    }
  }
}

template <typename T>
int launch_lbm_multistep(const T* f, const uint8_t* solid, T* out,
                         const LBMParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tile = p->k >= 1 ? pick_tile<T>(p->k) : 0;
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes<T>(tile, p->k);
  err = cudaFuncSetAttribute(lbm_multistep_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((p->nx + tile - 1) / tile, (p->ny + tile - 1) / tile);
  lbm_multistep_kernel<T><<<grid, block, bytes, (cudaStream_t)stream>>>(
      f, solid, out, p->ny, p->nx, p->k, tile, lbm_const<T>(*p));
  return (int)cudaGetLastError();
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

}  // extern "C"
