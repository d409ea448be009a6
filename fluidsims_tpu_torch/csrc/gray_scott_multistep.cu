// K Gray–Scott steps per launch by temporal blocking in shared memory,
// periodic in x and y, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/gray_scott_pallas.py::
// _ms_kernel (pallas_call at :203), which loads a row band with K wrapped
// ghost rows and 64 wrapped ghost columns into VMEM, steps it K times with
// pltpu.roll (the garbage from the slab edge creeps one cell inward a
// step) and writes the band's interior.  Here the same ghost creep runs
// on square tiles:
//
//   * each block loads a (T + 2K)^2 tile of u and v, the periodic wrap
//     done by index arithmetic (a tile may be wider than the grid);
//   * it steps K times in shared memory, ping-ponging between two copies;
//     step s computes only the cells [s, T + 2K - s) of each axis, the
//     region whose neighbours are still valid;
//   * it writes the T^2 interior, the cells that lie inside the grid.
//
// Every tile cell holds the true value of the periodic image it stands
// for, and gs_cell (gray_scott.cuh) is the one-step kernel's arithmetic,
// so a launch is bitwise equal to K launches of gray_scott_step.cu.
//
// Tile.  Four (T + 2K)^2 arrays (u, v, two copies) must fit the 227 KB a
// block can use (232,448 bytes, opted in with cudaFuncSetAttribute): T is
// the largest of 64, 32, 16 that fits.  f32: T = 64 up to K = 28 (4 x
// 96^2 x 4 B = 147 KB at K = 16), then T = 32.  f64: T = 64 up to K = 10,
// T = 32 up to K = 26 (131 KB at K = 16), then T = 16.  The kernel takes
// 1 <= K <= 32 (kernels/gray_scott_cuda.py MAX_BLOCK_K checks it before
// the launch).
//
// What bounds it on an H100: per launch the bytes of one step (u and v in
// and out, 67 MB at 2048^2 f32, ~20 us at 3.35 TB/s) against K steps of
// 27 operations a cell, 1.5-2.2x of them redundant in the halos (the
// average of (T + 2(K - s))^2 / T^2 over the steps): ~0.03 ms of f32
// issue a launch at K = 16, so operations bound it.  One 1024-thread
// block fills an SM at f32, T = 64; the 16 __syncthreads of a launch and
// the shared-memory traffic (10 reads and 2 writes a cell-step) are what a
// faster version would look at.
#include "gray_scott.cuh"

namespace fst {
namespace {

constexpr int kMaxSmem = 232448;  // 227 KB, the H100's per-block maximum
constexpr int kThreadsX = 32, kThreadsY = 32;

template <typename T>
int smem_bytes(int tile, int k) {
  const int S = tile + 2 * k;
  return 4 * S * S * (int)sizeof(T);
}

template <typename T>
int pick_tile(int k) {
  const int tiles[3] = {64, 32, 16};
  for (int tile : tiles)
    if (smem_bytes<T>(tile, k) <= kMaxSmem) return tile;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gs_multistep_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    T* __restrict__ u_out, T* __restrict__ v_out, int ny,
                    int nx, int k, int tile, GSConst<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = tile + 2 * k;
  T* cu = reinterpret_cast<T*>(smem);
  T* cv = cu + S * S;
  T* nu = cv + S * S;
  T* nv = nu + S * S;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.y * tile - k, x0 = blockIdx.x * tile - k;

  for (int ly = ty; ly < S; ly += kThreadsY) {
    const size_t row = (size_t)wrap(y0 + ly, ny) * nx;
    for (int lx = tx; lx < S; lx += kThreadsX) {
      const size_t g = row + wrap(x0 + lx, nx);
      cu[ly * S + lx] = __ldg(u + g);
      cv[ly * S + lx] = __ldg(v + g);
    }
  }
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    for (int ly = s + ty; ly < S - s; ly += kThreadsY) {
      for (int lx = s + tx; lx < S - s; lx += kThreadsX) {
        const int i = ly * S + lx;
        gs_cell(c, cu[i], cu[i + 1], cu[i - 1], cu[i + S], cu[i - S], cv[i],
                cv[i + 1], cv[i - 1], cv[i + S], cv[i - S], nu + i, nv + i);
      }
    }
    __syncthreads();
    T* t = cu; cu = nu; nu = t;
    t = cv; cv = nv; nv = t;
  }

  for (int ly = ty; ly < tile; ly += kThreadsY) {
    const int gy = blockIdx.y * tile + ly;
    if (gy >= ny) break;
    for (int lx = tx; lx < tile; lx += kThreadsX) {
      const int gx = blockIdx.x * tile + lx;
      if (gx >= nx) break;
      const int i = (ly + k) * S + lx + k;
      u_out[(size_t)gy * nx + gx] = cu[i];
      v_out[(size_t)gy * nx + gx] = cv[i];
    }
  }
}

template <typename T>
int launch_gs_multistep(const T* u, const T* v, T* u_out, T* v_out,
                        const GSParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tile = p->k >= 1 ? pick_tile<T>(p->k) : 0;
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes<T>(tile, p->k);
  err = cudaFuncSetAttribute(gs_multistep_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((p->nx + tile - 1) / tile, (p->ny + tile - 1) / tile);
  gs_multistep_kernel<T><<<grid, block, bytes, (cudaStream_t)stream>>>(
      u, v, u_out, v_out, p->ny, p->nx, p->k, tile, gs_const<T>(*p));
  return (int)cudaGetLastError();
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

}  // extern "C"
