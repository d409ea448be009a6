// One D2Q9 step (moments + drive, BGK collision, streaming, on-link
// bounce-back), x periodic and y bounded, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/lbm_pallas.py::_kernel
// (pallas_call at :118), which PULLS: from a row band with one-row halos
// (copies padded on the host) it recomputes the collision of every cell
// and takes each slot from the upstream cell.  Here the form is PUSH, the
// reference's own (tau_lbm.cu:94-132): one thread per cell collides once
// and writes each post-collision packet to exactly one slot —
//
//   * packet q of a fluid cell goes to slot q of the downstream cell
//     (x + ex_q wrapping, y + ey_q) when that cell lies in [0, ny) and is
//     fluid, else to the cell's own slot OPP[q] (on-link bounce-back);
//   * a solid cell writes f[OPP[q]] into its own slot q.
//
// Every output slot has exactly one writer (the pull's upstream cell, or
// the cell itself when the upstream link is a wall or leaves the grid),
// so there are no atomics, and the result is slot for slot that of the
// pull in solvers/lbm.py::step: the same bits, since lbm_collide
// (lbm.cuh) keeps the plain version's arithmetic and the streaming only
// moves values.  Rows outside [0, ny) are out of bounds whatever the
// solid map holds (the plain version's `oob` rule), so a map without
// walls is stepped as the plain version steps it.
//
// On the solver's path it runs the `n % block_k` remainder steps of a
// run, and every step when block_k = 1.
//
// What bounds it on an H100: bytes.  A cell reads its 9 packets and its
// solid byte (and the 8 neighbours' bytes, mostly from L1), and writes 9
// packets: 73 bytes at f32, 153 MB a step at 2048x1024, ~46 us at
// 3.35 TB/s, against 160 operations a fluid cell (~5 us at f32).  Plane
// by plane the loads are coalesced, and so are the pushed stores: a warp
// writes 32 neighbouring slots of one plane, shifted by one cell.
#include "lbm.cuh"

namespace fst {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
lbm_step_kernel(const T* __restrict__ f, const uint8_t* __restrict__ solid,
                T* __restrict__ out, int ny, int nx, LBMConst<T> c) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const size_t plane = (size_t)ny * nx;
  const size_t i = (size_t)y * nx + x;
  T fl[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) fl[q] = __ldg(f + q * plane + i);
  if (__ldg(solid + i)) {
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q * plane + i] = fl[opp_of(q)];
    return;
  }
  T post[9];
  lbm_collide(c, fl, post);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int yd = y + ey_of(q);
    int xd = x + ex_of(q);
    xd = xd < 0 ? xd + nx : (xd >= nx ? xd - nx : xd);
    const size_t d = (size_t)yd * nx + xd;
    if (yd >= 0 && yd < ny && !__ldg(solid + d)) {
      out[q * plane + d] = post[q];
    } else {
      out[opp_of(q) * plane + i] = post[q];
    }
  }
}

template <typename T>
int launch_lbm_step(const T* f, const uint8_t* solid, T* out,
                    const LBMParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((p->nx + block.x - 1) / block.x,
                  (p->ny + block.y - 1) / block.y);
  lbm_step_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      f, solid, out, p->ny, p->nx, lbm_const<T>(*p));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_lbm_step_f32(const float* f, const uint8_t* solid, float* out,
                     const fst::LBMParams* p, int device, void* stream) {
  return fst::launch_lbm_step<float>(f, solid, out, p, device, stream);
}

int fst_lbm_step_f64(const double* f, const uint8_t* solid, double* out,
                     const fst::LBMParams* p, int device, void* stream) {
  return fst::launch_lbm_step<double>(f, solid, out, p, device, stream);
}

}  // extern "C"
