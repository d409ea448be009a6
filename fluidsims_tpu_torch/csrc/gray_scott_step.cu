// One Gray–Scott step, periodic in x and y, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/gray_scott_pallas.py::
// _kernel (pallas_call at :77), which updates one row band in VMEM from a
// copy of the field padded on the host with wrap columns and whole wrap
// bands.  Here there is no padded copy: one thread per cell reads its four
// neighbours with the periodic wrap done by index arithmetic, which also
// holds on grids smaller than a block.  The arithmetic is gs_cell
// (gray_scott.cuh), the plain version's order, so the result is bitwise
// that of solvers/gray_scott.py::step.
//
// On the solver's path it runs the `n % block_k` remainder steps of a
// run, and every step when block_k = 1.
//
// What bounds it on an H100: bytes.  A cell reads u and v and writes them
// (16 bytes at f32; the neighbours come from L1/L2) and does 27
// operations, so at 2048^2 f32 the 67 MB a step move in ~20 us at
// 3.35 TB/s while the arithmetic needs ~1.7 us at 67 TFLOP/s.  Rows of 32 threads keep
// the loads and stores coalesced; the whole state (64 MB in and out at
// 2048^2 f32) is near the 50 MB L2, so back-to-back steps partly hit it.
#include "gray_scott.cuh"

namespace fst {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
gs_step_kernel(const T* __restrict__ u, const T* __restrict__ v,
               T* __restrict__ u_out, T* __restrict__ v_out, int ny, int nx,
               GSConst<T> c) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const size_t row = (size_t)y * nx;
  const size_t rd = (size_t)wrap(y + 1, ny) * nx;
  const size_t ru = (size_t)wrap(y - 1, ny) * nx;
  const int xr = wrap(x + 1, nx), xl = wrap(x - 1, nx);
  T un, vn;
  gs_cell(c, __ldg(u + row + x), __ldg(u + row + xr), __ldg(u + row + xl),
          __ldg(u + rd + x), __ldg(u + ru + x), __ldg(v + row + x),
          __ldg(v + row + xr), __ldg(v + row + xl), __ldg(v + rd + x),
          __ldg(v + ru + x), &un, &vn);
  u_out[row + x] = un;
  v_out[row + x] = vn;
}

template <typename T>
int launch_gs_step(const T* u, const T* v, T* u_out, T* v_out,
                   const GSParams* p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((p->nx + block.x - 1) / block.x,
                  (p->ny + block.y - 1) / block.y);
  gs_step_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, u_out, v_out, p->ny, p->nx, gs_const<T>(*p));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_gs_step_f32(const float* u, const float* v, float* u_out,
                    float* v_out, const fst::GSParams* p, int device,
                    void* stream) {
  return fst::launch_gs_step<float>(u, v, u_out, v_out, p, device, stream);
}

int fst_gs_step_f64(const double* u, const double* v, double* u_out,
                    double* v_out, const fst::GSParams* p, int device,
                    void* stream) {
  return fst::launch_gs_step<double>(u, v, u_out, v_out, p, device, stream);
}

}  // extern "C"
