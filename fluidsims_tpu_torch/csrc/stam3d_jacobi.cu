// One Jacobi sweep of the 3-D stable-fluids solves, for float and double:
// out = (x0 + a * sum6(x)) / c on the interior of an (n+2)^3 volume; the
// ghost ring of out is not touched.
//
// Over a z-slab (the z-slab runner, parallel/stam3d_sharded.py): x, x0 and
// out are W slices of (n+2)^2 whose first is the global slice z_off, and
// the sweep writes the cells of the slab's inner slices [1, W - 2] that lie
// in the global interior 1 <= z_off + k <= n; the global faces, the slices
// past gz = n + 1 (the padding of the z extent to a multiple of the ranks)
// and the slab's two end slices are not touched.  The runner gives the
// global ring its parity (the entry buffer's ring before an even sweep of
// the solve, zero before an odd one) by ping-ponging two windows whose
// rings hold those values, as the one-device wrapper ping-pongs a copy of
// x and a zero-ring scratch.  The whole volume is the slab of W = n + 2
// slices at z_off = 0: today's launch.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam3d_pallas.py::
// _jacobi_kernel (pallas_call at :176), which ran `ip` sweeps of a z band in
// VMEM, recomputing a halo band instead of syncing through HBM, and
// re-applied the ping-pong ghost ring by iteration parity inside the
// window.  Here one launch is one sweep, and the ring semantics are the
// reference's own lin_solve (js_cuda3d.cu:297-313): the wrapper
// (kernels/stam3d_cuda.py::lin_solve) ping-pongs between a copy of x and a
// scratch volume whose ring is zero, so reads alternate between x's ghosts
// and zeros, and any sweep count (odd too) is exact.  sum6 is summed in the
// plain version's order (x-, x+, y-, y+, z-, z+, solvers/stam3d.py::_sum6)
// and c divides truly, so the result is bitwise that of the plain version.
//
// What bounds it on an H100: bytes.  A cell reads x0 and x and writes out
// (12 bytes at f32; the six neighbours come from L1/L2) against 8
// operations, so at 192^3 f32 a sweep moves ~88 MB, ~26 us at 3.35 TB/s.
// Rows of 32 threads along x keep the loads and stores coalesced.
#include <cuda_runtime.h>

#include <stddef.h>

namespace fst {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
jacobi_kernel(const T* __restrict__ x, const T* __restrict__ x0,
              T* __restrict__ out, int n, int k0, T a, T c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int j = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int k = blockIdx.z + k0;
  if (i > n || j > n) return;
  const size_t N = (size_t)n + 2;
  const size_t sy = N, sz = N * N;
  const size_t s = (size_t)k * sz + (size_t)j * sy + i;
  const T sum = __ldg(x + s - 1) + __ldg(x + s + 1) + __ldg(x + s - sy) +
                __ldg(x + s + sy) + __ldg(x + s - sz) + __ldg(x + s + sz);
  out[s] = (__ldg(x0 + s) + a * sum) / c;
}

// A slab of w slices of (n+2)^2 from global slice z_off: the slices k in
// [max(1, 1 - z_off), min(w - 2, n - z_off)] are swept, one block row of
// the grid's z each; none is no launch.
template <typename T>
int launch_jacobi(const T* x, const T* x0, T* out, int n, int w, int z_off,
                  double a, double c, int device, void* stream) {
  if (n < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int k0 = 1 - z_off > 1 ? 1 - z_off : 1;
  const int k1 = n - z_off < w - 2 ? n - z_off : w - 2;
  if (k1 < k0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((n + block.x - 1) / block.x, (n + block.y - 1) / block.y,
                  k1 - k0 + 1);
  jacobi_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      x, x0, out, n, k0, T(a), T(c));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// w slices of (n+2)^2 from global slice z_off; the whole volume is w =
// n + 2, z_off = 0.
int fst_stam3d_jacobi_f32(const float* x, const float* x0, float* out, int n,
                          int w, int z_off, double a, double c, int device,
                          void* stream) {
  return fst::launch_jacobi<float>(x, x0, out, n, w, z_off, a, c, device,
                                   stream);
}

int fst_stam3d_jacobi_f64(const double* x, const double* x0, double* out,
                          int n, int w, int z_off, double a, double c,
                          int device, void* stream) {
  return fst::launch_jacobi<double>(x, x0, out, n, w, z_off, a, c, device,
                                    stream);
}

}  // extern "C"
