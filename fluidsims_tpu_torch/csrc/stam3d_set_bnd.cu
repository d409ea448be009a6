// The reflective ghost faces of the 3-D stable fluids' four fields u, v, w
// and d, in place, for float and double (k_set_bnd, js_cuda3d.cu:119-157):
// on the x faces u takes the negated interior neighbour and the others copy
// it, on the y faces v, on the z faces w; d copies on every face.  Only the
// n^2 interior cells of each face are written; edges and corners keep
// their values.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam3d_pallas.py::
// _set_bnd_kernel (pallas_call at :345), which streamed all four volumes
// through VMEM in z bands and selected the faces with masks: one read and
// one write of every cell.  Here a launch touches the face cells alone.
// Every face cell reads an interior cell, which no thread writes, so the
// writes need no order and the update is safe in place.  Negation and copy
// are exact: the result is bitwise that of the plain version.
//
// What bounds it on an H100: bytes, and at these sizes the launch.  A
// thread reads one value and writes one: 6 n^2 cells a field, 4 fields, so
// ~7 MB at 192^3 f32 (~2 us at 3.35 TB/s).
#include <cuda_runtime.h>

#include <stddef.h>

namespace fst {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
set_bnd_kernel(T* __restrict__ u, T* __restrict__ v, T* __restrict__ w,
               T* __restrict__ d, int n) {
  const long long per_face = (long long)n * n;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 24 * per_face) return;
  const int field = (int)(t / (6 * per_face));
  const int face = (int)(t / per_face % 6);
  const int rem = (int)(t % per_face);
  const int a = rem / n + 1, b = rem % n + 1;
  const int axis = face >> 1;           // 0: x, 1: y, 2: z
  const int wall = (face & 1) ? n + 1 : 0;
  const int src = (face & 1) ? n : 1;
  int k = a, j = b, i = b, ks = a, js = b, is = b;
  if (axis == 0) {        // (k, j) = (a, b)
    i = wall;
    is = src;
  } else if (axis == 1) { // (k, i) = (a, b)
    j = wall;
    js = src;
  } else {                // (j, i) = (a, b)
    j = js = a;
    k = wall;
    ks = src;
  }
  T* g = field == 0 ? u : (field == 1 ? v : (field == 2 ? w : d));
  const size_t N = (size_t)n + 2;
  const T val = g[((size_t)ks * N + js) * N + is];
  g[((size_t)k * N + j) * N + i] = field == axis ? -val : val;
}

template <typename T>
int launch_set_bnd(T* u, T* v, T* w, T* d, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long threads = 24LL * n * n;
  const int block = 256;
  set_bnd_kernel<T><<<(unsigned)((threads + block - 1) / block), block, 0,
                      (cudaStream_t)stream>>>(u, v, w, d, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_stam3d_set_bnd_f32(float* u, float* v, float* w, float* d, int n,
                           int device, void* stream) {
  return fst::launch_set_bnd<float>(u, v, w, d, n, device, stream);
}

int fst_stam3d_set_bnd_f64(double* u, double* v, double* w, double* d, int n,
                           int device, void* stream) {
  return fst::launch_set_bnd<double>(u, v, w, d, n, device, stream);
}

}  // extern "C"
