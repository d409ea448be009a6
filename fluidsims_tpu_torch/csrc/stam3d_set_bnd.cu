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
// One launch covers all 12 (axis, field) pairs: blockIdx.z = axis * 4 +
// field (the x faces first, whose accesses are the slowest), a block
// kSetBndX threads along b by kSetBndRows rows a, and each thread writes
// both walls of its axis from one decode, in 32-bit index arithmetic:
//   x faces: the row (k, j) = (a, b): i = 0 from i = 1, i = n + 1 from n;
//   y faces: (k, i) = (a, b): j = 0 from j = 1, j = n + 1 from n;
//   z faces: (j, i) = (a, b): k = 0 from k = 1, k = n + 1 from n;
// with a, b in [1, n].  Along b the y and z faces' cells are consecutive
// in memory, so those accesses coalesce; an x-face thread's four cells lie
// in its own row, two 32-byte sectors a row.
//
// What bounds it on an H100: bytes.  The useful ones are 2 x 24 n^2 cells
// (~7 MB at 192^3 f32, ~2 us at 3.35 TB/s); the sectors the layout makes
// it touch are ~2.4x that at f32 (the x faces' 8 n^2 sectors, each read
// and written, 18.9 MB at 192^3).  Those scattered sectors set the pace:
// at 192^3 f32 a build that wrote the x faces alone took 0.0082 of the
// launch's 0.0098 ms, one that wrote the y and z faces alone 0.0029
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 13).
#include <cuda_runtime.h>

#include <stddef.h>

#include "tiles.cuh"

// The block: threads along b, rows a (tools/tune_tiles_torch.py sweep
// --set set_bnd builds other values with -D).
#ifndef FST_SET_BND_X
#define FST_SET_BND_X 32
#endif
#ifndef FST_SET_BND_ROWS
#define FST_SET_BND_ROWS 8
#endif

namespace fst {
namespace {

constexpr int kSetBndX = FST_SET_BND_X;
constexpr int kSetBndRows = FST_SET_BND_ROWS;
constexpr int kSetBndPairs = 12;  // 3 axes x 4 fields

template <typename T>
__global__ void __launch_bounds__(kSetBndX * kSetBndRows)
set_bnd_kernel(T* __restrict__ u, T* __restrict__ v, T* __restrict__ w,
               T* __restrict__ d, int n) {
  const int b = blockIdx.x * kSetBndX + threadIdx.x + 1;
  const int a = blockIdx.y * kSetBndRows + threadIdx.y + 1;
  if (a > n || b > n) return;
  const int axis = blockIdx.z >> 2, field = blockIdx.z & 3;
  T* g = field == 0 ? u : (field == 1 ? v : (field == 2 ? w : d));
  const size_t N = (size_t)n + 2;
  size_t base, stride;  // the wall cell at a = 0 of the axis, its step
  if (axis == 0) {
    base = ((size_t)a * N + b) * N;
    stride = 1;
  } else if (axis == 1) {
    base = (size_t)a * N * N + b;
    stride = N;
  } else {
    base = (size_t)a * N + b;
    stride = N * N;
  }
  const T lo = g[base + stride];
  const T hi = g[base + (size_t)n * stride];
  const bool neg = field == axis;
  g[base] = neg ? -lo : lo;
  g[base + (size_t)(n + 1) * stride] = neg ? -hi : hi;
}

dim3 set_bnd_grid(int n) {
  return dim3((unsigned)((n + kSetBndX - 1) / kSetBndX),
              (unsigned)((n + kSetBndRows - 1) / kSetBndRows), kSetBndPairs);
}

template <typename T>
int launch_set_bnd(T* u, T* v, T* w, T* d, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  set_bnd_kernel<T><<<set_bnd_grid(n), dim3(kSetBndX, kSetBndRows), 0,
                      (cudaStream_t)stream>>>(u, v, w, d, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// The launch for an (n+2)^3 volume: blocks, threads a block, and the
// block's extent along b (tile_x) and a (tile_y).
int fst_stam3d_set_bnd_blocks(int n, fst::TileLaunch* out) {
  const dim3 g = fst::set_bnd_grid(n);
  *out = fst::TileLaunch{(int)(g.x * g.y * g.z), fst::kSetBndX *
                         fst::kSetBndRows, fst::kSetBndX, fst::kSetBndRows,
                         0, 0};
  return 0;
}

int fst_stam3d_set_bnd_f32(float* u, float* v, float* w, float* d, int n,
                           int device, void* stream) {
  return fst::launch_set_bnd<float>(u, v, w, d, n, device, stream);
}

int fst_stam3d_set_bnd_f64(double* u, double* v, double* w, double* d, int n,
                           int device, void* stream) {
  return fst::launch_set_bnd<double>(u, v, w, d, n, device, stream);
}

}  // extern "C"
