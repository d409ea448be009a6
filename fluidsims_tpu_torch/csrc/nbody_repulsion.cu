// Exact all-pairs repulsion of the prime-graph layout, for float and
// double, 2-D and 3-D: `_repulsion_exact` of
// fluidsims_tpu_torch/solvers/nbody_graph.py.  For each target t_i,
//
//   f_i = sum_j repulsion * (|t_i - p_j|^2 + softening)^(-3/2) * (t_i - p_j)
//
// over every source p_j, from the explicit differences; the self pair
// contributes exactly zero (d = 0).
//
// The TPU build has no Pallas kernel for this: the JAX step computes it
// as plain XLA (fluidsims_tpu/solvers/nbody_graph.py:209-247,
// `_repulsion_exact`), which fuses each chunk of 1024 targets into one
// loop that reads positions and writes forces.  Eagerly, the plain
// PyTorch version writes ~13 (chunk, n) temporaries a chunk to device
// memory; this kernel keeps every pair in registers.
//
// Design: one thread a target, 256 a block; the sources go through
// shared memory a tile of 256 at a time (each thread loads one), and
// every thread of the block reads each staged source (a broadcast).  Each
// tile's 256 terms are summed into a partial that is then added to the
// running total, so that in f32 no one accumulator takes all n terms.
// The arithmetic of a pair is the plain version's, in its order:
// d2 = dx*dx + dy*dy (+ dz*dz) + softening, inv = rsqrt(d2), w =
// repulsion * ((inv * inv) * inv), f += w * d; `-fmad=false` keeps every
// multiply and add rounded on its own.  rsqrtf is within 2 ulp and
// double rsqrt within 1 ulp, so the kernel matches its plain version to
// rounding, not bitwise (the sums go in another order too).
//
// What bounds it on an H100: operations.  n^2 pairs of ~14 operations
// (2-D) or ~19 (3-D) with one reciprocal square root each; at 2^17
// bodies 1.7e10 pairs, 3.6 ms at 67 TFLOP/s in f32.  The bytes are
// negligible (each position read once from memory a block, forces
// written once).  The SFU's rsqrt (16 a clock an SM) and the lack of
// fused multiply-adds keep it above that bound; making it fast is later
// work.
#include <cuda_runtime.h>

namespace fst {
namespace {

constexpr int kNBodyThreads = 256;  // targets a block = sources a tile

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kNBodyThreads)
nbody_repulsion_kernel(const T* __restrict__ tgt, int nt,
                       const T* __restrict__ pos, int n, T softening,
                       T repulsion, T* __restrict__ out) {
  __shared__ T src[D][kNBodyThreads];
  const int i = blockIdx.x * kNBodyThreads + threadIdx.x;
  const bool live = i < nt;
  T t[D], acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    t[k] = live ? tgt[(size_t)i * D + k] : T(0);
    acc[k] = T(0);
  }

  for (int base = 0; base < n; base += kNBodyThreads) {
    const int j = base + threadIdx.x;
    if (j < n) {
#pragma unroll
      for (int k = 0; k < D; ++k) src[k][threadIdx.x] = pos[(size_t)j * D + k];
    }
    __syncthreads();
    const int m = min(kNBodyThreads, n - base);
    T part[D];
#pragma unroll
    for (int k = 0; k < D; ++k) part[k] = T(0);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      T d[D];
#pragma unroll
      for (int k = 0; k < D; ++k) d[k] = t[k] - src[k][jj];
      T d2 = d[0] * d[0] + d[1] * d[1];
      if constexpr (D == 3) d2 = d2 + d[2] * d[2];
      d2 = d2 + softening;
      const T inv = rsqrt_of(d2);
      const T w = repulsion * (inv * inv * inv);
#pragma unroll
      for (int k = 0; k < D; ++k) part[k] = part[k] + w * d[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = acc[k] + part[k];
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < D; ++k) out[(size_t)i * D + k] = acc[k];
  }
}

template <typename T>
int launch_repulsion(const T* tgt, int nt, const T* pos, int n, int dims,
                     double softening, double repulsion, T* out, int device,
                     void* stream) {
  if (nt < 1 || n < 1 || (dims != 2 && dims != 3))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (nt + kNBodyThreads - 1) / kNBodyThreads;
  if (dims == 2)
    nbody_repulsion_kernel<T, 2><<<blocks, kNBodyThreads, 0, s>>>(
        tgt, nt, pos, n, T(softening), T(repulsion), out);
  else
    nbody_repulsion_kernel<T, 3><<<blocks, kNBodyThreads, 0, s>>>(
        tgt, nt, pos, n, T(softening), T(repulsion), out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_nbody_repulsion_f32(const float* tgt, int nt, const float* pos, int n,
                            int dims, double softening, double repulsion,
                            float* out, int device, void* stream) {
  return fst::launch_repulsion<float>(tgt, nt, pos, n, dims, softening,
                                      repulsion, out, device, stream);
}

int fst_nbody_repulsion_f64(const double* tgt, int nt, const double* pos,
                            int n, int dims, double softening,
                            double repulsion, double* out, int device,
                            void* stream) {
  return fst::launch_repulsion<double>(tgt, nt, pos, n, dims, softening,
                                       repulsion, out, device, stream);
}

}  // extern "C"
