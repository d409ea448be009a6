// Exact all-pairs repulsion of the prime-graph layout, for float and
// double, 2-D and 3-D: `_repulsion_exact` of
// fluidsims_tpu_torch/solvers/nbody_graph.py.  For each target t_i,
//
//   f_i = sum_j repulsion * (|t_i - p_j|^2 + softening)^(-3/2) * (t_i - p_j)
//
// over every source p_j, from the explicit differences (never the
// |a|^2 + |b|^2 - 2ab identity, which cancels in f32 at 7e3-scale
// coordinates, so no tensor core either); the self pair and coincident
// bodies contribute exactly zero (d = 0), with no branch.
//
// The TPU build has no Pallas kernel for this: the JAX step computes it
// as plain XLA (fluidsims_tpu/solvers/nbody_graph.py:209-247,
// `_repulsion_exact`), which fuses each chunk of 1024 targets into one
// loop that reads positions and writes forces.  Eagerly, the plain
// PyTorch version writes ~13 (chunk, n) temporaries a chunk to device
// memory; this kernel keeps every pair in registers.
//
// What bounds it on an H100: the issue of its instructions.  The
// function's operations (14 a pair in 2-D, 19 in 3-D, as the plain
// version writes them) give 3.6 ms at 2^17 bodies in f32 at 67 TFLOP/s;
// the SFU's rsqrt (16 a clock an SM) ~4.1 ms.  The bytes are negligible.
// A warp issues one instruction a clock, so the design spends as few
// issue slots a pair as it can:
//
// * each thread takes kTargets targets (the targets of block b are
//   b * kThreads * kTargets + k * kThreads + threadIdx.x, k < kTargets),
//   so that each source read from shared memory serves kTargets pairs;
// * the sources go through shared memory a tile of kThreads at a time,
//   one vector each (float2, float4 padded for 3-D, double2), staged one
//   a thread (two buffers, one barrier a tile, measured no faster);
// * a full tile runs a loop of fixed count, unrolled kUnroll sources at a
//   time; the ragged last tile runs a loop of its own;
// * a pair is d = t - p, d2 = fma(dx, dx, fma(dy, dy, softening)) (dz
//   innermost in 3-D), inv = rsqrt(d2), w = (inv * inv) * inv and part =
//   fma(w, d, part): fused multiply-adds written out (the library is built
//   with -fmad=false, on which the other kernels' bits depend), and the
//   repulsion factor applied once to a target's sum.  2-D f32: 2 FADD, 4
//   FFMA, 2 FMUL and 1 MUFU a pair and warp (rsqrt with denormals
//   flushed), and 1 / kTargets of a shared load.  In f64, w comes from
//   rsqrt.approx.ftz.f64 cubed and corrected by a series (6 FP64
//   operations and no branch, for the library rsqrt's 5, its special-case
//   branch and the cube's 2): 12 FP64 operations a pair, whose pipe (half
//   the FP32 rate) sets the f64 pace;
// * each tile's partial sum is added to the running total, so that in f32
//   no one accumulator takes all n terms (~1e-6 of sum |terms| at 2^17).
//
// The f32 rsqrt is within 2 ulp and the f64 w within a few ulp, and the
// sums go in another order, so the kernel matches its plain version to
// rounding, not bitwise.
#include <cuda_runtime.h>

// Threads a block (= sources a tile) and targets a thread, for float and
// for double, and the sources a step of a full tile's loop
// (`tools/tune_tiles_torch.py sweep --set nbody` times candidates).
#ifndef FST_NBODY_THREADS
#define FST_NBODY_THREADS 256
#endif
#ifndef FST_NBODY_TARGETS
#define FST_NBODY_TARGETS 2
#endif
#ifndef FST_NBODY_F64_THREADS
#define FST_NBODY_F64_THREADS 512
#endif
#ifndef FST_NBODY_F64_TARGETS
#define FST_NBODY_F64_TARGETS 1
#endif
#ifndef FST_NBODY_UNROLL
#define FST_NBODY_UNROLL 16
#endif

namespace fst {
namespace {

template <typename T> struct NBodyShape;
template <> struct NBodyShape<float> {
  static constexpr int kThreads = FST_NBODY_THREADS;
  static constexpr int kTargets = FST_NBODY_TARGETS;
};
template <> struct NBodyShape<double> {
  static constexpr int kThreads = FST_NBODY_F64_THREADS;
  static constexpr int kTargets = FST_NBODY_F64_TARGETS;
};
constexpr int kUnroll = FST_NBODY_UNROLL;

// A staged source: one vector of D coordinates (3-D padded to 4).
struct __align__(16) Double3P { double x, y, z, pad; };
template <typename T, int D> struct SrcVec;
template <> struct SrcVec<float, 2> { using V = float2; };
template <> struct SrcVec<float, 3> { using V = float4; };
template <> struct SrcVec<double, 2> { using V = double2; };
template <> struct SrcVec<double, 3> { using V = Double3P; };

__device__ __forceinline__ void pack(float2& v, const float* p) {
  v = make_float2(p[0], p[1]);
}
__device__ __forceinline__ void pack(float4& v, const float* p) {
  v = make_float4(p[0], p[1], p[2], 0.f);
}
__device__ __forceinline__ void pack(double2& v, const double* p) {
  v = make_double2(p[0], p[1]);
}
__device__ __forceinline__ void pack(Double3P& v, const double* p) {
  v = Double3P{p[0], p[1], p[2], 0.0};
}
__device__ __forceinline__ void unpack(const float2& v, float (&c)[2]) {
  c[0] = v.x;
  c[1] = v.y;
}
__device__ __forceinline__ void unpack(const float4& v, float (&c)[3]) {
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
}
__device__ __forceinline__ void unpack(const double2& v, double (&c)[2]) {
  c[0] = v.x;
  c[1] = v.y;
}
__device__ __forceinline__ void unpack(const Double3P& v, double (&c)[3]) {
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// w = x^(-3/2) = rsqrt(x)^3.  In f32 the SFU's rsqrt with denormal inputs
// flushed (the card's rsqrtf otherwise spends a compare and two
// predicated multiplies a call on them): x >= softening in every run, and
// a denormal x gives an infinite w either way (rsqrtf(x)^3 overflows).
__device__ __forceinline__ float w_of(float x) {
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(x));
  return (inv * inv) * inv;
}
// In f64, y = rsqrt.approx.ftz.f64(x) (~2^-22 relative) and e = 1 - x y^2:
// x^(-3/2) = y^3 (1 - e)^(-3/2) = y^3 (1 + 3e/2 + 15e^2/8 + ...), to ~2^-53
// in six operations with no branch.  x = 0 gives inf * 0 = NaN, as the
// plain version's w * d does at the self pair of softening 0.
__device__ __forceinline__ double w_of(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double y2 = y * y;
  const double e = __fma_rn(-x, y2, 1.0);
  const double y3 = y2 * y;
  return __fma_rn(y3, e * __fma_rn(1.875, e, 1.5), y3);
}

// The pairs of one staged source with a thread's K targets.
template <typename T, int D, int K>
__device__ __forceinline__ void add_source(
    const typename SrcVec<T, D>::V& sv, const T (&t)[K][D], T softening,
    T (&part)[K][D]) {
  T s[D];
  unpack(sv, s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T d[D];
#pragma unroll
    for (int c = 0; c < D; ++c) d[c] = t[k][c] - s[c];
    T d2 = fmadd(d[D - 1], d[D - 1], softening);
#pragma unroll
    for (int c = D - 2; c >= 0; --c) d2 = fmadd(d[c], d[c], d2);
    const T w = w_of(d2);
#pragma unroll
    for (int c = 0; c < D; ++c) part[k][c] = fmadd(w, d[c], part[k][c]);
  }
}

// Thread threadIdx.x stages source `base + threadIdx.x`, if there is one.
template <typename T, int D>
__device__ __forceinline__ void stage(typename SrcVec<T, D>::V* buf,
                                      const T* __restrict__ pos, int base,
                                      int n) {
  const int j = base + threadIdx.x;
  if (j < n) pack(buf[threadIdx.x], pos + (size_t)j * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NBodyShape<T>::kThreads)
nbody_repulsion_kernel(const T* __restrict__ tgt, int nt,
                       const T* __restrict__ pos, int n, T softening,
                       T repulsion, T* __restrict__ out) {
  constexpr int kT = NBodyShape<T>::kThreads;
  constexpr int kK = NBodyShape<T>::kTargets;
  static_assert(kT % kUnroll == 0, "a tile is whole steps of the unroll");
  using V = typename SrcVec<T, D>::V;
  __shared__ V src[kT];

  const int first = blockIdx.x * (kT * kK) + threadIdx.x;
  T t[kK][D], acc[kK][D];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = first + k * kT;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      t[k][c] = i < nt ? tgt[(size_t)i * D + c] : T(0);
      acc[k][c] = T(0);
    }
  }

  for (int base = 0; base < n; base += kT) {
    stage<T, D>(src, pos, base, n);
    __syncthreads();
    T part[kK][D];
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) part[k][c] = T(0);
    const int m = min(kT, n - base);
    if (m == kT) {
#pragma unroll 1
      for (int j0 = 0; j0 < kT; j0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          add_source<T, D, kK>(src[j0 + u], t, softening, part);
      }
    } else {
#pragma unroll 1
      for (int jj = 0; jj < m; ++jj)
        add_source<T, D, kK>(src[jj], t, softening, part);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[k][c] = acc[k][c] + part[k][c];
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = first + k * kT;
    if (i < nt) {
#pragma unroll
      for (int c = 0; c < D; ++c) out[(size_t)i * D + c] = repulsion * acc[k][c];
    }
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
  constexpr int kT = NBodyShape<T>::kThreads;
  constexpr int per_block = kT * NBodyShape<T>::kTargets;
  const int blocks = (nt + per_block - 1) / per_block;
  if (dims == 2)
    nbody_repulsion_kernel<T, 2><<<blocks, kT, 0, s>>>(
        tgt, nt, pos, n, T(softening), T(repulsion), out);
  else
    nbody_repulsion_kernel<T, 3><<<blocks, kT, 0, s>>>(
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

// The launch's shape for `nt` targets: threads a block (= sources a
// tile), targets a thread, blocks and sources a step of a full tile's
// loop.
int fst_nbody_repulsion_launch(int nt, int f64, int* shape) {
  if (nt < 1) return (int)cudaErrorInvalidValue;
  const int threads = f64 ? fst::NBodyShape<double>::kThreads
                          : fst::NBodyShape<float>::kThreads;
  const int targets = f64 ? fst::NBodyShape<double>::kTargets
                          : fst::NBodyShape<float>::kTargets;
  shape[0] = threads;
  shape[1] = targets;
  shape[2] = (nt + threads * targets - 1) / (threads * targets);
  shape[3] = fst::kUnroll;
  return 0;
}

}  // extern "C"
