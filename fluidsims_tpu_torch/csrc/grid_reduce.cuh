// What the K-step τ-clock kernels share (burgers_multistep.cu,
// shallow_water_multistep.cu, mhd_multistep.cu): NaN-propagating min and
// max as torch.minimum / torch.maximum / torch.clamp_min compute them, the
// exact grid-wide max of a step's wavespeeds, and the cooperative launch,
// which the 2-D stable fluids' whole-solve Jacobi kernel
// (stam2d_lin_solve.cu) and FLIP's grid phase (flip_grid.cu) use too,
// their grids asked once and kept.
//
// The grid-wide max.  Every wavespeed is >= +0, and for non-negative IEEE
// values the order of the bit patterns is the order of the values, so a
// block max followed by atomicMax on the bits (zero-extended to 64 bits for
// float) is the exact max, whatever the order the atomics land in.  Bit
// atomics drop NaN, so a flag beside the bits records whether any
// wavespeed was NaN; the max read back is then NaN, as torch.max's is.
// Each step uses its own slot of three, rotated one step ahead (the tiled
// kernels' notes say how: burgers_multistep.cu), folded and read with
// tiles.cuh's block_max_add and slot_max_read.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace fst {

namespace cg = cooperative_groups;

constexpr int kStepThreads = 256;  // threads a block of the K-step kernels
constexpr int kMaxSlots = 3;

// torch.maximum / clamp_min on CUDA: NaN if either is NaN, else ::max.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

__device__ __forceinline__ unsigned long long to_bits(float v) {
  return (unsigned long long)__float_as_uint(v);
}
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float((unsigned int)b);
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

// A thread's running max of the wavespeeds it saw, and whether one was NaN.
template <typename T>
struct LocalMax {
  T m = T(0);
  bool nan = false;
  __device__ __forceinline__ void add(T s) {
    if (s != s)
      nan = true;
    else
      m = fmax(m, s + T(0));  // + 0 makes a -0 wavespeed +0
  }
};

__device__ __forceinline__ void grid_max_clear(unsigned long long* slots,
                                               int slot) {
  slots[2 * slot] = 0ull;
  slots[2 * slot + 1] = 0ull;
}

// Periodic index i mod n in [0, n), for the small offsets of a stencil
// (one pass of each loop unless n is smaller than the offset).
__device__ __forceinline__ int wrap1(int i, int n) {
  while (i < 0) i += n;
  while (i >= n) i -= n;
  return i;
}

// The blocks of a cooperative launch of `kernel` with `threads` threads and
// `smem` bytes of dynamic shared memory a block: `want` blocks, capped at
// the blocks that can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, asked with the same
// `threads` and `smem`): a cooperative launch past that is refused.
// Returns the CUDA error code; a failed query leaves no error behind for the
// next launch's check.
template <typename Kernel>
int cooperative_blocks(Kernel kernel, long long want, int device, int* grid,
                       size_t smem = 0, int threads = kStepThreads) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) return (int)cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  // With shared memory, ask for the largest shared-memory carveout, so that
  // the launch gets the carveout the occupancy query counted on (left to
  // the CUDA runtime, a later launch may get a smaller one and hold fewer
  // blocks an SM than the grid needs); above 48 KB with the kernel's static
  // shared memory, allow the device's largest block (less the static
  // part), once, so that no query lowers what another launch of the
  // kernel needs.
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int optin = 0;
  cudaFuncAttributes fa{};
  if (err == cudaSuccess && smem > 0) err = cudaFuncGetAttributes(&fa, kernel);
  const bool large = smem + fa.sharedSizeBytes > 48 * 1024;
  if (err == cudaSuccess && large)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess && large)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  *grid = (int)(want < cap ? want : cap);
  return 0;
}

// The grid of a cooperative launch of `kernel` that walks `cells` cells in
// grid-stride loops: one block of kStepThreads threads per kStepThreads
// cells, capped as cooperative_blocks caps it.
template <typename Kernel>
int cooperative_grid(Kernel kernel, long long cells, int device, int* grid) {
  return cooperative_blocks(kernel, (cells + kStepThreads - 1) / kStepThreads,
                            device, grid);
}

// Launches `kernel(args)` cooperatively on `grid` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory a block (a grid from
// cooperative_blocks or cooperative_grid, asked with the same `threads` and
// `smem`).  Returns the CUDA error code.
template <typename Kernel, typename Args>
int launch_cooperative_on(Kernel kernel, const Args& args, int grid,
                          int device, void* stream, size_t smem = 0,
                          int threads = kStepThreads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {(void*)&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(threads), params, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch also sets the last error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace fst
