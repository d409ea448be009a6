// What the FLIP/APIC transfer kernels share (flip_p2g.cu, flip_g2p.cu): the
// linear hat weight, the clip, and the bilinear sample of two (n, n)
// grids, each written in the operation order of the plain PyTorch version
// (solvers/flip_apic.py::_w1, _sample), so that with -fmad=false the
// kernels round as it does.
#pragma once

#include <cuda_runtime.h>

namespace fst {

constexpr int kFlipThreads = 256;  // threads a block of the particle kernels

// Linear hat weight (tau_flip_apic.cu w1, :67-70): 1 - |x| inside |x| < 1.
template <typename T>
__device__ __forceinline__ T flip_w1(T x) {
  const T ax = fabs(x);
  return ax < T(1) ? T(1) - ax : T(0);
}

// torch.clamp / jnp.clip: NaN passes through.
template <typename T>
__device__ __forceinline__ T flip_clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ int flip_clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// Bilinear sample of u and v at particle coordinates (px, py) (sample_grid,
// :186-200): g = clip(p * (n - 1), 0, hi) with hi = n - 1.001 in T, the
// base corner floor(g) and the far one min(base + 1, n - 1), blended as
// (1 - tx)((1 - ty) f00 + ty f01) + tx((1 - ty) f10 + ty f11).  The grids
// are read-only for the whole launch.
template <typename T>
__device__ __forceinline__ void flip_sample(const T* __restrict__ u,
                                            const T* __restrict__ v, T px,
                                            T py, int n, T nm1, T hi, T& su,
                                            T& sv) {
  const T gx = flip_clip(px * nm1, T(0), hi);
  const T gy = flip_clip(py * nm1, T(0), hi);
  // the index clamp only keeps a non-finite coordinate inside the grid
  const int i0 = flip_clampi((int)floor(gx), 0, n - 1);
  const int j0 = flip_clampi((int)floor(gy), 0, n - 1);
  const int i1 = min(i0 + 1, n - 1);
  const int j1 = min(j0 + 1, n - 1);
  const T tx = gx - T(i0), ty = gy - T(j0);
  const T ox = T(1) - tx, oy = T(1) - ty;
  const size_t r0 = (size_t)j0 * n, r1 = (size_t)j1 * n;
  su = ox * (oy * __ldg(u + r0 + i0) + ty * __ldg(u + r1 + i0)) +
       tx * (oy * __ldg(u + r0 + i1) + ty * __ldg(u + r1 + i1));
  sv = ox * (oy * __ldg(v + r0 + i0) + ty * __ldg(v + r1 + i0)) +
       tx * (oy * __ldg(v + r0 + i1) + ty * __ldg(v + r1 + i1));
}

}  // namespace fst
