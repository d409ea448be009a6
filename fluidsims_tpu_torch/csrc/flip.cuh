// What the FLIP/APIC transfer kernels share (flip_p2g.cu, flip_g2p.cu): the
// linear hat weight, the clip, and the bilinear sample of two (n, n)
// grids, each written in the operation order of the plain PyTorch version
// (solvers/flip_apic.py::_w1, _sample), so that with -fmad=false the
// kernels round as it does.
#pragma once

#include <cuda_runtime.h>

namespace fst {

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

// One axis of a bilinear sample at particle coordinate p (sample_grid,
// :186-200): g = clip(p * (n - 1), 0, hi) with hi = n - 1.001 in T, the
// base node i0 = floor(g), the far one i1 = min(i0 + 1, n - 1), the
// fraction t = g - i0 and o = 1 - t.  The index clamp only keeps a
// non-finite coordinate inside the grid (a NaN converts to 0).
template <typename T>
struct FlipAxis {
  int i0, i1;
  T t, o;
};

template <typename T>
__device__ __forceinline__ FlipAxis<T> flip_axis(T p, T nm1, T hi, int n) {
  const T g = flip_clip(p * nm1, T(0), hi);
  FlipAxis<T> a;
  a.i0 = flip_clampi((int)floor(g), 0, n - 1);
  a.i1 = min(a.i0 + 1, n - 1);
  a.t = g - T(a.i0);
  a.o = T(1) - a.t;
  return a;
}

// The bilinear blend (1 - tx)((1 - ty) f00 + ty f01) + tx((1 - ty) f10 +
// ty f11) of the values f<x><y> at (y.i<y>, x.i<x>).
template <typename T>
__device__ __forceinline__ T flip_blend(const FlipAxis<T>& x,
                                        const FlipAxis<T>& y, T f00, T f01,
                                        T f10, T f11) {
  return x.o * (y.o * f00 + y.t * f01) + x.t * (y.o * f10 + y.t * f11);
}

}  // namespace fst
