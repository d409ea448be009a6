// Masked max-wavespeed reduction of the 3-D hypersonic solver, for float
// and double: `max_wavespeed` of fluidsims_tpu_torch/solvers/
// hypersonic3d.py, the max over fluid cells of
// (|u|+a)/dx + (|v|+a)/dy + (|w|+a)/dz with non-finite sums and solid
// cells counted as 0.
//
// The TPU build has no Pallas kernel for this part: the JAX step takes it
// as a masked jnp.max in XLA (fluidsims_tpu/solvers/hypersonic3d.py:
// 913-918) next to the Pallas cell update (kernels/hypersonic3d_pallas.py::
// _band_kernel).  Here it keeps dt on the device: the result stays in a
// one-element device tensor that the dτ feedback reads, and no value
// crosses to the host.
//
// Each thread (grid-stride) keeps the largest finite sum of its fluid
// cells; every candidate is a non-negative number (0 to start), whose bit
// pattern orders as an unsigned integer, so the block maxima combine with
// one atomicMax on the bits per block.  Max is order-free: the result is
// bitwise the plain version's.
//
// What bounds it on an H100: bytes.  It reads five fields and the mask
// once (5 x 67 MB + 17 MB = 352 MB at 256^3 f32, ~0.105 ms at 3.35 TB/s)
// with ~20 operations a cell.
#include "hypersonic3d.cuh"

namespace fst {
namespace {

constexpr int kThreads3 = 256;

template <typename T> struct Bits3;
template <> struct Bits3<float> {
  using U = unsigned int;
  static __device__ U of(float v) { return __float_as_uint(v); }
};
template <> struct Bits3<double> {
  using U = unsigned long long;
  static __device__ U of(double v) { return (U)__double_as_longlong(v); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads3)
wavespeed3_kernel(const T* __restrict__ r, const T* __restrict__ u,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const T* __restrict__ p, const uint8_t* __restrict__ solid,
                  typename Bits3<T>::U* __restrict__ out_bits, size_t n,
                  Gas3<T> g, T dx, T dy, T dz) {
  T best = T(0);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (solid[i]) continue;
    const T a = soundspeed(r[i], p[i], g);
    const T s = ((dabs(u[i]) + a) / dx + (dabs(v[i]) + a) / dy) +
                (dabs(w[i]) + a) / dz;
    if (isfinite(s) && s > best) best = s;
  }

  __shared__ T red[kThreads3];
  red[threadIdx.x] = best;
  __syncthreads();
  for (int k = kThreads3 / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k && red[threadIdx.x + k] > red[threadIdx.x])
      red[threadIdx.x] = red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicMax(out_bits, Bits3<T>::of(red[0]));
}

template <typename T>
int launch_wavespeed3(const T* r, const T* u, const T* v, const T* w,
                      const T* p, const uint8_t* solid, T* out,
                      const Hyp3DParams* prm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // bits 0 (= +0.0) start the max
  err = cudaMemsetAsync(out, 0, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)prm->nz * prm->ny * prm->nx;
  const size_t want = (n + kThreads3 - 1) / kThreads3;
  const int blocks = (int)(want < 2048 ? want : 2048);
  wavespeed3_kernel<T><<<blocks, kThreads3, 0, s>>>(
      r, u, v, w, p, solid,
      reinterpret_cast<typename Bits3<T>::U*>(out), n, gas3_of<T>(*prm),
      T(prm->d[0]), T(prm->d[1]), T(prm->d[2]));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_hyp3d_wavespeed_f32(const float* r, const float* u, const float* v,
                            const float* w, const float* p,
                            const uint8_t* solid, float* out,
                            const fst::Hyp3DParams* prm, int device,
                            void* stream) {
  return fst::launch_wavespeed3<float>(r, u, v, w, p, solid, out, prm, device,
                                       stream);
}

int fst_hyp3d_wavespeed_f64(const double* r, const double* u, const double* v,
                            const double* w, const double* p,
                            const uint8_t* solid, double* out,
                            const fst::Hyp3DParams* prm, int device,
                            void* stream) {
  return fst::launch_wavespeed3<double>(r, u, v, w, p, solid, out, prm,
                                        device, stream);
}

}  // extern "C"
