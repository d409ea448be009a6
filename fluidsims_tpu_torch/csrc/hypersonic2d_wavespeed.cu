// Inflow column + CFL wavespeed reduction of the flagship 2-D hypersonic
// solver, for float and double: `apply_inflow_` followed by
// `max_wavespeed` of fluidsims_tpu_torch/solvers/hypersonic2d.py.
//
// The TPU build has no Pallas kernel for this part: the JAX step computes
// it as plain XLA (fluidsims_tpu/solvers/hypersonic2d.py:401-409,436-447)
// next to the Pallas cell update (kernels/hypersonic2d_pallas.py::
// _band_kernel).  Here it is the reduction that keeps dt on the device: the
// result stays in a one-element device tensor that cfl_dt and then the
// step kernel read, and no value crosses to the host.
//
// In one pass over the grid each thread (grid-stride) writes the inflow
// state into the fluid cells of column `inflow_col`, IN PLACE (idempotent;
// column 0 on one device, the inflow column of an extended slab in a
// sharded run, none for -1), and takes
// max(|u|+a, |v|+a) of every cell with the rules of max_wavespeed: a
// non-finite speed and a solid cell count as 1e-12, and 1e-12 floors the
// result.  Every value is then a positive finite number, whose bit pattern
// orders as an unsigned integer, so the block maxima combine with one
// atomicMax on the bits per block.  Max is order-free: the result is
// bitwise the plain version's.
//
// What bounds it on an H100: bytes.  It reads the four fields and the mask
// once (71 MB at 2048^2 f32, ~21 us at 3.35 TB/s) with a few flops a cell.
#include "euler2d.cuh"

namespace fst {
namespace {

constexpr int kThreads = 256;

template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned int;
  static __device__ U of(float v) { return __float_as_uint(v); }
};
template <> struct Bits<double> {
  using U = unsigned long long;
  static __device__ U of(double v) { return (U)__double_as_longlong(v); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
inflow_wavespeed_kernel(T* __restrict__ rho, T* __restrict__ mx,
                        T* __restrict__ my, T* __restrict__ E,
                        const uint8_t* __restrict__ mask,
                        typename Bits<T>::U* __restrict__ out_bits, int ny,
                        int nx, int inflow_col, Gas<T> g, Q4<T> infl) {
  const T floor_s = T(1e-12);
  T best = floor_s;
  const size_t n = (size_t)ny * nx;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (mask[i]) continue;  // solid: 1e-12, the floor already in `best`
    Q4<T> c;
    if ((int)(i % nx) == inflow_col) {  // inflow column, fluid cell
      c = infl;
      rho[i] = c.r; mx[i] = c.a; my[i] = c.b; E[i] = c.e;
    } else {
      c = {rho[i], mx[i], my[i], E[i]};
    }
    const Q4<T> q = cons_to_prim(c, g);
    const T a = sound_speed(q, g);
    const T s = nmax(dabs(q.a) + a, dabs(q.b) + a);
    if (isfinite(s) && s > best) best = s;
  }

  __shared__ T red[kThreads];
  red[threadIdx.x] = best;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k && red[threadIdx.x + k] > red[threadIdx.x])
      red[threadIdx.x] = red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicMax(out_bits, Bits<T>::of(red[0]));
}

template <typename T>
int launch_wavespeed(T* rho, T* mx, T* my, T* E, const uint8_t* mask,
                     T* out, const Hyp2DParams* p, int inflow_col, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // bits 0 (= +0.0) start the max; every block contributes >= 1e-12
  err = cudaMemsetAsync(out, 0, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)p->ny * p->nx;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 2048 ? want : 2048);
  const Gas<T> g = {T(p->gamma), T(p->gm1)};
  const Q4<T> infl = {T(p->infl[0]), T(p->infl[1]), T(p->infl[2]),
                      T(p->infl[3])};
  inflow_wavespeed_kernel<T><<<blocks, kThreads, 0, s>>>(
      rho, mx, my, E, mask, reinterpret_cast<typename Bits<T>::U*>(out),
      p->ny, p->nx, inflow_col, g, infl);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_hyp2d_inflow_wavespeed_f32(float* rho, float* mx, float* my, float* E,
                                   const uint8_t* mask, float* out,
                                   const fst::Hyp2DParams* p, int inflow_col,
                                   int device, void* stream) {
  return fst::launch_wavespeed<float>(rho, mx, my, E, mask, out, p,
                                      inflow_col, device, stream);
}

int fst_hyp2d_inflow_wavespeed_f64(double* rho, double* mx, double* my,
                                   double* E, const uint8_t* mask, double* out,
                                   const fst::Hyp2DParams* p, int inflow_col,
                                   int device, void* stream) {
  return fst::launch_wavespeed<double>(rho, mx, my, E, mask, out, p,
                                       inflow_col, device, stream);
}

}  // extern "C"
