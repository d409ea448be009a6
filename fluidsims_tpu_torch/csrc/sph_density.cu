// SPH density + log-density Tait EOS per particle, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/sph_pallas.py::
// _density_kernel (pallas_call at :257).  That kernel held the particles of
// 128 cells per block in a (2, K, 128) lane-dense VMEM layout, with
// sentinel positions in empty slots and whole halo blocks on both sides, and
// summed dense (K, K) pair blocks.  Here the particles are already sorted
// by cell (sph_bin.cu), so there is no dense layout, no sentinel and no
// halo, and no cell capacity K: one thread per sorted position walks every
// member of the 3x3 neighbour cells (the self pair included, as in the
// reference's linked lists, tau_sph.cu:165-176) and sums m W(r).  Then, per particle, as sph_pallas.py:
// 103-118 does: s = log(max(rho, 1e-6)), rho = exp(s), the Tait pressure
// (the gamma_eos == 1 branch skips the power), and p / rho^2, which the
// forces kernel adds per pair.  Output rp (n, 2) = (rho, p / rho^2) in
// sorted order, for every particle.
//
// What bounds it on an H100: the pair arithmetic, ~20 operations a
// candidate pair, and the latency of the neighbour loads.  The candidate
// pairs depend on the data: the sum over cells of count times the sum of
// count over the 3x3 cells around it (~10^8 at 65,536 particles piled at
// the floor of the box, ~10^8 at 2^20).  Threads of one warp sit mostly in one cell
// and walk the same neighbours in step, so each neighbour load is one
// broadcast; the per-particle bytes (4 T in, 2 T out) are small beside it.
#include "sph.cuh"

namespace fst {
namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
density_kernel(const V4<T>* __restrict__ fields,
               const int* __restrict__ starts, SPHParams p,
               V2<T>* __restrict__ rp) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.n) return;
  const V4<T> me = fields[s];
  const int c = cell_of(me.x, me.y, p);
  const int gx = c % p.Gx, gy = c / p.Gx;
  const T inv_h = T(p.inv_h), alpha = T(p.alpha), alpha_q = T(p.alpha_q);

  T rho = T(0);
  for (int oy = -1; oy <= 1; ++oy) {
    for (int ox = -1; ox <= 1; ++ox) {
      int b, e;
      if (!cell_range(starts, gx + ox, gy + oy, p, &b, &e)) continue;
      T part = T(0);
      for (int j = b; j < e; ++j) {
        const V4<T> o = fields[j];
        const T dx = me.x - o.x;
        const T dy = me.y - o.y;
        const T q = sqrt(dx * dx + dy * dy) * inv_h;
        const T q2 = q * q;
        T w = T(0);
        if (q < T(1)) {
          w = alpha * (T(1) - T(1.5) * q2 + T(0.75) * q2 * q);
        } else if (q < T(2)) {
          const T t = T(2) - q;
          w = alpha_q * t * t * t;
        }
        part += w;
      }
      rho += part;
    }
  }
  rho = T(p.mass) * rho;

  const T sl = log(nmax(rho, T(1e-6)));
  rho = exp(sl);
  const T ratio = rho * T(p.inv_rho0);
  const T powed = p.gamma_is_one ? ratio : exp(T(p.gamma_eos) * log(ratio));
  const T press =
      nmax(T(p.c0sq_rho0) * (powed - T(1)) / T(p.gamma_eos), T(0));
  const T rs = nmax(rho, T(1e-30));
  rp[s] = {rho, press / (rs * rs)};
}

template <typename T>
int launch_density(const T* fields, const int* starts, const SPHParams* p,
                   T* rp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  density_kernel<T><<<(p->n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      reinterpret_cast<const V4<T>*>(fields), starts, *p,
      reinterpret_cast<V2<T>*>(rp));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_sph_density_f32(const float* fields, const int* starts,
                        const fst::SPHParams* p, float* rp, int device,
                        void* stream) {
  return fst::launch_density<float>(fields, starts, p, rp, device, stream);
}

int fst_sph_density_f64(const double* fields, const int* starts,
                        const fst::SPHParams* p, double* rp, int device,
                        void* stream) {
  return fst::launch_density<double>(fields, starts, p, rp, device, stream);
}

}  // extern "C"
