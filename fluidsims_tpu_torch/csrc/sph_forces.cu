// SPH pressure-gradient + Monaghan viscosity forces, gravity, and the
// symplectic Euler step with restitution walls, for float and double.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/sph_pallas.py::
// _forces_kernel (pallas_call at :267), which fused the same forces and
// integrate over (4, K, 128)-lane VMEM blocks with sentinel slots and halo
// blocks.  Here, as in sph_density.cu, one thread per sorted position walks
// the first min(count, K) members of the 3x3 neighbour cells.  A pair is
// skipped when it is the thread's own particle (by index) and when
// r^2 >= (2h)^2 or r^2 <= 1e-16 (sph_pallas.py:158-160).  The pressure term
// is -m (p_i/rho_i^2 + p_j/rho_j^2) from the density kernel's per-particle
// p/rho^2, the viscosity term Monaghan's (:166-181), both times gradW.
// Then gravity and the fused integrate (:190-203) with dt read from device
// memory, as the TPU kernel read it from SMEM: dt never goes to the host.
// Positions with rank >= K, which no pair sum sees, take the zero-pair-
// force + gravity integrate of sph_pallas.py:319-327 in the same launch.
// Output pos and vel (n, 2) in particle order.
//
// What bounds it on an H100: the pair arithmetic, ~45 operations a
// candidate pair with an IEEE square root and two divisions (the same
// candidate pairs as the density kernel), and the latency of the neighbour
// loads (4 T + 2 T a neighbour, one broadcast per warp as in the density
// kernel).  The writes in particle order are scattered, 4 T a particle.
#include "sph.cuh"

namespace fst {
namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
forces_kernel(const V4<T>* __restrict__ fields, const V2<T>* __restrict__ rp,
              const int* __restrict__ starts, const int* __restrict__ order,
              const T* __restrict__ dt_ptr, SPHParams p,
              T* __restrict__ pos_out, T* __restrict__ vel_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.n) return;
  const V4<T> me = fields[s];
  const int c = cell_of(me.x, me.y, p);
  T ax = T(0), ay = T(0);
  if (s - __ldg(starts + c) < p.K) {
    const int gx = c % p.Gx, gy = c / p.Gx;
    const T inv_h = T(p.inv_h), alpha = T(p.alpha), two_h = T(p.two_h);
    const T four_h2 = T(p.four_h2), m = T(p.mass), neg_m = T(-p.mass);
    const T visc_coef = T(p.visc_coef), eps_h2 = T(p.eps_h2);
    const V2<T> mine = rp[s];
    const T rho_i = nmax(mine.a, T(1e-30));
    const T pt_i = mine.b;
    for (int oy = -1; oy <= 1; ++oy) {
      for (int ox = -1; ox <= 1; ++ox) {
        int b, e;
        if (!stored_range(starts, gx + ox, gy + oy, p, &b, &e)) continue;
        T px = T(0), py = T(0);
        for (int j = b; j < e; ++j) {
          if (j == s) continue;
          const V4<T> o = fields[j];
          const T dx = me.x - o.x;
          const T dy = me.y - o.y;
          const T r2 = dx * dx + dy * dy;
          if (!(r2 < four_h2 && r2 > T(1e-16))) continue;
          const T r2s = nmax(r2, T(1e-30));
          const T inv_r = T(1) / sqrt(r2s);
          const T r = r2s * inv_r;
          const T q = r * inv_h;
          T dwdq;
          if (q < T(1)) {
            dwdq = alpha * (T(-3) * q + T(2.25) * q * q);
          } else {
            const T t = T(2) - q;
            dwdq = alpha * (T(-0.75) * (t * t));
          }
          const bool ok = (r > T(1e-8)) && (r < two_h);
          const T scale = ok ? dwdq * inv_h * inv_r : T(0);

          const V2<T> oj = rp[j];
          T common = neg_m * (pt_i + oj.b);
          if (p.use_visc) {
            const T dot = (me.vx - o.vx) * dx + (me.vy - o.vy) * dy;
            if (dot < T(0)) {
              const T rho_bar = T(0.5) * (rho_i + nmax(oj.a, T(1e-30)));
              const T pi = visc_coef * dot / ((r2 + eps_h2) * rho_bar);
              common = common - m * pi;
            }
          }
          const T cc = common * scale;
          px += cc * dx;
          py += cc * dy;
        }
        ax += px;
        ay += py;
      }
    }
  }
  if (p.use_grav) ay = ay - T(p.gravity);

  const T dt = *dt_ptr;
  const T e = T(0.2);
  T vx = me.vx + ax * dt;
  T vy = me.vy + ay * dt;
  T x = me.x + vx * dt;
  T y = me.y + vy * dt;
  const T bx = T(p.box_x), by = T(p.box_y);
  const bool lo_x = x < T(0), hi_x = x > bx;
  const bool lo_y = y < T(0), hi_y = y > by;
  x = lo_x ? T(0) : (hi_x ? bx : x);
  y = lo_y ? T(0) : (hi_y ? by : y);
  if (lo_x || hi_x) vx = -e * vx;
  if (lo_y || hi_y) vy = -e * vy;
  const int idx = __ldg(order + s);
  pos_out[2 * idx] = x;
  pos_out[2 * idx + 1] = y;
  vel_out[2 * idx] = vx;
  vel_out[2 * idx + 1] = vy;
}

template <typename T>
int launch_forces(const T* fields, const T* rp, const int* starts,
                  const int* order, const T* dt, const SPHParams* p,
                  T* pos_out, T* vel_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  forces_kernel<T><<<(p->n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const V4<T>*>(fields),
      reinterpret_cast<const V2<T>*>(rp), starts, order, dt, *p, pos_out,
      vel_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_sph_forces_f32(const float* fields, const float* rp,
                       const int* starts, const int* order, const float* dt,
                       const fst::SPHParams* p, float* pos_out,
                       float* vel_out, int device, void* stream) {
  return fst::launch_forces<float>(fields, rp, starts, order, dt, p, pos_out,
                                   vel_out, device, stream);
}

int fst_sph_forces_f64(const double* fields, const double* rp,
                       const int* starts, const int* order, const double* dt,
                       const fst::SPHParams* p, double* pos_out,
                       double* vel_out, int device, void* stream) {
  return fst::launch_forces<double>(fields, rp, starts, order, dt, p, pos_out,
                                    vel_out, device, stream);
}

}  // extern "C"
