// The grid phase of FLIP/APIC in one launch, for float and double: from the
// P2G grids (mass, mom_u, mom_v) to u_prev, v_prev (normalized, gravity,
// wall clamps) and the projected u_proj, v_proj, through the divergence
// and `jacobi` Jacobi pressure sweeps from p = 0, on any (n, n) grid.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/flip_pallas.py::
// _grid_kernel (pallas_call at :287), which held the 128^2 grids in VMEM
// and ran every phase there.  A block of an H100 cannot hold the f64 set
// (or a large n), so the phases are spread over the whole card and
// separated by grid syncs: one cooperative launch (csrc/grid_reduce.cuh),
// grid-stride loops over the cells, a sync after the normalize-and-clamp
// phase, after the divergence and after every sweep (jacobi + 2 in all).
// The arithmetic is JAX's XLA function (solvers/flip_apic.py::_grid_phase,
// :181-224), not the Pallas kernel's (which multiplies by 0.5/(n - 1)):
//   u = mom_u / max(mass, 1e-8) where mass > 1e-8 (else mom_u), v likewise
//   minus gravity*dt; u = 0 on the columns 0 and n - 1, v = 0 on those
//   rows; div = -0.5 (n - 1) ((u_E - u_W) + v_N - v_S) on the interior;
//   p <- 0.25 ((((div + p_W) + p_E) + p_S) + p_N) on the interior, the
//   ring 0; u_proj = u - (0.5 (p_E - p_W)) / (n - 1), v_proj likewise, a
//   true division, and a zero ring.
// With those orders and -fmad=false the result is bitwise that of the
// plain version.  p ping-pongs between two scratch fields zeroed in the
// first phase (their rings are never written); div is a third.  Fields
// written during the launch are read with plain loads, not __ldg.
//
// What bounds it on an H100: in bytes, little (3 grids in, 4 out: 448 KiB
// at 128^2 f32, ~0.13 us at 3.35 TB/s; the scratch lives in L2); in
// operations, ~260 a cell at 48 sweeps.  What sets its pace is the
// jacobi + 2 grid syncs, a few microseconds each: a first, correct
// kernel; several sweeps a sync, or one block in shared memory where the
// grid fits, is later work.
#include <cuda_runtime.h>

#include "grid_reduce.cuh"

namespace fst {
namespace {

template <typename T>
struct GridArgs {
  const T* mass;
  const T* mom_u;
  const T* mom_v;
  T* u_prev;
  T* v_prev;
  T* u_proj;
  T* v_proj;
  T* div;     // scratch (n, n): the divergence (interior only)
  T* pa;      // scratch (n, n) x 2: the pressure ping-pong, zero rings
  T* pb;
  int n;
  int jacobi;
  T gdt;      // gravity * dt, rounded once from double
};

template <typename T>
__global__ void __launch_bounds__(kStepThreads) grid_kernel(GridArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int n = p.n;
  const long long cells = (long long)n * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T zero = T(0), eps = T(1e-8), nm1 = T(n - 1);

  // normalize + gravity + wall clamps (k_normalize_forces, :133-150)
  for (long long s = first; s < cells; s += stride) {
    const int j = (int)(s / n);
    const int i = (int)(s - (long long)j * n);
    const T m = __ldg(p.mass + s);
    const T mm = m < eps ? eps : m;   // torch.clamp_min: NaN passes
    const bool has = m > eps;
    const T mu = __ldg(p.mom_u + s), mv = __ldg(p.mom_v + s);
    T u = has ? mu / mm : mu;
    T v = has ? mv / mm - p.gdt : mv;
    if (i == 0 || i == n - 1) u = zero;
    if (j == 0 || j == n - 1) v = zero;
    p.u_prev[s] = u;
    p.v_prev[s] = v;
    p.pa[s] = zero;
    p.pb[s] = zero;
  }
  grid.sync();

  // divergence on the interior (k_divergence, :152-161)
  const T cdiv = T(-0.5 * (double)(n - 1));
  for (long long s = first; s < cells; s += stride) {
    const int j = (int)(s / n);
    const int i = (int)(s - (long long)j * n);
    if (j < 1 || j > n - 2 || i < 1 || i > n - 2) continue;
    const T* u = p.u_prev;
    const T* v = p.v_prev;
    p.div[s] = cdiv * (((u[s + 1] - u[s - 1]) + v[s + n]) - v[s - n]);
  }
  grid.sync();

  // Jacobi pressure (k_jacobi, :162-172) from p = 0; rings stay 0
  const T quarter = T(0.25);
  const T* src = p.pa;
  for (int k = 0; k < p.jacobi; ++k) {
    T* dst = (k % 2 == 0) ? p.pb : p.pa;
    for (long long s = first; s < cells; s += stride) {
      const int j = (int)(s / n);
      const int i = (int)(s - (long long)j * n);
      if (j < 1 || j > n - 2 || i < 1 || i > n - 2) continue;
      dst[s] = quarter *
               ((((p.div[s] + src[s - 1]) + src[s + 1]) + src[s - n]) +
                src[s + n]);
    }
    grid.sync();
    src = dst;
  }

  // projection on the interior (k_project, :173-184); zero ring
  const T half = T(0.5);
  for (long long s = first; s < cells; s += stride) {
    const int j = (int)(s / n);
    const int i = (int)(s - (long long)j * n);
    if (j < 1 || j > n - 2 || i < 1 || i > n - 2) {
      p.u_proj[s] = zero;
      p.v_proj[s] = zero;
      continue;
    }
    p.u_proj[s] = p.u_prev[s] - (half * (src[s + 1] - src[s - 1])) / nm1;
    p.v_proj[s] = p.v_prev[s] - (half * (src[s + n] - src[s - n])) / nm1;
  }
}

template <typename T>
int grid_blocks(int n, int device, int* grid) {
  return cooperative_grid(grid_kernel<T>, (long long)n * n, device, grid);
}

template <typename T>
int launch_grid(const T* mass, const T* mom_u, const T* mom_v, T* u_prev,
                T* v_prev, T* u_proj, T* v_proj, T* scratch, int n,
                int jacobi, double gdt, int grid, int device, void* stream) {
  const size_t cells = (size_t)n * n;
  const GridArgs<T> args{mass,   mom_u,   mom_v,           u_prev,
                         v_prev, u_proj,  v_proj,          scratch,
                         scratch + cells, scratch + 2 * cells, n,
                         jacobi, T(gdt)};
  return launch_cooperative_on(grid_kernel<T>, args, grid, device, stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// The grid (blocks) of the launch on an (n, n) grid: the wrapper asks once
// per (n, dtype, device) and passes it to every launch.
int fst_flip_grid_blocks_f32(int n, int device, int* grid) {
  return fst::grid_blocks<float>(n, device, grid);
}

int fst_flip_grid_blocks_f64(int n, int device, int* grid) {
  return fst::grid_blocks<double>(n, device, grid);
}

// scratch holds 3 (n, n) fields.
int fst_flip_grid_f32(const float* mass, const float* mom_u,
                      const float* mom_v, float* u_prev, float* v_prev,
                      float* u_proj, float* v_proj, float* scratch, int n,
                      int jacobi, double gdt, int grid, int device,
                      void* stream) {
  return fst::launch_grid<float>(mass, mom_u, mom_v, u_prev, v_prev, u_proj,
                                 v_proj, scratch, n, jacobi, gdt, grid,
                                 device, stream);
}

int fst_flip_grid_f64(const double* mass, const double* mom_u,
                      const double* mom_v, double* u_prev, double* v_prev,
                      double* u_proj, double* v_proj, double* scratch, int n,
                      int jacobi, double gdt, int grid, int device,
                      void* stream) {
  return fst::launch_grid<double>(mass, mom_u, mom_v, u_prev, v_prev, u_proj,
                                  v_proj, scratch, n, jacobi, gdt, grid,
                                  device, stream);
}

}  // extern "C"
