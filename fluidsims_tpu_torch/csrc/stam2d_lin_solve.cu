// The whole Jacobi solve of the 2-D stable fluids in one launch, for float
// and double: `iters` sweeps out = (b + a * sum4(x)) / c over an (n, n)
// interior whose zero ring is implicit (neighbours outside read 0).
//
// Replaces the TPU kernel fluidsims_tpu/kernels/stam2d_pallas.py::
// _lin_solve_kernel (pallas_call at :80), which held x and b in VMEM and
// ran every sweep there, so that only x, b and the result crossed HBM.  A
// block of an H100 cannot hold a 512^2 field, so the sweeps are spread
// over the whole card and separated by grid syncs: one cooperative launch
// (csrc/grid_reduce.cuh) per solve, grid-stride loops over the cells.  The
// sweeps ping-pong between out and one scratch field, the first reading
// x, with the parity chosen so that the last sweep writes out: any count,
// odd too, and x, the state's warm start, is never written.  a and c are
// launch arguments, as the Pallas kernel's SMEM scalars are, so the
// diffusion and pressure solves share one build.  sum4 is summed in the
// plain version's order (rows j-1, j+1, then columns i-1, i+1, zeros
// added where the ring is; solvers/stam2d.py::_sum4) and c divides truly,
// so with -fmad=false the result is bitwise that of the plain version.
//
// What bounds it on an H100: bytes, once.  A launch must read x and b and
// write out (3 MiB at 512^2 f32, ~0.94 us at 3.35 TB/s); the sweeps between
// read and write the 1 MiB fields in L2 (50 MB).  What sets its pace is
// the grid sync between sweeps, `iters - 1` a launch: a first, correct
// kernel; several sweeps a sync (halos in shared memory) is later work.
// Fields written during the launch are read with plain loads, not __ldg:
// the read-only cache is not coherent with other blocks' writes.
#include <cuda_runtime.h>

#include "grid_reduce.cuh"

namespace fst {
namespace {

template <typename T>
struct LinSolveArgs {
  const T* x;     // warm start, read by the first sweep only
  const T* b;
  T* out;
  T* scratch;     // the other ping-pong field (unused when iters == 1)
  int n;
  int iters;
  T a;
  T c;
};

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
lin_solve_kernel(LinSolveArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int n = p.n;
  const long long cells = (long long)n * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T zero = T(0);
  const T* src = p.x;
  for (int k = 0; k < p.iters; ++k) {
    T* dst = ((p.iters - 1 - k) % 2 == 0) ? p.out : p.scratch;
    for (long long s = first; s < cells; s += stride) {
      const int j = (int)(s / n);
      const int i = (int)(s - (long long)j * n);
      const T up = j > 0 ? src[s - n] : zero;
      const T dn = j < n - 1 ? src[s + n] : zero;
      const T lf = i > 0 ? src[s - 1] : zero;
      const T rt = i < n - 1 ? src[s + 1] : zero;
      const T sum = up + dn + lf + rt;
      dst[s] = (__ldg(p.b + s) + p.a * sum) / p.c;
    }
    if (k + 1 < p.iters) grid.sync();
    src = dst;
  }
}

template <typename T>
int lin_solve_grid(int n, int device, int* grid) {
  return cooperative_grid(lin_solve_kernel<T>, (long long)n * n, device,
                          grid);
}

template <typename T>
int launch_lin_solve(const T* x, const T* b, T* out, T* scratch, int n,
                     double a, double c, int iters, int grid, int device,
                     void* stream) {
  const LinSolveArgs<T> args{x, b, out, scratch, n, iters, T(a), T(c)};
  return launch_cooperative_on(lin_solve_kernel<T>, args, grid, device,
                               stream);
}

}  // namespace
}  // namespace fst

extern "C" {

// The grid (blocks) of a solve on an (n, n) field: the wrapper asks once
// per (n, dtype, device) and passes it to every launch.
int fst_stam2d_lin_solve_grid_f32(int n, int device, int* grid) {
  return fst::lin_solve_grid<float>(n, device, grid);
}

int fst_stam2d_lin_solve_grid_f64(int n, int device, int* grid) {
  return fst::lin_solve_grid<double>(n, device, grid);
}

int fst_stam2d_lin_solve_f32(const float* x, const float* b, float* out,
                             float* scratch, int n, double a, double c,
                             int iters, int grid, int device, void* stream) {
  return fst::launch_lin_solve<float>(x, b, out, scratch, n, a, c, iters,
                                      grid, device, stream);
}

int fst_stam2d_lin_solve_f64(const double* x, const double* b, double* out,
                             double* scratch, int n, double a, double c,
                             int iters, int grid, int device, void* stream) {
  return fst::launch_lin_solve<double>(x, b, out, scratch, n, a, c, iters,
                                       grid, device, stream);
}

}  // extern "C"
