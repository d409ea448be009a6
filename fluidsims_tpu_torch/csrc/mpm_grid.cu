// The grid update of MLS-MPM, for float and double: from the P2G grids
// (mass, mom_x, mom_y) to the node velocities (gu, gv), one thread a node.
//
// Replaces the TPU kernel fluidsims_tpu/kernels/mpm_pallas.py::
// _grid_kernel (pallas_call at :206), which held the (Gy, 128) lane-padded
// grids in VMEM.  The update has no solve and no neighbour, so here it is
// a plain launch over the Gy * Gx nodes, the reference's k_grid_update
// (tau_mpm.cu:185-198) in the order of JAX's scatter engine (solvers/
// mpm.py::_grid_update): where mass > 0, u = mom_x / max(mass, 1e-30) and
// v = mom_y / max(mass, 1e-30) - gravity*dt (true divisions), then u = 0
// where the node is in the 3 columns of a side wall and u points out of
// it, v likewise with the 3 rows of the floor and the lid; u = v = 0
// where there is no mass.  With -fmad=false the result is bitwise that of
// the plain version.
//
// What bounds it on an H100: bytes (3 grids in, 2 out: 184 KB at 96^2
// f32, ~0.05 us at 3.35 TB/s, and ~8 operations a node); at these sizes
// the launch itself.  A separate kernel rather than a tail of the P2G:
// the P2G's grids are complete only when every particle has added.
#include <cuda_runtime.h>

#include "mpm.cuh"

namespace fst {
namespace {

template <typename T>
struct GridArgs {
  const T* mass;  // (Gy, Gx)
  const T* mom_x;
  const T* mom_y;
  T* gu;          // (Gy, Gx)
  T* gv;
  int gx, gy;
  T gdt;          // gravity * dt, rounded once from double
};

template <typename T>
__global__ void __launch_bounds__(kMPMThreads) mpm_grid_kernel(
    GridArgs<T> p) {
  const long long cells = (long long)p.gx * p.gy;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= cells) return;
  const int x = (int)(node % p.gx), y = (int)(node / p.gx);
  const T m = __ldg(p.mass + node);
  T u = T(0), v = T(0);
  if (m > T(0)) {
    const T fm = mpm_max(m, T(1e-30));
    u = __ldg(p.mom_x + node) / fm;
    v = __ldg(p.mom_y + node) / fm - p.gdt;
    if ((x < 3 && u < T(0)) || (x > p.gx - 4 && u > T(0))) u = T(0);
    if ((y < 3 && v < T(0)) || (y > p.gy - 4 && v > T(0))) v = T(0);
  }
  p.gu[node] = u;
  p.gv[node] = v;
}

template <typename T>
int launch_grid(const T* mass, const T* mom_x, const T* mom_y, T* gu, T* gv,
                int gx, int gy, double gdt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GridArgs<T> args{mass, mom_x, mom_y, gu, gv, gx, gy, T(gdt)};
  const long long blocks = ((long long)gx * gy + kMPMThreads - 1) /
                           kMPMThreads;
  mpm_grid_kernel<T><<<(unsigned)blocks, kMPMThreads, 0,
                       (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

int fst_mpm_grid_f32(const float* mass, const float* mom_x,
                     const float* mom_y, float* gu, float* gv, int gx, int gy,
                     double gdt, int device, void* stream) {
  return fst::launch_grid<float>(mass, mom_x, mom_y, gu, gv, gx, gy, gdt,
                                 device, stream);
}

int fst_mpm_grid_f64(const double* mass, const double* mom_x,
                     const double* mom_y, double* gu, double* gv, int gx,
                     int gy, double gdt, int device, void* stream) {
  return fst::launch_grid<double>(mass, mom_x, mom_y, gu, gv, gx, gy, gdt,
                                  device, stream);
}

}  // extern "C"
