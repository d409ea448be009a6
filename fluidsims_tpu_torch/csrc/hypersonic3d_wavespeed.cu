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
// What bounds it on an H100: bytes.  It reads five fields and the mask
// once (5 x 67 MB + 17 MB = 352 MB at 256^3 f32, ~0.105 ms at 3.35 TB/s)
// with ~20 operations a cell; at 64^3 (5.5 MB, in L2 after the step) a
// launch's fixed cost.  The design:
//
// * 16-byte loads: a thread takes kVec cells at a time (4 f32, 2 f64)
//   from each of the five fields, with their kVec mask bytes in one load,
//   in a grid-stride loop over whole vectors; the cells before the first
//   vector (where the six tensors start inside one) and after the last go
//   one at a time.  Tensors whose starts lie at different places inside a
//   vector (views at odd offsets) go one cell at a time;
// * every candidate is a non-negative number (0 to start), whose bit
//   pattern orders as an unsigned integer: a warp takes the max of the
//   bits (__reduce_max_sync in f32, shuffles in f64), the block's warps
//   one exchange through shared memory;
// * no memset: each block takes the max of its bits into one word of a
//   two-word scratch and, after a fence, adds one to the other (the count
//   of blocks done); the block that counts last swaps the word for 0,
//   writes the 0-d result and zeroes the count for the next launch.  The
//   wrapper keeps the scratch per device, stream and grid shape, zeroed
//   when made, so that launches on one scratch never overlap;
// * the blocks: as many as the card keeps resident at once, or fewer.
//   (A slot a block folded by the last one, and one cell a thread where
//   whole vectors leave resident threads idle, measured slower at 64^3.)
//
// Max is order-free: the result is bitwise the plain version's.
#include "hypersonic3d.cuh"

#ifndef FST_WS3_THREADS
#define FST_WS3_THREADS 256
#endif
namespace fst {
namespace {

constexpr int kWs3Threads = FST_WS3_THREADS;
constexpr int kWs3Warps = kWs3Threads / 32;
static_assert(kWs3Threads % 32 == 0 && kWs3Warps <= 32,
              "whole warps, at most 32");

template <typename T> struct Ws3;
template <> struct Ws3<float> {
  static constexpr int kVec = 4;
  using V = float4;
  using M = uchar4;
  using U = unsigned int;
  static __device__ U bits(float v) { return __float_as_uint(v); }
  static __device__ float value(U b) { return __uint_as_float(b); }
  static __device__ U warp_max(U b) {
    return __reduce_max_sync(0xffffffffu, b);
  }
};
template <> struct Ws3<double> {
  static constexpr int kVec = 2;
  using V = double2;
  using M = uchar2;
  using U = unsigned long long;
  static __device__ U bits(double v) { return (U)__double_as_longlong(v); }
  static __device__ double value(U b) { return __longlong_as_double((long long)b); }
  static __device__ U warp_max(U b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const U x = __shfl_xor_sync(0xffffffffu, b, o);
      b = x > b ? x : b;
    }
    return b;
  }
};

template <typename T>
struct Ws3Args {
  const T* r;
  const T* u;
  const T* v;
  const T* w;
  const T* p;
  const uint8_t* solid;
  size_t n;       // cells
  size_t head;    // cells before the first vector (n: no vectors)
  size_t nvec;    // whole vectors from `head`
  unsigned long long* word;     // the max bits so far; 0 between launches
  unsigned long long* counter;  // blocks done; 0 between launches
  T* out;
  Gas3<T> g;
  T dx, dy, dz;
};

// best, or the cell's sum where that is finite, larger, and the cell is
// fluid
template <typename T>
__device__ __forceinline__ T cell_max(T best, T r, T u, T v, T w, T p,
                                      bool solid, const Ws3Args<T>& A) {
  const T a = soundspeed(r, p, A.g);
  const T s = ((dabs(u) + a) / A.dx + (dabs(v) + a) / A.dy) +
              (dabs(w) + a) / A.dz;
  return (!solid && isfinite(s) && s > best) ? s : best;
}

template <typename T>
__device__ __forceinline__ T cell_at(T best, size_t i, const Ws3Args<T>& A) {
  return cell_max(best, A.r[i], A.u[i], A.v[i], A.w[i], A.p[i],
                  A.solid[i] != 0, A);
}

// The block's max bits, in every thread.
template <typename T>
__device__ __forceinline__ typename Ws3<T>::U block_max(
    typename Ws3<T>::U b, typename Ws3<T>::U* wmax) {
  using W = Ws3<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  b = W::warp_max(b);
  if (lane == 0) wmax[warp] = b;
  __syncthreads();
  b = lane < kWs3Warps ? wmax[lane] : typename W::U(0);
  return W::warp_max(b);
}

template <typename T>
__global__ void __launch_bounds__(kWs3Threads)
wavespeed3_kernel(const Ws3Args<T> A) {
  using W = Ws3<T>;
  using U = typename W::U;
  using V = typename W::V;
  using M = typename W::M;
  constexpr int kVec = W::kVec;
  const size_t stride = (size_t)gridDim.x * kWs3Threads;
  const size_t gtid = (size_t)blockIdx.x * kWs3Threads + threadIdx.x;

  T best = T(0);
  for (size_t i = gtid; i < A.head; i += stride) best = cell_at(best, i, A);
  {
    const V* r = reinterpret_cast<const V*>(A.r + A.head);
    const V* u = reinterpret_cast<const V*>(A.u + A.head);
    const V* v = reinterpret_cast<const V*>(A.v + A.head);
    const V* w = reinterpret_cast<const V*>(A.w + A.head);
    const V* p = reinterpret_cast<const V*>(A.p + A.head);
    const M* m = reinterpret_cast<const M*>(A.solid + A.head);
    for (size_t k = gtid; k < A.nvec; k += stride) {
      const V rk = r[k], uk = u[k], vk = v[k], wk = w[k], pk = p[k];
      const M mk = m[k];
      best = cell_max(best, rk.x, uk.x, vk.x, wk.x, pk.x, mk.x != 0, A);
      best = cell_max(best, rk.y, uk.y, vk.y, wk.y, pk.y, mk.y != 0, A);
      if constexpr (kVec == 4) {
        best = cell_max(best, rk.z, uk.z, vk.z, wk.z, pk.z, mk.z != 0, A);
        best = cell_max(best, rk.w, uk.w, vk.w, wk.w, pk.w, mk.w != 0, A);
      }
    }
  }
  for (size_t i = A.head + A.nvec * kVec + gtid; i < A.n; i += stride)
    best = cell_at(best, i, A);

  __shared__ U wmax[kWs3Warps];
  const U b = block_max<T>(W::bits(best), wmax);
  if (threadIdx.x == 0) {
    atomicMax(A.word, (unsigned long long)b);
    // every block's max reaches the word before its count
    __threadfence();
    if (atomicAdd(A.counter, 1ull) == gridDim.x - 1) {
      *A.out = W::value((U)atomicExch(A.word, 0ull));
      *A.counter = 0;
    }
  }
}

// The blocks that the card keeps resident at once, a device and dtype.
template <typename T>
int resident_blocks(int device, int* blocks) {
  static int cached[64];
  int* c = device >= 0 && device < 64 ? &cached[device] : nullptr;
  if (c && *c > 0) {
    *blocks = *c;
    return 0;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wavespeed3_kernel<T>, kWs3Threads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (c) *c = *blocks;
  return 0;
}

// Cells before the first whole vector when all six tensors start at the
// same place inside one, else n (no vectors).
template <typename T>
size_t vector_head(const T* const* fields, const uint8_t* solid, size_t n) {
  constexpr int kVec = Ws3<T>::kVec;
  const uintptr_t first = (uintptr_t)fields[0];
  if (first % sizeof(T)) return n;
  const uintptr_t off = (first / sizeof(T)) % kVec;
  for (int k = 1; k < 5; ++k) {
    const uintptr_t a = (uintptr_t)fields[k];
    if (a % sizeof(T) || (a / sizeof(T)) % kVec != off) return n;
  }
  if ((uintptr_t)solid % kVec != off) return n;
  const size_t head = (kVec - off) % kVec;
  return head < n ? head : n;
}

template <typename T>
int launch_wavespeed3(const T* r, const T* u, const T* v, const T* w,
                      const T* p, const uint8_t* solid, T* out,
                      unsigned long long* scratch, const Hyp3DParams* prm,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)prm->nz * prm->ny * prm->nx;
  const T* fields[5] = {r, u, v, w, p};
  const size_t head = vector_head(fields, solid, n);
  const size_t nvec = (n - head) / Ws3<T>::kVec;
  const size_t units = head < n ? (nvec > head ? nvec : head) : n;
  int resident = 0;
  if (int e = resident_blocks<T>(device, &resident)) return e;
  size_t blocks = (units + kWs3Threads - 1) / kWs3Threads;
  if (blocks > (size_t)resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  Ws3Args<T> A{r, u, v, w, p, solid, n, head, nvec, scratch, scratch + 1,
               out, gas3_of<T>(*prm), T(prm->d[0]), T(prm->d[1]),
               T(prm->d[2])};
  wavespeed3_kernel<T><<<(unsigned)blocks, kWs3Threads, 0,
                         (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fst

extern "C" {

// `scratch`: two words, zeroed when made, kept for the launches of one
// grid shape on one stream (the max bits so far, the blocks done).
int fst_hyp3d_wavespeed_f32(const float* r, const float* u, const float* v,
                            const float* w, const float* p,
                            const uint8_t* solid, float* out,
                            unsigned long long* scratch,
                            const fst::Hyp3DParams* prm, int device,
                            void* stream) {
  return fst::launch_wavespeed3<float>(r, u, v, w, p, solid, out, scratch,
                                       prm, device, stream);
}

int fst_hyp3d_wavespeed_f64(const double* r, const double* u, const double* v,
                            const double* w, const double* p,
                            const uint8_t* solid, double* out,
                            unsigned long long* scratch,
                            const fst::Hyp3DParams* prm, int device,
                            void* stream) {
  return fst::launch_wavespeed3<double>(r, u, v, w, p, solid, out, scratch,
                                        prm, device, stream);
}

}  // extern "C"
