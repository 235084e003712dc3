// prox_sgd — fused proximal SGD step over a whole round's client stack.
//
//   w[c, p] <- w[c, p] - lr * (g[c, p] + mu * (w[c, p] - w0[c, p]))
//              for every client c with step < steps[c]; other rows untouched.
//
// Replaces the Pallas TPU kernel `repro/kernels/prox_sgd.py::prox_sgd`
// (`_prox_sgd_kernel`), which the reference launches once per leaf per
// client (`repro/kernels/ops.py::prox_sgd_pytree`). Here one launch covers
// the flat (C, P) buffer of every client in the round, and the per-client
// step mask of the reference's masked fori_loop (`repro/core/client.py`,
// `live = i < steps`) is applied in the kernel: a masked row is never
// written (and a vector that lies wholly in masked rows never read), so a
// masked step is an exact no-op.
//
// Bound on the H100: bytes. Each live element reads w and g (and w0, unless
// the anchor is the shared (P,) one) and writes w, for 5 flops — far below
// the card's ~20 flop/B ridge. At the simulator's shape (C = 10,
// P = 46,639, f32, every client live, shared anchor) that is 5.78 MB, or
// 1.7 us at 3.35 TB/s; on the main path the stack was just written and sits
// in the 50 MB L2, so a launch is dominated by its fixed cost and by the
// round trips each thread waits for.
//
// Design: the (C, P) stack is one contiguous array of C*P elements, so w, g
// and a per-client w0 are read and written as 16-byte vectors (4 f32 or
// 8 bf16) whatever P is: femnist_mlp's P = 46,639 is odd, and rows of an
// odd-width stack do not start on 16 bytes, but the flat array does. Only
// the flat tail (fewer than one vector) goes element by element. A
// vector's row, for the step mask and the shared anchor, is its first
// element's index / P; since P is at least the vector width, a vector
// crosses at most one row boundary. A vector that straddles a live and a
// masked row stores its live elements one by one. The shared (P,) anchor
// (a synchronous round's global model, w0_stride = 0) is read element by
// element through the read-only path: its 186 KB stay in L1/L2. Each
// thread takes one vector a pass: it reads the step budgets of the
// vector's rows, then puts all of the vector's loads in flight, then
// computes and stores, so it waits for two round trips (the budgets, the
// data). Masked rows are neither read nor written, which keeps the bytes
// at the live rows' (at C = 100 with 3 in 10 clients masked, 39 MB
// instead of 51 MB); loading the data before the mask is known measured
// no faster at C = 10, and two or four vectors a thread measured slower
// than one (fewer threads to hide the latency). The grid below already
// holds every vector of the C = 10 stack in one pass. The grid is the card's SMs x resident blocks
// (queried once per device), cut to the work and balanced so that every
// block makes the same number of passes. Inputs whose base pointer is not
// on 16 bytes, and P smaller than a vector, take the same kernel one
// element at a time. The arithmetic is f32 with explicitly rounded
// operations (no FMA contraction), in the order of the plain PyTorch
// version, so the f32 results are bitwise those of its torch ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T step_one(T w, T g, T a, float lr, float mu) {
  const float wf = to_f32(w);
  const float inner = __fadd_rn(to_f32(g), __fmul_rn(mu, __fsub_rn(wf, to_f32(a))));
  return from_f32<T>(__fsub_rn(wf, __fmul_rn(lr, inner)));
}

// N elements of T moved as one load or store: a 16-byte vector, or T.
template <typename T, int N>
using Pack = typename std::conditional<N == 1, T, uint4>::type;

// Row of flat element e. `narrow`: every flat index fits 32 bits, so one
// 32-bit division does instead of a 64-bit one.
__device__ __forceinline__ int64_t row_of(int64_t e, int64_t P, bool narrow) {
  return narrow ? static_cast<int64_t>(static_cast<uint32_t>(e) /
                                       static_cast<uint32_t>(P))
                : e / P;
}

// n = C * P elements; packs of N (P >= N). SHARED: w0 is one (P,) anchor,
// else (C, P) like w. One pack a thread and pass.
template <typename T, int N, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    prox_sgd_kernel(T* __restrict__ w, const T* __restrict__ g,
                    const T* __restrict__ w0,
                    const int32_t* __restrict__ steps, int step, int64_t P,
                    int64_t n, bool narrow, float lr, float mu) {
  using V = Pack<T, N>;
  const int64_t nv = n / N;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < nv; v += static_cast<int64_t>(gridDim.x) * kThreads) {
    // The pack's row, its offset in the row, and whether the rows of its
    // first (lo) and last (hi) elements are live: a masked pack is neither
    // read nor written.
    const int64_t e = v * N, c = row_of(e, P, narrow), off = e - c * P;
    const bool lo = step < __ldg(steps + c);
    const bool hi = off + N > P ? step < __ldg(steps + c + 1) : lo;
    if (!(lo || hi)) continue;
    // Every load before any arithmetic.
    V wv = reinterpret_cast<const V*>(w)[v];
    const V gv = __ldg(reinterpret_cast<const V*>(g) + v);
    V av;
    T an[N];
    if constexpr (SHARED) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t p = off + j;
        an[j] = __ldg(w0 + (p < P ? p : p - P));
      }
    } else {
      av = __ldg(reinterpret_cast<const V*>(w0) + v);
    }
    // The step; a live pack goes back as one store, a pack that straddles
    // a live and a masked row element by element.
    T* we = reinterpret_cast<T*>(&wv);
    const T* ge = reinterpret_cast<const T*>(&gv);
    const T* ae = SHARED ? an : reinterpret_cast<const T*>(&av);
#pragma unroll
    for (int j = 0; j < N; ++j) we[j] = step_one(we[j], ge[j], ae[j], lr, mu);
    if (lo && hi) {
      reinterpret_cast<V*>(w)[v] = wv;
    } else {
      const int64_t first = P - off;   // elements in the first row
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < first ? lo : hi) w[e + j] = we[j];
    }
  }
  // The flat tail past the last whole pack: fewer than N elements.
  if (N > 1 && blockIdx.x == 0) {
    const int64_t e = nv * N + threadIdx.x;
    if (e < n) {
      const int64_t c = row_of(e, P, narrow);
      if (step < __ldg(steps + c))
        w[e] = step_one(w[e], __ldg(g + e),
                        __ldg(w0 + (SHARED ? e - c * P : e)), lr, mu);
    }
  }
}

// The card's SMs x resident blocks of `kernel` at kThreads a block, queried
// once per device and then read from `cache`.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int device,
                            std::atomic<int>* cache, int* out) {
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && (*out = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = std::max(1, sms * per_sm);
  if (cached) cache[device].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int N, bool SHARED>
cudaError_t run(T* w, const T* g, const T* w0, const int32_t* steps,
                int step, int64_t C, int64_t P, float lr, float mu,
                int device, cudaStream_t stream) {
  static std::atomic<int> cap[kMaxDevices];
  int max_blocks = 0;
  const cudaError_t err = resident_blocks(prox_sgd_kernel<T, N, SHARED>,
                                          device, cap, &max_blocks);
  if (err != cudaSuccess) return err;
  const int64_t n = C * P;
  const int64_t per_block = static_cast<int64_t>(kThreads) * N;
  const int64_t chunks = std::max<int64_t>(1, (n + per_block - 1) / per_block);
  const int64_t passes = (chunks + max_blocks - 1) / max_blocks;
  const int64_t blocks = (chunks + passes - 1) / passes;
  prox_sgd_kernel<T, N, SHARED><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(w, g, w0, steps, step, P, n,
                                            n <= UINT32_MAX, lr, mu);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(void* w_, const void* g_, const void* w0_, int64_t w0_stride,
           const void* steps_, int step, int C, int64_t P, float lr, float mu,
           int device, void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  T* w = static_cast<T*>(w_);
  const T* g = static_cast<const T*>(g_);
  const T* w0 = static_cast<const T*>(w0_);
  const int32_t* steps = static_cast<const int32_t*>(steps_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int N = 16 / sizeof(T);
  const bool shared = w0_stride == 0;
  const bool vec = P >= N && aligned16(w) && aligned16(g) &&
                   (shared || aligned16(w0));
  if (vec)
    err = shared ? run<T, N, true>(w, g, w0, steps, step, C, P, lr, mu,
                                   device, s)
                 : run<T, N, false>(w, g, w0, steps, step, C, P, lr, mu,
                                    device, s);
  else
    err = shared ? run<T, 1, true>(w, g, w0, steps, step, C, P, lr, mu,
                                   device, s)
                 : run<T, 1, false>(w, g, w0, steps, step, C, P, lr, mu,
                                    device, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). Return cudaGetLastError() after the
// launch: 0 on success.
extern "C" int prox_sgd_f32(void* w, const void* g, const void* w0,
                            int64_t w0_stride, const void* steps, int step,
                            int C, int64_t P, float lr, float mu, int device,
                            void* stream) {
  return launch<float>(w, g, w0, w0_stride, steps, step, C, P, lr, mu, device,
                       stream);
}

extern "C" int prox_sgd_bf16(void* w, const void* g, const void* w0,
                             int64_t w0_stride, const void* steps, int step,
                             int C, int64_t P, float lr, float mu, int device,
                             void* stream) {
  return launch<__nv_bfloat16>(w, g, w0, w0_stride, steps, step, C, P, lr, mu,
                               device, stream);
}
