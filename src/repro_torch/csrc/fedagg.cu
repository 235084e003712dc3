// fedagg — federated weighted aggregation (paper Eq. 1) over a client stack.
//
//   out[p] = sum_k w[k] * x[k, p]                                (plain form)
//   out[p] = base[p] + scale * sum_k w[k] * (x[k, p] - base[p])  (delta form)
//
// Replaces the Pallas TPU kernel `repro/kernels/fedagg.py::fedagg`
// (`_fedagg_kernel`). The TPU kernel walks P in sequential grid steps of
// (K, 4096) VMEM slabs; here blocks run in parallel over P and each thread
// owns output elements, looping over the K clients with an f32
// accumulator, so nothing crosses blocks and no second pass is needed.
// The delta form is the exact per-element form of the reference's
// `weighted_delta_update` (FedBuff), so the staleness-discounted server
// update is one pass too. x is read as the (K, P) buffer it already is:
// no copy like the reference's `jnp.concatenate` in `fedagg_pytree`.
//
// Bound on the H100: bytes. K*P reads (+ P for base) and P writes for 2*K*P
// flops. At the simulator's shape (K = 10, P = 46,639, f32) that is
// 2.05 MB, or 0.61 us at 3.35 TB/s; the stack was just written and sits
// in the 50 MB L2. So a launch is its fixed cost (an empty launch costs
// 1.7-1.9 us back to back, 4.5-5.0 us with a CUDA event on each side) plus
// the few memory round trips of each thread. At K = 100 it is 18.8 MB,
// 5.6 us.
//
// Design: neighbouring threads read neighbouring p for each k, so every
// load of x is coalesced whatever P's alignment (femnist_mlp's rows of
// 46,639 f32 start off 16 bytes), and P = 46,639 outputs make ~11 warps
// an SM; the compiler unrolls the k loop into rounds of 4 rows in flight.
// The K weights are read through the read-only cache. Warm at K = 100
// this loop already streams the stack out of L2 at ~4.7 TB/s (18.8 MB in
// ~4 us past the 1.7-1.9-us floor of a launch run back to back).
//
// Redesigns measured against this loop, each in the same process on an
// H100 80GB HBM3 at 700 W (f32, P = 46,639, CUDA events around each
// launch, an empty launch 4.5-5.0 us so timed); none was faster at both
// K = 10 (the simulator's) and K = 100, so the loop stays:
// - the rows of a group of 16 clients all in flight before the sum: at
//   K = 10 warm 5.54-5.98 us against 5.79-6.21 with one timer and
//   6.21-6.40 against 6.24 with another; cold 6.14-6.98 against
//   7.01-7.49; at K = 100 warm 9.4-20.3 against 8.7-9.2 (4-130 %
//   slower);
// - each output split among 2-8 client lanes whose separately rounded
//   products the first lane sums from shared memory in k order (~12 rows
//   in flight a thread at K = 100): cold at K = 100 14.3-14.6 against
//   14.9-15.0, warm 12.9-13.0 against 9.1-9.2, as one warp in eight does
//   each block's serial sum;
// - 2 or 4 consecutive outputs a thread (fewer warps to hide the
//   latency), (K, tile) slabs staged through a ring of shared-memory
//   stages with `cp.async` (instruction-bound), loads that skip L1 (the
//   rows' unaligned edges are shared by neighbouring warps through L1), a
//   grid sized to the card (the same 183 blocks at this P): none faster
//   at K = 10 warm.
// TMA fits no odd-width stack at all: a bulk copy needs a 16-byte aligned
// source and size, a tensor map a row stride that is a multiple of 16
// bytes, and a row of 46,639 f32 is 186,556 bytes.
// The sum runs over k in order with explicitly rounded operations (no FMA
// contraction), so f32 results are bitwise those of the same torch ops.
//
// Batched form (`fedagg_batched_*`), for the batched scenario sweep
// (`repro/sim/batched.py`, which vmaps `weighted_delta_update` over a
// scenario axis): x (S, K, P), w (S, K), base (S, P), and a per-scenario
// server learning rate `scale` (S,) read on the card; out (S, P). The
// scenario is the grid's second dimension and each block runs the loop
// above over its scenario's stack, so one launch aggregates a whole
// batch: at S = 32, K = 10, P = 47,887 f32 the delta form moves 73.6 MB,
// 22 us at 3.35 TB/s, where 32 launches of the unbatched kernel would pay
// 32 launch floors. A scenario whose weights are all zero gets base back
// (base + scale * 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, bool BASE>
__global__ void fedagg_kernel(const T* __restrict__ x,
                              const float* __restrict__ w,
                              const T* __restrict__ base, float scale,
                              T* __restrict__ out, int K, int64_t P) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    float acc = 0.0f;
    if (BASE) {
      const float b = to_f32(base[p]);
      for (int k = 0; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k),
                                       __fsub_rn(to_f32(x[k * P + p]), b)));
      out[p] = from_f32<T>(__fadd_rn(b, __fmul_rn(scale, acc)));
    } else {
      for (int k = 0; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), to_f32(x[k * P + p])));
      out[p] = from_f32<T>(acc);
    }
  }
}

// Scenario s of S: x + s*K*P, w + s*K, base + s*P, scale[s], out + s*P;
// each scenario's loop is fedagg_kernel's (kept as its own kernel above,
// so the unbatched launch's machine code stays as measured).
template <typename T, bool BASE>
__global__ void fedagg_batched_kernel(const T* __restrict__ x,
                                      const float* __restrict__ w,
                                      const T* __restrict__ base,
                                      const float* __restrict__ scale,
                                      T* __restrict__ out, int S, int K,
                                      int64_t P) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const T* xs = x + (int64_t)s * K * P;
    const float* ws = w + (int64_t)s * K;
    T* os = out + (int64_t)s * P;
    for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < P;
         p += stride) {
      float acc = 0.0f;
      if (BASE) {
        const float b = to_f32(base[(int64_t)s * P + p]);
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, __fmul_rn(__ldg(ws + k),
                                         __fsub_rn(to_f32(xs[k * P + p]), b)));
        os[p] = from_f32<T>(__fadd_rn(b, __fmul_rn(__ldg(scale + s), acc)));
      } else {
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, __fmul_rn(__ldg(ws + k), to_f32(xs[k * P + p])));
        os[p] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* base, float scale,
           void* out, int K, int64_t P, int device, void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int64_t blocks = (P + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (base != nullptr)
    fedagg_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(base), scale, static_cast<T*>(out), K, P);
  else
    fedagg_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), nullptr, scale,
        static_cast<T*>(out), K, P);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

template <typename T>
int launch_batched(const void* x, const void* w, const void* base,
                   const void* scale, void* out, int S, int K, int64_t P,
                   int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int64_t blocks = (P + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)(S < 65535 ? S : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (base != nullptr)
    fedagg_batched_kernel<T, true><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(base), static_cast<const float*>(scale),
        static_cast<T*>(out), S, K, P);
  else
    fedagg_batched_kernel<T, false><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), nullptr,
        nullptr, static_cast<T*>(out), S, K, P);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). `base` may be null (plain form).
// Return cudaGetLastError() after the launch: 0 on success.
extern "C" int fedagg_f32(const void* x, const void* w, const void* base,
                          float scale, void* out, int K, int64_t P, int device,
                          void* stream) {
  return launch<float>(x, w, base, scale, out, K, P, device, stream);
}

extern "C" int fedagg_bf16(const void* x, const void* w, const void* base,
                           float scale, void* out, int K, int64_t P,
                           int device, void* stream) {
  return launch<__nv_bfloat16>(x, w, base, scale, out, K, P, device, stream);
}

// The batched form: x (S, K, P), w (S, K), base (S, P) or null, scale (S,)
// f32 on the card (read only with base), out (S, P).
extern "C" int fedagg_batched_f32(const void* x, const void* w,
                                  const void* base, const void* scale,
                                  void* out, int S, int K, int64_t P,
                                  int device, void* stream) {
  return launch_batched<float>(x, w, base, scale, out, S, K, P, device,
                               stream);
}

extern "C" int fedagg_batched_bf16(const void* x, const void* w,
                                   const void* base, const void* scale,
                                   void* out, int S, int K, int64_t P,
                                   int device, void* stream) {
  return launch_batched<__nv_bfloat16>(x, w, base, scale, out, S, K, P,
                                       device, stream);
}
