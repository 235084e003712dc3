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
//
// Extended form (`prox_sgd_rows_*`), for the batched scenario sweep
// (`repro/sim/batched.py`, which vmaps the client update over scenarios
// with a per-scenario mu and per-scenario anchors): one launch over the
// R = S * Cpad rows of a whole batch of scenarios. `mu` may be an (R,)
// f32 vector, read once per vector by its row (twice where the vector
// straddles two rows, each element taking its own row's). The anchor may
// be grouped: w0 is (G, P) and row r reads anchor row r / (R / G), so a
// batch of synchronous scenarios anchors each scenario's Cpad rows on its
// own global model without an (R, P) broadcast; G = R is the per-client
// form and a (P,) anchor the shared one. A grouped anchor row does not
// line up with the flat stack's 16-byte vectors (P is odd), so it is read
// element by element through the read-only path, like the shared one; it
// adds G * P reads, 6 MB at S = 32 against the stack's 184 MB. The forms
// are template parameters: the unextended entry points instantiate the
// same code as before.

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

// How row r finds its anchor: one shared (P,) anchor, its own row of an
// (R, P) stack, or row r / group of a (G, P) stack.
enum Anchor { kShared = 0, kPerRow = 1, kGrouped = 2 };

// n = R * P elements; packs of N (P >= N). One pack a thread and pass.
// MU_ROWS: mu is the (R,) vector `mu_rows`, else the scalar `mu`.
template <typename T, int N, int ANCHOR, bool MU_ROWS>
__global__ void __launch_bounds__(kThreads)
    prox_sgd_kernel(T* __restrict__ w, const T* __restrict__ g,
                    const T* __restrict__ w0,
                    const int32_t* __restrict__ steps, int step, int64_t P,
                    int64_t n, bool narrow, float lr, float mu,
                    int64_t group, const float* __restrict__ mu_rows) {
  using V = Pack<T, N>;
  const int64_t nv = n / N;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < nv; v += static_cast<int64_t>(gridDim.x) * kThreads) {
    // The pack's row, its offset in the row, and whether the rows of its
    // first (lo) and last (hi) elements are live: a masked pack is neither
    // read nor written.
    const int64_t e = v * N, c = row_of(e, P, narrow), off = e - c * P;
    const bool straddle = off + N > P;
    const bool lo = step < __ldg(steps + c);
    const bool hi = straddle ? step < __ldg(steps + c + 1) : lo;
    if (!(lo || hi)) continue;
    const int64_t first = P - off;   // elements in the first row
    // Every load before any arithmetic.
    V wv = reinterpret_cast<const V*>(w)[v];
    const V gv = __ldg(reinterpret_cast<const V*>(g) + v);
    V av;
    T an[N];
    if constexpr (ANCHOR == kShared) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t p = off + j;
        an[j] = __ldg(w0 + (p < P ? p : p - P));
      }
    } else if constexpr (ANCHOR == kGrouped) {
      const T* a_lo = w0 + row_of(c, group, narrow) * P;
      const T* a_hi = straddle ? w0 + row_of(c + 1, group, narrow) * P : a_lo;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t p = off + j;
        an[j] = p < P ? __ldg(a_lo + p) : __ldg(a_hi + (p - P));
      }
    } else {
      av = __ldg(reinterpret_cast<const V*>(w0) + v);
    }
    float mu_lo = mu, mu_hi = mu;
    if constexpr (MU_ROWS) {
      mu_lo = __ldg(mu_rows + c);
      mu_hi = straddle ? __ldg(mu_rows + c + 1) : mu_lo;
    }
    // The step; a live pack goes back as one store, a pack that straddles
    // a live and a masked row element by element.
    T* we = reinterpret_cast<T*>(&wv);
    const T* ge = reinterpret_cast<const T*>(&gv);
    const T* ae = ANCHOR == kPerRow ? reinterpret_cast<const T*>(&av) : an;
#pragma unroll
    for (int j = 0; j < N; ++j)
      we[j] = step_one(we[j], ge[j], ae[j], lr, j < first ? mu_lo : mu_hi);
    if (lo && hi) {
      reinterpret_cast<V*>(w)[v] = wv;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < first ? lo : hi) w[e + j] = we[j];
    }
  }
  // The flat tail past the last whole pack: fewer than N elements.
  if (N > 1 && blockIdx.x == 0) {
    const int64_t e = nv * N + threadIdx.x;
    if (e < n) {
      const int64_t c = row_of(e, P, narrow), p = e - c * P;
      const int64_t a = ANCHOR == kShared   ? p
                        : ANCHOR == kPerRow ? e
                                            : row_of(c, group, narrow) * P + p;
      if (step < __ldg(steps + c))
        w[e] = step_one(w[e], __ldg(g + e), __ldg(w0 + a), lr,
                        MU_ROWS ? __ldg(mu_rows + c) : mu);
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

// Everything a launch passes on to the kernel.
template <typename T>
struct Args {
  T* w;
  const T* g;
  const T* w0;
  const int32_t* steps;
  int step;
  int64_t C, P;
  float lr, mu;
  int64_t group;
  const float* mu_rows;
};

template <typename T, int N, int ANCHOR, bool MU_ROWS>
cudaError_t run(const Args<T>& a, int device, cudaStream_t stream) {
  static std::atomic<int> cap[kMaxDevices];
  int max_blocks = 0;
  const cudaError_t err = resident_blocks(
      prox_sgd_kernel<T, N, ANCHOR, MU_ROWS>, device, cap, &max_blocks);
  if (err != cudaSuccess) return err;
  const int64_t n = a.C * a.P;
  const int64_t per_block = static_cast<int64_t>(kThreads) * N;
  const int64_t chunks = std::max<int64_t>(1, (n + per_block - 1) / per_block);
  const int64_t passes = (chunks + max_blocks - 1) / max_blocks;
  const int64_t blocks = (chunks + passes - 1) / passes;
  prox_sgd_kernel<T, N, ANCHOR, MU_ROWS>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          a.w, a.g, a.w0, a.steps, a.step, a.P, n, n <= UINT32_MAX, a.lr,
          a.mu, a.group, a.mu_rows);
  return cudaGetLastError();
}

template <typename T, int N, int ANCHOR>
cudaError_t run_mu(const Args<T>& a, int device, cudaStream_t stream) {
  return a.mu_rows != nullptr ? run<T, N, ANCHOR, true>(a, device, stream)
                              : run<T, N, ANCHOR, false>(a, device, stream);
}

template <typename T, int N>
cudaError_t run_anchor(const Args<T>& a, int anchor, int device,
                       cudaStream_t stream) {
  switch (anchor) {
    case kShared: return run_mu<T, N, kShared>(a, device, stream);
    case kPerRow: return run_mu<T, N, kPerRow>(a, device, stream);
    default: return run_mu<T, N, kGrouped>(a, device, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const Args<T>& a, int anchor, int device, void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int N = 16 / sizeof(T);
  // Only a per-row anchor is read as vectors of the flat stack.
  const bool vec = a.P >= N && aligned16(a.w) && aligned16(a.g) &&
                   (anchor != kPerRow || aligned16(a.w0));
  err = vec ? run_anchor<T, N>(a, anchor, device, s)
            : run_anchor<T, 1>(a, anchor, device, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

template <typename T>
int launch_plain(void* w, const void* g, const void* w0, int64_t w0_stride,
                 const void* steps, int step, int C, int64_t P, float lr,
                 float mu, int device, void* stream) {
  const Args<T> a{static_cast<T*>(w), static_cast<const T*>(g),
                  static_cast<const T*>(w0),
                  static_cast<const int32_t*>(steps), step, C, P, lr, mu,
                  0, nullptr};
  return launch<T>(a, w0_stride == 0 ? kShared : kPerRow, device, stream);
}

// group: 0 for one shared (P,) anchor, else the rows that share one row of
// the (R / group, P) anchor stack (1: per row).
template <typename T>
int launch_rows(void* w, const void* g, const void* w0, int64_t group,
                const void* mu_rows, const void* steps, int step, int R,
                int64_t P, float lr, float mu, int device, void* stream) {
  const Args<T> a{static_cast<T*>(w), static_cast<const T*>(g),
                  static_cast<const T*>(w0),
                  static_cast<const int32_t*>(steps), step, R, P, lr, mu,
                  group, static_cast<const float*>(mu_rows)};
  const int anchor = group == 0 ? kShared : group == 1 ? kPerRow : kGrouped;
  return launch<T>(a, anchor, device, stream);
}

}  // namespace

// C entry points (bound with ctypes). Return cudaGetLastError() after the
// launch: 0 on success.
extern "C" int prox_sgd_f32(void* w, const void* g, const void* w0,
                            int64_t w0_stride, const void* steps, int step,
                            int C, int64_t P, float lr, float mu, int device,
                            void* stream) {
  return launch_plain<float>(w, g, w0, w0_stride, steps, step, C, P, lr, mu,
                             device, stream);
}

extern "C" int prox_sgd_bf16(void* w, const void* g, const void* w0,
                             int64_t w0_stride, const void* steps, int step,
                             int C, int64_t P, float lr, float mu, int device,
                             void* stream) {
  return launch_plain<__nv_bfloat16>(w, g, w0, w0_stride, steps, step, C, P,
                                     lr, mu, device, stream);
}

// The extended form: anchor row group and an optional (R,) f32 mu vector
// (null: the scalar mu).
extern "C" int prox_sgd_rows_f32(void* w, const void* g, const void* w0,
                                 int64_t group, const void* mu_rows,
                                 const void* steps, int step, int R,
                                 int64_t P, float lr, float mu, int device,
                                 void* stream) {
  return launch_rows<float>(w, g, w0, group, mu_rows, steps, step, R, P, lr,
                            mu, device, stream);
}

extern "C" int prox_sgd_rows_bf16(void* w, const void* g, const void* w0,
                                  int64_t group, const void* mu_rows,
                                  const void* steps, int step, int R,
                                  int64_t P, float lr, float mu, int device,
                                  void* stream) {
  return launch_rows<__nv_bfloat16>(w, g, w0, group, mu_rows, steps, step, R,
                                    P, lr, mu, device, stream);
}
