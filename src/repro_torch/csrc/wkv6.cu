// wkv6 — RWKV6/SSD chunked, strict-past, decayed outer-product scan.
//
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,   o_t = r_t^T S_{t-1}
//
// with the (K, V) state S carried across chunks of L steps. Per chunk,
// with logc the inclusive and logb = logc - logw the exclusive cumulative
// log decay (both per state row k):
//   inter  o[t]   = (r[t] exp(logb[t])) S
//   intra  o[t]  += sum_{i<t} A[t,i] v[i],
//          A[t,i] = sum_k r[t,k] k[i,k] exp(min(logb[t,k] - logc[i,k], 0))
//   carry  S      = S exp(logc[L-1]) + sum_i (k[i] exp(logc[L-1] - logc[i]))^T v[i]
// Every exponent is <= 0, so nothing overflows however strong the decay.
//
// Replaces the Pallas TPU kernel `repro/kernels/wkv6.py::wkv6`
// (`_wkv6_kernel`). The TPU kernel walks the chunks as its innermost
// sequential grid dimension with S in VMEM scratch; blocks on the card do
// not run in order, so here one block owns one (b, h) and loops over the
// chunks itself, with S in shared memory the whole time. A chunk's r, k,
// logw and v tiles are loaded into shared memory (widened through any
// strides: the SSD heads pass k and logw as stride-0 broadcasts), the
// cumulative logs are taken per state row, then the block computes the
// intra scores A, the outputs and the new state in three passes separated
// by barriers. The rows of a ragged last chunk are zero-filled (r = k =
// v = 0, logw = 0), which leaves the state unchanged: the reference's zero
// padding, with no copy of the inputs. The (L, K) tiles are padded to
// K + 1 floats a row so that threads reading consecutive rows of one
// column hit distinct banks.
//
// Bound on the H100: bytes. At the serving shape (B=4, H=50, T=2048,
// K=16, V=64) the inputs and outputs are 0.29 GB against about 5 K V
// flops a step (0.01 TFLOP): 0.09 ms at 3.35 TB/s. This first kernel
// reads each tile with plain loads and no prefetch of the next chunk, and
// the B * H = 200 blocks each walk 32 chunks in sequence, so latency and
// the per-chunk barriers, not bandwidth, set its time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides4 {
  long long b, h, t, x;                 // in elements
};

__device__ __forceinline__ float at(const float* p, const Strides4& s,
                                    int b, int h, int t, int x) {
  return p[b * s.b + h * s.h + t * s.t + x * s.x];
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ s0, float* __restrict__ o,
            float* __restrict__ sT, Strides4 sr, Strides4 sk, Strides4 sv,
            Strides4 sw, Strides4 ss, Strides4 so, Strides4 st, int H,
            int T, int K, int V, int L) {
  const int KP = K + 1;                 // padded row of the (L, K) tiles
  extern __shared__ float sm[];
  float* S = sm;                        // [K][V] the carried state
  float* R = S + K * V;                 // [L][KP] r, then r exp(logb)
  float* Kt = R + L * KP;               // [L][KP] k, then k exp(total - logc)
  float* LC = Kt + L * KP;              // [L][KP] logw, then logc
  float* LB = LC + L * KP;              // [L][KP] logb = logc - logw
  float* Vt = LB + L * KP;              // [L][V]
  float* A = Vt + L * V;                // [L][L + 1] intra-chunk scores

  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;

  for (int e = tid; e < K * V; e += kThreads)
    S[e] = at(s0, ss, b, h, e / V, e % V);

  for (int c0 = 0; c0 < T; c0 += L) {
    __syncthreads();                    // the last chunk is consumed
    for (int e = tid; e < L * K; e += kThreads) {
      const int t = e / K, x = e % K, e2 = t * KP + x;
      const bool in = c0 + t < T;
      R[e2] = in ? at(r, sr, b, h, c0 + t, x) : 0.0f;
      Kt[e2] = in ? at(k, sk, b, h, c0 + t, x) : 0.0f;
      LC[e2] = in ? at(w, sw, b, h, c0 + t, x) : 0.0f;
    }
    for (int e = tid; e < L * V; e += kThreads) {
      const int t = e / V, y = e % V;
      Vt[e] = c0 + t < T ? at(v, sv, b, h, c0 + t, y) : 0.0f;
    }
    __syncthreads();

    // Cumulative logs, one state row per thread.
    for (int x = tid; x < K; x += kThreads) {
      float c = 0.0f;
      for (int t = 0; t < L; ++t) {
        const float lw = LC[t * KP + x];
        c += lw;
        LC[t * KP + x] = c;
        LB[t * KP + x] = c - lw;
      }
    }
    __syncthreads();

    // Intra-chunk scores, strict lower triangle.
    for (int e = tid; e < L * L; e += kThreads) {
      const int t = e / L, i = e % L;
      float a = 0.0f;
      if (i < t) {
        const float* rt = R + t * KP;
        const float* bt = LB + t * KP;
        const float* ki = Kt + i * KP;
        const float* ci = LC + i * KP;
        for (int x = 0; x < K; ++x)
          a += rt[x] * ki[x] * expf(fminf(bt[x] - ci[x], 0.0f));
      }
      A[t * (L + 1) + i] = a;
    }
    __syncthreads();

    // Queries decayed to the chunk start; keys decayed to the chunk end.
    const float* total = LC + (L - 1) * KP;
    for (int e = tid; e < L * K; e += kThreads) {
      const int e2 = (e / K) * KP + e % K;
      R[e2] *= expf(LB[e2]);
      Kt[e2] *= expf(total[e % K] - LC[e2]);
    }
    __syncthreads();

    // Outputs: inter-chunk against S, plus intra-chunk.
    for (int e = tid; e < L * V; e += kThreads) {
      const int t = e / V, y = e % V;
      if (c0 + t >= T) continue;
      float inter = 0.0f, intra = 0.0f;
      for (int x = 0; x < K; ++x) inter += R[t * KP + x] * S[x * V + y];
      for (int i = 0; i < t; ++i) intra += A[t * (L + 1) + i] * Vt[i * V + y];
      o[b * so.b + h * so.h + (c0 + t) * so.t + y * so.x] = inter + intra;
    }
    __syncthreads();

    // Carry the state to the next chunk.
    for (int e = tid; e < K * V; e += kThreads) {
      const int x = e / V, y = e % V;
      float acc = 0.0f;
      for (int i = 0; i < L; ++i) acc += Kt[i * KP + x] * Vt[i * V + y];
      S[e] = S[e] * expf(total[x]) + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < K * V; e += kThreads)
    sT[b * st.b + h * st.h + (e / V) * st.t + (e % V) * st.x] = S[e];
}

}  // namespace

// C entry point (bound with ctypes). strides: (b, h, t, x) of r, k, v,
// logw, s0, o, s_final in elements (for s0 and s_final: b, h, K, V).
// Returns the launch's CUDA error: 0 on success.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* s0, void* o, void* sT,
                        const int64_t* st, int B, int H, int T, int K, int V,
                        int L, int device, void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides4 s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides4{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  const int bytes = (int)sizeof(float) *
                    (K * V + 4 * L * (K + 1) + L * V + L * (L + 1));
  err = cudaFuncSetAttribute(wkv6_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) {
    wkv6_kernel<<<B * H, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(s0), static_cast<float*>(o),
        static_cast<float*>(sT), s[0], s[1], s[2], s[3], s[4], s[5], s[6], H,
        T, K, V, L);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
