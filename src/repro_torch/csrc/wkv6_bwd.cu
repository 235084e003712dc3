// wkv6_bwd — the gradient of `wkv6`, the strict-past chunked decayed
// outer-product scan
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t^T S_{t-1},  w = exp(logw)
//
// dr, dk, dv, dlogw and ds0 from the inputs, dO and the gradient of the
// end state. The TPU has no such kernel: the reference trains through
// `jax.grad` of its jnp scan (`repro/models/lm/scan_core.py::
// chunked_decay_scan`). This kernel is the backward of the port's CUDA
// forward (`wkv6.cu`), which stays as it is.
//
// The reverse recurrence dS_{t-1} = r_t dO_t^T + diag(w_t) dS_t is taken
// a chunk of L steps at a time, in the chunked form of the forward. With
// logc the inclusive and logb = logc - logw the exclusive cumulative log
// decay of the chunk, S the chunk's start state and dS the gradient of
// its end state:
//   A[t,i]  = sum_k r[t,k] k[i,k] e[t,i,k],
//             e[t,i,k] = exp(min(logb[t,k] - logc[i,k], 0))
//   dA[t,i] = dO[t] . v[i]                    (both for i < t, else 0)
//   dv[i]   = sum_{t>i} A[t,i] dO[t] + (k[i] exp(logc[L-1] - logc[i]))^T dS
//   dr[t,k] = exp(logb[t,k]) (S dO[t])[k] + sum_{i<t} dA[t,i] k[i,k] e[t,i,k]
//   dk[i,k] = sum_{t>i} dA[t,i] r[t,k] e[t,i,k]
//             + exp(logc[L-1,k] - logc[i,k]) (dS v[i])[k]
//   dS     <- dS exp(logc[L-1]) + sum_t (r[t] exp(logb[t]))^T dO[t]
// and, with q_t = r_t dr_t and p_t = k_t dk_t (elementwise over k), the
// decay's gradient is a suffix sum over the whole sequence,
//   dlogw[s] = sum_{t >= s} (q_t - p_t) - q_s + sum_v dS_T S_T,
// because every term of S_{t-1} carries exp(logc up to t-1) and every use
// of k_i carries exp(-logc up to i). Every exponent is <= 0 and nothing
// is divided by w, so strong decay is as stable as in the forward.
//
// One block per (b, h): a forward pass over the chunks recomputes each
// chunk's start state into a scratch buffer that the wrapper allocates
// (nothing is kept from the forward kernel), then a reverse pass walks the
// chunks from the last, carrying dS (K x V) and the suffix sum (K) in
// shared memory. Within a chunk every output element is one thread's
// dot product over shared-memory tiles. The ragged last chunk is
// zero-filled (r = k = v = dO = 0, logw = 0), as in the forward. All
// math is f32 on the CUDA cores.
//
// Bound on the H100: bytes. At the full-width training shape (B=2, H=50,
// T=2048, K=16, V=64) the SSD heads pass k and logw as broadcast views,
// and the inputs and outputs are ~0.2 GB: ~0.06 ms at 3.35 TB/s. This
// design runs 100 blocks, each sequential over 32 chunks, so latency and
// not bytes bounds it: a chunk-parallel form is a later step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;

struct Strides4 {
  long long b, h, t, x;                 // in elements
};

struct Dims {
  int B, H, T, K, V, L;
};

// Rows of the shared-memory tiles are padded by one float, so that the
// threads of a warp, which walk consecutive rows of a tile, hit distinct
// banks.
__host__ __device__ constexpr int padded(int n) { return n + 1; }

// Floats of shared memory a block uses: r, k, logc, logb, exp(logb),
// exp(logc[L-1] - logc), q, p (L, K); v, dO (L, V); A, dA (L, L); S, dS
// (K, V); the total decay and the suffix sum (K).
__host__ __device__ constexpr int smem_floats(int K, int V, int L) {
  return 8 * L * padded(K) + 2 * L * padded(V) + 2 * L * padded(L) +
         2 * K * padded(V) + 2 * K;
}

// Rows t0 .. t0 + L - 1 of a (T, X) slice with strides (t, x) into a
// padded (L, X) tile; rows at or past T are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long st, long long sx, int t0,
                                          int T, int L, int X) {
  for (int i = threadIdx.x; i < L * X; i += kThreads) {
    const int t = i / X, x = i % X;
    dst[t * padded(X) + x] = t0 + t < T ? src[(t0 + t) * st + x * sx] : 0.0f;
  }
}

// In place: logw -> inclusive cumulative log per column k, summed in order;
// `lb` (if given) the exclusive one; `tot` the chunk's total.
__device__ __forceinline__ void cumulative(float* lc, float* lb, float* tot,
                                           int K, int L) {
  const int KP = padded(K);
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float run = 0.0f;
    for (int t = 0; t < L; ++t) {
      const float w = lc[t * KP + k];
      run += w;
      lc[t * KP + k] = run;
      if (lb) lb[t * KP + k] = run - w;
    }
    tot[k] = run;
  }
}

__global__ void __launch_bounds__(kThreads)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ s0, const float* __restrict__ dout,
                const float* __restrict__ dsT, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ ds0,
                float* __restrict__ states, Strides4 sr, Strides4 sk,
                Strides4 sv, Strides4 sw, Strides4 ss0, Strides4 sg,
                Strides4 sdT, Dims dm) {
  const int K = dm.K, V = dm.V, L = dm.L, T = dm.T;
  const int KP = padded(K), VP = padded(V), LP = padded(L);
  extern __shared__ float smem[];
  float* rs = smem;                     // (L, KP) each
  float* ks = rs + L * KP;
  float* lc = ks + L * KP;
  float* lb = lc + L * KP;
  float* eb = lb + L * KP;              // exp(logb)
  float* ed = eb + L * KP;              // exp(logc[L-1] - logc)
  float* qs = ed + L * KP;
  float* ps = qs + L * KP;
  float* vs = ps + L * KP;              // (L, VP) each
  float* gs = vs + L * VP;
  float* as = gs + L * VP;              // (L, LP) each
  float* das = as + L * LP;
  float* S = das + L * LP;              // (K, VP) each
  float* dS = S + K * VP;
  float* tot = dS + K * VP;             // (K) each
  float* carry = tot + K;

  const int b = blockIdx.x / dm.H, h = blockIdx.x % dm.H;
  const int tid = threadIdx.x;
  const int n_chunks = (T + L - 1) / L;
  const float* rb = r + b * sr.b + h * sr.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const float* gb = dout + b * sg.b + h * sg.h;
  float* st = states + (long long)blockIdx.x * n_chunks * K * V;
  const long long out_kb = (long long)blockIdx.x * T * K;   // dense outputs
  const long long out_vb = (long long)blockIdx.x * T * V;

  // ---- forward: each chunk's start state into `states`.
  for (int i = tid; i < K * V; i += kThreads)
    S[(i / V) * VP + i % V] =
        s0[b * ss0.b + h * ss0.h + (i / V) * ss0.t + (i % V) * ss0.x];
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();
    for (int i = tid; i < K * V; i += kThreads)
      st[(long long)c * K * V + i] = S[(i / V) * VP + i % V];
    load_rows(ks, kb, sk.t, sk.x, t0, T, L, K);
    load_rows(lc, wb, sw.t, sw.x, t0, T, L, K);
    load_rows(vs, vb, sv.t, sv.x, t0, T, L, V);
    __syncthreads();
    cumulative(lc, nullptr, tot, K, L);
    __syncthreads();
    // k[i] decayed to the chunk's end, in place.
    for (int i = tid; i < L * K; i += kThreads) {
      const int at = (i / K) * KP + i % K;
      ks[at] *= expf(tot[i % K] - lc[at]);
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = S[kk * VP + vv] * expf(tot[kk]);
      for (int t = 0; t < L; ++t)
        acc = fmaf(ks[t * KP + kk], vs[t * VP + vv], acc);
      S[kk * VP + vv] = acc;
    }
  }
  __syncthreads();
  // S is the end state: the end-state gradient's share of dlogw.
  for (int i = tid; i < K * V; i += kThreads)
    dS[(i / V) * VP + i % V] =
        dsT ? dsT[b * sdT.b + h * sdT.h + (i / V) * sdT.t + (i % V) * sdT.x]
            : 0.0f;
  __syncthreads();
  for (int kk = tid; kk < K; kk += kThreads) {
    float f = 0.0f;
    for (int vv = 0; vv < V; ++vv)
      f = fmaf(dS[kk * VP + vv], S[kk * VP + vv], f);
    carry[kk] = f;
  }

  // ---- reverse: chunk by chunk from the last.
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * L;
    __syncthreads();
    load_rows(rs, rb, sr.t, sr.x, t0, T, L, K);
    load_rows(ks, kb, sk.t, sk.x, t0, T, L, K);
    load_rows(lc, wb, sw.t, sw.x, t0, T, L, K);
    load_rows(vs, vb, sv.t, sv.x, t0, T, L, V);
    load_rows(gs, gb, sg.t, sg.x, t0, T, L, V);
    for (int i = tid; i < K * V; i += kThreads)
      S[(i / V) * VP + i % V] = st[(long long)c * K * V + i];
    __syncthreads();
    cumulative(lc, lb, tot, K, L);
    __syncthreads();
    for (int i = tid; i < L * K; i += kThreads) {
      const int at = (i / K) * KP + i % K;
      eb[at] = expf(lb[at]);
      ed[at] = expf(tot[i % K] - lc[at]);
    }
    // Scores A and dA of the strict lower triangle.
    for (int i = tid; i < L * L; i += kThreads) {
      const int tt = i / L, ii = i % L;
      float a = 0.0f, da = 0.0f;
      if (ii < tt) {
        for (int kk = 0; kk < K; ++kk)
          a = fmaf(rs[tt * KP + kk] * ks[ii * KP + kk],
                   expf(fminf(lb[tt * KP + kk] - lc[ii * KP + kk], 0.0f)), a);
        for (int vv = 0; vv < V; ++vv)
          da = fmaf(gs[tt * VP + vv], vs[ii * VP + vv], da);
      }
      as[tt * LP + ii] = a;
      das[tt * LP + ii] = da;
    }
    __syncthreads();
    // dv.
    for (int i = tid; i < L * V; i += kThreads) {
      const int ii = i / V, vv = i % V;
      float acc = 0.0f;
      for (int tt = ii + 1; tt < L; ++tt)
        acc = fmaf(as[tt * LP + ii], gs[tt * VP + vv], acc);
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(ks[ii * KP + kk] * ed[ii * KP + kk], dS[kk * VP + vv],
                   acc);
      if (t0 + ii < T) dv[out_vb + (long long)(t0 + ii) * V + vv] = acc;
    }
    // dr and q = r dr.
    for (int i = tid; i < L * K; i += kThreads) {
      const int tt = i / K, kk = i % K, at = tt * KP + kk;
      float sg_ = 0.0f;
      for (int vv = 0; vv < V; ++vv)
        sg_ = fmaf(S[kk * VP + vv], gs[tt * VP + vv], sg_);
      float acc = eb[at] * sg_;
      for (int ii = 0; ii < tt; ++ii)
        acc = fmaf(das[tt * LP + ii] * ks[ii * KP + kk],
                   expf(fminf(lb[at] - lc[ii * KP + kk], 0.0f)), acc);
      qs[at] = rs[at] * acc;
      if (t0 + tt < T) dr[out_kb + (long long)(t0 + tt) * K + kk] = acc;
    }
    // dk and p = k dk.
    for (int i = tid; i < L * K; i += kThreads) {
      const int ii = i / K, kk = i % K, at = ii * KP + kk;
      float acc = 0.0f;
      for (int tt = ii + 1; tt < L; ++tt)
        acc = fmaf(das[tt * LP + ii] * rs[tt * KP + kk],
                   expf(fminf(lb[tt * KP + kk] - lc[at], 0.0f)), acc);
      float dsv = 0.0f;
      for (int vv = 0; vv < V; ++vv)
        dsv = fmaf(dS[kk * VP + vv], vs[ii * VP + vv], dsv);
      acc = fmaf(ed[at], dsv, acc);
      ps[at] = ks[at] * acc;
      if (t0 + ii < T) dk[out_kb + (long long)(t0 + ii) * K + kk] = acc;
    }
    __syncthreads();
    // dlogw by the suffix sum, and the state gradient carried back.
    for (int kk = tid; kk < K; kk += kThreads) {
      float run = carry[kk];
      for (int tt = L - 1; tt >= 0; --tt) {
        const float q = qs[tt * KP + kk];
        run += q - ps[tt * KP + kk];
        if (t0 + tt < T)
          dw[out_kb + (long long)(t0 + tt) * K + kk] = run - q;
      }
      carry[kk] = run;
    }
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = dS[kk * VP + vv] * expf(tot[kk]);
      for (int tt = 0; tt < L; ++tt)
        acc = fmaf(rs[tt * KP + kk] * eb[tt * KP + kk], gs[tt * VP + vv],
                   acc);
      dS[kk * VP + vv] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += kThreads)
    ds0[(long long)blockIdx.x * K * V + i] = dS[(i / V) * VP + i % V];
}

// Largest dynamic shared memory a block may use (227 KB), set once per
// device.
constexpr int kMaxSmemBytes = 232448;
std::atomic<unsigned> configured{0};

}  // namespace

// C entry point (bound with ctypes). st: the 4 strides of r, k, v, logw,
// s0, dO, dS_T (elements); dS_T may be null (zero). dr, dk, dlogw are
// dense (B, H, T, K), dv (B, H, T, V), ds0 (B, H, K, V); `states` is
// scratch of B H ceil(T / L) K V floats. Returns the launch's CUDA error.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* s0, const void* dout,
                            const void* dsT, void* dr, void* dk, void* dv,
                            void* dw, void* ds0, void* states,
                            const int64_t* st, int B, int H, int T, int K,
                            int V, int L, int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides4 s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides4{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  const int bytes = smem_floats(K, V, L) * (int)sizeof(float);
  const unsigned bit = 1u << (device & 31);
  if (bytes > kMaxSmemBytes) err = cudaErrorInvalidValue;
  else if (!(configured.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err == cudaSuccess)
      configured.fetch_or(bit, std::memory_order_release);
  }
  if (err == cudaSuccess) {
    wkv6_bwd_kernel<<<B * H, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(s0), static_cast<const float*>(dout),
        static_cast<const float*>(dsT), static_cast<float*>(dr),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dw), static_cast<float*>(ds0),
        static_cast<float*>(states), s[0], s[1], s[2], s[3], s[4], s[5], s[6],
        Dims{B, H, T, K, V, L});
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
