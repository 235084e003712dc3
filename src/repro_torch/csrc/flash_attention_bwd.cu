// flash_attention_bwd — the gradient of `flash_attention` (causal /
// sliding-window / tanh-softcap GQA attention over positions 0..S-1):
// dQ, dK, dV from Q, K, V, O and dO, recomputing the scores
// (FlashAttention-2 style) instead of storing them.
//
//   s[q,k]  = softcap(q.k * scale), pair counted under the forward's masks
//   p[q,k]  = exp(s[q,k] - lse[q]),            lse[q] = log sum_k exp(s[q,k])
//   dV[k]  += sum_q p[q,k] dO[q]
//   ds[q,k] = p[q,k] (dO[q].v[k] - delta[q]) (1 - tanh^2) scale,
//                                               delta[q] = dO[q].O[q]
//   dQ[q]  += sum_k ds[q,k] k[k],   dK[k] += sum_q ds[q,k] q[q]
//
// The TPU has no such kernel: the reference trains through `jax.grad` of
// its jnp attention (`repro/models/lm/attention.py::attention_prefill`).
// This kernel is the backward of the port's CUDA forward
// (`flash_attention.cu`), which stays as it is: the forward writes no
// row statistics, so a pre-pass recomputes them.
//
// Three kernels, one launch each, all f32 arithmetic on the CUDA cores
// over f32 or bf16 inputs (bf16 widened on load), outputs stored in the
// input type:
//   flash_bwd_rows  one block per (32 query rows, head, batch): lse by
//          an online max/sum over the reachable key tiles, and delta;
//   flash_bwd_dkdv  one block per (32 keys, KV head, batch): loops over
//          the rep query heads of its KV head and over the query tiles
//          that reach its keys, and sums dK and dV in registers. One block
//          owns each output row, so no atomics: two runs give the same
//          bits;
//   flash_bwd_dq  one block per (32 query rows, head, batch): loops over
//          the reachable key tiles and sums dQ in registers.
// Tiles are 32 x 32 (query rows x keys) with 256 threads: a thread
// computes 4 scores of one row (keys lane % 8 + 8 n) and owns D / 8
// columns of one output row (columns lane % 8 + 8 c). Shared-memory rows
// are padded to D + 1 floats, so the 8 rows a warp reads at once lie on
// distinct banks. The masks are the forward's, tile skipping included:
// a key tile no row of a query tile reaches is not visited. A masked
// pair's p is set to exactly 0 (never exp of an overflow).
//
// Bound on the H100: operations. The pass does five products of the
// forward's size (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) where the forward
// does two: 2.5 x its 4 D flops a counted pair. At the full-width
// training shape (B=2, H=25, KV=5, S=2048, D=64, window 1024) that is
// 0.05 TFLOP. This simple design recomputes Q K^T three times and dO V^T
// twice, and runs on the f32 CUDA cores: tensor cores are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kB = 32;                  // query rows and keys per tile
constexpr int kThreads = 256;

struct Strides3 {
  long long b, h, s;                    // in elements; the D axis is 1
};

struct Masks {
  int S, causal, window;
  float scale, softcap;

  __device__ __forceinline__ bool ok(int qi, int kj) const {
    return kj < S && qi < S && (!causal || kj <= qi) &&
           (window <= 0 || qi - kj < window);
  }
  // The softcapped, scaled score, and the factor d score / d (q.k).
  __device__ __forceinline__ float score(float qk, float* dscore) const {
    const float x = qk * scale;
    if (softcap > 0.0f) {
      const float t = tanhf(x / softcap);
      *dscore = (1.0f - t * t) * scale;
      return softcap * t;
    }
    *dscore = scale;
    return x;
  }
  // Keys any query row of [q0, q0 + kB) reaches: [k_begin, k_end).
  __device__ __forceinline__ void key_range(int q0, int* kb, int* ke) const {
    const int q_last = min(q0 + kB, S) - 1;
    *ke = causal ? q_last + 1 : S;
    int b = window > 0 ? max(0, q0 - window + 1) : 0;
    *kb = b - b % kB;
  }
  // Query rows that reach any key of [k0, k0 + kB): [q_begin, q_end).
  __device__ __forceinline__ void query_range(int k0, int* qb, int* qe) const {
    const int b = causal ? k0 : 0;
    *qb = b - b % kB;
    *qe = window > 0 ? min(S, min(k0 + kB, S) - 1 + window) : S;
  }
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows r0 .. r0 + kB - 1 of a (S, D) matrix with row stride `ld` into a
// padded f32 tile [kB][D + 1]; rows at or past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int r0, int S) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < S ? load(src + (r0 + r) * ld + d) : 0.0f;
  }
}

template <int D>
constexpr int smem_floats() {
  // Four padded (kB, D) tiles, two (kB, kB + 1) score tiles, lse, delta.
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// Dots of row `qi` of `a` with rows kj = j0 + 8 n (n < 4) of `b`, both
// padded tiles, and (if kTwo) of row `qi` of `c` with the same rows of `d`.
template <int D, bool kTwo>
__device__ __forceinline__ void dots4(const float* a, const float* b,
                                      const float* c, const float* d, int qi,
                                      int j0, float (&ab)[4],
                                      float (&cd)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) ab[n] = cd[n] = 0.0f;
  const float* ar = a + qi * (D + 1);
  const float* cr = c + qi * (D + 1);
#pragma unroll 8
  for (int x = 0; x < D; ++x) {
    const float av = ar[x], cv = kTwo ? cr[x] : 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      ab[n] = fmaf(av, b[(j0 + 8 * n) * (D + 1) + x], ab[n]);
      if (kTwo) cd[n] = fmaf(cv, d[(j0 + 8 * n) * (D + 1) + x], cd[n]);
    }
  }
}

// --------------------------------------------------------------- rows
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ lse, float* __restrict__ delta, Strides3 sq,
            Strides3 sk, Strides3 so, Strides3 sd, int H, int rep, Masks mk) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [kB][D + 1]
  float* ks = qs + kB * (D + 1);        // [kB][D + 1]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, row = tid >> 3, j0 = tid & 7;
  const int qi = q0 + row;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / rep) * sk.h;
  load_tile<D>(qs, qb, sq.s, q0, mk.S);

  // delta = dO . O, eight lanes a row.
  float dsum = 0.0f;
  if (qi < mk.S) {
    const T* orow = o + b * so.b + h * so.h + qi * so.s;
    const T* grow = dout + b * sd.b + h * sd.h + qi * sd.s;
    for (int x = j0; x < D; x += 8) dsum = fmaf(load(grow + x), load(orow + x),
                                                dsum);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    dsum += __shfl_xor_sync(0xffffffffu, dsum, off);

  int k_begin, k_end;
  mk.key_range(q0, &k_begin, &k_end);
  float m = kNegInf, l = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<D>(ks, kb, sk.s, k0, mk.S);
    __syncthreads();
    float s[4], unused[4];
    dots4<D, false>(qs, ks, qs, ks, row, j0, s, unused);
    float mx = kNegInf, dsc;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int kj = k0 + j0 + 8 * n;
      s[n] = mk.ok(qi, kj) ? mk.score(s[n], &dsc) : kNegInf;
      mx = fmaxf(mx, s[n]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (s[n] > kNegInf) part += expf(s[n] - m_new);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    l = l * expf(m - m_new) + part;
    m = m_new;
  }
  if (j0 == 0 && qi < mk.S) {
    const long long at = ((long long)b * H + h) * mk.S + qi;
    lse[at] = m + logf(fmaxf(l, 1e-30f));
    delta[at] = dsum;
  }
}

// p and ds of the pairs (row, j0 + 8 n) of a tile, into [kB][kB + 1].
template <int D>
__device__ __forceinline__ void probs(const float* qs, const float* ks,
                                      const float* gs, const float* vs,
                                      const float* lse_s,
                                      const float* delta_s, int q0, int k0,
                                      const Masks& mk, float* ps, float* dss) {
  const int row = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  float s[4], dp[4];
  dots4<D, true>(qs, ks, gs, vs, row, j0, s, dp);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = j0 + 8 * n;
    float p = 0.0f, ds = 0.0f;
    if (mk.ok(q0 + row, k0 + j)) {
      float dscore;
      const float sc = mk.score(s[n], &dscore);
      p = expf(sc - lse_s[row]);
      ds = p * (dp[n] - delta_s[row]) * dscore;
    }
    ps[row * (kB + 1) + j] = p;
    dss[row * (kB + 1) + j] = ds;
  }
}

// The lse and delta of query rows q0 .. q0 + kB - 1 of (b, h).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, long long at,
                                          int q0, int S) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const bool in = q0 + i < S;
    lse_s[i] = in ? lse[at + q0 + i] : 0.0f;
    delta_s[i] = in ? delta[at + q0 + i] : 0.0f;
  }
}

// --------------------------------------------------------------- dkdv
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Strides3 sq, Strides3 sk,
            Strides3 sv, Strides3 sd, Strides3 sdk, Strides3 sdv, int H,
            int rep, Masks mk) {
  constexpr int NC = D / 8;             // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kB][D + 1] each
  float* ks = qs + kB * (D + 1);
  float* vs = ks + kB * (D + 1);
  float* gs = vs + kB * (D + 1);
  float* ps = gs + kB * (D + 1);        // [kB][kB + 1] each
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);   // [kB] each
  float* delta_s = lse_s + kB;

  const int b = blockIdx.z, g = blockIdx.y, k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, kr = tid >> 3, c0 = tid & 7;
  load_tile<D>(ks, k + b * sk.b + g * sk.h, sk.s, k0, mk.S);
  load_tile<D>(vs, v + b * sv.b + g * sv.h, sv.s, k0, mk.S);
  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc_k[c] = acc_v[c] = 0.0f;

  int q_begin, q_end;
  mk.query_range(k0, &q_begin, &q_end);
  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const long long at = ((long long)b * H + h) * mk.S;
    for (int q0 = q_begin; q0 < q_end; q0 += kB) {
      __syncthreads();                  // the last tile is consumed
      load_tile<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, mk.S);
      load_tile<D>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, mk.S);
      load_rows(lse_s, delta_s, lse, delta, at, q0, mk.S);
      __syncthreads();
      probs<D>(qs, ks, gs, vs, lse_s, delta_s, q0, k0, mk, ps, dss);
      __syncthreads();
      // dV[kr] += sum_i p[i, kr] dO[i];  dK[kr] += sum_i ds[i, kr] q[i].
      for (int i = 0; i < kB; ++i) {
        const float p = ps[i * (kB + 1) + kr], ds = dss[i * (kB + 1) + kr];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[c] = fmaf(p, gs[i * (D + 1) + c0 + 8 * c], acc_v[c]);
          acc_k[c] = fmaf(ds, qs[i * (D + 1) + c0 + 8 * c], acc_k[c]);
        }
      }
    }
  }
  if (k0 + kr < mk.S) {
    T* dkr = dk + b * sdk.b + g * sdk.h + (k0 + kr) * sdk.s;
    T* dvr = dv + b * sdv.b + g * sdv.h + (k0 + kr) * sdv.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dkr + c0 + 8 * c, acc_k[c]);
      store(dvr + c0 + 8 * c, acc_v[c]);
    }
  }
}

// ----------------------------------------------------------------- dq
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Strides3 sq, Strides3 sk, Strides3 sv,
          Strides3 sd, Strides3 sdq, int H, int rep, Masks mk) {
  constexpr int NC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kB * (D + 1);
  float* vs = ks + kB * (D + 1);
  float* gs = vs + kB * (D + 1);
  float* ps = gs + kB * (D + 1);
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);
  float* delta_s = lse_s + kB;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, row = tid >> 3, c0 = tid & 7;
  const T* kb = k + b * sk.b + (h / rep) * sk.h;
  const T* vb = v + b * sv.b + (h / rep) * sv.h;
  load_tile<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, mk.S);
  load_tile<D>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, mk.S);
  load_rows(lse_s, delta_s, lse, delta, ((long long)b * H + h) * mk.S, q0,
            mk.S);
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

  int k_begin, k_end;
  mk.key_range(q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<D>(ks, kb, sk.s, k0, mk.S);
    load_tile<D>(vs, vb, sv.s, k0, mk.S);
    __syncthreads();
    probs<D>(qs, ks, gs, vs, lse_s, delta_s, q0, k0, mk, ps, dss);
    __syncthreads();
    // dQ[row] += sum_j ds[row, j] k[j].
    for (int j = 0; j < kB; ++j) {
      const float ds = dss[row * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = fmaf(ds, ks[j * (D + 1) + c0 + 8 * c], acc[c]);
    }
  }
  if (q0 + row < mk.S) {
    T* dqr = dq + b * sdq.b + h * sdq.h + (q0 + row) * sdq.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dqr + c0 + 8 * c, acc[c]);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, int device,
                          std::atomic<unsigned>& done) {
  const unsigned bit = 1u << (device & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D, typename T>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta,
                       const Strides3* st, int B, int H, int KV, Masks mk,
                       int device, cudaStream_t stream) {
  static std::atomic<unsigned> done_rows{0}, done_kv{0}, done_q{0};
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err;
  if ((err = set_smem_once(flash_bwd_rows_kernel<D, T>, bytes, device,
                           done_rows)) ||
      (err = set_smem_once(flash_bwd_dkdv_kernel<D, T>, bytes, device,
                           done_kv)) ||
      (err = set_smem_once(flash_bwd_dq_kernel<D, T>, bytes, device,
                           done_q)))
    return err;
  const int rep = H / KV, tiles = (mk.S + kB - 1) / kB;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tg = static_cast<const T*>(dout);
  // st: q, k, v, o, dO, dQ, dK, dV.
  flash_bwd_rows_kernel<D, T><<<dim3(tiles, H, B), kThreads, bytes,
                                 stream>>>(
      tq, tk, to, tg, lse, delta, st[0], st[1], st[3], st[4], H, rep, mk);
  if ((err = cudaGetLastError())) return err;
  flash_bwd_dkdv_kernel<D, T><<<dim3(tiles, KV, B), kThreads, bytes,
                                 stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], H, rep, mk);
  if ((err = cudaGetLastError())) return err;
  flash_bwd_dq_kernel<D, T><<<dim3(tiles, H, B), kThreads, bytes,
                               stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), st[0], st[1], st[2],
      st[4], st[5], H, rep, mk);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, const int64_t* strides, int B, int H, int KV, int S,
           int D, float scale, int causal, int window, float softcap,
           int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides3 st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Masks mk{S, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *fl = static_cast<float*>(lse), *fd = static_cast<float*>(delta);
  switch (D) {
    case 32:
      err = launch_all<32, T>(q, k, v, o, dout, dq, dk, dv, fl, fd, st, B, H,
                              KV, mk, device, s);
      break;
    case 64:
      err = launch_all<64, T>(q, k, v, o, dout, dq, dk, dv, fl, fd, st, B, H,
                              KV, mk, device, s);
      break;
    case 128:
      err = launch_all<128, T>(q, k, v, o, dout, dq, dk, dv, fl, fd, st, B,
                               H, KV, mk, device, s);
      break;
    case 256:
      err = launch_all<256, T>(q, k, v, o, dout, dq, dk, dv, fl, fd, st, B,
                               H, KV, mk, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). strides: (b, h, s) of q, k, v, o,
// dO, dQ, dK, dV in elements; lse and delta are (B, H, S) f32 scratch;
// window 0 = none, softcap 0 = none. Return the launches' CUDA error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    const int64_t* strides, int B, int H, int KV, int S, int D, float scale,
    int causal, int window, float softcap, int device, void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, strides, B,
                       H, KV, S, D, scale, causal, window, softcap, device,
                       stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    const int64_t* strides, int B, int H, int KV, int S, int D, float scale,
    int causal, int window, float softcap, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                               strides, B, H, KV, S, D, scale, causal, window,
                               softcap, device, stream);
}
