// flash_attention_bwd — the gradient of `flash_attention` (causal /
// sliding-window / tanh-softcap GQA attention of S queries against Sk
// keys, Sk = S but for cross-attention, which has no mask):
// dQ, dK, dV from Q, K, V, O, dO and the forward's log-sum-exp per row,
// recomputing the scores (FlashAttention-2 style) instead of storing them.
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
// (`flash_attention.cu`), which writes lse for it (the autograd forward
// asks for it). Two kernels, launched in this order:
//   dq    one block per (64 query rows, head, batch): delta = dO . O for
//         its rows (written out for dkdv), then over the reachable key
//         tiles S = Q K^T, dP = dO V^T and dQ += dS K;
//   dkdv  one block per (64 keys, KV head, batch): loops over the rep
//         query heads of its KV head and the query tiles that reach its
//         keys, summing dK and dV.
// dq's blocks cover the S queries and loop over key tiles bounded by Sk;
// dkdv's cover the Sk keys and loop over query tiles bounded by S; lse
// and delta are per query row, (B, H, S).
// One block owns each output row, so there are no atomics: two runs give
// the same bits. The masks are the forward's, tile skipping included; a
// masked pair's p is exactly 0 (never exp of an overflow).
//
// bf16 (`tc::`): tensor cores, a template on (DQK, DV) as the f32 kernels
// below, built for (D, D) at D in {64, 128, 256} and for deepseek-v3's
// MLA heads (192, 128). The products run on `wgmma` m64n64k16, bf16 in
// and f32 accumulate, on tiles of 64 rows stored and loaded as the
// forward's (`wgmma.cuh`: 128-byte swizzle, 16-byte `cp.async` copies, a
// ring of two stages for the streamed tiles). Q and K are DQK wide, dO
// and V DV wide: S = Q K^T (and S^T = K Q^T) contracts over DQK (12 k16
// steps at 192), dP = dO V^T (and dP^T = V dO^T) and delta = dO . O over
// DV; dQ and dK accumulate DQK columns (three 64-column blocks at 192),
// dV DV columns. dq is one warpgroup: Q and dO staged once, K and V
// streamed; S and dP from shared memory, dQ += dS K with dS from
// registers and K read MN-major. dkdv is two warpgroups over one staged
// K and V tile, Q, dO, lse and delta streamed: both compute S^T = K Q^T
// (from which P^T); warpgroup 0 then sums dV += P^T dO, and warpgroup 1
// computes dP^T = V dO^T and sums dK += dS^T Q, so each holds one
// accumulator: DV wide in warpgroup 0, DQK wide in warpgroup 1 (at D =
// 256, 128 registers a thread; at (192, 128), 64 and 96). Shared memory
// is (1 + kStages)(DQK + DV) / 64 blocks of 8 KB and 1 KB of alignment
// slack: 193 KB at D = 256, 121 KB at (192, 128). That is 7 products of
// a tile's size where the bound counts 5 (S twice, the forward's lse
// saves a third). Scale, softcap, masks and lse are applied on the f32
// accumulator fragment before P or dS is rounded to bf16. A bf16 operand
// rounds P or dS by up to 2^-9 relative, which the bf16 tolerance does
// not absorb where a row's few large terms cancel (one rounding misses
// it by 3-8x at the training shapes, PERF.md); as in the forward's P V,
// each of P (dV), dS (dK) and dS (dQ) goes in as two bf16 products, its
// rounding hi and the rounding of what hi leaves, lo.
//
// f32 (`simt::`) runs on the CUDA cores, as the same two kernels: 32 x 32
// tiles, 256 threads, f32 FMAs over padded f32 shared tiles, lse from the
// forward and delta from the dq kernel. It is a template on (DQK, DV), the
// head dims of q, k, dq, dk and of v, o, dO, dv, built for (D, D) at D in
// {32, 64, 128, 256} and for MLA's (96, 64) (lm_moe_tiny trains through
// it) and (192, 128): s = q.k runs over DQK, dp = dO.v and delta = dO.O
// over DV, dq and dk accumulate DQK columns and dv DV. The bf16 kernels
// take no D = 96 (not whole 64-column blocks); there the wrapper raises.
//
// Bound on the H100: operations. Five products of the forward's size
// (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) where the forward does two: 2 (3 D
// + 2 Dv) flops a counted pair, 2.5 x the forward's 4 D where Dv = D. At
// the full-width training shape (B=2, H=25, KV=5, S=2048, D=64, window
// 1024) that is 0.05 TFLOP, 0.051 ms at the bf16 tensor-core rate; the
// bytes (q, k, v, o, dO, lse in and dq, dk, dv out, 26 MB) take 0.008
// ms. At lm_moe_tiny's f32 step (128 sequences, 4 heads of (96, 64), 33
// tokens) the bytes bound it: 0.013 ms. At deepseek-v3's bf16 training
// shape (B=2, H=KV=128, S=2048, (192, 128), causal) 2 (3 . 192 + 2 . 128)
// = 1,664 flops a pair over 2 . 128 . 2048 . 2049 / 2 pairs is 0.894
// TFLOP, 0.904 ms at 989 TFLOP/s (the H100 SXM's dense bf16 rate at its
// 700 W limit); the bytes (q, k, v, o, dO, dq, dk, dv and lse, 1.34 GB)
// take 0.40 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

struct Strides3 {
  long long b, h, s;                    // in elements; the D axis is 1
};

struct Masks {
  int S, Sk, causal, window;            // S queries, Sk keys
  float scale, softcap;

  __device__ __forceinline__ bool ok(int qi, int kj) const {
    return kj < Sk && qi < S && (!causal || kj <= qi) &&
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
  // Keys any query row of [q0, q0 + TB) reaches: [k_begin, k_end).
  template <int TB>
  __device__ __forceinline__ void key_range(int q0, int* kb, int* ke) const {
    const int q_last = min(q0 + TB, S) - 1;
    *ke = causal ? min(q_last + 1, Sk) : Sk;
    int b = window > 0 ? max(0, q0 - window + 1) : 0;
    *kb = b - b % TB;
  }
  // Query rows that reach any key of [k0, k0 + TB): [q_begin, q_end).
  template <int TB>
  __device__ __forceinline__ void query_range(int k0, int* qb, int* qe) const {
    const int b = causal ? k0 : 0;
    *qb = b - b % TB;
    *qe = window > 0 ? min(S, min(k0 + TB, Sk) - 1 + window) : S;
  }
  // Whether a (TB query rows from q0) x (TB keys from k0) tile has a pair
  // the masks drop: only such tiles run the mask arithmetic.
  template <int TB>
  __device__ __forceinline__ bool edge(int q0, int k0) const {
    return k0 + TB > Sk || q0 + TB > S || (causal && k0 + TB - 1 > q0) ||
           (window > 0 && q0 + TB - 1 - k0 >= window);
  }
};

// ------------------------------------------------------ CUDA cores (f32)
namespace simt {

constexpr int kB = 32;                  // query rows and keys per tile
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int DQK, int DV>
constexpr int smem_floats() {
  // Padded q, k (DQK) and v, dO (DV) tiles, two (kB, kB + 1) score tiles,
  // lse, delta.
  return 2 * kB * (DQK + 1) + 2 * kB * (DV + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// Dots of row `qi` of `a` with rows kj = j0 + 8 n (n < 4) of `b`, both
// padded tiles of D columns.
template <int D>
__device__ __forceinline__ void dots4(const float* a, const float* b, int qi,
                                      int j0, float (&ab)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) ab[n] = 0.0f;
  const float* ar = a + qi * (D + 1);
#pragma unroll 8
  for (int x = 0; x < D; ++x) {
    const float av = ar[x];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      ab[n] = fmaf(av, b[(j0 + 8 * n) * (D + 1) + x], ab[n]);
  }
}

// The same for two pairs of tiles of one width at once (q.k and dO.v
// where DQK = DV): one loop, twice the loads in flight.
template <int D>
__device__ __forceinline__ void dots4x2(const float* a, const float* b,
                                        const float* c, const float* d,
                                        int qi, int j0, float (&ab)[4],
                                        float (&cd)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) ab[n] = cd[n] = 0.0f;
  const float* ar = a + qi * (D + 1);
  const float* cr = c + qi * (D + 1);
#pragma unroll 8
  for (int x = 0; x < D; ++x) {
    const float av = ar[x], cv = cr[x];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      ab[n] = fmaf(av, b[(j0 + 8 * n) * (D + 1) + x], ab[n]);
      cd[n] = fmaf(cv, d[(j0 + 8 * n) * (D + 1) + x], cd[n]);
    }
  }
}

// p and ds of the pairs (row, j0 + 8 n) of a tile, into [kB][kB + 1]:
// s from q.k over DQK, dp from dO.v over DV.
template <int DQK, int DV>
__device__ __forceinline__ void probs(const float* qs, const float* ks,
                                      const float* gs, const float* vs,
                                      const float* lse_s,
                                      const float* delta_s, int q0, int k0,
                                      const Masks& mk, float* ps, float* dss) {
  const int row = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  float s[4], dp[4];
  if constexpr (DQK == DV) {
    dots4x2<DQK>(qs, ks, gs, vs, row, j0, s, dp);
  } else {
    dots4<DQK>(qs, ks, row, j0, s);
    dots4<DV>(gs, vs, row, j0, dp);
  }
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

template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Strides3 sq, Strides3 sk,
            Strides3 sv, Strides3 sd, Strides3 sdk, Strides3 sdv, int H,
            int rep, Masks mk) {
  constexpr int NK = DQK / 8, NV = DV / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kB][DQK + 1] each
  float* ks = qs + kB * (DQK + 1);
  float* vs = ks + kB * (DQK + 1);      // [kB][DV + 1] each
  float* gs = vs + kB * (DV + 1);
  float* ps = gs + kB * (DV + 1);       // [kB][kB + 1] each
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);   // [kB] each
  float* delta_s = lse_s + kB;

  const int b = blockIdx.z, g = blockIdx.y, k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, kr = tid >> 3, c0 = tid & 7;
  load_tile<DQK>(ks, k + b * sk.b + g * sk.h, sk.s, k0, mk.Sk);
  load_tile<DV>(vs, v + b * sv.b + g * sv.h, sv.s, k0, mk.Sk);
  float acc_k[NK], acc_v[NV];
#pragma unroll
  for (int c = 0; c < NK; ++c) acc_k[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < NV; ++c) acc_v[c] = 0.0f;

  int q_begin, q_end;
  mk.query_range<kB>(k0, &q_begin, &q_end);
  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const long long at = ((long long)b * H + h) * mk.S;
    for (int q0 = q_begin; q0 < q_end; q0 += kB) {
      __syncthreads();                  // the last tile is consumed
      load_tile<DQK>(qs, q + b * sq.b + h * sq.h, sq.s, q0, mk.S);
      load_tile<DV>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, mk.S);
      load_rows(lse_s, delta_s, lse, delta, at, q0, mk.S);
      __syncthreads();
      probs<DQK, DV>(qs, ks, gs, vs, lse_s, delta_s, q0, k0, mk, ps, dss);
      __syncthreads();
      // dV[kr] += sum_i p[i, kr] dO[i];  dK[kr] += sum_i ds[i, kr] q[i].
      for (int i = 0; i < kB; ++i) {
        const float p = ps[i * (kB + 1) + kr], ds = dss[i * (kB + 1) + kr];
#pragma unroll
        for (int c = 0; c < NV; ++c)
          acc_v[c] = fmaf(p, gs[i * (DV + 1) + c0 + 8 * c], acc_v[c]);
#pragma unroll
        for (int c = 0; c < NK; ++c)
          acc_k[c] = fmaf(ds, qs[i * (DQK + 1) + c0 + 8 * c], acc_k[c]);
      }
    }
  }
  if (k0 + kr < mk.Sk) {
    T* dkr = dk + b * sdk.b + g * sdk.h + (k0 + kr) * sdk.s;
    T* dvr = dv + b * sdv.b + g * sdv.h + (k0 + kr) * sdv.s;
#pragma unroll
    for (int c = 0; c < NK; ++c) store(dkr + c0 + 8 * c, acc_k[c]);
#pragma unroll
    for (int c = 0; c < NV; ++c) store(dvr + c0 + 8 * c, acc_v[c]);
  }
}

// dQ of 32 query rows; first their delta = dO . O over DV (eight lanes a
// row), written out for the dkdv kernel.
template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, Strides3 sq,
          Strides3 sk, Strides3 sv, Strides3 so, Strides3 sd, Strides3 sdq,
          int H, int rep, Masks mk) {
  constexpr int NC = DQK / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kB * (DQK + 1);
  float* vs = ks + kB * (DQK + 1);
  float* gs = vs + kB * (DV + 1);
  float* ps = gs + kB * (DV + 1);
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);
  float* delta_s = lse_s + kB;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, row = tid >> 3, c0 = tid & 7;
  const int qi = q0 + row;
  const long long at = ((long long)b * H + h) * mk.S;
  const T* kb = k + b * sk.b + (h / rep) * sk.h;
  const T* vb = v + b * sv.b + (h / rep) * sv.h;
  load_tile<DQK>(qs, q + b * sq.b + h * sq.h, sq.s, q0, mk.S);
  load_tile<DV>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, mk.S);
  float dsum = 0.0f;
  if (qi < mk.S) {
    const T* orow = o + b * so.b + h * so.h + qi * so.s;
    const T* grow = dout + b * sd.b + h * sd.h + qi * sd.s;
    for (int x = c0; x < DV; x += 8)
      dsum = fmaf(load(grow + x), load(orow + x), dsum);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  if (c0 == 0) {
    lse_s[row] = qi < mk.S ? lse[at + qi] : 0.0f;
    delta_s[row] = dsum;
    if (qi < mk.S) delta[at + qi] = dsum;
  }
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

  int k_begin, k_end;
  mk.key_range<kB>(q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<DQK>(ks, kb, sk.s, k0, mk.Sk);
    load_tile<DV>(vs, vb, sv.s, k0, mk.Sk);
    __syncthreads();
    probs<DQK, DV>(qs, ks, gs, vs, lse_s, delta_s, q0, k0, mk, ps, dss);
    __syncthreads();
    // dQ[row] += sum_j ds[row, j] k[j].
    for (int j = 0; j < kB; ++j) {
      const float ds = dss[row * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = fmaf(ds, ks[j * (DQK + 1) + c0 + 8 * c], acc[c]);
    }
  }
  if (qi < mk.S) {
    T* dqr = dq + b * sdq.b + h * sdq.h + qi * sdq.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dqr + c0 + 8 * c, acc[c]);
  }
}

}  // namespace simt

// ------------------------------------------------- tensor cores (bf16)
namespace tc {

using namespace wg;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                 // rows of a tile: queries or keys
constexpr int kStages = 2;              // ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;

// One staged pair (Q and dO, or K and V), then kStages pairs streamed (K
// and V, or Q and dO): Q and K DQK / 64 column blocks each, dO and V DV /
// 64; 1 KB of slack to align the base to the 1 KB period of the 128-byte
// swizzle. At (192, 128): 15 blocks of 8 KB and 1 KB, 121 KB.
template <int DQK, int DV>
constexpr int smem_bytes() {
  return (1 + kStages) * (DQK + DV) / 64 * kBlockBytes + 1024;
}

// Accumulator fragment of m64nNk16: register 4 i + e of a thread is row
// 16 warp + lane / 4 + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2 of
// the warpgroup's tile.
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return warp * 16 + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int i, int e) {
  return 8 * i + 2 * (lane & 3) + (e & 1);
}

// p of one pair from its raw score x = q.k; `dsc` gets d score / d (q.k).
__device__ __forceinline__ float prob(float x, float lse2, const Masks& mk,
                                      float* dsc) {
  float sc = x * mk.scale;
  *dsc = mk.scale;
  if (mk.softcap > 0.0f) {
    const float t = tanhf(sc / mk.softcap);
    sc = mk.softcap * t;
    *dsc = (1.0f - t * t) * mk.scale;
  }
  return exp2f(fmaf(sc, kLog2e, -lse2));
}

// Rows of a dense (B H S) f32 vector into shared memory with 4-byte
// `cp.async` copies, zero past S (the caller commits and waits).
__device__ __forceinline__ void load_row_stats(float* dst, const float* src,
                                               int q0, int S, int i) {
  const bool in = q0 + i < S;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst + i)),
               "l"(in ? src + q0 + i : src), "r"(in ? 4 : 0)
               : "memory");
}

// Rows of a warpgroup's (64 x 64 NB) f32 accumulator, its first NB column
// blocks, to bf16 rows at `out` (row stride `ld`), rows at or past
// `n_rows` skipped.
template <int NB, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N][32],
                                           bf16* out, long long ld,
                                           int n_rows, int warp, int lane) {
  static_assert(NB <= N, "column blocks of the accumulator");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = frag_row(warp, lane, 2 * r);
    if (row >= n_rows) continue;
    bf16* orow = out + row * ld + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * i) =
            __floats2bfloat162_rn(acc[c][4 * i + 2 * r],
                                  acc[c][4 * i + 2 * r + 1]);
  }
}

// dQ of 64 query rows of one (b, h): one warpgroup.
template <int DQK, int DV>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq,
                Strides3 sq, Strides3 sk, Strides3 sv, Strides3 so,
                Strides3 sd, Strides3 sdq, int H, int rep, Masks mk) {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "64-column wgmma blocks");
  constexpr int NB = DQK / 64;          // column blocks of dQ (and K)
  constexpr int kQKBytes = NB * kBlockBytes;         // a Q or K tile
  constexpr int kPairBytes = kQKBytes + DV / 64 * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float lse_s[kBM], delta_s[kBM];
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t gs = qs + kQKBytes;
  // Stage st: K at qs + (1 + st) kPairBytes, V right after it.

  // Grid: x = (batch, head), the rep heads of one KV head neighbours; y =
  // query tile from the last, so the heaviest under a causal mask start
  // first over every head and batch.
  const int b = blockIdx.x / H, h = blockIdx.x % H, S = mk.S, Sk = mk.Sk;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + b * sk.b + (h / rep) * sk.h;
  const bf16* vb = v + b * sv.b + (h / rep) * sv.h;
  int k_begin, k_end;
  mk.key_range<kBM>(q0, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + kBM - 1) / kBM;

  load_tile<DQK, 128>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<DV, 128>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, S, tid);
  load_tile<DQK, 128>(qs + kPairBytes, kb, sk.s, k_begin, Sk, tid);
  load_tile<DV, 128>(qs + kPairBytes + kQKBytes, vb, sv.s, k_begin, Sk, tid);
  cp_async_commit();

  // delta = dO . O of the block's rows, two threads a row (16-byte loads),
  // kept for the products and written out for dkdv.
  const long long at = ((long long)b * H + h) * S;
  {
    const int r = tid >> 1, qi = q0 + r;
    float d = 0.0f;
    if (qi < S) {
      const bf16* orow = o + b * so.b + h * so.h + qi * so.s + (tid & 1) * 8;
      const bf16* grow =
          dout + b * sd.b + h * sd.h + qi * sd.s + (tid & 1) * 8;
#pragma unroll
      for (int c = 0; c < DV; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(o2[j]);
          const float2 g = __bfloat1622float2(g2[j]);
          d = fmaf(a.x, g.x, d);
          d = fmaf(a.y, g.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = d;
      lse_s[r] = qi < S ? lse[at + qi] : 0.0f;
      if (qi < S) delta[at + qi] = d;
    }
  }
  __syncthreads();
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse_s[frag_row(warp, lane, 2 * r)] * kLog2e;
    del[r] = delta_s[frag_row(warp, lane, 2 * r)];
  }

  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBM;
    if (t + 1 < n_tiles) {              // prefetch the next tile
      const uint32_t nxt = qs + (1 + (t + 1) % kStages) * kPairBytes;
      load_tile<DQK, 128>(nxt, kb, sk.s, k0 + kBM, Sk, tid);
      load_tile<DV, 128>(nxt + kQKBytes, vb, sv.s, k0 + kBM, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();               // this tile (and Q, dO) landed
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t ks = qs + (1 + t % kStages) * kPairBytes;
    const uint32_t vs = ks + kQKBytes;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss_tile<DQK>(s, qs, ks);      // S = Q K^T
    wgmma_ss_tile<DV>(dp, gs, vs);      // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = mk.edge<kBM>(q0, k0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dsc;
        float p = prob(s[4 * i + e], lse2[e >> 1], mk, &dsc);
        if (edge && !mk.ok(q0 + frag_row(warp, lane, e),
                           k0 + frag_col(lane, i, e)))
          p = 0.0f;
        s[4 * i + e] = p * (dp[4 * i + e] - del[e >> 1]) * dsc;
      }
    }
    uint32_t hi[16], lo[16];
    split_bf16(s, hi, lo);
    wgmma_fence();
    wgmma_rs_tile<NB>(acc, hi, lo, ks);   // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    __syncthreads();                    // this stage is free for reuse
  }
  store_rows<NB>(acc, dq + b * sdq.b + h * sdq.h + q0 * sdq.s, sdq.s, S - q0,
                 warp, lane);
}

// dK and dV of 64 keys of one (b, KV head): warpgroup 0 sums dV (DV
// columns), warpgroup 1 dK (DQK columns). At (64, 64) two blocks share an
// SM (128 registers).
template <int DQK, int DV>
__global__ void __launch_bounds__(256, DQK == 64 && DV == 64 ? 2 : 1)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Strides3 sq, Strides3 sk,
                  Strides3 sv, Strides3 sd, Strides3 sdk, Strides3 sdv,
                  int H, int rep, Masks mk) {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "64-column wgmma blocks");
  static_assert(DV <= DQK, "dV's blocks are a prefix of the accumulator");
  constexpr int NK = DQK / 64, NV = DV / 64;   // column blocks of dK, dV
  constexpr int kQKBytes = NK * kBlockBytes;   // a Q or K tile
  constexpr int kPairBytes = kQKBytes + NV * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float lse_s[kStages][kBM], delta_s[kStages][kBM];
  const uint32_t ks = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + kQKBytes;
  // Stage st: Q at ks + (1 + st) kPairBytes, dO right after it.

  // Grid: x = (batch, KV head); y = key tile from the first, so the
  // heaviest under a causal mask start first over every head and batch.
  const int KV = H / rep, b = blockIdx.x / KV;
  const int g = blockIdx.x % KV, S = mk.S, Sk = mk.Sk;
  const int k0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, grp = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  int q_begin, q_end;
  mk.query_range<kBM>(k0, &q_begin, &q_end);
  const int n_q = q_end > q_begin ? (q_end - q_begin + kBM - 1) / kBM : 0;
  const int n_it = rep * n_q;

  // Iteration it: query head g rep + it / n_q, tile q_begin + 64 (it % n_q).
  auto prefetch = [&](int it) {
    const int h = g * rep + it / n_q, q0 = q_begin + (it % n_q) * kBM;
    const int st = it % kStages;
    const uint32_t dst = ks + (1 + st) * kPairBytes;
    load_tile<DQK, 256>(dst, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
    load_tile<DV, 256>(dst + kQKBytes, dout + b * sd.b + h * sd.h, sd.s, q0,
                       S, tid);
    const long long at = ((long long)b * H + h) * S;
    if (tid < kBM) load_row_stats(lse_s[st], lse + at, q0, S, tid);
    else if (tid < 2 * kBM)
      load_row_stats(delta_s[st], delta + at, q0, S, tid - kBM);
  };
  load_tile<DQK, 256>(ks, k + b * sk.b + g * sk.h, sk.s, k0, Sk, tid);
  load_tile<DV, 256>(vs, v + b * sv.b + g * sv.h, sv.s, k0, Sk, tid);
  if (n_it > 0) prefetch(0);
  cp_async_commit();

  // dK's NK blocks in warpgroup 1; warpgroup 0 uses the first NV for dV.
  float acc[NK][32];
#pragma unroll
  for (int c = 0; c < NK; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_begin + (it % n_q) * kBM;
    if (it + 1 < n_it) {
      prefetch(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const int st = it % kStages;
    const uint32_t qs = ks + (1 + st) * kPairBytes;
    const uint32_t gs = qs + kQKBytes;
    const float* lse_t = lse_s[st];
    const float* del_t = delta_s[st];

    // Rows of these fragments are keys, columns queries.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss_tile<DQK>(s, ks, qs);      // S^T = K Q^T
    if (grp == 1) wgmma_ss_tile<DV>(dp, vs, gs);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = mk.edge<kBM>(q0, k0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = frag_col(lane, i, e);
        float dsc;
        float p = prob(s[4 * i + e], lse_t[col] * kLog2e, mk, &dsc);
        if (edge && !mk.ok(q0 + col, k0 + frag_row(warp, lane, e)))
          p = 0.0f;
        s[4 * i + e] =
            grp == 0 ? p : p * (dp[4 * i + e] - del_t[col]) * dsc;
      }
    }
    uint32_t hi[16], lo[16];
    split_bf16(s, hi, lo);
    wgmma_fence();
    if (grp == 0)
      wgmma_rs_tile<NV>(acc, hi, lo, gs);    // dV += P^T dO
    else
      wgmma_rs_tile<NK>(acc, hi, lo, qs);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NK; ++c) fence_regs(acc[c]);
    __syncthreads();                    // this stage is free for reuse
  }
  cp_async_wait<0>();                   // K and V, when no query reaches
  if (grp == 0)
    store_rows<NV>(acc, dv + b * sdv.b + g * sdv.h + k0 * sdv.s, sdv.s,
                   Sk - k0, warp, lane);
  else
    store_rows<NK>(acc, dk + b * sdk.b + g * sdk.h + k0 * sdk.s, sdk.s,
                   Sk - k0, warp, lane);
}

}  // namespace tc

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

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  Strides3 st[8];                       // q, k, v, o, dO, dQ, dK, dV
  int B, H, KV;
  Masks mk;
};

template <int DQK, int DV, typename T>
cudaError_t launch_simt(const Args& a, int device, cudaStream_t stream) {
  using namespace simt;
  static std::atomic<unsigned> done_kv{0}, done_q{0};
  const int bytes = smem_floats<DQK, DV>() * (int)sizeof(float);
  cudaError_t err;
  if ((err = set_smem_once(flash_bwd_dkdv_kernel<DQK, DV, T>, bytes, device,
                           done_kv)) ||
      (err = set_smem_once(flash_bwd_dq_kernel<DQK, DV, T>, bytes, device,
                           done_q)))
    return err;
  const int rep = a.H / a.KV, q_tiles = (a.mk.S + kB - 1) / kB;
  const int k_tiles = (a.mk.Sk + kB - 1) / kB;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *o = static_cast<const T*>(a.o),
          *g = static_cast<const T*>(a.dout);
  const Strides3* st = a.st;
  flash_bwd_dq_kernel<DQK, DV, T><<<dim3(q_tiles, a.H, a.B), kThreads, bytes,
                                     stream>>>(
      q, k, v, o, g, a.lse, a.delta, static_cast<T*>(a.dq), st[0], st[1],
      st[2], st[3], st[4], st[5], a.H, rep, a.mk);
  if ((err = cudaGetLastError())) return err;
  flash_bwd_dkdv_kernel<DQK, DV, T><<<dim3(k_tiles, a.KV, a.B), kThreads,
                                       bytes, stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), st[0], st[1], st[2], st[4], st[6], st[7], a.H,
      rep, a.mk);
  return cudaGetLastError();
}

// q, k, v, o and dO must start every row on 16 bytes (the wrapper copies
// them when they do not).
template <int DQK, int DV>
cudaError_t launch_tc(const Args& a, int device, cudaStream_t stream) {
  using namespace tc;
  static std::atomic<unsigned> done_kv{0}, done_q{0};
  constexpr int bytes = smem_bytes<DQK, DV>();
  cudaError_t err;
  if ((err = set_smem_once(flash_bwd_dkdv_tc<DQK, DV>, bytes, device,
                           done_kv)) ||
      (err = set_smem_once(flash_bwd_dq_tc<DQK, DV>, bytes, device, done_q)))
    return err;
  const int rep = a.H / a.KV, q_tiles = (a.mk.S + kBM - 1) / kBM;
  const int k_tiles = (a.mk.Sk + kBM - 1) / kBM;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *o = static_cast<const bf16*>(a.o),
             *g = static_cast<const bf16*>(a.dout);
  const Strides3* st = a.st;
  flash_bwd_dq_tc<DQK, DV><<<dim3(a.B * a.H, q_tiles), 128, bytes,
                             stream>>>(
      q, k, v, o, g, a.lse, a.delta, static_cast<bf16*>(a.dq), st[0], st[1],
      st[2], st[3], st[4], st[5], a.H, rep, a.mk);
  if ((err = cudaGetLastError())) return err;
  flash_bwd_dkdv_tc<DQK, DV><<<dim3(a.B * a.KV, k_tiles), 256, bytes,
                               stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), st[0], st[1], st[2], st[4], st[6], st[7],
      a.H, rep, a.mk);
  return cudaGetLastError();
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, const int64_t* strides, int B, int H, int KV, int S,
           int Sk, int D, int Dv, float scale, int causal, int window,
           float softcap, int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(delta), {}, B, H, KV,
         Masks{S, Sk, causal, window, scale, softcap}};
  for (int i = 0; i < 8; ++i)
    a.st[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto is = [&](int dqk, int dv) { return D == dqk && Dv == dv; };
  err = cudaErrorInvalidValue;
  if constexpr (kBf16) {
    if (is(64, 64)) err = launch_tc<64, 64>(a, device, s);
    else if (is(128, 128)) err = launch_tc<128, 128>(a, device, s);
    else if (is(256, 256)) err = launch_tc<256, 256>(a, device, s);
    else if (is(192, 128)) err = launch_tc<192, 128>(a, device, s);
  } else {
    if (is(32, 32)) err = launch_simt<32, 32, float>(a, device, s);
    else if (is(64, 64)) err = launch_simt<64, 64, float>(a, device, s);
    else if (is(128, 128)) err = launch_simt<128, 128, float>(a, device, s);
    else if (is(256, 256)) err = launch_simt<256, 256, float>(a, device, s);
    else if (is(96, 64)) err = launch_simt<96, 64, float>(a, device, s);
    else if (is(192, 128)) err = launch_simt<192, 128, float>(a, device, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). strides: (b, h, s) of q, k, v, o,
// dO, dQ, dK, dV in elements; S the queries' length, Sk the keys' (k, v,
// dK, dV); lse the forward's dense (B, H, S) f32
// log-sum-exp, delta (B, H, S) f32 scratch; window 0 = none, softcap 0 =
// none; (D, Dv) the head dims of q, k and of v, o, dO: (32, 32), (64,
// 64), (128, 128), (256, 256), (96, 64) or (192, 128) for f32, and (64,
// 64), (128, 128), (256, 256) or (192, 128) for bf16. Return the
// launches' CUDA error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const int64_t* strides, int B, int H, int KV, int S, int Sk,
    int D, int Dv, float scale, int causal, int window, float softcap,
    int device, void* stream) {
  return launch<false>(q, k, v, o, dout, lse, dq, dk, dv, delta, strides, B,
                       H, KV, S, Sk, D, Dv, scale, causal, window, softcap,
                       device, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const int64_t* strides, int B, int H, int KV, int S, int Sk,
    int D, int Dv, float scale, int causal, int window, float softcap,
    int device, void* stream) {
  return launch<true>(q, k, v, o, dout, lse, dq, dk, dv, delta, strides, B,
                      H, KV, S, Sk, D, Dv, scale, causal, window, softcap,
                      device, stream);
}
