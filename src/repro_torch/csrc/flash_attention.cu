// flash_attention — online-softmax GQA attention of S queries at
// positions 0..S-1 against Sk keys at positions 0..Sk-1, with causal,
// sliding-window and tanh-softcap masks.
//
//   o[b,h,q] = sum_k softmax_k(s[q,k]) v[b,h/rep,k],
//   s[q,k]   = softcap(q.k / sqrt(D)),  pair counted if k <= q (causal)
//              and q - k < window
//
// Sk = S for self-attention. Cross-attention (whisper's decoder against
// its encoder's F = 1,500 frames) gives keys of their own length, with
// no mask (the wrapper refuses a causal or windowed call at Sk != S): the
// key loop, the tile skip and the key tail mask are bounded by Sk, the
// query rows, the output and lse by S.
//
// q and k have head dim D (DQK below), v and o head dim Dv (DV). The two
// are equal for GQA; MLA (deepseek-v3) attends with keys of nope + rope
// dims and values of v_head_dim: (D, Dv) = (192, 128) at full width, (96,
// 64) reduced (lm_moe_tiny). The scale is D^-1/2 of q's head dim, as the
// reference's `attention_prefill`. Each kernel is a template on (DQK, DV)
// and is built for the pairs the models use: (32, 32) f32 only, (64, 64),
// (128, 128), (256, 256), (192, 128) on both, (96, 64) f32 only.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (`_flash_kernel`). The TPU kernel walks the KV axis as
// the innermost sequential grid dimension with (m, l, acc) in VMEM
// scratch; here one block owns a tile of query rows of one (b, h) and
// loops over the key tiles itself, keeping m, l and acc in registers (f32,
// as on the TPU). Key tiles that no row of the block can reach (past the
// causal diagonal, or before the window) are never loaded, which is the
// TPU kernel's `pl.when(reachable)` at block granularity. Unlike the TPU
// kernel, S need not be a multiple of a tile: the tail tile is masked.
// The denominator is clamped at 1e-30 as on the TPU.
//
// Two kernels, one per input type. The bf16 kernel takes head dims that
// are whole 64-column wgmma blocks; 32 (lm_tiny) and 96 (lm_moe_tiny)
// take the f32 kernel only.
//
// bf16 (`flash_bf16_kernel`): tensor cores. One warpgroup (4 warps, 128
// threads) owns 64 query rows. Q is staged once in shared memory; K and V
// come in tiles of 64 keys through a ring of two shared-memory stages (K
// at DQK, V at DV columns: 105 KB in all at (192, 128)),
// loaded with 16-byte `cp.async` copies (zero-filled past Sk) while the
// products of the previous tile run. Every tile is stored as 64-column
// blocks of 64 rows x 128 bytes in the 128-byte swizzle that the `wgmma`
// descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8)).
// S = Q K^T is `wgmma` m64n64k16 from shared memory over DQK / 16
// k-steps (bf16 in, f32 accumulate: exact products, as the f32
// reference). Scale, softcap and
// masks are applied on the accumulator fragment; mask arithmetic runs
// only on tiles that straddle the diagonal, the window edge or Sk. A
// thread holds two rows' fragments, and the row max and sum reduce over
// the four lanes of a quad. O += P V is `wgmma` with P taken from
// registers as bf16 (the S fragment is already the A operand's layout)
// and V read from shared memory in its natural (key, d) layout, which is
// the transposed (MN-major) B operand, one accumulator of 64 columns for
// each of the DV / 64 column blocks. The Pallas kernel multiplies P
// by V in f32; one bf16 rounding of P (2^-9 relative) misses the bf16
// tolerance on the serving shape, so P goes in as two bf16 products, its
// rounding hi and the rounding of P - hi, which carry P to about 2^-17.
// The denominator sums the unrounded f32 P. Blocks are ordered so that the heaviest causal
// query tiles start first and the `rep` heads that read one KV head run
// next to one another (grid x = head), sharing its K and V in L2. The
// tensor-core helpers are shared with the backward (`wgmma.cuh`).
//
// Both kernels write each row's log-sum-exp, m + log(l), when given an
// lse buffer (the autograd forward does, for the backward kernels;
// serving passes none).
//
// f32 (`flash_f32_kernel`): CUDA cores, f32 FMAs (TF32 would not hold the
// f32 tolerance). 8 warps, each owning 4 query rows; a key tile of 32
// keys, one per lane. A lane computes the scores of its key against the
// warp's 4 rows (float4 loads from shared memory: K rows padded to DQK + 4
// floats so a quarter-warp's 16-byte loads hit distinct banks, q rows read
// as broadcasts), the warp reduces the tile's max per row with shuffles,
// and then each lane accumulates P V for DV / 32 columns of the output
// (lane + 32 c), reading the tile's probabilities as one float4 broadcast
// per key. The per-lane partial denominators are rescaled with the row's
// max like acc and reduced once at the end.
//
// Bound on the H100: operations. A counted pair needs 2 D flops for q.k
// and 2 Dv for p v. At the serving shape (B=4, H=25, KV=5, S=2048, D=64,
// window 1024, bf16) the 1.57e8 unmasked pairs need 0.040 TFLOP, 0.041 ms
// at the bf16 tensor-core rate, against 0.019 ms to move q, k, v and o.
// At deepseek-v3's MLA serving shape (B=4, H=KV=128, S=2048, full causal,
// (192, 128), bf16) the 1.074e9 pairs need 640 flops each, 0.695 ms at
// 989 TFLOP/s, against 0.40 ms to move q, k, v and o (1.34 GB). Whisper's
// cross-attention (B=4, H=KV=16, S=224 queries against Sk=1500 keys, D=64,
// bf16) is bound by bytes instead: 28 MB of q, k, v and o, 0.008 ms,
// against 5.5 GFLOP (0.006 ms). The bf16 kernel issues its products on the tensor cores; the f32 kernel is
// bounded in practice by the shared-memory loads that feed its FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

struct Strides3 {
  long long b, h, s;                    // in elements; the D axis is 1
};

// Raise a kernel's dynamic shared-memory limit once per device, not on
// every launch.
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

// ------------------------------------------------------------ f32 kernel
namespace f32 {

constexpr int kWarps = 8;               // warps per block
constexpr int kRows = 4;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per block
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

template <int DQK, int DV>
constexpr int smem_floats() {
  // q rows, padded K tile, V tile, per-warp probabilities.
  return kBQ * DQK + kBK * (DQK + 4) + kBK * DV + kWarps * kBK * kRows;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Strides3 sq, Strides3 sk,
                 Strides3 sv, Strides3 so, int rep, int S, int Sk,
                 float scale, int causal, int window, float softcap) {
  static_assert(DQK % 4 == 0 && DV % 32 == 0, "float4 q.k, 32-lane P V");
  constexpr int KS = DQK + 4;           // padded K row stride (floats)
  constexpr int NC = DV / 32;           // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][DQK]
  float* ks = qs + kBQ * DQK;                    // [kBK][KS]
  float* vs = ks + kBK * KS;                     // [kBK][DV]
  float* ps = vs + kBK * DV;                     // [kWarps][kBK][kRows]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + (h / rep) * sk.h;
  const float* vb = v + b * sv.b + (h / rep) * sv.h;

  for (int i = tid; i < kBQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK, qi = q0 + r;
    qs[i] = qi < S ? qb[qi * sq.s + d] : 0.0f;
  }

  // The keys any row of this block can reach: [k_begin, k_end).
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(q_last + 1, Sk) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBK;

  const int row0 = q0 + warp * kRows;   // this warp's first query row
  float* pw = ps + warp * kBK * kRows;
  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the last tile is consumed
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int j = i / DQK, d = i % DQK, kj = k0 + j;
      ks[j * KS + d] = kj < Sk ? kb[kj * sk.s + d] : 0.0f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV, kj = k0 + j;
      vs[i] = kj < Sk ? vb[kj * sv.s + d] : 0.0f;
    }
    __syncthreads();

    // Scores of this lane's key against the warp's rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* qr =
        reinterpret_cast<const float4*>(qs + warp * kRows * DQK);
#pragma unroll 4
    for (int d4 = 0; d4 < DQK / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = qr[r * (DQK / 4) + d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax: the row max over the tile is warp-uniform.
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = row0 + r;
      float sc = s[r] * scale;
      if (softcap > 0.0f) sc = softcap * tanhf(sc / softcap);
      const bool ok = kj < Sk && (!causal || kj <= qi) &&
                      (window <= 0 || qi - kj < window);
      float mx = ok ? sc : kNegInf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(sc - m_new) : 0.0f;
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      pw[lane * kRows + r] = p;
    }
    __syncwarp();

    // acc += P V over the tile's keys; this lane owns columns lane + 32c.
    const float4* pr = reinterpret_cast<const float4*>(pw);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pj = pr[j];
      const float* vr = vs + j * DV + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vr[32 * c];
        acc[0][c] = fmaf(pj.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pj.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pj.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pj.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int qi = row0 + r;
    if (qi < S) {
      if (lse != nullptr && lane == 0)
        lse[((long long)b * gridDim.y + h) * S + qi] = m[r] + logf(lt);
      float* orow = o + b * so.b + h * so.h + qi * so.s + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[32 * c] = acc[r][c] / lt;
    }
  }
}

}  // namespace f32

// ----------------------------------------------------------- bf16 kernel
namespace tc {

using namespace wg;

constexpr int kBQ = 64;                 // query rows per block (wgmma M)
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kStages = 2;              // K/V ring in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Q, then kStages (K, V) pairs: Q and K DQK / 64 column blocks each, V
// DV / 64; 1 KB of slack to align the base to the 1 KB period of the
// 128-byte swizzle. At (192, 128): 13 blocks of 8 KB and 1 KB, 105 KB.
template <int DQK, int DV>
constexpr int smem_bytes() {
  return ((1 + kStages) * (DQK / 64) + kStages * (DV / 64)) * kBlockBytes +
         1024;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  Strides3 sq, Strides3 sk, Strides3 sv, Strides3 so,
                  int rep, int S, int Sk, float scale, int causal,
                  int window, float softcap) {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "64-column wgmma blocks");
  constexpr int NB = DV / 64;           // 64-column blocks of the output
  constexpr int kQKBytes = DQK / 64 * kBlockBytes;   // a Q or K tile
  constexpr int kStageBytes = kQKBytes + NB * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // Stage st: K at qs + kQKBytes + st * kStageBytes, V right after it.

  // Grid: x = head (the rep heads of one KV head are neighbours), y =
  // query tile from the last (heaviest under a causal mask), z = batch.
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + (h / rep) * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + (h / rep) * sv.h;

  // The keys any row of this block can reach: [k_begin, k_end).
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(q_last + 1, Sk) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBK;
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  load_tile<DQK, kThreads>(qs, qb, sq.s, q0, S, tid);
  load_tile<DQK, kThreads>(qs + kQKBytes, kb, sk.s, k_begin, Sk, tid);
  load_tile<DV, kThreads>(qs + 2 * kQKBytes, vb, sv.s, k_begin, Sk, tid);
  cp_async_commit();

  // Accumulator fragment of m64nNk16: register 4 i + e of this thread is
  // row 16 warp + lane / 4 + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2.
  const int row = q0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    if (t + 1 < n_tiles) {              // prefetch the next tile
      const uint32_t nxt = qs + kQKBytes + ((t + 1) & 1) * kStageBytes;
      load_tile<DQK, kThreads>(nxt, kb, sk.s, k0 + kBK, Sk, tid);
      load_tile<DV, kThreads>(nxt + kQKBytes, vb, sv.s, k0 + kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();               // this tile (and Q) has landed
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t ks = qs + kQKBytes + (t & 1) * kStageBytes;
    const uint32_t vs = ks + kQKBytes;

    // S = Q K^T over DQK in steps of 16.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
    wgmma_ss_tile<DQK>(s, qs, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Masks only where the tile meets the diagonal, the window edge or Sk.
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int qi = row + 8 * (e >> 1), kj = k0 + 8 * i + col + (e & 1);
          const bool ok = kj < Sk && (!causal || kj <= qi) &&
                          (window <= 0 || qi - kj < window);
          if (!ok) x = -INFINITY;       // p = 0 whatever the row max
        }
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // Online softmax; a row lives on the four lanes of a quad.
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      mb[r] = m_new * kLog2e;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(fmaf(s[i], kLog2e, -mb[(i >> 1) & 1]));
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
    // P as the A operand of m64nNk16, split into bf16 hi + lo.
    uint32_t hi[16], lo[16];
    split_bf16(s, hi, lo);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      fence_regs(acc[c]);
    }

    // O += P V as hi V + lo V: V's rows of 16 keys lie 2048 bytes apart.
    wgmma_fence();
    wgmma_rs_tile<NB>(acc, hi, lo, vs);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    __syncthreads();                    // this stage is free for reuse
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= S) continue;
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * gridDim.x + h) * S + qi] = m[r] + logf(den[r]);
    __nv_bfloat16* orow = o + b * so.b + h * so.h + qi * so.s + col;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * i) =
            __floats2bfloat162_rn(acc[c][4 * i + 2 * r] / den[r],
                                  acc[c][4 * i + 2 * r + 1] / den[r]);
  }
}

}  // namespace tc

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Strides3* st, int B, int H, int KV,
                       int S, int Sk, float scale, int causal, int window,
                       float softcap, int device, cudaStream_t stream) {
  static_assert(f32::kRows == 4, "the P V loop reads 4 rows as one float4");
  static std::atomic<unsigned> configured{0};
  const int bytes = f32::smem_floats<DQK, DV>() * (int)sizeof(float);
  const cudaError_t err = set_smem_once(f32::flash_f32_kernel<DQK, DV>,
                                        bytes, device, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + f32::kBQ - 1) / f32::kBQ, H, B);
  f32::flash_f32_kernel<DQK, DV><<<grid, f32::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1],
      st[2], st[3], H / KV, S, Sk, scale, causal, window, softcap);
  return cudaGetLastError();
}

// q, k and v must start every row on 16 bytes (the wrapper copies them
// when they do not).
template <int DQK, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, float* lse, const Strides3* st, int B, int H,
                        int KV, int S, int Sk, float scale, int causal,
                        int window, float softcap, int device,
                        cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  constexpr int bytes = tc::smem_bytes<DQK, DV>();
  const cudaError_t err = set_smem_once(tc::flash_bf16_kernel<DQK, DV>,
                                        bytes, device, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + tc::kBQ - 1) / tc::kBQ, B);
  tc::flash_bf16_kernel<DQK, DV><<<grid, tc::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, st[0], st[1], st[2], st[3],
      H / KV, S, Sk, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* o,
           void* lse, const int64_t* strides, int B, int H, int KV, int S,
           int Sk, int D, int Dv, float scale, int causal, int window,
           float softcap, int device, void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides3 st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto run = [&](auto launch_d) {
    return launch_d(q, k, v, o, static_cast<float*>(lse), st, B, H, KV, S,
                    Sk, scale, causal, window, softcap, device, s);
  };
  const auto is = [&](int dqk, int dv) { return D == dqk && Dv == dv; };
  err = cudaErrorInvalidValue;
  if constexpr (kBf16) {
    // No D = 32 or 96: neither is a whole number of 64-column wgmma blocks.
    if (is(64, 64)) err = run(launch_bf16<64, 64>);
    else if (is(128, 128)) err = run(launch_bf16<128, 128>);
    else if (is(256, 256)) err = run(launch_bf16<256, 256>);
    else if (is(192, 128)) err = run(launch_bf16<192, 128>);  // deepseek-v3
  } else {
    if (is(32, 32)) err = run(launch_f32<32, 32>);
    else if (is(64, 64)) err = run(launch_f32<64, 64>);
    else if (is(128, 128)) err = run(launch_f32<128, 128>);
    else if (is(256, 256)) err = run(launch_f32<256, 256>);
    else if (is(96, 64)) err = run(launch_f32<96, 64>);       // lm_moe_tiny
    else if (is(192, 128)) err = run(launch_f32<192, 128>);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). strides: (b, h, s) of q, k, v, o in
// elements; S the queries' length, Sk the keys' and values'; D the head
// dim of q and k, Dv that of v and o; window 0 = none, softcap 0 = none;
// lse, if not null, a dense (B, H, S) f32 output of each row's
// log-sum-exp (what the backward kernels read). Return the launch's CUDA
// error: 0 on success.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const int64_t* strides, int B, int H,
                                   int KV, int S, int Sk, int D, int Dv,
                                   float scale, int causal, int window,
                                   float softcap, int device, void* stream) {
  return launch<false>(q, k, v, o, lse, strides, B, H, KV, S, Sk, D, Dv,
                       scale, causal, window, softcap, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const int64_t* strides, int B, int H,
                                    int KV, int S, int Sk, int D, int Dv,
                                    float scale, int causal, int window,
                                    float softcap, int device, void* stream) {
  return launch<true>(q, k, v, o, lse, strides, B, H, KV, S, Sk, D, Dv,
                      scale, causal, window, softcap, device, stream);
}
