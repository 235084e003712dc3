// flash_attention — online-softmax GQA attention over positions 0..S-1,
// with causal, sliding-window and tanh-softcap masks.
//
//   o[b,h,q] = sum_k softmax_k(s[q,k]) v[b,h/rep,k],
//   s[q,k]   = softcap(q.k / sqrt(D)),  pair counted if k <= q (causal)
//              and q - k < window
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (`_flash_kernel`). The TPU kernel walks the KV axis as
// the innermost sequential grid dimension with (m, l, acc) in VMEM
// scratch; here one block owns 32 query rows of one (b, h) and loops over
// the key tiles itself, keeping m, l and acc in registers (f32, as on the
// TPU). Key tiles that no row of the block can reach (past the causal
// diagonal, or before the window) are never loaded, which is the TPU
// kernel's `pl.when(reachable)` at block granularity. Unlike the TPU
// kernel, S need not be a multiple of a tile: the tail tile is masked.
//
// Layout: 8 warps, each owning 4 query rows; a key tile of 32 keys, one
// per lane. A lane computes the scores of its key against the warp's 4
// rows (f32 FMAs over D, float4 loads from shared memory: K rows padded to
// D + 4 floats so a quarter-warp's 16-byte loads hit distinct banks, q
// rows read as broadcasts), the warp reduces the tile's max per row with
// shuffles, and then each lane accumulates P V for D / 32 columns of the
// output (lane + 32 c), reading the tile's probabilities as one float4
// broadcast per key. Nothing is held per thread as a whole row, so D = 256
// fits: 32 accumulators a thread. The per-lane partial denominators are
// rescaled with the row's max like acc and reduced once at the end; the
// denominator is clamped at 1e-30 as on the TPU.
//
// Bound on the H100: operations. At the serving shape (B=4, H=25, KV=5,
// S=2048, D=64, window 1024, bf16) the 1.57e8 unmasked pairs need 4 * D
// flops each (0.040 TFLOP in all), 0.041 ms at the bf16 tensor-core rate,
// against 0.019 ms to move q, k, v and o. This first kernel computes on the CUDA
// cores in f32 (no mma/wgmma yet), so it is bounded in practice by the
// shared-memory loads that feed those FMAs; inputs of either type are
// widened to f32 on their way into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kRows = 4;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per block
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

struct Strides3 {
  long long b, h, s;                    // in elements; the D axis is 1
};

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

template <int D>
constexpr int smem_floats() {
  // q rows, padded K tile, V tile, per-warp probabilities.
  return kBQ * D + kBK * (D + 4) + kBK * D + kWarps * kBK * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides3 sq,
             Strides3 sk, Strides3 sv, Strides3 so, int rep, int S,
             float scale, int causal, int window, float softcap) {
  constexpr int KS = D + 4;             // padded K row stride (floats)
  constexpr int NC = D / 32;            // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][D]
  float* ks = qs + kBQ * D;                      // [kBK][KS]
  float* vs = ks + kBK * KS;                     // [kBK][D]
  float* ps = vs + kBK * D;                      // [kWarps][kBK][kRows]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / rep) * sk.h;
  const T* vb = v + b * sv.b + (h / rep) * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    qs[i] = qi < S ? to_f32(qb[qi * sq.s + d]) : 0.0f;
  }

  // The keys any row of this block can reach: [k_begin, k_end).
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
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
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D, kj = k0 + j;
      const bool in = kj < S;
      ks[j * KS + d] = in ? to_f32(kb[kj * sk.s + d]) : 0.0f;
      vs[j * D + d] = in ? to_f32(vb[kj * sv.s + d]) : 0.0f;
    }
    __syncthreads();

    // Scores of this lane's key against the warp's rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* qr = reinterpret_cast<const float4*>(qs + warp * kRows * D);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = qr[r * (D / 4) + d4];
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
      const bool ok = kj < S && (!causal || kj <= qi) &&
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
      const float* vr = vs + j * D + lane;
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
      T* orow = o + b * so.b + h * so.h + qi * so.s + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[32 * c] = from_f32<T>(acc[r][c] / lt);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const int64_t* st, int B, int H, int KV, int S,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t stream) {
  static_assert(kRows == 4, "the P V loop reads 4 rows as one float4");
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const Strides3 sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H / KV,
      S, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int B, int H, int KV, int S, int D,
           float scale, int causal, int window, float softcap, int device,
           void* stream) {
  // Launch on the tensors' device and give the calling thread back its
  // current device, which PyTorch reads for its own defaults.
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      err = launch_d<T, 64>(q, k, v, o, strides, B, H, KV, S, scale, causal,
                            window, softcap, s);
      break;
    case 128:
      err = launch_d<T, 128>(q, k, v, o, strides, B, H, KV, S, scale, causal,
                             window, softcap, s);
      break;
    case 256:
      err = launch_d<T, 256>(q, k, v, o, strides, B, H, KV, S, scale, causal,
                             window, softcap, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry points (bound with ctypes). strides: (b, h, s) of q, k, v, o in
// elements; window 0 = none, softcap 0 = none. Return the launch's CUDA
// error: 0 on success.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const int64_t* strides, int B, int H,
                                   int KV, int S, int D, float scale,
                                   int causal, int window, float softcap,
                                   int device, void* stream) {
  return launch<float>(q, k, v, o, strides, B, H, KV, S, D, scale, causal,
                       window, softcap, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int64_t* strides, int B, int H,
                                    int KV, int S, int D, float scale,
                                    int causal, int window, float softcap,
                                    int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, S, D, scale,
                               causal, window, softcap, device, stream);
}
