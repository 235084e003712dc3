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
// sequential grid dimension with S in VMEM scratch. On the card the
// chunks run in parallel, one block per (b, h, chunk) in one launch
// (6,400 blocks at the serving shape). A block computes everything of its
// chunk that does not need the carried state: the cumulative logs, the
// strict-lower scores A, the chunk's local state U = sum_i (k[i]
// exp(logc[L-1] - logc[i]))^T v[i]. Only then does it wait for the block
// of the chunk before to publish the start state S_c (a flag in global
// memory, acquire/release), carries S_{c+1} = S_c exp(logc[L-1]) + U,
// publishes it for the next chunk at once, and computes its outputs
// o = inter + intra against S_c. The chain of states is K V work per
// chunk, and the blocks of one layer of chunks wait on it together, so
// their own work hides it. Blocks take their chunk from a ticket counter
// in the order they start, chunk-major, so a block only ever waits for
// one that is already running.
//
// Tiles load with 16-byte `cp.async` copies where a tensor's innermost
// stride is 1 and its rows are 16-byte aligned, and with plain loads
// otherwise (the SSD heads pass logw broadcast over the state dim, stride
// 0); k broadcast over heads (stride 0 on h) is read where it lies. The
// rows of a ragged last chunk are zero-filled (r = k = v = 0, logw = 0),
// which leaves the state unchanged: the reference's zero padding, with no
// copy of the inputs. All math is f32 on the CUDA cores, in register
// tiles of 4 x 4 (scores, outputs) or 1 x 4 (local state) fed by float4
// shared-memory reads, for which the (L, K) tiles are transposed to
// (K, L) in shared memory. Below the diagonal the scores factor the decay
// through the last row of each 4-row key block (both exponents <= 0), so
// they take 4 exps per state row of a 4 x 4 tile instead of 16. The
// cumulative logs are summed in order, as the reference does: their
// differences then cancel the same rounding. The SSD heads' shape (K, V,
// L) = (16, 64, 64) and RWKV6's time mix (64, 64, 64) are compiled with
// fixed sizes, which turns index arithmetic into shifts; others take the
// same code with sizes from the arguments (`wkv6_generic_f32` takes that
// generic build at every shape, to compare the two).
//
// Bound on the H100: bytes. At the serving shape (B=4, H=50, T=2048,
// K=16, V=64) the inputs and outputs are 0.29 GB against about 5 K V
// flops a step (0.01 TFLOP): 0.09 ms at 3.35 TB/s. The states cost 26 MB
// more each way.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

struct Strides4 {
  long long b, h, t, x;                 // in elements
};

// Shared-memory regions and rows of float4 reads start on 16 bytes.
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// Row of the (K, L) transposed tiles: 16-byte rows, skewed by 4 floats so
// a transposing write of consecutive k hits at most two rows per bank.
__host__ __device__ constexpr int row_lt(int L) { return round4(L) + 4; }

// The staging of r, k and logw rows, later the (L, L) scores.
__host__ __device__ constexpr int raw_floats(int K, int L) {
  return round4(3 * L * K) > round4(L) * round4(L) ? round4(3 * L * K)
                                                   : round4(L) * round4(L);
}

// Floats of shared memory a block uses: three (K, LT) tiles, two that
// hold a (K, LT) tile and later a (K, V) state, the staging of r, k and
// logw (later the scores), the (L, V) values, and the (K) total log decay
// and its exp.
__host__ __device__ constexpr int smem_floats(int K, int V, int L) {
  return 3 * K * row_lt(L) +
         2 * (row_lt(L) > round4(V) ? K * row_lt(L) : K * round4(V)) +
         raw_floats(K, L) + L * round4(V) + 2 * round4(K);
}

// Rows t0 .. t0 + L - 1 of one (b, h) slice (`src` points at it) of a
// (.., T, W) f32 tensor into dst[L][ld]; rows at or past T are zero. With
// `vec` the rows are contiguous and 16-byte aligned and go by cp.async
// (the caller commits and waits); otherwise by plain loads.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long st,
                                          long long sx, int t0, int T, int L,
                                          int W, bool vec, int tid) {
  if (vec) {
    const int W4 = W / 4;
    for (int e = tid; e < L * W4; e += kThreads) {
      const int t = e / W4, c = e % W4;
      const bool in = t0 + t < T;
      const float* g = in ? src + (t0 + t) * st + 4 * c : src;
      const uint32_t s = static_cast<uint32_t>(
          __cvta_generic_to_shared(dst + t * ld + 4 * c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(g), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int e = tid; e < L * W; e += kThreads) {
      const int t = e / W, x = e % W;
      dst[t * ld + x] = t0 + t < T ? src[(t0 + t) * st + x * sx] : 0.0f;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][b] += x[a] y[b] for 4-vectors x, y.
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 x,
                                       float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xs[a], ys[b], acc[a][b]);
}

// Bit i of `vec` says whether input i (r, k, v, logw) may go by cp.async,
// and kVecO whether o's rows take 16-byte stores.
enum { kVecR = 1, kVecK = 2, kVecV = 4, kVecW = 8, kVecO = 16 };

// Chunk c's start state is published by the block of chunk c - 1 of the
// same (b, h): it writes S_c to `states` and then sets that chunk's flag
// (flags and states are chunk-major: index c BH + bh).
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// One block per chunk. Blocks take their chunk from a ticket counter in
// the order they start, chunk-major over (b, h), so the block that
// publishes a chunk's start state started before any block that waits
// for it: no block waits on one that is not running.
//
// KC, VC, LC > 0 fix K, V and L at compile time (the serving shapes),
// which turns the index arithmetic into shifts and unrolls the loops;
// 0 takes them from the arguments.
template <int KC, int VC, int LC>
__global__ void __launch_bounds__(kThreads, 4)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ s0, float* __restrict__ o,
                  float* __restrict__ sT, float* __restrict__ states,
                  int* __restrict__ flags, Strides4 sr, Strides4 sk,
                  Strides4 sv, Strides4 sw, Strides4 ss, Strides4 so,
                  Strides4 st, int BH, int H, int T, int K_, int V_, int L_,
                  int nc, int vec) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int K = KC > 0 ? KC : K_, V = VC > 0 ? VC : V_, L = LC > 0 ? LC : L_;
  const int LT = row_lt(L), VP = round4(V), LB4 = round4(L) / 4;
  const int LA = round4(L), KW = K * (LT > VP ? LT : VP);
  const int tid = threadIdx.x;
  if (nc == 0) {                        // T = 0: s_final = s0
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    for (int e = tid; e < K * V; e += kThreads) {
      const int x = e / V, y = e % V;
      sT[b * st.b + h * st.h + x * st.t + y * st.x] =
          s0[b * ss.b + h * ss.h + x * ss.t + y * ss.x];
    }
    return;
  }
  extern __shared__ float4 sm4[];
  float* RT = reinterpret_cast<float*>(sm4);   // [K][LT] r, then r exp(logb)
  float* LCT = RT + K * LT;                    // [K][LT] logc
  float* LBT = LCT + K * LT;                   // [K][LT] logb
  float* KT = LBT + K * LT;                    // [K][LT] k, then k decayed
  float* S = KT;                               //   to the chunk's end; then
                                               //   [K][VP] the start state
  float* KH = KT + KW;                         // [K][LT] k decayed to the
  float* U = KH;                               //   end of its 4-row block;
                                               //   then [K][VP] local state
  float* raw = KH + KW;                        // [3][L][K] r, k, logw rows;
  float* AT = raw;                             //   then [LA][LA] scores^T
  float* Vt = raw + raw_floats(K, L);          // [L][VP]
  float* total = Vt + L * VP;                  // [K] logc[L-1]
  float* decay = total + round4(K);            // [K] exp(logc[L-1])

  __shared__ int ticket;
  if (tid == 0) ticket = atomicAdd(flags + BH * nc, 1);
  __syncthreads();
  const int c = ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H, t0 = c * L;
  float* Rr = raw;
  float* Kr = raw + L * K;
  float* Wr = raw + 2 * L * K;
  load_rows(Rr, K, r + b * sr.b + h * sr.h, sr.t, sr.x, t0, T, L, K,
            vec & kVecR, tid);
  load_rows(Kr, K, k + b * sk.b + h * sk.h, sk.t, sk.x, t0, T, L, K,
            vec & kVecK, tid);
  load_rows(Wr, K, w + b * sw.b + h * sw.h, sw.t, sw.x, t0, T, L, K,
            vec & kVecW, tid);
  load_rows(Vt, VP, v + b * sv.b + h * sv.h, sv.t, sv.x, t0, T, L, V,
            vec & kVecV, tid);
  cp_async_wait_all();
  __syncthreads();

  // Transpose r and k (all loads of a batch before its stores, which the
  // compiler cannot reorder across shared-memory stores).
  for (int e0 = 0; e0 < L * K; e0 += 4 * kThreads) {
    float rv[4], kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads + tid;
      rv[j] = e < L * K ? Rr[e] : 0.0f;
      kv[j] = e < L * K ? Kr[e] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads + tid;
      if (e < L * K) {
        RT[(e % K) * LT + e / K] = rv[j];
        KT[(e % K) * LT + e / K] = kv[j];
      }
    }
  }
  // Cumulative logs, one state row per thread in order (the reference's
  // order of summation), 8 steps' loads ahead of their stores.
  for (int x = tid; x < K; x += kThreads) {
    float acc = 0.0f;
    for (int t0c = 0; t0c < L; t0c += 8) {
      float lw[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lw[j] = t0c + j < L ? Wr[(t0c + j) * K + x] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (t0c + j < L) {
          acc += lw[j];
          LCT[x * LT + t0c + j] = acc;
          LBT[x * LT + t0c + j] = acc - lw[j];
        }
      }
    }
    total[x] = acc;
    decay[x] = expf(acc);
  }
  __syncthreads();

  // Keys decayed to the last row m of their 4-row block: exp(logc[m] -
  // logc[i]) <= 0 in the exponent (blocks past L are never read).
  for (int e = tid; e < K * L; e += kThreads) {
    const int x = e / L, i = e % L, m = (i | 3) < L ? (i | 3) : L - 1;
    const float* lc = LCT + x * LT;
    KH[x * LT + i] = KT[x * LT + i] *
                     exp2f(fminf(lc[m] - lc[i], 0.0f) * kLog2e);
  }
  __syncthreads();

  // Intra-chunk scores A[t][i], i < t, stored transposed (AT[i][t]) in
  // 4 x 4 tiles on and below the diagonal, zero where i >= t; rows and
  // columns past L (L not a multiple of 4) hold values nothing reads.
  // Below the diagonal every i of column block g precedes every t, so
  // with m = 4 g + 3 the decay factors as exp(logb[t] - logc[m]) exp(
  // logc[m] - logc[i]), both exponents <= 0: threads 0 .. 127 take these
  // tiles, 4 exps per state row instead of 16. Threads 128 .. 255 (other
  // warps, so neither group waits on the other's branch) take the
  // diagonal tiles element by element, with the exp of each pair's own
  // difference.
  constexpr int kHalf = kThreads / 2;
  if (tid < kHalf) {
    const int n_off = LB4 * (LB4 - 1) / 2;
    for (int p = tid; p < n_off; p += kHalf) {
      int tb = static_cast<int>((1.0f + sqrtf(8.0f * p + 1.0f)) * 0.5f);
      if (tb * (tb - 1) / 2 > p) --tb;
      if (tb * (tb + 1) / 2 <= p) ++tb;
      const int g = p - tb * (tb - 1) / 2;   // g < tb
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
#pragma unroll 4
      for (int x = 0; x < K; ++x) {
        const float4 r4 = ld4(RT + x * LT + 4 * tb);
        const float4 b4 = ld4(LBT + x * LT + 4 * tb);
        const float cm = LCT[x * LT + 4 * g + 3];
        const float q[4] = {
            r4.x * exp2f(fminf(b4.x - cm, 0.0f) * kLog2e),
            r4.y * exp2f(fminf(b4.y - cm, 0.0f) * kLog2e),
            r4.z * exp2f(fminf(b4.z - cm, 0.0f) * kLog2e),
            r4.w * exp2f(fminf(b4.w - cm, 0.0f) * kLog2e)};
        outer4(acc, make_float4(q[0], q[1], q[2], q[3]),
               ld4(KH + x * LT + 4 * g));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(AT + (4 * g + j) * LA + 4 * tb) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
  } else {
    for (int e = tid - kHalf; e < LB4 * 16; e += kHalf) {
      const int t = 4 * (e >> 4) + ((e >> 2) & 3);
      const int i = 4 * (e >> 4) + (e & 3);
      float a = 0.0f;
      if (i < t) {
#pragma unroll 4
        for (int x = 0; x < K; ++x)
          a += RT[x * LT + t] * KT[x * LT + i] *
               exp2f(fminf(LBT[x * LT + t] - LCT[x * LT + i], 0.0f) *
                     kLog2e);
      }
      AT[i * LA + t] = a;
    }
  }
  __syncthreads();
  // Queries decayed to the chunk's start, keys to its end.
  for (int e0 = 0; e0 < K * L; e0 += 4 * kThreads) {
    float rv[4], kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads + tid, x = e / L, q = x * LT + e % L;
      if (e < K * L) {
        rv[j] = RT[q] * expf(LBT[q]);
        kv[j] = KT[q] * expf(total[x] - LCT[q]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads + tid, q = (e / L) * LT + e % L;
      if (e < K * L) {
        RT[q] = rv[j];
        KT[q] = kv[j];
      }
    }
  }
  __syncthreads();

  // The chunk's local state U = sum_i k_i(decayed)^T v_i, a state row by
  // 4 columns per thread.
  const int VB = VP / 4;
  for (int u = tid; u < K * VB; u += kThreads) {
    const int x = u / VB, y = 4 * (u % VB);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      const float kx = KT[x * LT + i];
      const float4 vv = ld4(Vt + i * VP + y);
      acc.x = fmaf(kx, vv.x, acc.x);
      acc.y = fmaf(kx, vv.y, acc.y);
      acc.z = fmaf(kx, vv.z, acc.z);
      acc.w = fmaf(kx, vv.w, acc.w);
    }
    *reinterpret_cast<float4*>(U + x * VP + y) = acc;
  }

  // The start state: s0, or what chunk c - 1's block published. A wait
  // that outlasts any real run (a broken protocol) traps rather than
  // hangs.
  const long long kv = static_cast<long long>(K) * V;
  if (c > 0) {
    if (tid == 0) {
      const int* f = flags + (c - 1) * BH + bh;
      long long spins = 0;
      while (load_acquire(f) == 0) {
        __nanosleep(100);
        if (++spins > (1LL << 26)) __trap();
      }
    }
    __syncthreads();                    // also: KT is read, S may go there
    const float* prev = states + ((c - 1) * BH + bh) * kv;
    for (int e = tid; e < K * V; e += kThreads)
      S[(e / V) * VP + e % V] = __ldcg(prev + e);
  } else {
    __syncthreads();                    // KT is read, S may go there
    for (int e = tid; e < K * V; e += kThreads) {
      const int x = e / V, y = e % V;
      S[x * VP + y] = s0[b * ss.b + h * ss.h + x * ss.t + y * ss.x];
    }
  }
  __syncthreads();

  // Carry the state past this chunk and publish it for chunk c + 1.
  float* next = states + (static_cast<long long>(c) * BH + bh) * kv;
  for (int e = tid; e < K * V; e += kThreads) {
    const int x = e / V, y = e % V;
    const float s = S[x * VP + y] * decay[x] + U[x * VP + y];
    if (c + 1 < nc) __stcg(next + e, s);
    else sT[b * st.b + h * st.h + x * st.t + y * st.x] = s;
  }
  if (c + 1 < nc) {                     // the barrier orders every
    __syncthreads();                    // thread's state writes before
    if (tid == 0) {                     // thread 0's fence and release
      __threadfence();
      store_release(flags + c * BH + bh, 1);
    }
  }

  // Outputs in 4 x 4 tiles (4 steps by 4 columns): intra-chunk, then
  // inter-chunk against the start state, into one accumulator.
  for (int u = tid; u < LB4 * VB; u += kThreads) {
    const int tb = u / VB, y = 4 * (u % VB);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;
    const int i_end = min(4 * tb + 3, L);
#pragma unroll 4
    for (int i = 0; i < i_end; ++i)
      outer4(acc, ld4(AT + i * LA + 4 * tb), ld4(Vt + i * VP + y));
#pragma unroll 4
    for (int x = 0; x < K; ++x)
      outer4(acc, ld4(RT + x * LT + 4 * tb), ld4(S + x * VP + y));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * tb + a;
      if (t >= L || t0 + t >= T) continue;
      float* orow = o + b * so.b + h * so.h + (t0 + t) * so.t;
      if (vec & kVecO) {
        *reinterpret_cast<float4*>(orow + y) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (y + j < V) orow[(y + j) * so.x] = acc[a][j];
      }
    }
  }
}

// Whether a (B, H, T, W) input's rows can go by 16-byte copies.
bool rows_vec(const void* p, const Strides4& s, int W) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.x == 1 &&
         W % 4 == 0 && s.b % 4 == 0 && s.h % 4 == 0 && s.t % 4 == 0;
}

// Raise a kernel's dynamic shared-memory limit to the card's maximum
// (less its static shared memory) once per device, not on every launch.
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, int device,
                           std::atomic<unsigned>& done) {
  const unsigned bit = 1u << (device & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int max_bytes = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_bytes - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int KC, int VC, int LC>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* s0, void* o, void* sT,
                   const Strides4* s, int B, int H, int T, int K, int V,
                   int L, void* states, void* flags, int vec, int device,
                   cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  const cudaError_t err =
      configure_once(wkv6_chunk_kernel<KC, VC, LC>, device, configured);
  if (err != cudaSuccess) return err;
  const int nc = (T + L - 1) / L;
  const int blocks = nc > 0 ? B * H * nc : B * H;
  wkv6_chunk_kernel<KC, VC, LC>
      <<<blocks, kThreads, smem_floats(K, V, L) * sizeof(float), stream>>>(
          static_cast<const float*>(r), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(w),
          static_cast<const float*>(s0), static_cast<float*>(o),
          static_cast<float*>(sT), static_cast<float*>(states),
          static_cast<int*>(flags), s[0], s[1], s[2], s[3], s[4], s[5], s[6],
          B * H, H, T, K, V, L, nc, vec);
  return cudaGetLastError();
}

// Launch on the tensors' device (fixed: take a build fixed at the shape
// where there is one) and give the calling thread back its current
// device, which PyTorch reads for its own defaults.
int run(const void* r, const void* k, const void* v, const void* w,
        const void* s0, void* o, void* sT, const int64_t* st, int B, int H,
        int T, int K, int V, int L, void* states, void* flags, int device,
        void* stream, bool fixed) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides4 s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides4{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  const int vec = (rows_vec(r, s[0], K) ? kVecR : 0) |
                  (rows_vec(k, s[1], K) ? kVecK : 0) |
                  (rows_vec(v, s[2], V) ? kVecV : 0) |
                  (rows_vec(w, s[3], K) ? kVecW : 0) |
                  (rows_vec(o, s[5], V) ? kVecO : 0);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (fixed && K == 16 && V == 64 && L == 64)          // hymba's SSD heads
    err = launch<16, 64, 64>(r, k, v, w, s0, o, sT, s, B, H, T, K, V, L,
                             states, flags, vec, device, cs);
  else if (fixed && K == 64 && V == 64 && L == 64)     // rwkv6's time mix
    err = launch<64, 64, 64>(r, k, v, w, s0, o, sT, s, B, H, T, K, V, L,
                             states, flags, vec, device, cs);
  else
    err = launch<0, 0, 0>(r, k, v, w, s0, o, sT, s, B, H, T, K, V, L,
                          states, flags, vec, device, cs);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// C entry point (bound with ctypes). strides: (b, h, t, x) of r, k, v,
// logw, s0, o, s_final in elements (for s0 and s_final: b, h, K, V).
// states: B H nc K V floats, nc = ceil(T / L), each chunk's end state;
// flags: B H nc + 1 ints, zero on entry (the published flags, then the
// ticket counter). One launch; returns its CUDA error: 0 on success.
// The serving and training shapes (K, V, L) = (16, 64, 64) and
// (64, 64, 64) take builds fixed at them.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* s0, void* o, void* sT,
                        const int64_t* st, int B, int H, int T, int K, int V,
                        int L, void* states, void* flags, int device,
                        void* stream) {
  return run(r, k, v, w, s0, o, sT, st, B, H, T, K, V, L, states, flags,
             device, stream, true);
}

// The same launch through the generic build at every shape (sizes from
// the arguments), to hold the fixed builds against it.
extern "C" int wkv6_generic_f32(const void* r, const void* k, const void* v,
                                const void* w, const void* s0, void* o,
                                void* sT, const int64_t* st, int B, int H,
                                int T, int K, int V, int L, void* states,
                                void* flags, int device, void* stream) {
  return run(r, k, v, w, s0, o, sT, st, B, H, T, K, V, L, states, flags,
             device, stream, false);
}
