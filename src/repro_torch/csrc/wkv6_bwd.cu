// wkv6_bwd — the gradient of `wkv6`, the strict-past chunked decayed
// outer-product scan
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t^T S_{t-1},  w = exp(logw)
//
// dr, dk, dv, dlogw and ds0 from the inputs, dO, the gradient of the end
// state and the forward's chunk start states. The TPU has no such
// kernel: the reference trains through `jax.grad` of its jnp scan
// (`repro/models/lm/scan_core.py::chunked_decay_scan`). This kernel is
// the backward of the port's CUDA forward (`wkv6.cu`), which hands each
// chunk's end state to the next chunk through a buffer that the autograd
// forward keeps for this kernel.
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
//   dS     <- dS exp(logc[L-1]) + dU,  dU = sum_t (r[t] exp(logb[t]))^T dO[t]
// and, with q_t = r_t dr_t and p_t = k_t dk_t (elementwise over k), the
// decay's gradient is a suffix sum over the whole sequence,
//   dlogw[s] = sum_{t >= s} (q_t - p_t) - q_s + sum_v dS_T S_T,
// because every term of S_{t-1} carries exp(logc up to t-1) and every use
// of k_i carries exp(-logc up to i). Every exponent is <= 0 and nothing
// is divided by w, so strong decay is as stable as in the forward.
//
// Chunk-parallel, the mirror of the forward: one block per (b, h,
// chunk), all in one launch, blocks taking their chunk from a ticket
// counter in reverse chunk order (so the block a chunk waits for started
// before it). A block first computes everything of its chunk that does
// not need dS: the cumulative logs, A and dA, the local part of dv, dr
// whole (it needs the start state, which the forward kept, not dS), the
// local part of dk, the chunk's local state U = sum_i (k[i] exp(logc[L-1]
// - logc[i]))^T v[i] and dU, and the chunk's sums of q and of k times the
// local dk. Only then does it wait for the block of chunk c + 1 to
// publish (dS, carry) through a buffer and a flag (release / acquire,
// as the forward), and at once publishes for chunk c - 1
//   dS_{c-1} = dS exp(logc[L-1]) + dU,
//   carry_{c-1} = carry + sum_t q_t - sum_t k_t dk_t,
// the last sum being the local part plus sum_v dS U, a K V pass: so the
// chain carries the dlogw suffix across chunks too, and its hop is K V
// work. The last chunk starts from dS_T and sum_v dS_T S_T with S_T = S
// exp(logc[L-1]) + U; chunk 0 writes dS_{-1} as ds0. Then the block adds
// dS's terms to dv and dk and takes the suffix sum within its chunk.
//
// Products run in register tiles of 4 rows by 4 (or, for the (L, K)
// outputs at K <= 16, 1) columns fed by float4 shared-memory reads, one
// tile a thread, on and below the diagonal for the triangular ones; rows
// are padded by 4 floats. The ragged last chunk is zero-filled (r = k = v
// = dO = 0, logw = 0, which changes nothing) and computes only its rows
// rounded up to 4 (T = 33 at chunk 64 computes 36). All math is f32 on
// the CUDA cores. K, V <= 64 and L <= 64, each a multiple of 4: at K = V
// = L = 64 (rwkv6) a block takes 192,768 bytes of shared memory, at the
// SSD heads' (16, 64, 64) 105,024, two blocks an SM.
//
// Bound on the H100: bytes. At the full-width training shape (B=2, H=50,
// T=2048, K=16, V=64) the SSD heads pass k and logw as broadcast views,
// and the gradient's inputs and outputs are ~0.22 GB: ~0.067 ms at 3.35
// TB/s (the forward's chunk states, 12.7 MB, are read rather than
// recomputed, which is this kernel's choice, not the bound's). A chunk's
// work is ~1.4 M flops and ~0.1 M decays (each pair's taken three times,
// for A, dr and dk), issued from shared-memory tiles: that, not the
// 32-hop hand-off chain, bounds it in practice (a launch of as many
// blocks without the chain takes as long).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

struct Strides4 {
  long long b, h, t, x;                 // in elements
};

struct Dims {
  int B, H, T, K, V, L, nc;
};

// Floats of shared memory a block uses (rows padded by 4): r, k, logc,
// logb (then q), k decayed to the chunk's end, r decayed to its start
// (then k dk) as (L, K); v, dO (then reduction scratch) as (L, V); the
// start state S (K, V); A (then dS) and dA (L, L); and five (K) vectors.
__host__ __device__ constexpr int smem_floats(int K, int V, int L) {
  return 6 * L * (K + 4) + 2 * L * (V + 4) + K * (V + 4) +
         (L * (L + 4) > K * (V + 4) ? L * (L + 4) : K * (V + 4)) +
         L * (L + 4) + 5 * K;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// acc + a . b, one fma at a time in order: a dot product over 4 v of
// 4, so summed as a single chain in index order.
__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
// TN consecutive floats at p (16-byte aligned when TN = 4).
template <int TN>
__device__ __forceinline__ void ldn(float (&x)[TN], const float* p) {
  if constexpr (TN == 4) {
    const float4 v = ld4(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) x[j] = p[j];
  }
}
// acc[a][b] += x[a] y[b] for 4-vectors x, y.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& x,
                                       const float4& y) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[a][b] = fmaf(at4(x, a), at4(y, b), acc[a][b]);
}
// exp(min(a - b, 0)): the decay between two cumulative logs, the
// hardware exp2 of a product with log2(e) (a few ulps, against expf's
// one or two: the sums it feeds stay within a few tenths of the
// tolerance of the plain version, PERF.md).
__device__ __forceinline__ float decay(float a, float b) {
  return __expf(fminf(a - b, 0.0f));
}

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

// Rows t0 .. t0 + n - 1 of one (b, h) slice (`src` points at it) of a
// (.., T, W) f32 tensor with strides (t, x) into dst[n][ld] by 4-byte
// `cp.async` copies, all in flight at once whatever the strides (the
// caller commits and waits); rows at or past T are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long st,
                                          long long sx, int t0, int T, int n,
                                          int W) {
  for (int e = threadIdx.x; e < n * W; e += kThreads) {
    const int t = e / W, x = e % W;
    const bool in = t0 + t < T;
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + t * ld + x));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(in ? src + (t0 + t) * st + x * sx : src),
                 "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// TN: columns per thread of the (L, K) outputs (dr, dk): 1 at K <= 16,
// else 4, so that about one 4-row tile falls to each thread.
// Two blocks an SM at K <= 16 (105 KB of shared memory at the SSD heads'
// shape); above it one, with the registers to keep its tiles.
template <int TN>
__global__ void __launch_bounds__(kThreads, TN == 1 ? 2 : 1)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ s0, const float* __restrict__ dout,
                const float* __restrict__ dsT, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ ds0,
                const float* __restrict__ states, float* __restrict__ xfer,
                int* __restrict__ flags, Strides4 sr, Strides4 sk,
                Strides4 sv, Strides4 sw, Strides4 ss0, Strides4 sg,
                Strides4 sdT, Dims dm) {
  const int K = dm.K, V = dm.V, L = dm.L, T = dm.T, nc = dm.nc;
  const int BH = dm.B * dm.H;
  const int ldK = K + 4, ldV = V + 4, ldL = L + 4;
  extern __shared__ float4 sm4[];
  float* R = reinterpret_cast<float*>(sm4);     // [L][ldK] each
  float* KK = R + L * ldK;
  float* LC = KK + L * ldK;                     // logw, then logc
  float* LB = LC + L * ldK;                     // logb, then q = r dr
  float* KD = LB + L * ldK;                     // k exp(logc[L-1] - logc)
  float* RB = KD + L * ldK;                     // r exp(logb), then k dk
  float* VV = RB + L * ldK;                     // [L][ldV] each
  float* G = VV + L * ldV;                      // dO, then scratch
  float* S = G + L * ldV;                       // [K][ldV]
  float* AA = S + K * ldV;                      // [L][ldL] A, then dS
  float* DA = AA + (L * ldL > K * ldV ? L * ldL : K * ldV);   // [L][ldL]
  float* total = DA + L * ldL;                  // [K] each: logc[L-1]
  float* decay_t = total + K;                   //   exp(logc[L-1])
  float* carry = decay_t + K;                   //   dlogw carried in
  float* qsum = carry + K;                      //   sum_t q
  float* psum = qsum + K;                       //   sum_t k dk (local)
  float* Q = LB;
  float* P = RB;
  float* DS = AA;

  __shared__ int ticket;
  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(flags + BH * nc, 1);
  __syncthreads();
  const int c = nc - 1 - ticket / BH, bh = ticket % BH;
  const int b = bh / dm.H, h = bh % dm.H, t0 = c * L;
  const int Lc = min(L, (T - t0 + 3) & ~3);     // rows computed
  const int Lq = Lc / 4;
  const long long KV = static_cast<long long>(K) * V, slot = KV + K;

  // ---- loads: the chunk's rows and its start state.
  load_rows(R, ldK, r + b * sr.b + h * sr.h, sr.t, sr.x, t0, T, Lc, K);
  load_rows(KK, ldK, k + b * sk.b + h * sk.h, sk.t, sk.x, t0, T, Lc, K);
  load_rows(LC, ldK, w + b * sw.b + h * sw.h, sw.t, sw.x, t0, T, Lc, K);
  load_rows(VV, ldV, v + b * sv.b + h * sv.h, sv.t, sv.x, t0, T, Lc, V);
  load_rows(G, ldV, dout + b * sg.b + h * sg.h, sg.t, sg.x, t0, T, Lc, V);
  if (c == 0)
    load_rows(S, ldV, s0 + b * ss0.b + h * ss0.h, ss0.t, ss0.x, 0, K, K, V);
  else
    load_rows(S, ldV, states + (static_cast<long long>(c - 1) * BH + bh) * KV,
              V, 1, 0, K, K, V);
  cp_async_wait_all();
  __syncthreads();

  // ---- cumulative logs, one state row per thread, summed in order (the
  // reference's order: their differences then cancel the same rounding).
  for (int x = tid; x < K; x += kThreads) {
    float acc = 0.0f;
    for (int t0c = 0; t0c < Lc; t0c += 4) {   // Lc is a multiple of 4
      float lw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) lw[j] = LC[(t0c + j) * ldK + x];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc += lw[j];
        LC[(t0c + j) * ldK + x] = acc;
        LB[(t0c + j) * ldK + x] = acc - lw[j];
      }
    }
    total[x] = acc;
    decay_t[x] = expf(acc);
  }
  __syncthreads();
  for (int e = tid; e < Lc * K; e += kThreads) {
    const int at = (e / K) * ldK + e % K;
    KD[at] = KK[at] * decay(total[e % K], LC[at]);
    RB[at] = R[at] * expf(LB[at]);
  }

  // ---- A and dA in 4 x 4 tiles on and below the diagonal (zero where
  // i >= t): an A tile (K / 4 steps of 64 decays) a thread on threads
  // [0, n_low), the cheaper dA tiles (V / 4 steps of 64 fmas) round robin
  // on the others (n_low <= 136 < kThreads).
  const int n_low = Lq * (Lq + 1) / 2;
  for (int u = tid < n_low ? 2 * tid : 2 * (tid - n_low) + 1; u < 2 * n_low;
       u += tid < n_low ? 2 * n_low : 2 * (kThreads - n_low)) {
    const int p = u >> 1;
    int tb = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
    if (tb * (tb + 1) / 2 > p) --tb;
    if ((tb + 1) * (tb + 2) / 2 <= p) ++tb;
    const int g = p - tb * (tb + 1) / 2;        // g <= tb
    float acc[4][4] = {};
    if (u & 1) {                                // dA = dO v^T
      for (int x = 0; x < V; x += 4) {
        float4 gx[4], vx[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          gx[a] = ld4(G + (4 * tb + a) * ldV + x);
          vx[a] = ld4(VV + (4 * g + a) * ldV + x);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fma4(gx[a], vx[j], acc[a][j]);
      }
    } else {                                    // A, the decay per pair
      for (int x = 0; x < K; x += 4) {
        float4 rx[4], bx[4], kx[4], cx[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          rx[a] = ld4(R + (4 * tb + a) * ldK + x);
          bx[a] = ld4(LB + (4 * tb + a) * ldK + x);
          kx[a] = ld4(KK + (4 * g + a) * ldK + x);
          cx[a] = ld4(LC + (4 * g + a) * ldK + x);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              acc[a][j] = fmaf(at4(rx[a], y) * at4(kx[j], y),
                               decay(at4(bx[a], y), at4(cx[j], y)),
                               acc[a][j]);
      }
    }
    float* out = (u & 1) ? DA : AA;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g == tb && j >= a) acc[a][j] = 0.0f;
      *reinterpret_cast<float4*>(out + (4 * tb + a) * ldL + 4 * g) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
  __syncthreads();

  // ---- dS-free products, one tile a thread each. (L, V) tiles: rows
  // 4 vr + a, columns 4 vc + b; (K, V): rows TN vr + a, columns 4 vc + b;
  // (L, K): rows 4 kr + a, columns TN kc + b.
  const int nV = V / 4, nK = K / TN;
  const int vr = tid / nV, vc = tid % nV, kr = tid / nK, kc = tid % nK;
  const bool has_v = tid < Lq * nV, has_k = tid < Lq * nK;
  const bool has_s = tid < (K / TN) * nV;
  float dvl[4][4] = {}, dkl[4][TN] = {}, q[4][TN] = {};
  float U[TN][4] = {}, dU[TN][4] = {};
  if (has_v)                                    // sum_{t>i} A[t,i] dO[t]
    for (int t = 4 * vr + 1; t < Lc; ++t)
      outer4(dvl, ld4(AA + t * ldL + 4 * vr), ld4(G + t * ldV + 4 * vc));
  if (has_s)
    for (int i = 0; i < Lc; ++i) {
      float kd[TN], rb[TN];
      ldn(kd, KD + i * ldK + TN * vr);
      ldn(rb, RB + i * ldK + TN * vr);
      const float4 vv = ld4(VV + i * ldV + 4 * vc);
      const float4 gg = ld4(G + i * ldV + 4 * vc);
#pragma unroll
      for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          U[a][j] = fmaf(kd[a], at4(vv, j), U[a][j]);
          dU[a][j] = fmaf(rb[a], at4(gg, j), dU[a][j]);
        }
    }
  if (has_k) {
    float sdo[4][TN] = {}, intra[4][TN] = {}, lb[4][TN], lc[4][TN];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ldn(lb[a], LB + (4 * kr + a) * ldK + TN * kc);
      ldn(lc[a], LC + (4 * kr + a) * ldK + TN * kc);
    }
    // dr: exp(logb) (S dO[t]) + sum_{i<t} dA[t,i] k[i] e[t,i].
    for (int x = 0; x < V; x += 4) {
      float4 gx[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gx[a] = ld4(G + (4 * kr + a) * ldV + x);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 sx = ld4(S + (TN * kc + j) * ldV + x);
#pragma unroll
        for (int a = 0; a < 4; ++a) sdo[a][j] = fma4(gx[a], sx, sdo[a][j]);
      }
    }
    const int i_end = min(4 * kr + 3, Lc);
    for (int i = 0; i < i_end; ++i) {
      float kx[TN], cx[TN];
      ldn(kx, KK + i * ldK + TN * kc);
      ldn(cx, LC + i * ldK + TN * kc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float da = DA[(4 * kr + a) * ldL + i];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          intra[a][j] = fmaf(da * kx[j], decay(lb[a][j], cx[j]), intra[a][j]);
      }
    }
    // The local dk: sum_{t>i} dA[t,i] r[t] e[t,i].
    for (int t = 4 * kr + 1; t < Lc; ++t) {
      const float4 da = ld4(DA + t * ldL + 4 * kr);
      float rx[TN], bx[TN];
      ldn(rx, R + t * ldK + TN * kc);
      ldn(bx, LB + t * ldK + TN * kc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          dkl[a][j] = fmaf(at4(da, a) * rx[j], decay(bx[j], lc[a][j]),
                           dkl[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * kr + a;
      float d[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        d[j] = fmaf(expf(lb[a][j]), sdo[a][j], intra[a][j]);
        q[a][j] = R[t * ldK + TN * kc + j] * d[j];
      }
      if (t0 + t < T) {
        float* o = dr + (static_cast<long long>(bh) * T + t0 + t) * K +
                   TN * kc;
        if constexpr (TN == 4)
          *reinterpret_cast<float4*>(o) = make_float4(d[0], d[1], d[2], d[3]);
        else
          o[0] = d[0];
      }
    }
  }
  __syncthreads();                              // LB and RB are free
  if (has_k)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int at = (4 * kr + a) * ldK + TN * kc + j;
        Q[at] = q[a][j];
        P[at] = KK[at] * dkl[a][j];
      }
  __syncthreads();
  for (int x = tid; x < K; x += kThreads) {
    float sq = 0.0f, sp = 0.0f;
#pragma unroll 4
    for (int t = 0; t < Lc; ++t) {
      sq += Q[t * ldK + x];
      sp += P[t * ldK + x];
    }
    qsum[x] = sq;
    psum[x] = sp;
  }

  // ---- the hand-off: dS and the dlogw carry from chunk c + 1 (or dS_T),
  // then dS_{c-1} and carry_{c-1} for chunk c - 1 (or ds0) at once.
  if (c == nc - 1) {
    for (int e = tid; e < K * V; e += kThreads) {
      const int x = e / V, y = e % V;
      DS[x * ldV + y] =
          dsT ? dsT[b * sdT.b + h * sdT.h + x * sdT.t + y * sdT.x] : 0.0f;
    }
  } else {
    if (tid == 0) {                             // a wait that outlasts any
      const int* f = flags + c * BH + bh;       // real run traps
      long long spins = 0;
      while (load_acquire(f) == 0) {
        __nanosleep(100);
        if (++spins > (1LL << 26)) __trap();
      }
    }
    __syncthreads();
    // 16-byte copies through L2 (.cg): the slot is 16-byte aligned.
    const float* in = xfer + (static_cast<long long>(c) * BH + bh) * slot;
    for (int e = tid; e < K * V / 4; e += kThreads) {
      const int x = (4 * e) / V, y = (4 * e) % V;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(
                           __cvta_generic_to_shared(DS + x * ldV + y))),
                   "l"(in + 4 * e)
                   : "memory");
    }
    for (int x = tid; x < K; x += kThreads) carry[x] = __ldcg(in + KV + x);
    cp_async_wait_all();
  }
  __syncthreads();
  float* out = c > 0
      ? xfer + (static_cast<long long>(c - 1) * BH + bh) * slot : nullptr;
  float* red_u = G;                             // [K][nV]: sum dS U
  float* red_s = G + K * nV;                    // [K][nV]: sum dS S
  if (has_s) {
#pragma unroll
    for (int a = 0; a < TN; ++a) {
      const int x = TN * vr + a;
      const float4 d4 = ld4(DS + x * ldV + 4 * vc);
      const float4 s4 = ld4(S + x * ldV + 4 * vc);
      float nx[4], su = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nx[j] = fmaf(at4(d4, j), decay_t[x], dU[a][j]);
        su = fmaf(at4(d4, j), U[a][j], su);
      }
      red_u[x * nV + vc] = su;
      red_s[x * nV + vc] = fma4(d4, s4, 0.0f);
      float* o = c > 0 ? out + x * V + 4 * vc
                       : ds0 + static_cast<long long>(bh) * KV + x * V + 4 * vc;
      if (c > 0) __stcg(reinterpret_cast<float4*>(o),
                        make_float4(nx[0], nx[1], nx[2], nx[3]));
      else *reinterpret_cast<float4*>(o) = make_float4(nx[0], nx[1], nx[2],
                                                       nx[3]);
    }
  }
  __syncthreads();
  for (int x = tid; x < K; x += kThreads) {
    float su = 0.0f, ss = 0.0f;
    for (int j = 0; j < nV; ++j) {
      su += red_u[x * nV + j];
      ss += red_s[x * nV + j];
    }
    // The last chunk's carry: sum_v dS_T S_T, S_T = S exp(logc[L-1]) + U.
    const float cin = c == nc - 1 ? fmaf(decay_t[x], ss, su) : carry[x];
    carry[x] = cin;
    if (c > 0) __stcg(out + KV + x, cin + qsum[x] - psum[x] - su);
  }
  if (c > 0) {                                  // the barrier orders every
    __syncthreads();                            // thread's writes before
    if (tid == 0) {                             // thread 0's fence and
      __threadfence();                          // release
      store_release(flags + (c - 1) * BH + bh, 1);
    }
  }

  // ---- dS's terms: dv += (k[i] exp(logc[L-1] - logc[i]))^T dS, dk +=
  // exp(logc[L-1] - logc[i]) (dS v[i]); then p = k dk.
  if (has_v) {
#pragma unroll 4
    for (int x = 0; x < K; ++x) {
      const float4 d4 = ld4(DS + x * ldV + 4 * vc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float kd = KD[(4 * vr + a) * ldK + x];
#pragma unroll
        for (int j = 0; j < 4; ++j) dvl[a][j] = fmaf(kd, at4(d4, j), dvl[a][j]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * vr + a;
      if (t0 + i < T)
        *reinterpret_cast<float4*>(
            dv + (static_cast<long long>(bh) * T + t0 + i) * V + 4 * vc) =
            make_float4(dvl[a][0], dvl[a][1], dvl[a][2], dvl[a][3]);
    }
  }
  if (has_k) {
    float sv[4][TN] = {};
    for (int x = 0; x < V; x += 4) {
      float4 vx[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) vx[a] = ld4(VV + (4 * kr + a) * ldV + x);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 d4 = ld4(DS + (TN * kc + j) * ldV + x);
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a][j] = fma4(vx[a], d4, sv[a][j]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * kr + a;
      float d[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int x = TN * kc + j, at = i * ldK + x;
        d[j] = fmaf(decay(total[x], LC[at]), sv[a][j], dkl[a][j]);
        P[at] = KK[at] * d[j];
      }
      if (t0 + i < T) {
        float* o = dk + (static_cast<long long>(bh) * T + t0 + i) * K +
                   TN * kc;
        if constexpr (TN == 4)
          *reinterpret_cast<float4*>(o) = make_float4(d[0], d[1], d[2], d[3]);
        else
          o[0] = d[0];
      }
    }
  }
  __syncthreads();

  // ---- dlogw: the suffix sum within the chunk, from the carry.
  for (int x = tid; x < K; x += kThreads) {
    float run = carry[x];
    for (int tb = Lc - 4; tb >= 0; tb -= 4) {
      float qv[4], pv[4];
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        qv[j] = Q[(tb + j) * ldK + x];
        pv[j] = P[(tb + j) * ldK + x];
      }
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        run += qv[j] - pv[j];
        if (t0 + tb + j < T)
          dw[(static_cast<long long>(bh) * T + t0 + tb + j) * K + x] =
              run - qv[j];
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to the card's maximum
// (less its static shared memory) once per device.
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

template <int TN>
cudaError_t launch(const float* const* in, float* const* out,
                   const float* states, float* xfer, int* flags,
                   const Strides4* s, Dims dm, int device,
                   cudaStream_t stream) {
  static std::atomic<unsigned> configured{0};
  const cudaError_t err =
      configure_once(wkv6_bwd_kernel<TN>, device, configured);
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<TN>
      <<<dm.B * dm.H * dm.nc, kThreads,
         smem_floats(dm.K, dm.V, dm.L) * sizeof(float), stream>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0], out[1],
          out[2], out[3], out[4], states, xfer, flags, s[0], s[1], s[2], s[3],
          s[4], s[5], s[6], dm);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). st: the 4 strides of r, k, v, logw,
// s0, dO, dS_T (elements); dS_T may be null (zero). dr, dk, dlogw are
// dense (B, H, T, K), dv (B, H, T, V), ds0 (B, H, K, V). states: the
// forward's start states of chunks 1 .. nc - 1, dense (nc - 1, B, H, K,
// V), nc = ceil(T / L) >= 1; xfer: scratch of (nc - 1) B H (K V + K)
// floats; flags: B H nc + 1 ints, zero on entry. K, V and L multiples
// of 4, at most 64. One launch; returns its CUDA error.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* s0, const void* dout,
                            const void* dsT, void* dr, void* dk, void* dv,
                            void* dw, void* ds0, const void* states,
                            void* xfer, void* flags, const int64_t* st,
                            int B, int H, int T, int K, int V, int L,
                            int device, void* stream) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides4 s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides4{st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]};
  const float* in[7] = {
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(s0), static_cast<const float*>(dout),
      static_cast<const float*>(dsT)};
  float* out[5] = {static_cast<float*>(dr), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dw),
                   static_cast<float*>(ds0)};
  const Dims dm{B, H, T, K, V, L, (T + L - 1) / L};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (K % 4 || V % 4 || L % 4 || K > 64 || V > 64 || L > 64 || T < 1)
    err = cudaErrorInvalidValue;
  else if (K <= 16)
    err = launch<1>(in, out, static_cast<const float*>(states),
                    static_cast<float*>(xfer), static_cast<int*>(flags), s,
                    dm, device, cs);
  else
    err = launch<4>(in, out, static_cast<const float*>(states),
                    static_cast<float*>(xfer), static_cast<int*>(flags), s,
                    dm, device, cs);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
