// ssd — the SSD heads' elementwise work on each side of the `wkv6` scan,
// forward (the backward is `ssd_bwd.cu`).
//
//   front: xh   = silu(conv_b + sum_i xs[t - 3 + i] conv_w[i])   (model dtype)
//          dt   = softplus(dt_raw + dt_b),  logw = -dt exp(a_log)
//          v    = xh dt,  r = ct exp(logw),  k = bt              (f32)
//   back:  u    = round(o + (ct . bt) dt xh + d_skip xh)         (model dtype)
//          g    = u silu(z),  y = g (mean g^2 + eps)^-1/2 (1 + out_norm)
//
// Replaces no TPU kernel: the reference leaves this work to XLA, which
// fuses it around its scan. In the port's plain composition it was some
// 90 PyTorch launches a layer forward and backward (the causal conv's
// shifted slices and their zero-filled backward, f32 copies, the gate, the
// norm), 12.7 GB a layer-step at full-width hymba-1.5b (4 x 2048 tokens).
//
// Bound on the H100: bytes. The front reads xs and the small projections
// and writes xh, v and r (the scan's inputs in the layouts it already
// read: r and v (B, T, H, .) rows, read transposed); the back reads o, xh
// and z and writes y. At hymba-1.5b's 4 x 2048 rows (E = 3,200, H = 50):
// 0.24 GB and 0.27 GB, 0.07 and 0.08 ms at 3.35 TB/s. Neither keeps an
// intermediate in device memory that the next step reads back: the conv
// window rides in registers as a thread walks down its rows, and the
// norm's row sum is a block reduction. The back kernel saves only the
// per-row inverse RMS for the backward.
//
// Work split (`ssd.cuh`): 4 channels a thread, a head a half warp. The
// front kernel's block is one 64-row tile of one sequence and up to 16
// heads; each thread walks the tile's rows keeping the conv's last three
// inputs, and lane j of a head writes r's state row j. The back kernel's
// block owns whole rows (the norm is over all E channels), 16 of them,
// and fetches each row's inputs one row ahead of their use.

#include "ssd.cuh"

namespace {

using namespace ssd;

template <typename T>
__global__ void __launch_bounds__(256) ssd_front_kernel(
    const T* __restrict__ xz, const T* __restrict__ dt_raw,
    const T* __restrict__ bt, const T* __restrict__ ct,
    const T* __restrict__ conv_w, const T* __restrict__ conv_b,
    const T* __restrict__ dt_b, const T* __restrict__ a_log,
    const T* __restrict__ tail, WeightStrides ws, T* __restrict__ xh,
    float* __restrict__ r, float* __restrict__ v, float* __restrict__ k,
    float* __restrict__ dt, float* __restrict__ logw, int B, int T_, int E,
    int H, int heads_per_block, int tiles_per_seq) {
  const Tile tile(blockIdx.x, tiles_per_seq, kRowsFront, T_);
  const int g = tile.gb / B;
  const int h = blockIdx.y * heads_per_block + threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;
  if (threadIdx.x >= heads_per_block * kLanes || h >= H) return;
  const int c = h * kHeadDim + 4 * j;

  float w[kConvK][4], bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < kConvK; ++i)
      w[i][q] = to_f32(conv_w[g * ws.conv_w + (size_t)i * E + c + q]);
    bias[q] = to_f32(conv_b[g * ws.conv_b + c + q]);
  }
  const float A = expf(to_f32(a_log[g * ws.a_log + h]));
  const float dtb = to_f32(dt_b[g * ws.dt_b + h]);

  float xw[kConvK][4];                 // conv inputs t - 3 .. t
#pragma unroll
  for (int i = 0; i < kConvK - 1; ++i)
    conv_in(xz, tail, tile.gb, tile.t0 - (kConvK - 1) + i, T_, E, c, xw[i]);
#pragma unroll 2
  for (int t = tile.t0; t < tile.t1; ++t) {
    const size_t row = (size_t)tile.gb * T_ + t;
    load(xz + row * 2 * E + c, xw[kConvK - 1]);
    const float d = softplus(to_f32(dt_raw[row * H + h]) + dtb);
    const float lw = -d * A;
    float xo[4], vo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xo[q] = round_to<T>(silu(conv_pre(xw, w, bias, q)));
      vo[q] = xo[q] * d;
    }
    store(xh + row * E + c, xo);
    store(v + row * E + c, vo);
    r[(row * H + h) * kState + j] = to_f32(ct[row * kState + j]) * expf(lw);
    if (j == 0) {
      dt[row * H + h] = d;
      logw[row * H + h] = lw;
    }
    if (h == 0) k[row * kState + j] = to_f32(bt[row * kState + j]);
#pragma unroll
    for (int i = 0; i < kConvK - 1; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) xw[i][q] = xw[i + 1][q];
  }
}

template <typename T>
__global__ void __launch_bounds__(1024) ssd_back_kernel(
    const float* __restrict__ o, const T* __restrict__ xh,
    const T* __restrict__ xz, const T* __restrict__ bt,
    const T* __restrict__ ct, const float* __restrict__ dt,
    const T* __restrict__ d_skip, const T* __restrict__ out_norm,
    WeightStrides ws, T* __restrict__ y, float* __restrict__ rstd, int B,
    int T_, int E, int H, int tiles_per_seq) {
  __shared__ float red[32];
  const Tile tile(blockIdx.x, tiles_per_seq, kRowsBack, T_);
  const int g = tile.gb / B;
  const int c = 4 * threadIdx.x;
  const bool on = c < E;
  const int h = on ? c / kHeadDim : 0;
  float w1[4] = {1.f, 1.f, 1.f, 1.f}, D = 0.f;
  if (on) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w1[q] = 1.f + to_f32(out_norm[g * ws.out_norm + c + q]);
    D = to_f32(d_skip[g * ws.d_skip + h]);
  }
  const size_t seq = (size_t)tile.gb * T_;
  BackRow<T, false> cur, next;
  if (tile.t0 < tile.t1)
    next.fetch(o, xh, xz, nullptr, bt, ct, dt, seq + tile.t0, E, H, c, h, on);
  for (int t = tile.t0; t < tile.t1; ++t) {
    const size_t row = seq + t;
    cur = next;
    if (t + 1 < tile.t1)
      next.fetch(o, xh, xz, nullptr, bt, ct, dt, row + 1, E, H, c, h, on);
    const float cb = cur.cb();
    float gq[4] = {0.f, 0.f, 0.f, 0.f}, ss = 0.f;
    if (on) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float u = round_to<T>(cur.o[q] + cb * (cur.x[q] * cur.d) +
                                    D * cur.x[q]);
        gq[q] = u * silu(cur.z[q]);
        ss += gq[q] * gq[q];
      }
    }
    const float rs = 1.f / sqrtf(block_sum(ss, red) / E + kNormEps);
    if (on) {
      float yo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) yo[q] = gq[q] * rs * w1[q];
      store(y + row * E + c, yo);
    }
    if (threadIdx.x == 0) rstd[row] = rs;
  }
}

template <typename T>
int front(const void* xz, const void* dt_raw, const void* bt, const void* ct,
          const void* conv_w, const void* conv_b, const void* dt_b,
          const void* a_log, const void* tail, const int64_t* st, void* xh,
          void* r, void* v, void* k, void* dt, void* logw, int G, int B,
          int T_, int E, int H, int device, void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const WeightStrides ws{st[0], st[1], st[2], st[3], st[4], st[5]};
  const int tiles_per_seq = (T_ + kRowsFront - 1) / kRowsFront;
  int rounds, hpb;
  head_rounds(H, 256 / kLanes, &rounds, &hpb);
  const dim3 grid(G * B * tiles_per_seq, rounds);
  if (grid.x == 0) return (int)cudaSuccess;
  ssd_front_kernel<T><<<grid, round32(hpb * kLanes), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xz), static_cast<const T*>(dt_raw),
      static_cast<const T*>(bt), static_cast<const T*>(ct),
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b),
      static_cast<const T*>(dt_b), static_cast<const T*>(a_log),
      static_cast<const T*>(tail), ws, static_cast<T*>(xh),
      static_cast<float*>(r), static_cast<float*>(v), static_cast<float*>(k),
      static_cast<float*>(dt), static_cast<float*>(logw), B, T_, E, H, hpb,
      tiles_per_seq);
  return (int)cudaGetLastError();
}

template <typename T>
int back(const void* o, const void* xh, const void* xz, const void* bt,
         const void* ct, const void* dt, const void* d_skip,
         const void* out_norm, const int64_t* st, void* y, void* rstd, int G,
         int B, int T_, int E, int H, int device, void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const WeightStrides ws{st[0], st[1], st[2], st[3], st[4], st[5]};
  const int tiles_per_seq = (T_ + kRowsBack - 1) / kRowsBack;
  const int blocks = G * B * tiles_per_seq;
  if (blocks == 0) return (int)cudaSuccess;
  ssd_back_kernel<T><<<blocks, round32(E / 4), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const T*>(xh),
      static_cast<const T*>(xz), static_cast<const T*>(bt),
      static_cast<const T*>(ct), static_cast<const float*>(dt),
      static_cast<const T*>(d_skip), static_cast<const T*>(out_norm), ws,
      static_cast<T*>(y), static_cast<float*>(rstd), B, T_, E, H,
      tiles_per_seq);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Model-dtype tensors (f32 or bf16,
// one dtype throughout): xz (G, B T, 2E), dt_raw (G, B T, H), bt / ct
// (G, B T, 16), conv_w (G, 4, E), conv_b / out_norm (G, E), dt_b / a_log /
// d_skip (G, H), tail (G, B, 3, E) or null, xh / y (G, B T, E). f32: r
// (G B, T, H, 16), v and o (G B, T, H, 64), k (G, B T, 16), dt / logw
// (G, B T, H), rstd (G, B T). All dense but the weights, whose client
// strides are `st` (conv_w, conv_b, dt_b, a_log, d_skip, out_norm). Each
// launches one kernel and returns its CUDA error: 0 on success.
#define SSD_FRONT(NAME, T)                                                  \
  extern "C" int NAME(const void* xz, const void* dt_raw, const void* bt,    \
                      const void* ct, const void* conv_w,                    \
                      const void* conv_b, const void* dt_b,                  \
                      const void* a_log, const void* tail,                   \
                      const int64_t* st, void* xh, void* r, void* v,         \
                      void* k, void* dt, void* logw, int G, int B, int T_,   \
                      int E, int H, int device, void* stream) {              \
    return front<T>(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, tail,  \
                    st, xh, r, v, k, dt, logw, G, B, T_, E, H, device,       \
                    stream);                                                 \
  }
SSD_FRONT(ssd_front_f32, float)
SSD_FRONT(ssd_front_bf16, __nv_bfloat16)

#define SSD_BACK(NAME, T)                                                   \
  extern "C" int NAME(const void* o, const void* xh, const void* xz,         \
                      const void* bt, const void* ct, const void* dt,        \
                      const void* d_skip, const void* out_norm,              \
                      const int64_t* st, void* y, void* rstd, int G, int B,  \
                      int T_, int E, int H, int device, void* stream) {      \
    return back<T>(o, xh, xz, bt, ct, dt, d_skip, out_norm, st, y, rstd, G,  \
                   B, T_, E, H, device, stream);                             \
  }
SSD_BACK(ssd_back_f32, float)
SSD_BACK(ssd_back_bf16, __nv_bfloat16)
