// ssd_bwd — the backward of `ssd.cu`'s two kernels, with the scan's
// backward (`wkv6_bwd`) between them, and the sums that are left.
//
//   back_bwd:  nh = g rstd,  dn = dy (1 + out_norm)
//              dg = rstd (dn - nh mean_e(dn nh)),  du = dg silu(z)  (f32)
//              dz = dg u silu'(z)  (into dxz's second half)
//              p2 = sum over a head's 64 channels of du xh,  partials of
//              dout_norm = sum dy nh
//   front_bwd: dxh  = (dv + cb du) dt + d_skip du,  dpre = dxh silu'(pre)
//              dxs[t - 3 + i] += conv_w[i] dpre[t]  (into dxz's first half)
//              dlw  = sum_n dlogw + exp(logw) sum_n dr ct
//              ddt  = sum_p dv xh + cb p2 - exp(a_log) dlw,
//              ddt_raw = ddt sigmoid(dt_raw + dt_b);  partials of
//              dconv_w, dconv_b, ddt_b, da_log, dd_skip
//   reduce:    each weight's partials summed over its client's tiles, and
//              the shared projections' dbt = dcb ct + sum_h dk, dct = dcb
//              bt + sum_h exp(logw) dr, dcb = sum_h dt p2
//
// u, g, pre and xh are recomputed from what the forward read (o, xz and
// the projections), not saved: the forward keeps only the per-row inverse
// RMS. The gradient of u is the scan's output gradient (u is o plus
// terms), written once in the layout the scan's backward reads; dk and
// dlogw come back dense from it and are summed over their broadcast axes
// here. Both halves of dxz are written by the kernels, so the input
// projection's backward reads one dense gradient.
//
// Replaces no TPU kernel (the reference differentiates XLA's fusion of
// the same arithmetic). Bound on the H100: bytes. At hymba-1.5b's 4 x
// 2048 rows: back_bwd reads dy, o, xh, z (0.26 GB) and writes du and dz
// (0.16 GB); front_bwd and the reduction read du, dv, xs and the scan's
// dense (H, T, 16) gradients (0.34 GB) and write dxs (0.05 GB): 0.81 GB,
// 0.24 ms at 3.35 TB/s. The conv's backward walks each tile's rows from
// the last up with its windows of conv inputs and of dpre in registers
// (each tile recomputes the 3 rows past its end), fetching each row's
// inputs a row ahead. At 2 channels a lane and 80 registers (6 blocks of
// 4 warps an SM) enough warps stay resident to cover the walk's load
// latency: 4 channels a lane at 138 registers took twice the time. Every
// sum runs in a fixed order, so two launches give the same bits.

#include "ssd.cuh"

namespace {

using namespace ssd;

constexpr int kPartsConv = kConvK + 1;   // conv_w's taps, then conv_b
constexpr int kPartsHead = 3;            // dt_b, a_log, d_skip

template <typename T>
__global__ void __launch_bounds__(1024) ssd_back_bwd_kernel(
    const T* __restrict__ dy, const float* __restrict__ o,
    const T* __restrict__ xh, const T* __restrict__ xz,
    const T* __restrict__ bt, const T* __restrict__ ct,
    const float* __restrict__ dt, const T* __restrict__ d_skip,
    const T* __restrict__ out_norm, WeightStrides ws,
    const float* __restrict__ rstd, float* __restrict__ du,
    T* __restrict__ dxz, float* __restrict__ p2,
    float* __restrict__ norm_part, int B, int T_, int E, int H,
    int tiles_per_seq) {
  __shared__ float red[32];
  const Tile tile(blockIdx.x, tiles_per_seq, kRowsBack, T_);
  const int g = tile.gb / B;
  const int c = 4 * threadIdx.x;
  const bool on = c < E;
  const int h = on ? c / kHeadDim : 0;
  float w1[4] = {1.f, 1.f, 1.f, 1.f}, D = 0.f, dnorm[4] = {0.f, 0.f, 0.f, 0.f};
  if (on) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w1[q] = 1.f + to_f32(out_norm[g * ws.out_norm + c + q]);
    D = to_f32(d_skip[g * ws.d_skip + h]);
  }
  const size_t seq = (size_t)tile.gb * T_;
  for (int t = tile.t0; t < tile.t1; ++t) {
    const size_t row = seq + t;
    BackRow<T, true> cur;
    cur.fetch(o, xh, xz, dy, bt, ct, dt, row, E, H, c, h, on);
    const float cb = cur.cb();
    const float rs = rstd[row];
    float u[4] = {0.f, 0.f, 0.f, 0.f}, nh[4] = {0.f, 0.f, 0.f, 0.f};
    float dn[4] = {0.f, 0.f, 0.f, 0.f}, dot = 0.f;
    if (on) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u[q] = round_to<T>(cur.o[q] + cb * (cur.x[q] * cur.d) +
                           D * cur.x[q]);
        nh[q] = u[q] * silu(cur.z[q]) * rs;
        dn[q] = cur.dy[q] * w1[q];
        dot += dn[q] * nh[q];
        dnorm[q] += cur.dy[q] * nh[q];
      }
    }
    const float mean = block_sum(dot, red) / E;
    float pp = 0.f;
    if (on) {
      float duv[4], dz[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dg = rs * (dn[q] - nh[q] * mean);
        duv[q] = dg * silu(cur.z[q]);
        dz[q] = dg * u[q] * dsilu(cur.z[q]);
        pp += duv[q] * cur.x[q];
      }
      store(du + row * E + c, duv);
      store(dxz + row * 2 * E + E + c, dz);
    }
    pp = head_sum(pp);
    if (on && threadIdx.x % kLanes == 0) p2[row * H + h] = pp;
  }
  if (on) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      norm_part[(size_t)blockIdx.x * E + c + q] = dnorm[q];
  }
}

// front_bwd: 2 channels a lane, a head a warp, up to 4 heads a block.
constexpr int kBwdCh = 2;
constexpr int kBwdHeads = 4;

// One row's inputs to the conv's backward, fetched a row ahead of their
// use: the conv input entering the window (row t - 3), du and dv for the
// lane's 2 channels, and its head's per-row values; lane j < 16 also takes
// state row j of ct, bt, dlogw and dr.
template <typename T>
struct FrontRow {
  float x[kBwdCh], du[kBwdCh], dv[kBwdCh];
  float ct, bt, dl, dr, d, lw, p2, u;
  __device__ __forceinline__ void fetch(
      const float* du_, const float* dv_, const float* dr_,
      const float* dlogw, const float* p2_, const T* xz, const T* tail,
      const T* dt_raw, const T* bt_, const T* ct_, const float* dt,
      const float* logw, int gb, int t, int T_, int E, int H, int h, int c,
      int j) {
    const size_t row = (size_t)gb * T_ + t;
    const int n = j % kState;
    const size_t a = (((size_t)gb * H + h) * T_ + t) * kState + n;
    conv_in(xz, tail, gb, t - (kConvK - 1), T_, E, c, x);
    load(du_ + row * E + c, du);
    load(dv_ + (((size_t)gb * H + h) * T_ + t) * kHeadDim + kBwdCh * j, dv);
    ct = to_f32(ct_[row * kState + n]);
    bt = to_f32(bt_[row * kState + n]);
    dl = dlogw[a];
    dr = dr_[a];
    d = dt[row * H + h];
    lw = logw[row * H + h];
    p2 = p2_[row * H + h];
    u = to_f32(dt_raw[row * H + h]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdHeads * 32, 6) ssd_front_bwd_kernel(
    const float* __restrict__ du, const float* __restrict__ dv,
    const float* __restrict__ dr, const float* __restrict__ dlogw,
    const float* __restrict__ p2, const T* __restrict__ xz,
    const T* __restrict__ tail, const T* __restrict__ dt_raw,
    const T* __restrict__ bt, const T* __restrict__ ct,
    const T* __restrict__ conv_w, const T* __restrict__ conv_b,
    const T* __restrict__ dt_b, const T* __restrict__ a_log,
    const T* __restrict__ d_skip, WeightStrides ws,
    const float* __restrict__ dt, const float* __restrict__ logw,
    T* __restrict__ dxz, T* __restrict__ ddt_raw, T* __restrict__ dtail,
    float* __restrict__ conv_part, float* __restrict__ head_part, int B,
    int T_, int E, int H, int heads_per_block, int tiles_per_seq) {
  const Tile tile(blockIdx.x, tiles_per_seq, kRowsFront, T_);
  const int g = tile.gb / B;
  const size_t seq = (size_t)tile.gb * T_;
  const int h = blockIdx.y * heads_per_block + threadIdx.x / 32;
  const int j = threadIdx.x % 32;
  if (threadIdx.x >= heads_per_block * 32 || h >= H) return;   // whole warps
  const int c = h * kHeadDim + kBwdCh * j;
  float w[kConvK][kBwdCh], bias[kBwdCh];
#pragma unroll
  for (int q = 0; q < kBwdCh; ++q) {
#pragma unroll
    for (int i = 0; i < kConvK; ++i)
      w[i][q] = to_f32(conv_w[g * ws.conv_w + (size_t)i * E + c + q]);
    bias[q] = to_f32(conv_b[g * ws.conv_b + c + q]);
  }
  const float A = expf(to_f32(a_log[g * ws.a_log + h]));
  const float dtb = to_f32(dt_b[g * ws.dt_b + h]);
  const float D = to_f32(d_skip[g * ws.d_skip + h]);

  float dw[kConvK][kBwdCh], db[kBwdCh];
#pragma unroll
  for (int q = 0; q < kBwdCh; ++q) {
    db[q] = 0.f;
#pragma unroll
    for (int i = 0; i < kConvK; ++i) dw[i][q] = 0.f;
  }
  float acc_dtb = 0.f, acc_alog = 0.f, acc_d = 0.f;
  // From the last row whose dpre reaches the tile's dxs down to its first:
  // xw[i] is conv input t - 3 + i, dp[i] is dpre[t + i] (0 past T). Each
  // row's inputs are fetched a row ahead of their use.
  const int t_top = min(tile.t1 + kConvK - 1, T_) - 1;
  float xw[kConvK][kBwdCh], dp[kConvK][kBwdCh];
#pragma unroll
  for (int i = 0; i < kConvK; ++i) {
    if (i < kConvK - 1)
      conv_in(xz, tail, tile.gb, t_top - (kConvK - 2) + i, T_, E, c, xw[i]);
    zero(dp[i]);
  }
  FrontRow<T> cur, next;
  next.fetch(du, dv, dr, dlogw, p2, xz, tail, dt_raw, bt, ct, dt, logw,
             tile.gb, t_top, T_, E, H, h, c, j);
  for (int t = t_top; t >= tile.t0; --t) {
    const size_t row = seq + t;
    cur = next;
    if (t > tile.t0)
      next.fetch(du, dv, dr, dlogw, p2, xz, tail, dt_raw, bt, ct, dt, logw,
                 tile.gb, t - 1, T_, E, H, h, c, j);
#pragma unroll
    for (int i = kConvK - 1; i > 0; --i)
#pragma unroll
      for (int q = 0; q < kBwdCh; ++q) {
        xw[i][q] = xw[i - 1][q];
        dp[i][q] = dp[i - 1][q];
      }
#pragma unroll
    for (int q = 0; q < kBwdCh; ++q) xw[0][q] = cur.x[q];
    const float cb = warp_sum(j < kState ? cur.ct * cur.bt : 0.f);
    float xo[kBwdCh];
#pragma unroll
    for (int q = 0; q < kBwdCh; ++q) {
      const float pre = conv_pre(xw, w, bias, q);
      xo[q] = round_to<T>(silu(pre));
      const float dxh = (cur.dv[q] + cb * cur.du[q]) * cur.d + D * cur.du[q];
      dp[0][q] = dxh * dsilu(pre);
    }
    if (t < tile.t1) {
      float dx[kBwdCh], p1 = 0.f;
#pragma unroll
      for (int q = 0; q < kBwdCh; ++q) {
        float acc = w[0][q] * dp[3][q];
#pragma unroll
        for (int i = 1; i < kConvK; ++i) acc += w[i][q] * dp[kConvK - 1 - i][q];
        dx[q] = acc;
#pragma unroll
        for (int i = 0; i < kConvK; ++i) dw[i][q] += xw[i][q] * dp[0][q];
        db[q] += dp[0][q];
        p1 += cur.dv[q] * xo[q];
      }
      store(dxz + row * 2 * E + c, dx);
      p1 = warp_sum(p1);
      const float sdl = warp_sum(j < kState ? cur.dl : 0.f);
      const float sdr = warp_sum(j < kState ? cur.dr * cur.ct : 0.f);
      const float dlw = sdl + expf(cur.lw) * sdr;
      const float ddr = (p1 + cb * cur.p2 - A * dlw) * sigmoid(cur.u + dtb);
      if (j == 0) ddt_raw[row * H + h] = from_f32<T>(ddr);
      acc_dtb += ddr;
      acc_alog += A * cur.d * dlw;
      acc_d += cur.p2;
    }
  }
  // The tail's gradient: conv inputs -3 .. -1 feed rows 0 .. 2.
  if (tile.t0 == 0 && dtail != nullptr) {
#pragma unroll
    for (int m = 0; m < kConvK - 1; ++m) {
      float dx[kBwdCh];
#pragma unroll
      for (int q = 0; q < kBwdCh; ++q) {
        float acc = w[0][q] * dp[m][q];
#pragma unroll
        for (int i = 1; i <= m; ++i) acc += w[i][q] * dp[m - i][q];
        dx[q] = acc;
      }
      store(dtail + ((size_t)tile.gb * (kConvK - 1) + m) * E + c, dx);
    }
  }
  float* cp = conv_part + (size_t)blockIdx.x * kPartsConv * E + c;
#pragma unroll
  for (int q = 0; q < kBwdCh; ++q) {
#pragma unroll
    for (int i = 0; i < kConvK; ++i) cp[(size_t)i * E + q] = dw[i][q];
    cp[(size_t)kConvK * E + q] = db[q];
  }
  if (j == 0) {
    float* hp = head_part + (size_t)blockIdx.x * kPartsHead * H + h;
    hp[0] = acc_dtb;
    hp[H] = -acc_alog;
    hp[2 * H] = acc_d;
  }
}

// The sums that the conv's backward leaves: one thread per weight element
// of one client (its partials summed over the client's tiles in order),
// then one per (row, state row) for the shared projections B and C, whose
// gradients sum over heads: dbt = dcb ct + sum_h dk, dct = dcb bt + sum_h
// exp(logw) dr, dcb = sum_h dt p2.
template <typename T>
__global__ void __launch_bounds__(256) ssd_reduce_kernel(
    const float* __restrict__ conv_part, const float* __restrict__ head_part,
    const float* __restrict__ norm_part, const float* __restrict__ dt,
    const float* __restrict__ p2, const float* __restrict__ dk,
    const float* __restrict__ dr, const float* __restrict__ logw,
    const T* __restrict__ bt, const T* __restrict__ ct,
    T* __restrict__ dconv_w, T* __restrict__ dconv_b,
    T* __restrict__ dout_norm, T* __restrict__ ddt_b, T* __restrict__ da_log,
    T* __restrict__ dd_skip, T* __restrict__ dbt, T* __restrict__ dct, int G,
    int B, int T_, int E, int H, int front_tiles, int back_tiles) {
  const long long cols = (long long)(kPartsConv + 1) * E + kPartsHead * H;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= G * cols) {
    const long long pair = idx - G * cols;
    if (pair >= (long long)G * B * T_ * kState) return;
    const size_t row = pair / kState;
    const int n = (int)(pair % kState);
    const size_t gb = row / T_, t = row % T_;
    float dcb = 0.f, sk = 0.f, sr = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t a = ((gb * H + h) * T_ + t) * kState + n;
      dcb += dt[row * H + h] * p2[row * H + h];
      sk += dk[a];
      sr += expf(logw[row * H + h]) * dr[a];
    }
    dbt[pair] = from_f32<T>(dcb * to_f32(ct[pair]) + sk);
    dct[pair] = from_f32<T>(dcb * to_f32(bt[pair]) + sr);
    return;
  }
  const int g = (int)(idx / cols), col = (int)(idx % cols);
  float acc = 0.f;
  if (col < kPartsConv * E) {
    const float* p = conv_part + (size_t)g * front_tiles * kPartsConv * E + col;
    for (int k = 0; k < front_tiles; ++k) acc += p[(size_t)k * kPartsConv * E];
    if (col < kConvK * E)
      dconv_w[(size_t)g * kConvK * E + col] = from_f32<T>(acc);
    else
      dconv_b[(size_t)g * E + col - kConvK * E] = from_f32<T>(acc);
  } else if (col < (kPartsConv + 1) * E) {
    const int e = col - kPartsConv * E;
    const float* p = norm_part + (size_t)g * back_tiles * E + e;
    for (int k = 0; k < back_tiles; ++k) acc += p[(size_t)k * E];
    dout_norm[(size_t)g * E + e] = from_f32<T>(acc);
  } else {
    const int m = col - (kPartsConv + 1) * E;
    const float* p = head_part + (size_t)g * front_tiles * kPartsHead * H + m;
    for (int k = 0; k < front_tiles; ++k) acc += p[(size_t)k * kPartsHead * H];
    T* out = m < H ? ddt_b : m < 2 * H ? da_log : dd_skip;
    out[(size_t)g * H + m % H] = from_f32<T>(acc);
  }
}

template <typename T>
int back_bwd(const void* dy, const void* o, const void* xh, const void* xz,
             const void* bt, const void* ct, const void* dt,
             const void* d_skip, const void* out_norm, const int64_t* st,
             const void* rstd, void* du, void* dxz, void* p2,
             void* norm_part, int G, int B, int T_, int E, int H, int device,
             void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const WeightStrides ws{st[0], st[1], st[2], st[3], st[4], st[5]};
  const int tiles_per_seq = (T_ + kRowsBack - 1) / kRowsBack;
  const int blocks = G * B * tiles_per_seq;
  if (blocks == 0) return (int)cudaSuccess;
  ssd_back_bwd_kernel<T><<<blocks, round32(E / 4), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dy), static_cast<const float*>(o),
      static_cast<const T*>(xh), static_cast<const T*>(xz),
      static_cast<const T*>(bt), static_cast<const T*>(ct),
      static_cast<const float*>(dt), static_cast<const T*>(d_skip),
      static_cast<const T*>(out_norm), ws, static_cast<const float*>(rstd),
      static_cast<float*>(du), static_cast<T*>(dxz), static_cast<float*>(p2),
      static_cast<float*>(norm_part), B, T_, E, H, tiles_per_seq);
  return (int)cudaGetLastError();
}

template <typename T>
int front_bwd(const void* du, const void* dv, const void* dr, const void* dk,
              const void* dlogw, const void* p2, const void* xz,
              const void* tail, const void* dt_raw, const void* bt,
              const void* ct, const void* conv_w, const void* conv_b,
              const void* dt_b, const void* a_log, const void* d_skip,
              const int64_t* st, const void* dt, const void* logw,
              const void* norm_part, void* dxz, void* ddt_raw, void* dbt,
              void* dct, void* dtail, void* dconv_w, void* dconv_b,
              void* ddt_b, void* da_log, void* dd_skip, void* dout_norm,
              void* conv_part, void* head_part, int G, int B, int T_, int E,
              int H, int device, void* stream) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const WeightStrides ws{st[0], st[1], st[2], st[3], st[4], st[5]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int tiles_per_seq = (T_ + kRowsFront - 1) / kRowsFront;
  int rounds, hpb;
  head_rounds(H, kBwdHeads, &rounds, &hpb);
  const dim3 grid(G * B * tiles_per_seq, rounds);
  if (grid.x > 0) {
    ssd_front_bwd_kernel<T><<<grid, hpb * 32, 0, cs>>>(
        static_cast<const float*>(du), static_cast<const float*>(dv),
        static_cast<const float*>(dr), static_cast<const float*>(dlogw),
        static_cast<const float*>(p2), static_cast<const T*>(xz),
        static_cast<const T*>(tail), static_cast<const T*>(dt_raw),
        static_cast<const T*>(bt), static_cast<const T*>(ct),
        static_cast<const T*>(conv_w), static_cast<const T*>(conv_b),
        static_cast<const T*>(dt_b), static_cast<const T*>(a_log),
        static_cast<const T*>(d_skip), ws, static_cast<const float*>(dt),
        static_cast<const float*>(logw), static_cast<T*>(dxz),
        static_cast<T*>(ddt_raw), static_cast<T*>(dtail),
        static_cast<float*>(conv_part), static_cast<float*>(head_part), B, T_,
        E, H, hpb, tiles_per_seq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long outs =
      (long long)G * ((kPartsConv + 1) * E + kPartsHead * H) +
      (long long)G * B * T_ * kState;
  ssd_reduce_kernel<T><<<(unsigned)((outs + 255) / 256), 256, 0, cs>>>(
      static_cast<const float*>(conv_part),
      static_cast<const float*>(head_part),
      static_cast<const float*>(norm_part), static_cast<const float*>(dt),
      static_cast<const float*>(p2), static_cast<const float*>(dk),
      static_cast<const float*>(dr), static_cast<const float*>(logw),
      static_cast<const T*>(bt), static_cast<const T*>(ct),
      static_cast<T*>(dconv_w), static_cast<T*>(dconv_b),
      static_cast<T*>(dout_norm), static_cast<T*>(ddt_b),
      static_cast<T*>(da_log), static_cast<T*>(dd_skip), static_cast<T*>(dbt),
      static_cast<T*>(dct), G, B, T_, E, H, B * tiles_per_seq,
      B * ((T_ + kRowsBack - 1) / kRowsBack));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes); shapes and dtypes as in `ssd.cu`'s.
// back_bwd: dy (G, B T, E) model dtype; du (G, B T, E) f32, dz into
// dxz[..., E:], p2 (G, B T, H) f32, norm_part (G B ceil(T / 16), E) f32.
// front_bwd: du; dv (G B, H, T, 64), dr, dk and dlogw (G B, H, T, 16) f32
// dense; dxs into dxz[..., :E]; ddt_raw, dbt, dct, dtail (null: none)
// and the weights' gradients in the model dtype; conv_part (G B ceil(T /
// 64), 5, E) and head_part (G B ceil(T / 64), 3, H) f32 scratch. It
// launches the conv's backward and then the reduction; each returns the
// first CUDA error: 0 on success.
#define SSD_BACK_BWD(NAME, T)                                               \
  extern "C" int NAME(const void* dy, const void* o, const void* xh,         \
                      const void* xz, const void* bt, const void* ct,        \
                      const void* dt, const void* d_skip,                    \
                      const void* out_norm, const int64_t* st,               \
                      const void* rstd, void* du, void* dxz, void* p2,       \
                      void* norm_part, int G, int B, int T_, int E, int H,   \
                      int device, void* stream) {                            \
    return back_bwd<T>(dy, o, xh, xz, bt, ct, dt, d_skip, out_norm, st,      \
                       rstd, du, dxz, p2, norm_part, G, B, T_, E, H, device, \
                       stream);                                              \
  }
SSD_BACK_BWD(ssd_back_bwd_f32, float)
SSD_BACK_BWD(ssd_back_bwd_bf16, __nv_bfloat16)

#define SSD_FRONT_BWD(NAME, T)                                              \
  extern "C" int NAME(                                                       \
      const void* du, const void* dv, const void* dr, const void* dk,        \
      const void* dlogw, const void* p2, const void* xz, const void* tail,   \
      const void* dt_raw, const void* bt, const void* ct,                    \
      const void* conv_w, const void* conv_b, const void* dt_b,              \
      const void* a_log, const void* d_skip, const int64_t* st,              \
      const void* dt, const void* logw, const void* norm_part, void* dxz,    \
      void* ddt_raw, void* dbt, void* dct, void* dtail, void* dconv_w,       \
      void* dconv_b, void* ddt_b, void* da_log, void* dd_skip,               \
      void* dout_norm, void* conv_part, void* head_part, int G, int B,       \
      int T_, int E, int H, int device, void* stream) {                      \
    return front_bwd<T>(du, dv, dr, dk, dlogw, p2, xz, tail, dt_raw, bt, ct, \
                        conv_w, conv_b, dt_b, a_log, d_skip, st, dt, logw,   \
                        norm_part, dxz, ddt_raw, dbt, dct, dtail, dconv_w,   \
                        dconv_b, ddt_b, da_log, dd_skip, dout_norm,          \
                        conv_part, head_part, G, B, T_, E, H, device,        \
                        stream);                                             \
  }
SSD_FRONT_BWD(ssd_front_bwd_f32, float)
SSD_FRONT_BWD(ssd_front_bwd_bf16, __nv_bfloat16)
