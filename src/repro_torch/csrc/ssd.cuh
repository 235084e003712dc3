// ssd.cuh — what the SSD heads' kernels (`ssd.cu`, `ssd_bwd.cu`) share:
// their fixed widths, the row tiles, the model dtype's conversions, 4- and
// 2-wide loads and stores, the activations, and the reductions over a
// head's lanes and over a block.
//
// Layout of the work. A thread takes 4 consecutive channels of d_inner
// (E = H * 64), so one head is 16 lanes, a half warp, and lane j of a head
// also owns state row j (N = 16); the conv's backward, which keeps the
// most in registers, takes 2 channels, a head a warp. A row tile is rows
// t0 .. t0 + R - 1 of one sequence, so a tile never spans two clients:
// the weights' gradients are summed per client from per-tile partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kHeadDim = 64;
constexpr int kState = 16;
constexpr int kConvK = 4;
constexpr int kLanes = kHeadDim / 4;   // lanes of one head
constexpr int kRowsFront = 64;         // rows a thread walks in the conv kernels
constexpr int kRowsBack = 16;          // rows a block walks in the norm kernels
constexpr float kNormEps = 1e-5f;

// Strides over the client axis (G) of the per-client weights, in elements;
// their other axes are dense.
struct WeightStrides {
  long long conv_w, conv_b, dt_b, a_log, d_skip, out_norm;
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
// v rounded to the model's dtype, back in f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// N = 4 or 2 consecutive elements, at a boundary of their size.
__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load(const float* p, float (&x)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  x[0] = a.x; x[1] = a.y;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x[0] = a.x; x[1] = a.y;
}
__device__ __forceinline__ void store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}
template <int N> __device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) x[q] = 0.f;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.f + x * (1.f - s));
}
// Exact softplus, as logaddexp(u, 0).
__device__ __forceinline__ float softplus(float u) {
  return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

// Sum over the 16 lanes of a head (a half warp; only those lanes take
// part). The butterfly leaves the same bits in every lane.
__device__ __forceinline__ float head_sum(float v) {
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1) v += __shfl_xor_sync(mask, v, m);
  return v;
}

// Sum over the warp, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum over the block (blockDim.x a multiple of 32, every thread calling);
// every thread gets the same bits. red: 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  __syncthreads();                     // red's last reads are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

// One row's inputs to the norm kernels (`ssd_back_kernel` and its
// backward), fetched a row ahead of their use so that two rows' loads are
// in flight: the scan's output o, xh, z and (kGrad) dy for the thread's 4
// channels, its head's dt, and state row (lane % 16) of ct and bt.
template <typename T, bool kGrad>
struct BackRow {
  float o[4], x[4], z[4], dy[kGrad ? 4 : 1], d, ct, bt;
  __device__ __forceinline__ void fetch(const float* o_, const T* xh,
                                        const T* xz, const T* dy_,
                                        const T* bt_, const T* ct_,
                                        const float* dt, size_t row, int E,
                                        int H, int c, int h, bool on) {
    const int n = threadIdx.x % kState;
    ct = to_f32(ct_[row * kState + n]);
    bt = to_f32(bt_[row * kState + n]);
    if (!on) return;
    load(o_ + row * E + c, o);
    load(xh + row * E + c, x);
    load(xz + row * 2 * E + E + c, z);
    if constexpr (kGrad) load(dy_ + row * E + c, dy);
    d = dt[row * H + h];
  }
  // ct . bt of the row, in every lane (lanes 16 .. 31 repeat 0 .. 15).
  __device__ __forceinline__ float cb() const {
    return warp_sum((threadIdx.x & 31) < kState ? ct * bt : 0.f);
  }
};

// Row tile `tile` of sequences of T rows: its sequence (g B + b), first
// row and end.
struct Tile {
  int gb, t0, t1;
  __device__ Tile(int tile, int tiles_per_seq, int rows, int T)
      : gb(tile / tiles_per_seq),
        t0((tile % tiles_per_seq) * rows),
        t1(min((tile % tiles_per_seq) * rows + rows, T)) {}
};

// Row t of the conv's input (t < 0: the tail, or zeros) for channels
// c .. c + N - 1.
template <typename T, int N>
__device__ __forceinline__ void conv_in(const T* xz, const T* tail, int gb,
                                        int t, int T_, int E, int c,
                                        float (&x)[N]) {
  if (t >= 0)
    load(xz + ((size_t)gb * T_ + t) * 2 * E + c, x);
  else if (tail != nullptr)
    load(tail + ((size_t)gb * (kConvK - 1) + (kConvK - 1 + t)) * E + c, x);
  else
    zero(x);
}

// The conv before its SiLU: taps in order, then the bias. xw[i] is input
// row t - K + 1 + i.
template <int N>
__device__ __forceinline__ float conv_pre(const float (&xw)[kConvK][N],
                                          const float (&w)[kConvK][N],
                                          const float (&b)[N], int q) {
  float acc = xw[0][q] * w[0][q];
#pragma unroll
  for (int i = 1; i < kConvK; ++i) acc += xw[i][q] * w[i][q];
  return acc + b[q];
}

// Heads of one block in the conv kernels: rounds of at most `most` heads,
// as even as they come.
inline void head_rounds(int H, int most, int* rounds, int* heads_per_block) {
  *rounds = (H + most - 1) / most;
  *heads_per_block = (H + *rounds - 1) / *rounds;
}

inline int round32(int n) { return (n + 31) / 32 * 32; }

// Launch on `device` and give the calling thread back its current device,
// which PyTorch reads for its own defaults.
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    int now = prev;
    if (cudaGetDevice(&now) == cudaSuccess && now != prev) cudaSetDevice(prev);
  }
};

}  // namespace ssd
