// K3: SAME, stride-1, k x k depthwise convolution plus bias over channels-last
// x [B, H, W, C], written by hand for Hopper (sm_90a).
//
//   out[b, y, x, c] = sum_{dy, dx} xpad[b, y + dy, x + dx, c] * w[dy, dx, c] + bias[c]
//
// with xpad zero-padded by (k - 1) / 2 on each side; taps accumulate in f32 in
// (dy, dx) order, the bias is added in f32, and the result is rounded to x's
// type once.
//
// Replaces unet_zoo_tpu/ops/pallas/depthwise.py::depthwise_conv2d (the TPU
// kernel; pl.pallas_call at depthwise.py:83). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/depthwise.py.
//
// Bound: 2 k^2 operations per output element against one read of x and one
// write of the output (4 bytes per element in bf16): far below the card's
// ridge, so device-memory bytes bound it. The design reads each input once
// from device memory per block and keeps the stencil in shared memory:
//   - one block per (TH x TW output tile, chunk of 128 bytes of channels,
//     image); the tile and a halo of (k - 1) / 2 pixels (zero outside the
//     image) go to shared memory with 16-byte cp.async copies along C where
//     C allows (else element by element, zero beyond C);
//   - each thread owns a pair of channels (__nv_bfloat162 / float2 reads of
//     shared memory, conflict-free across a warp) and keeps their k x k taps
//     and bias in registers, and walks the tile's pixels with its lane row;
//   - odd H, W (tiles past the edge) and odd C (a last single channel,
//     element stores) are masked.
// The halo is re-read by neighbouring tiles ((TH + k - 1)(TW + k - 1) / (TH TW),
// 1.4x at k = 3), mostly from L2.
//
// Layout: x, out [B, H, W, C] contiguous, bf16 or f32; w [k, k, C] and bias
// [C] (or null) in x's type. Requirements (checked by the wrapper): k in
// {3, 5, 7}, 4-byte-aligned pointers (8-byte for f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile columns
constexpr int NTHREADS = 256;
constexpr int CHUNK_BYTES = 128; // channels of one block: 64 bf16 or 32 f32

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
__device__ __forceinline__ void store_pair(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

template <typename T, int K>
__global__ void __launch_bounds__(NTHREADS)
    depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
                     int tiles_w, int vec) {
  constexpr int P = (K - 1) / 2;
  constexpr int HY = TH + K - 1;
  constexpr int HX = TW + K - 1;
  constexpr int CB = CHUNK_BYTES / sizeof(T);  // channels of the chunk
  constexpr int VEC = 16 / sizeof(T);          // channels of one 16-byte copy
  constexpr int NP = CB / 2;                   // channel pairs of the chunk
  constexpr int NL = NTHREADS / NP;            // lane rows over the pixels
  __shared__ __align__(16) T tile[HY * HX * CB];

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int c0 = blockIdx.y * CB;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;

  // the haloed tile, zero outside the image and beyond C
  if (vec) {
    for (int i = tid; i < HY * HX * (CB / VEC); i += NTHREADS) {
      const int pix = i / (CB / VEC);
      const int c = c0 + (i % (CB / VEC)) * VEC;
      const int gy = ty0 + pix / HX - P;
      const int gx = tx0 + pix % HX - P;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      const T* src = ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + c : xb;
      cp_async16(&tile[pix * CB + (i % (CB / VEC)) * VEC], src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = tid; i < HY * HX * CB; i += NTHREADS) {
      const int pix = i / CB;
      const int c = c0 + i % CB;
      const int gy = ty0 + pix / HX - P;
      const int gx = tx0 + pix % HX - P;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      tile[i] = ok ? xb[(static_cast<size_t>(gy) * W + gx) * C + c] : from_float<T>(0.f);
    }
  }
  __syncthreads();

  const int pair = tid % NP;
  const int c = c0 + 2 * pair;
  if (c >= C) return;
  const bool two = c + 1 < C;
  float2 taps[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    taps[t].x = to_float(w[t * C + c]);
    taps[t].y = two ? to_float(w[t * C + c + 1]) : 0.f;
  }
  float2 bv = make_float2(0.f, 0.f);
  if (bias != nullptr) {
    bv.x = to_float(bias[c]);
    bv.y = two ? to_float(bias[c + 1]) : 0.f;
  }
  const bool pair_store = two && (C % 2 == 0);
  T* ob = out + static_cast<size_t>(b) * H * W * C;

  for (int pix = tid / NP; pix < TH * TW; pix += NL) {
    const int oy = pix / TW, ox = pix % TW;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (gy >= H || gx >= W) continue;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float2 v = load_pair(&tile[((oy + dy) * HX + ox + dx) * CB + 2 * pair]);
        acc.x = fmaf(v.x, taps[dy * K + dx].x, acc.x);
        acc.y = fmaf(v.y, taps[dy * K + dx].y, acc.y);
      }
    }
    acc.x += bv.x;
    acc.y += bv.y;
    T* dst = ob + (static_cast<size_t>(gy) * W + gx) * C + c;
    if (pair_store) {
      store_pair(dst, acc);
    } else {
      dst[0] = from_float<T>(acc.x);
      if (two) dst[1] = from_float<T>(acc.y);
    }
  }
}

template <typename T, int K>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, int h, int wd,
           int c, cudaStream_t stream) {
  constexpr int CB = CHUNK_BYTES / sizeof(T);
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const int vec = (c % (16 / static_cast<int>(sizeof(T))) == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(tiles_w * tiles_h, (c + CB - 1) / CB, batch);
  depthwise_kernel<T, K><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), h, wd, c, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* x, const void* w, const void* bias, void* out, int batch, int h, int wd,
             int c, int k, cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, 3>(x, w, bias, out, batch, h, wd, c, stream);
    case 5: return launch<T, 5>(x, w, bias, out, batch, h, wd, c, stream);
    case 7: return launch<T, 7>(x, w, bias, out, batch, h, wd, c, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int depthwise_conv(const void* x, const void* w, const void* bias, void* out,
                              int batch, int h, int wd, int c, int k, int is_f32,
                              void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f32) return launch_k<float>(x, w, bias, out, batch, h, wd, c, k, stream);
  return launch_k<bf16>(x, w, bias, out, batch, h, wd, c, k, stream);
}
