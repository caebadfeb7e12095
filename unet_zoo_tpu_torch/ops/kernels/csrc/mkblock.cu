// K4: mmunet's MKBlock in eval, written by hand for Hopper (sm_90a).
//
//   q = C/4; x = [x1 | x2 | x3 | x4] by channel quarters
//   a = gelu(s1 * dw3(x1) + t1)
//   b = gelu(s2 * dw5(a + x2) + t2)
//   c = gelu(s3 * dw7(b + x3) + t3)
//   h0 = bf16([a | b | c | x4])
//   out = x + (bf16(gelu(h0 @ w1 + b1)) @ w2 + b2)
//
// (depthwise biases and norm1-3 folded into (s, t); norm4 folded into w1, b1;
// GELU is the exact erf form.)
//
// Replaces unet_zoo_tpu/ops/pallas/mkblock.py::fused_mkblock (the TPU kernel;
// pl.pallas_call at mkblock.py:211). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/mkblock.py.
//
// Bound: the pointwise MLP is 16*M*C^2 FLOPs against about 4*M*C bytes (x in,
// out, and the bf16 weights once), 4*C FLOP/byte, above the card's ~295
// FLOP/byte ridge for every C in mmunet (96..768): the block is bound by
// tensor-core operations. The depthwise cascade is 166*q FLOPs per pixel on
// the CUDA cores, far below either bound.
//
// Form, two or three grids per call:
//   1. mkblock_cascade: one block per 16x16 output tile, batch image and chunk
//      of 8 channel chains (channel j of quarters 1-3 form one chain, since
//      every conv is depthwise). It stages quarter 1 of a 28x28 tile (halo
//      6 = 1 + 2 + 3) in shared memory, computes a over 26x26, a + x2 and then
//      b over 22x22, b + x3 and then c over the 16x16 tile, all in f32, and
//      writes the bf16 h0 (quarter 4 copied through). One thread per pixel
//      holds the chunk's 8 channels in registers, so every global access is
//      one 16-byte vector. Out-of-image cells of a and b are zero, the SAME
//      padding each depthwise conv sees in the reference (the TPU kernel
//      re-masks its halo rows for the same reason).
//   2. For C = 96 and 192 (86% of mmunet's MLP FLOPs), mkblock_mlp_fused:
//      the whole MLP over 128-row tiles, the hidden layer made and consumed
//      64 columns at a time in shared memory (see below).
//   2'. Otherwise two GEMM grids through a device-memory hidden layer:
//      mkblock_gemm<GELU>: hid = bf16(gelu(h0 @ w1 + b1)), [M, 4C];
//      mkblock_gemm<RESIDUAL>: out = bf16(x + hid @ w2 + b2), [M, C].
//      Both run the block-tile main loop K1 runs (gemm_mainloop in mma.cuh:
//      4-stage cp.async ring, 64x32 warp tiles) with their own epilogues.
// Every product is mma.sync m16n8k16, bf16 in, f32 accumulate. Known gaps to
// the bound, for later work: mma.sync instead of wgmma, h0 not kept on chip
// between the cascade and the MLP, and the hidden layer of C = 384 and 768
// through device memory.
//
// Layout: x, h0, out are NHWC bf16 (torch channels_last); taps [83, q] f32 (9
// dw3, 25 dw5, 49 dw7 taps, row-major per kernel); affine [6, q] f32 (s1, t1,
// s2, t2, s3, t3); w1 [C, 4C] and w2 [4C, C] bf16 row-major ([K, N]); b1, b2
// f32. Requirements (checked by the wrapper): C a multiple of 32 (each quarter
// holds whole 8-channel chunks, so every vector is 16-byte aligned), 16-byte
// aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---- grid 1: the depthwise cascade ----------------------------------------

constexpr int TILE = 16;             // output tile side
constexpr int CC = 8;                // channel chains per block: one 16-byte bf16 vector
constexpr int S6 = TILE + 12;        // quarter-1 input region (halo 6)
constexpr int S5 = TILE + 10;        // a (+ x2) region (halo 5)
constexpr int S3 = TILE + 6;         // b (+ x3) region (halo 3)
constexpr int NTAPS = 9 + 25 + 49;
constexpr int CASCADE_THREADS = 256;
constexpr int CASCADE_SMEM = (S6 * S6 + S5 * S5 + NTAPS + 6) * CC * 4;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

struct Vec8 {
  float v[CC];
};

__device__ __forceinline__ Vec8 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(float* p, const Vec8& r) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r.v[4], r.v[5], r.v[6], r.v[7]);
}

__device__ __forceinline__ Vec8 load_bf16x8(const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  Vec8 r;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    r.v[2 * u] = f.x;
    r.v[2 * u + 1] = f.y;
  }
  return r;
}

__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* p, const Vec8& r) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(r.v[2 * u], r.v[2 * u + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// k x k depthwise conv at region cell (r, s) of `src` (side `ss`, cell (r, s)
// of the output region is cell (r + k/2, s + k/2) of the source region),
// then the folded affine and GELU, for the 8 channels of the chunk.
template <int K>
__device__ __forceinline__ Vec8 dw_affine_gelu(const float* src, int ss, int r, int s,
                                               const float* wt, const float* af) {
  Vec8 acc = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const Vec8 v = load8(src + ((r + dy) * ss + s + dx) * CC);
      const Vec8 w = load8(wt + (dy * K + dx) * CC);
#pragma unroll
      for (int u = 0; u < CC; ++u) acc.v[u] += v.v[u] * w.v[u];
    }
  const Vec8 sc = load8(af), sh = load8(af + CC);
#pragma unroll
  for (int u = 0; u < CC; ++u) acc.v[u] = gelu(acc.v[u] * sc.v[u] + sh.v[u]);
  return acc;
}

// One thread per pixel of a region, holding the chunk's 8 channels in
// registers: 16-byte global loads and stores, 32-byte shared-memory accesses.
__global__ void __launch_bounds__(CASCADE_THREADS) mkblock_cascade(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
    const float* __restrict__ affine, __nv_bfloat16* __restrict__ h0, int H, int W, int C) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                   // [S6][S6][CC]: x1, later b + x3 as [S3][S3][CC]
  float* buf_b = buf_a + S6 * S6 * CC;   // [S5][S5][CC]: a + x2
  float* wt = buf_b + S5 * S5 * CC;      // [NTAPS][CC]
  float* af = wt + NTAPS * CC;           // [6][CC]

  const int q = C / 4;
  const int tiles_w = (W + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_w) * TILE;
  const int tx0 = (blockIdx.x % tiles_w) * TILE;
  const int j0 = blockIdx.y * CC;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W * C;
  const __nv_bfloat16* xb = x + img + j0;  // channel j0 of quarter 1
  __nv_bfloat16* hb = h0 + img + j0;
  const int tid = threadIdx.x;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  auto pixel = [&](int gy, int gx) { return (static_cast<size_t>(gy) * W + gx) * C; };
  const Vec8 zero = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};

  for (int i = tid; i < NTAPS * CC; i += CASCADE_THREADS) wt[i] = taps[(i / CC) * q + j0 + i % CC];
  for (int i = tid; i < 6 * CC; i += CASCADE_THREADS) af[i] = affine[(i / CC) * q + j0 + i % CC];
  // quarter 1 over the 28x28 region, zero outside the image
  for (int p = tid; p < S6 * S6; p += CASCADE_THREADS) {
    const int gy = ty0 - 6 + p / S6, gx = tx0 - 6 + p % S6;
    store8(buf_a + p * CC, inside(gy, gx) ? load_bf16x8(xb + pixel(gy, gx)) : zero);
  }
  __syncthreads();

  // a over 26x26; buf_b = a + x2 (zero outside the image)
  for (int p = tid; p < S5 * S5; p += CASCADE_THREADS) {
    const int r = p / S5, s = p % S5;
    const int gy = ty0 - 5 + r, gx = tx0 - 5 + s;
    Vec8 v = zero;
    if (inside(gy, gx)) {
      v = dw_affine_gelu<3>(buf_a, S6, r, s, wt, af);
      const size_t pix = pixel(gy, gx);
      if (r >= 5 && r < 5 + TILE && s >= 5 && s < 5 + TILE) store_bf16x8(hb + pix, v);
      const Vec8 x2 = load_bf16x8(xb + pix + q);
#pragma unroll
      for (int u = 0; u < CC; ++u) v.v[u] += x2.v[u];
    }
    store8(buf_b + p * CC, v);
  }
  __syncthreads();

  // b over 22x22; buf_a = b + x3 (zero outside the image)
  for (int p = tid; p < S3 * S3; p += CASCADE_THREADS) {
    const int r = p / S3, s = p % S3;
    const int gy = ty0 - 3 + r, gx = tx0 - 3 + s;
    Vec8 v = zero;
    if (inside(gy, gx)) {
      v = dw_affine_gelu<5>(buf_b, S5, r, s, wt + 9 * CC, af + 2 * CC);
      const size_t pix = pixel(gy, gx);
      if (r >= 3 && r < 3 + TILE && s >= 3 && s < 3 + TILE) store_bf16x8(hb + pix + q, v);
      const Vec8 x3 = load_bf16x8(xb + pix + 2 * q);
#pragma unroll
      for (int u = 0; u < CC; ++u) v.v[u] += x3.v[u];
    }
    store8(buf_a + p * CC, v);
  }
  __syncthreads();

  // c over the tile (one pixel per thread); quarter 4 passes through
  static_assert(TILE * TILE == CASCADE_THREADS, "one output pixel per thread");
  const int r = tid / TILE, s = tid % TILE;
  if (!inside(ty0 + r, tx0 + s)) return;
  const size_t pix = pixel(ty0 + r, tx0 + s);
  store_bf16x8(hb + pix + 2 * q, dw_affine_gelu<7>(buf_a, S3, r, s, wt + 34 * CC, af + 4 * CC));
  *reinterpret_cast<uint4*>(hb + pix + 3 * q) = *reinterpret_cast<const uint4*>(xb + pix + 3 * q);
}

// ---- grids 2 and 3: the pointwise MLP ----------------------------------------

enum Epilogue { GELU = 0, RESIDUAL = 1 };

struct GemmParams {
  const __nv_bfloat16* a;    // [M, K]
  const __nv_bfloat16* w;    // [K, N]
  const float* bias;         // [N]
  const __nv_bfloat16* res;  // [M, N] (RESIDUAL)
  __nv_bfloat16* out;        // [M, N]
  int M, N, K;
};

// out = bf16(epilogue(a @ w + bias)). Block tile BM x BN; warps are
// (BM/64) x (BN/32), each on 64 rows x 32 columns (the main loop is
// gemm_mainloop in mma.cuh, shared with K1; this kernel adds the A loader,
// rows of a plain [M, K] matrix, and the epilogue).
template <int EPI, int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2) mkblock_gemm(const GemmParams p) {
  using T = GemmTile<BM, BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m_blk = blockIdx.x * BM;
  const int n_blk = blockIdx.y * BN;

  auto load_a = [&](typename T::ATile& tile, int k0) {
    const int a_col = T::a_col();
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const int m = m_blk + T::a_row(i);
      const bool ok = m < p.M;
      const __nv_bfloat16* src = ok ? p.a + static_cast<size_t>(m) * p.K + k0 + a_col : p.a;
      cp_async16(&tile[T::a_row(i)][a_col], src, ok);
    }
  };

  float acc[4][4][4];
  gemm_mainloop<BM, BN>(smem_raw, p.w, p.N, p.K, n_blk, load_a, acc);

  // Epilogue (accumulator layout: GemmTile in mma.cuh).
  const int wm = T::warp_row();
  const int wn = T::warp_col();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_blk + wm + i * 16 + g + half * 8;
      if (m >= p.M) continue;
      const size_t row = static_cast<size_t>(m) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_blk + wn + j * 8 + tig * 2;
        if (n >= p.N) continue;
        float v0 = acc[i][j][2 * half] + p.bias[n];
        float v1 = acc[i][j][2 * half + 1] + p.bias[n + 1];
        if constexpr (EPI == GELU) {
          v0 = gelu(v0);
          v1 = gelu(v1);
        } else {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.res + row + n));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + row + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int EPI, int BM, int BN>
int launch_gemm(const GemmParams& p, cudaStream_t stream) {
  constexpr int bytes = GemmTile<BM, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(mkblock_gemm<EPI, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  mkblock_gemm<EPI, BM, BN><<<grid, GEMM_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Block tile 128x128. For N = 96 (C = 96, the second GEMM) a 256x64 tile
// would compute the same padded 128 columns but read the [M, 4C] hidden
// layer twice, once per column tile.
template <int EPI>
int gemm(const GemmParams& p, cudaStream_t stream) {
  return launch_gemm<EPI, 128, 128>(p, stream);
}

// ---- grid 2 for C = 96 and 192: the whole MLP in one grid --------------------

// out = bf16(x + bf16(gelu(h0 @ w1 + b1)) @ w2 + b2) for one 128-row tile per
// block. The h0 tile stays in shared memory; the hidden layer is made and
// consumed in 64-column chunks (GEMM1 chunk -> GELU -> bf16 in shared memory
// -> GEMM2 accumulate), so it never reaches device memory. The next chunk's
// w1 columns and w2 rows arrive by cp.async while the current one computes.
// The [128, C] output accumulator lives in registers (C/2 floats a thread),
// which is what limits this form to C <= 192.
constexpr int MLP_THREADS = 256;  // 8 warps

template <int C>
struct FusedMlp {
  static constexpr int BM = 128;
  static constexpr int HC = 64;             // hidden columns per chunk
  static constexpr int NCHUNK = 4 * C / HC;
  static constexpr int A_LD = C + 8;        // row pitches in bf16, ldmatrix conflict-free
  static constexpr int W1_LD = HC + 8;
  static constexpr int W2_LD = C + 8;
  static constexpr int H_LD = HC + 8;
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int W1_ELEMS = C * W1_LD;
  static constexpr int W2_ELEMS = HC * W2_LD;
  static constexpr int H_ELEMS = BM * H_LD;
  static constexpr int SMEM = 2 * (A_ELEMS + 2 * (W1_ELEMS + W2_ELEMS) + H_ELEMS);
  static constexpr int NT2 = C / 16;        // n8 tiles of a warp's C/2 output columns
};

template <int C>
__global__ void __launch_bounds__(MLP_THREADS) mkblock_mlp_fused(
    const __nv_bfloat16* __restrict__ h0, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ x,
    __nv_bfloat16* __restrict__ out, int M) {
  using F = FusedMlp<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][A_LD]
  __nv_bfloat16* W1s = As + F::A_ELEMS;                              // 2 x [C][W1_LD]
  __nv_bfloat16* W2s = W1s + 2 * F::W1_ELEMS;                        // 2 x [HC][W2_LD]
  __nv_bfloat16* Hs = W2s + 2 * F::W2_ELEMS;                         // [BM][H_LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m_blk = blockIdx.x * F::BM;

  for (int i = tid; i < F::BM * (C / 8); i += MLP_THREADS) {
    const int row = i / (C / 8), col = (i % (C / 8)) * 8;
    const bool ok = m_blk + row < M;
    cp_async16(As + row * F::A_LD + col,
               ok ? h0 + static_cast<size_t>(m_blk + row) * C + col : h0, ok);
  }
  auto load_weights = [&](int j, int buf) {
    __nv_bfloat16* w1s = W1s + buf * F::W1_ELEMS;
    __nv_bfloat16* w2s = W2s + buf * F::W2_ELEMS;
    for (int i = tid; i < C * (F::HC / 8); i += MLP_THREADS) {   // w1[:, j*HC : (j+1)*HC]
      const int row = i / (F::HC / 8), col = (i % (F::HC / 8)) * 8;
      cp_async16(w1s + row * F::W1_LD + col,
                 w1 + static_cast<size_t>(row) * 4 * C + j * F::HC + col, true);
    }
    for (int i = tid; i < F::HC * (C / 8); i += MLP_THREADS) {   // w2[j*HC : (j+1)*HC, :]
      const int row = i / (C / 8), col = (i % (C / 8)) * 8;
      cp_async16(w2s + row * F::W2_LD + col,
                 w2 + static_cast<size_t>(j * F::HC + row) * C + col, true);
    }
    cp_async_commit();
  };
  load_weights(0, 0);  // one group: the h0 tile and chunk 0's weights

  // GEMM1 warps: 4 x 2 over [128, 64], 32 x 32 each. GEMM2 warps: 4 x 2 over
  // [128, C], 32 x C/2 each.
  const int wm = (warp >> 1) * 32;
  const int wn1 = (warp & 1) * 32;
  const int wn2 = (warp & 1) * (C / 2);
  const int g = lane >> 2;
  const int tig = lane & 3;

  float acc2[2][F::NT2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < F::NT2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc2[i][j][r] = 0.f;

  for (int j = 0; j < F::NCHUNK; ++j) {
    const int buf = j & 1;
    if (j + 1 < F::NCHUNK) {
      load_weights(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk j's weights (and at j = 0 the h0 tile) have landed
    const __nv_bfloat16* w1s = W1s + buf * F::W1_ELEMS;
    const __nv_bfloat16* w2s = W2s + buf * F::W2_ELEMS;

    float acc1[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc1[i][n][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C; ks += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], As + (wm + i * 16 + (lane & 15)) * F::A_LD + ks + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldsm_x4_trans(r, w1s + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * F::W1_LD + wn1 +
                             j2 * 16 + (lane >> 4) * 8);
        bf[2 * j2][0] = r[0];
        bf[2 * j2][1] = r[1];
        bf[2 * j2 + 1][0] = r[2];
        bf[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(acc1[i][n], af[i], bf[n]);
    }
    // hidden chunk = bf16(gelu(acc1 + b1)) into shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm + i * 16 + g + half * 8;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = wn1 + n * 8 + tig * 2;
          const float* bias = b1 + j * F::HC + col;
          *reinterpret_cast<__nv_bfloat162*>(Hs + row * F::H_LD + col) =
              __floats2bfloat162_rn(gelu(acc1[i][n][2 * half] + bias[0]),
                                    gelu(acc1[i][n][2 * half + 1] + bias[1]));
        }
      }
    __syncthreads();  // the hidden chunk is complete

#pragma unroll
    for (int ks = 0; ks < F::HC; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], Hs + (wm + i * 16 + (lane & 15)) * F::H_LD + ks + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < F::NT2 / 2; ++j2) {
        uint32_t r[4];
        ldsm_x4_trans(r, w2s + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * F::W2_LD + wn2 +
                             j2 * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1f[2] = {r[2], r[3]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc2[i][2 * j2], af[i], b0);
          mma_bf16(acc2[i][2 * j2 + 1], af[i], b1f);
        }
      }
    }
    __syncthreads();  // done with this chunk's weights and hidden columns
  }

  // out = bf16(x + acc2 + b2)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_blk + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      const size_t row = static_cast<size_t>(m) * C;
#pragma unroll
      for (int n = 0; n < F::NT2; ++n) {
        const int col = wn2 + n * 8 + tig * 2;
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + row + col));
        *reinterpret_cast<__nv_bfloat162*>(out + row + col) = __floats2bfloat162_rn(
            acc2[i][n][2 * half] + b2[col] + r.x, acc2[i][n][2 * half + 1] + b2[col + 1] + r.y);
      }
    }
}

template <int C>
int launch_mlp_fused(const __nv_bfloat16* h0, const __nv_bfloat16* w1, const float* b1,
                     const __nv_bfloat16* w2, const float* b2, const __nv_bfloat16* x,
                     __nv_bfloat16* out, int M, cudaStream_t stream) {
  constexpr int bytes = FusedMlp<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(mkblock_mlp_fused<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + FusedMlp<C>::BM - 1) / FusedMlp<C>::BM);
  mkblock_mlp_fused<C><<<grid, MLP_THREADS, bytes, stream>>>(h0, w1, b1, w2, b2, x, out, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.

// Whether mkblock_forward at C channels runs the two GEMM grids, which pass
// the hidden layer through the caller's hid scratch (1), or the fused MLP
// grid, which needs none (0).
extern "C" int mkblock_needs_hidden(int c) { return c != 96 && c != 192; }

// Launches the cascade and the MLP on `stream` and returns the first CUDA
// error code (0 when every launch was accepted). h0 [B, H, W, C] and hid
// [B*H*W, 4C] are bf16 scratch from the caller; hid may be null where
// mkblock_needs_hidden(c) is 0.
extern "C" int mkblock_forward(const void* x, const float* taps, const float* affine,
                               const void* w1, const float* b1, const void* w2,
                               const float* b2, void* h0, void* hid, void* out, int batch,
                               int h, int w, int c, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaFuncSetAttribute(mkblock_cascade,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CASCADE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE), c / 4 / CC, batch);
  mkblock_cascade<<<grid, CASCADE_THREADS, CASCADE_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), taps, affine, static_cast<__nv_bfloat16*>(h0), h,
      w, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int m = batch * h * w;
  const auto* h0b = static_cast<const __nv_bfloat16*>(h0);
  const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
  const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* outb = static_cast<__nv_bfloat16*>(out);
  if (!mkblock_needs_hidden(c)) {
    return c == 96 ? launch_mlp_fused<96>(h0b, w1b, b1, w2b, b2, xb, outb, m, stream)
                   : launch_mlp_fused<192>(h0b, w1b, b1, w2b, b2, xb, outb, m, stream);
  }
  if (hid == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  GemmParams p{};
  p.M = m;
  p.a = static_cast<const __nv_bfloat16*>(h0);
  p.w = static_cast<const __nv_bfloat16*>(w1);
  p.bias = b1;
  p.res = nullptr;
  p.out = static_cast<__nv_bfloat16*>(hid);
  p.N = 4 * c;
  p.K = c;
  int rc = gemm<GELU>(p, stream);
  if (rc) return rc;

  p.a = static_cast<const __nv_bfloat16*>(hid);
  p.w = static_cast<const __nv_bfloat16*>(w2);
  p.bias = b2;
  p.res = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = c;
  p.K = 4 * c;
  return gemm<RESIDUAL>(p, stream);
}
