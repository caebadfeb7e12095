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
// the CUDA cores. Beside both, the GELU of the 4C hidden units and the 3q
// cascade outputs of every pixel costs 15-40 CUDA-core instructions an
// element; at C = 96 that is more issue time than the MLP's tensor-core
// time.
//
// Forms (ops/kernels/mkblock.py::plan picks one by C):
//   1. mkblock_cascade, every C: one block per 16x16 output tile, batch image
//      and chunk of 8 channel chains (channel j of quarters 1-3 form one
//      chain, since every conv is depthwise), the chunk fastest in launch
//      order (neighbouring chunks share 32-byte sectors of x and h0).
//      Quarters 1-3 of the chunk are staged in shared memory as bf16 by
//      cp.async, exactly and all at once, over the regions each stage reads
//      (halo 6 = 1 + 2 + 3 for quarter 1); a + x2 (26x26) and b + x3 (22x22)
//      stay f32 there. A lane owns one chain and one column of a 4-column
//      group (a warp reads 32 consecutive 4- or 2-byte cells: no bank
//      conflicts) and computes a vertical strip of S outputs: every input row
//      it loads serves the K tap rows that read it, the taps sit in its
//      registers. The taps are summed in row-major order and s * conv + t and
//      the GELU are rounded as the plain version's ATen passes round them, so
//      h0 agrees with the plain version on the card bit for bit. Out-of-image
//      cells of a and b are zero, the SAME padding each depthwise conv sees
//      in the reference (the TPU kernel re-masks its halo rows for the same
//      reason). The tile's a, b and c gather in shared memory and leave as
//      one 16-byte vector a pixel each (quarter 4 copied through). Its
//      16-byte accesses of x and h0, two to a 32-byte sector, bound the grid
//      more than its FMAs.
//   2. C <= 192: mkblock_mlp<C>, the whole MLP in one persistent grid (one
//      block an SM walking 128-row tiles): a producer warp brings h0 tiles
//      (double-buffered) and the weights by TMA; two consumer warpgroups of
//      64 rows each run, per chunk of HC hidden units, GEMM1 (wgmma, h0 and
//      w1^T from shared memory) -> b1, GELU and bf16 in registers -> GEMM2
//      with that chunk as wgmma's register A operand, accumulating the
//      [64, C] output in registers (FlashAttention-3's P.V pattern): the
//      hidden layer never leaves the registers. Where w1 and w2 fit beside
//      the h0 ring (C <= 96: 144 KB at C = 96) they stay in shared memory for
//      the block's life and HC = 128; otherwise (C = 128..192, HC = 64) they
//      stream from L2 through a two-stage ring, one chunk a stage (a cluster
//      of two sharing each chunk by TMA multicast measured no faster). The
//      GELU of the hidden layer, whose issue time rivals the tensor-core time
//      here, is gelu_hidden: one ex2 and no branch.
//   3. C > 192: the output accumulator of a 64-row tile does not fit a
//      warpgroup's registers, so the MLP runs as two wgmma grids through a
//      bf16 hidden layer in device memory (at mmunet's shapes, M <= 8192,
//      it stays in L2): mkblock_gemm<HIDDEN> makes bf16(gelu(h0 @ w1 + b1));
//      mkblock_gemm<OUTPUT> adds b2 and x; where its 128x128 tiles would not
//      fill the card, the plan splits its K over blocks that write f32
//      partials (mkblock_gemm<PARTIAL>) and mkblock_reduce sums them in a
//      fixed order, so a launch is deterministic.
//
// Layout: x, h0, out are NHWC bf16 (torch channels_last); taps [83, q] f32 (9
// dw3, 25 dw5, 49 dw7 taps, row-major per kernel); affine [6, q] f32 (s1, t1,
// s2, t2, s3, t3); w1t [4C, C] and w2t [C, 4C] bf16, each K-contiguous
// (pwconv1's and pwconv2's own [out, in] layout: mkblock.py packs them once);
// b1, b2 f32. Requirements (checked by the wrapper): C a multiple of 32 (each
// quarter holds whole 8-channel chunks, so every vector is 16-byte aligned),
// 16-byte aligned pointers.
//
// Tensor maps are encoded through cudaGetDriverEntryPoint (only the runtime
// is linked) and cached by address, shape, box and swizzle: a map is a
// function of exactly these, so a hit is always right.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// The exact-erf GELU, in the order of PyTorch's own kernel: (v / 2) (1 +
// erf(v / sqrt 2)).
__device__ __forceinline__ float gelu(float v) {
  return __fmul_rn(v * 0.5f, __fadd_rn(1.f, erff(v * 0.70710678118654752f)));
}

// GELU of the hidden layer, which is rounded to bf16 right after: the same
// erf form, with erfc(|v| / sqrt 2) taken as 2^-(|v| P(|v|)), P a degree-9
// polynomial fitted on [0, 6] (|v| clamped there), one ex2 and no branch:
// about half the instructions of erff's two divergent paths. Against
// float64, its relative error stays below 4.2e-6 on [-6, 6] and its absolute
// error below 4e-7 everywhere; one bf16 ulp is 3.9e-3. (For v < 0 it is more
// accurate than 0.5 v (1 + erff(v / sqrt 2)), whose 1 + erf cancels.)
__device__ __forceinline__ float gelu_hidden(float v) {
  const float u = fminf(fabsf(v), 6.f);
  float p = 1.099061198e-08f;
  p = fmaf(p, u, -3.713543322e-07f);
  p = fmaf(p, u, 5.338380106e-06f);
  p = fmaf(p, u, -4.067522605e-05f);
  p = fmaf(p, u, 1.429589174e-04f);
  p = fmaf(p, u, 3.217392077e-04f);
  p = fmaf(p, u, -7.406513207e-03f);
  p = fmaf(p, u, 5.281817168e-02f);
  p = fmaf(p, u, 4.590643048e-01f);
  p = fmaf(p, u, 1.151128173e+00f);
  float e;  // erfc(|v| / sqrt 2)
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-u * p));
  return v * (v >= 0.f ? fmaf(-0.5f, e, 1.f) : 0.5f * e);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- grid 1: the depthwise cascade ----------------------------------------

namespace cascade {

constexpr int CC = 8;         // channel chains a block: one 16-byte bf16 vector of a pixel
constexpr int THREADS = 256;  // 8 warps; a warp covers 4 columns x 8 chains
constexpr int T = 16;         // output tile side
// regions around the tile: quarter 1 with halo 6; a + x2 (and x2) with halo
// 5; b + x3 (and x3) with halo 3
constexpr int X1 = T + 12, A = T + 10, B = T + 6;
// shared memory: [x1 | x2 | x3] (b + x3 over x1 | x2 once a is made) | a + x2 | out
constexpr int X1_BYTES = X1 * X1 * CC * 2;  // bf16
constexpr int X2_BYTES = A * A * CC * 2;
constexpr int X3_BYTES = B * B * CC * 2;
constexpr int YA_BYTES = A * A * CC * 4;    // f32
constexpr int YB_BYTES = B * B * CC * 4;
constexpr int OUT_BYTES = T * T * 3 * CC * 2;  // the tile's a | b | c, bf16
constexpr int IN_BYTES = X1_BYTES + X2_BYTES + X3_BYTES;  // the staged quarters
static_assert(YB_BYTES <= X1_BYTES + X2_BYTES, "b + x3 goes over x1 | x2");
constexpr int SMEM = IN_BYTES + YA_BYTES + OUT_BYTES;
constexpr int BLOCKS_PER_SM = 3;
// strip heights: a column of each region in as few strips as the registers
// allow (a clamped last strip recomputes a few rows)
constexpr int SA = 13, SB = 11, SC = 8;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// acc[i] = sum over (dy, dx) of w[dy K + dx] * src[r0 + i + dy][col + dx] at
// chain ch of a region of `pitch` columns, the taps summed in row-major
// order: the S rows of a strip, the K values of each input row loaded once
// and used by every tap row that reads them.
template <int K, int S, typename U>
__device__ __forceinline__ void conv_strip(const U* src, int pitch, int r0, int col, int ch,
                                           const float (&w)[K * K], float (&acc)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.f;
  const U* p = src + (r0 * pitch + col) * CC + ch;
#pragma unroll
  for (int i = 0; i < S + K - 1; ++i) {
    float v[K];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) v[dx] = ld(p + (i * pitch + dx) * CC);
#pragma unroll
    for (int dy = K - 1; dy >= 0; --dy) {
      const int o = i - dy;
      if (o >= 0 && o < S) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[o] = fmaf(w[dy * K + dx], v[dx], acc[o]);
      }
    }
  }
}

// One K x K stage over the R x R region of cells that lies HALO pixels
// around the tile, in strips of S rows: work item (column group g, strip s)
// goes to warp item % 8; the last group and strip are clamped into the
// region, so a few cells are computed twice (with the same value). A cell
// inside the image becomes v = gelu(s * conv + t); the tile's own cells put
// bf16(v) into out (the tile's h0 slots of this stage); where dst is given,
// the cell stores v + xres (the next quarter, staged over the same region),
// or 0 outside the image. Strips wholly outside the image only store zeros.
template <int K, int S, int R, int HALO, typename U>
__device__ __forceinline__ void stage(const U* src, int pitch, const float* __restrict__ taps,
                                      float s, float t, const __nv_bfloat16* xres, float* dst,
                                      __nv_bfloat16* out, int q, int ty0, int tx0, int H, int W) {
  constexpr int G = (R + 3) / 4, NS = (R + S - 1) / S;
  const int lane = threadIdx.x & 31;
  const int ch = lane & 7;
  float w[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) w[i] = __ldg(taps + i * q);
  for (int item = threadIdx.x >> 5; item < G * NS; item += THREADS / 32) {
    const int col = min((item % G) * 4, R - 4) + (lane >> 3);
    const int r0 = min((item / G) * S, R - S);
    const int gx = tx0 - HALO + col, gy0 = ty0 - HALO + r0;
    if (gx < 0 || gx >= W || gy0 + S <= 0 || gy0 >= H) {
      if (dst != nullptr) {
#pragma unroll
        for (int i = 0; i < S; ++i) dst[((r0 + i) * R + col) * CC + ch] = 0.f;
      }
      continue;
    }
    float acc[S];
    conv_strip<K, S>(src, pitch, r0, col, ch, w, acc);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int r = r0 + i, cell = (r * R + col) * CC + ch;
      float y = 0.f;
      if (gy0 + i >= 0 && gy0 + i < H) {
        // conv * s + t rounded after each operation, as the reference's
        // separate ATen passes do
        const float v = gelu(__fadd_rn(__fmul_rn(acc[i], s), t));
        if (r >= HALO && r < HALO + T && col >= HALO && col < HALO + T)
          out[((r - HALO) * T + col - HALO) * 3 * CC + ch] = __float2bfloat16_rn(v);
        if (dst != nullptr) y = v + __bfloat162float(xres[cell]);
      }
      if (dst != nullptr) dst[cell] = y;
    }
  }
}

}  // namespace cascade

// One block per work item (batch image, tile, chunk of chains), the chunk
// fastest in launch order, so that the blocks reading and writing the two
// halves of a 32-byte sector of x and h0 run together.
__global__ void __launch_bounds__(cascade::THREADS, cascade::BLOCKS_PER_SM) mkblock_cascade(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
    const float* __restrict__ affine, __nv_bfloat16* __restrict__ h0, int H, int W, int C) {
  using namespace cascade;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const auto* x1s = reinterpret_cast<const __nv_bfloat16*>(smem_raw);             // [X1][X1][CC]
  const auto* x2s = reinterpret_cast<const __nv_bfloat16*>(smem_raw + X1_BYTES);  // [A][A][CC]
  const auto* x3s =
      reinterpret_cast<const __nv_bfloat16*>(smem_raw + X1_BYTES + X2_BYTES);     // [B][B][CC]
  float* yb = reinterpret_cast<float*>(smem_raw);                   // [B][B][CC], after a
  float* ya = reinterpret_cast<float*>(smem_raw + IN_BYTES);        // [A][A][CC]
  __nv_bfloat16* outs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + IN_BYTES + YA_BYTES);  // [T*T][3][CC]

  const int q = C / 4, nch = q / CC;
  const int tiles_w = (W + T - 1) / T;
  const int tile = blockIdx.x / nch;
  const int ty0 = tile / tiles_w * T, tx0 = tile % tiles_w * T;
  const int j0 = blockIdx.x % nch * CC;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;
  const int tid = threadIdx.x;
  const int j = j0 + (tid & 7);  // this lane's chain
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  auto pixel = [&](int gy, int gx) { return (img + static_cast<size_t>(gy) * W + gx) * C; };

  // quarters 1-3 of the chunk over the regions the stages read, as bf16
  // (zero outside the image), all in flight at once
  auto region = [&](const __nv_bfloat16* dst, int side, int halo, int quarter) {
    for (int p = tid; p < side * side; p += THREADS) {
      const int gy = ty0 - halo + p / side, gx = tx0 - halo + p % side;
      const bool ok = inside(gy, gx);
      cp_async16(const_cast<__nv_bfloat16*>(dst) + p * CC,
                 ok ? x + pixel(gy, gx) + quarter * q + j0 : x, ok);
    }
  };
  region(x1s, X1, 6, 0);
  region(x2s, A, 5, 1);
  region(x3s, B, 3, 2);
  cp_async_commit();
  // quarter 4 passes through
  for (int p = tid; p < T * T; p += THREADS) {
    const int gy = ty0 + p / T, gx = tx0 + p % T;
    if (!inside(gy, gx)) continue;
    const size_t o = pixel(gy, gx) + 3 * q + j0;
    *reinterpret_cast<uint4*>(h0 + o) = __ldg(reinterpret_cast<const uint4*>(x + o));
  }
  cp_async_wait<0>();
  __syncthreads();

  // a over the halo-5 region; ya = a + x2
  stage<3, SA, A, 5>(x1s, X1, taps + j, __ldg(affine + j), __ldg(affine + q + j), x2s, ya, outs,
                     q, ty0, tx0, H, W);
  __syncthreads();
  // b over the halo-3 region; yb = b + x3, over x1 | x2
  stage<5, SB, B, 3>(ya, A, taps + 9 * q + j, __ldg(affine + 2 * q + j),
                     __ldg(affine + 3 * q + j), x3s, yb, outs + CC, q, ty0, tx0, H, W);
  __syncthreads();
  // c over the tile
  stage<7, SC, T, 0>(yb, B, taps + 34 * q + j, __ldg(affine + 4 * q + j),
                     __ldg(affine + 5 * q + j), static_cast<const __nv_bfloat16*>(nullptr),
                     static_cast<float*>(nullptr), outs + 2 * CC, q, ty0, tx0, H, W);
  __syncthreads();

  // the tile's a, b and c: one 16-byte vector each a pixel
  for (int p = tid; p < 3 * T * T; p += THREADS) {
    const int px = p / 3, part = p % 3;
    const int gy = ty0 + px / T, gx = tx0 + px % T;
    if (!inside(gy, gx)) continue;
    *reinterpret_cast<uint4*>(h0 + pixel(gy, gx) + part * q + j0) =
        *reinterpret_cast<const uint4*>(outs + p * CC);
  }
}

// ---- grid 2 for C <= 192: the whole MLP, persistent ---------------------------

namespace mlp {
constexpr int BM = 128;            // rows of a tile: two consumer warpgroups of 64
constexpr int THREADS = 288;       // consumer warpgroups 0-1, producer warp 8
constexpr int SMEM_LIMIT = 232448;
}  // namespace mlp

template <int C>
struct Fused {
  // A row of h0 or w1^T (K = C) is KFULL 128-byte boxes (128-byte swizzle)
  // and, where C is an odd multiple of 32, one 64-byte box (64-byte swizzle).
  static constexpr int KFULL = C / 64;
  static constexpr int KHALF = (C % 64) / 32;
  static constexpr int ROW = 128 * KFULL + 64 * KHALF;
  // hidden units a chunk: GEMM1 is m64nHCk16; 128 (fewer h0 re-reads from
  // shared memory) where its accumulator fits the registers beside the
  // [64, C] output accumulator (three consumer warpgroups of 64 rows, HC 64,
  // measured no faster at C = 96)
  static constexpr int HC = C <= 96 ? 128 : 64;
  static constexpr int NCHUNK = 4 * C / HC;
  static constexpr int A_BYTES = mlp::BM * ROW;  // an h0 tile: [box][128 rows][box bytes]
  static constexpr int W1_BYTES = HC * ROW;      // w1^T rows of a chunk: [box][HC][box bytes]
  static constexpr int W2_BYTES = C * HC * 2;    // w2^T columns of a chunk: [HC / 64][C][64 K]
  static constexpr int W_BYTES = W1_BYTES + W2_BYTES;
  static constexpr int A_STAGES = 2;
  static constexpr bool RESIDENT =
      1024 + A_STAGES * A_BYTES + NCHUNK * W_BYTES + 16 * (A_STAGES + NCHUNK) <= mlp::SMEM_LIMIT;
  static constexpr int W_STAGES = RESIDENT ? NCHUNK : 2;
  static constexpr int SMEM = 1024 + A_STAGES * A_BYTES + W_STAGES * W_BYTES +
                              16 * (A_STAGES + W_STAGES);
};

template <int C>
__global__ void __launch_bounds__(mlp::THREADS, 1)
    mkblock_mlp(const __grid_constant__ CUtensorMap map_h0,
                const __grid_constant__ CUtensorMap map_h0h,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w1h,
                const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ b1,
                const float* __restrict__ b2, const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ out, int M) {
  using F = Fused<C>;
  using mlp::BM;
  constexpr int HC = F::HC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w_ring = a_ring + F::A_STAGES * F::A_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(w_ring + F::W_STAGES * F::W_BYTES);
  uint64_t* a_empty = a_full + F::A_STAGES;
  uint64_t* w_full = a_empty + F::A_STAGES;
  uint64_t* w_empty = w_full + F::W_STAGES;
  const int ntiles = (M + BM - 1) / BM;
  if (static_cast<int>(blockIdx.x) >= ntiles) return;  // no TMA load may outlive its block

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F::A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < F::W_STAGES; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread issues every TMA load ----------------------------
    auto load_w = [&](int j, int s) {
      unsigned char* w1s = w_ring + s * F::W_BYTES;
      mbar_arrive_expect_tx(&w_full[s], F::W_BYTES);
#pragma unroll
      for (int kb = 0; kb < F::KFULL; ++kb)
        tma_load_2d(w1s + kb * HC * 128, &map_w1, &w_full[s], kb * 64, j * HC);
      if (F::KHALF)
        tma_load_2d(w1s + F::KFULL * HC * 128, &map_w1h, &w_full[s], F::KFULL * 64, j * HC);
#pragma unroll
      for (int g = 0; g < HC / 64; ++g)
        tma_load_2d(w1s + F::W1_BYTES + g * C * 128, &map_w2, &w_full[s], j * HC + g * 64, 0);
    };
    if (threadIdx.x == 256) {
      if (F::RESIDENT)
        for (int j = 0; j < F::NCHUNK; ++j) load_w(j, j);
      int as = 0, ws = 0;
      uint32_t aph = 0, wph = 0;
      auto load_a = [&](int tile) {
        mbar_wait<true>(&a_empty[as], aph ^ 1);
        unsigned char* a = a_ring + as * F::A_BYTES;
        mbar_arrive_expect_tx(&a_full[as], F::A_BYTES);
#pragma unroll
        for (int kb = 0; kb < F::KFULL; ++kb)
          tma_load_2d(a + kb * BM * 128, &map_h0, &a_full[as], kb * 64, tile * BM);
        if (F::KHALF)
          tma_load_2d(a + F::KFULL * BM * 128, &map_h0h, &a_full[as], F::KFULL * 64, tile * BM);
        if (++as == F::A_STAGES) {
          as = 0;
          aph ^= 1;
        }
      };
      // the next tile's h0 is in flight while this tile's weight chunks stream
      load_a(blockIdx.x);
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (tile + static_cast<int>(gridDim.x) < ntiles) load_a(tile + gridDim.x);
        if (!F::RESIDENT) {
          for (int j = 0; j < F::NCHUNK; ++j) {
            mbar_wait<true>(&w_empty[ws], wph ^ 1);
            load_w(j, ws);
            if (++ws == F::W_STAGES) {
              ws = 0;
              wph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ---------------------------------------
    const int wg = threadIdx.x >> 7;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;

    // GEMM1, issued: acc1 = h0 rows [64, C] x w1^T rows of a chunk [HC, C]^T
    auto gemm1 = [&](float (&acc1)[HC / 2], uint32_t a_base, uint32_t w1_base) {
#pragma unroll
      for (int i = 0; i < HC / 2; ++i) acc1[i] = 0.f;
      fence_regs(acc1);
      wgmma_fence();
      auto mma = [&](uint64_t a, uint64_t b) {
        if constexpr (HC == 128) {
          wgmma_bf16_n128(acc1, a, b);
        } else {
          wgmma_bf16_n64(acc1, a, b);
        }
      };
#pragma unroll
      for (int kb = 0; kb < F::KFULL; ++kb)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          mma(sw128_desc(a_base + kb * BM * 128 + wg * 64 * 128 + 32 * k),
              sw128_desc(w1_base + kb * HC * 128 + 32 * k));
      if (F::KHALF) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          mma(sw64_desc(a_base + F::KFULL * BM * 128 + wg * 64 * 64 + 32 * k),
              sw64_desc(w1_base + F::KFULL * HC * 128 + 32 * k));
      }
      wgmma_commit();
    };
    const uint32_t w_base = smem_addr(w_ring);

    int as = 0, ws = 0;
    uint32_t aph = 0, wph = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      mbar_wait(&a_full[as], aph);
      const uint32_t a_base = smem_addr(a_ring + as * F::A_BYTES);
      float acc2[C / 2];
#pragma unroll
      for (int i = 0; i < C / 2; ++i) acc2[i] = 0.f;

#pragma unroll 1
      for (int j = 0; j < F::NCHUNK; ++j) {
        const int s = F::RESIDENT ? j : ws;
        mbar_wait(&w_full[s], F::RESIDENT ? 0 : wph);
        const uint32_t w1_base = w_base + s * F::W_BYTES;
        float acc1[HC / 2];
        gemm1(acc1, a_base, w1_base);
        wgmma_wait<0>();
        fence_regs(acc1);
        // the h0 tile is read by GEMM1 alone: release it after the last chunk's
        if (j == F::NCHUNK - 1 && t == 0) mbar_arrive(&a_empty[as]);

        // 64 hidden units at a time: bf16(gelu(acc1 + b1)) in the register
        // layout of wgmma's A operand (accumulator columns 16 k .. 16 k + 15
        // are the A fragment of k-step k), then GEMM2: acc2 [64, C] += those
        // units [64, 64] x their w2 rows
#pragma unroll
        for (int g = 0; g < HC / 64; ++g) {
          uint32_t frag[4][4];
          const float* bj = b1 + j * HC + g * 64 + 2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bj + 8 * n));
            const float* a = acc1 + 32 * g + 4 * n;
            frag[n / 2][(n & 1) * 2] =
                pack_bf16(gelu_hidden(a[0] + bb.x), gelu_hidden(a[1] + bb.y));
            frag[n / 2][(n & 1) * 2 + 1] =
                pack_bf16(gelu_hidden(a[2] + bb.x), gelu_hidden(a[3] + bb.y));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) fence_regs(frag[k]);
          wgmma_fence();
          const uint32_t w2_base = w1_base + F::W1_BYTES + g * C * 128;
#pragma unroll
          for (int k = 0; k < 4; ++k) wgmma_bf16_rs<C>(acc2, frag[k], sw128_desc(w2_base + 32 * k));
          wgmma_commit();
          wgmma_wait<0>();  // frag is read by the wgmma: done before it is rewritten
#pragma unroll
          for (int k = 0; k < 4; ++k) fence_regs(frag[k]);
          fence_regs(acc2);
        }
        if (!F::RESIDENT) {
          if (t == 0) mbar_arrive(&w_empty[ws]);
          if (++ws == F::W_STAGES) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
      if (++as == F::A_STAGES) {
        as = 0;
        aph ^= 1;
      }

      // out = bf16(x + acc2 + b2); register 4 n + e: row r0 + 8 (e / 2),
      // column 8 n + 2 (l % 4) + e % 2
      const int r0 = tile * BM + wg * 64 + (t >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + 8 * h;
          if (m >= M) continue;
          const size_t o = static_cast<size_t>(m) * C + col;
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
              acc2[4 * n + 2 * h] + bb.x + r.x, acc2[4 * n + 2 * h + 1] + bb.y + r.y);
        }
      }
    }
  }
}

// ---- grids 2-3 for C > 192: two GEMMs through the hidden layer -----------------

namespace gemm {
constexpr int BM = 128, BN = 128, BK = 64;  // a box row: 64 bf16 = 128 bytes
constexpr int STAGES = 3;      // a short K (C or 4C <= 3072): three stages, two blocks an SM
constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
constexpr int THREADS = 288;  // consumer warpgroups 0-1 (64 rows each), producer warp 8
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 16 * STAGES;
}  // namespace gemm

enum Epi { HIDDEN = 0, OUTPUT = 1, PARTIAL = 2 };

struct GemmArgs {
  const float* bias;          // [N]
  const __nv_bfloat16* res;   // [M, N]: x (OUTPUT)
  void* out;                  // [M, N] bf16 (HIDDEN, OUTPUT), [splits, M, N] f32 (PARTIAL)
  int M, N, K;
};

// out = epilogue(a @ b^T) over one 128x128 tile and the K range of split
// blockIdx.z; a [M, K] and b [N, K] K-contiguous, read by TMA through a
// three-stage ring (OOB rows and K read as zero). HIDDEN: bf16(gelu(acc +
// bias)); OUTPUT: bf16(acc + bias + res); PARTIAL: the f32 sums.
template <int EPI>
__global__ void __launch_bounds__(gemm::THREADS, 1)
    mkblock_gemm(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const GemmArgs p) {
  using namespace gemm;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_a = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring_b = ring_a + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (p.K + BK - 1) / BK, S = gridDim.z;
  const int k_lo = blockIdx.z * KT / S, k_hi = (blockIdx.z + 1) * KT / S;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int kt = k_lo; kt < k_hi; ++kt) {
      mbar_wait<true>(&empty[s], ph ^ 1);
      mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
      tma_load_2d(ring_a + s * A_BYTES, &map_a, &full[s], kt * BK, m0);
      tma_load_2d(ring_b + s * B_BYTES, &map_b, &full[s], kt * BK, n0);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = k_lo; kt < k_hi; ++kt) {
    mbar_wait(&full[s], ph);
    const uint32_t a = smem_addr(ring_a + s * A_BYTES + wg * 64 * 128);
    const uint32_t b = smem_addr(ring_b + s * B_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_bf16_n128(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    // the group that read the previous stage has completed
    if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // register 4 j + e: row r0 + 8 (e / 2), column n0 + 8 j + 2 (l % 4) + e % 2
  const int r0 = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= p.N) continue;
    float2 bb = make_float2(0.f, 0.f);
    if (EPI != PARTIAL) bb = __ldg(reinterpret_cast<const float2*>(p.bias + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= p.M) continue;
      const size_t o = static_cast<size_t>(m) * p.N + n;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (EPI == HIDDEN) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
            __floats2bfloat162_rn(gelu_hidden(v0 + bb.x), gelu_hidden(v1 + bb.y));
      } else if (EPI == OUTPUT) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + o));
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
            __floats2bfloat162_rn(v0 + bb.x + r.x, v1 + bb.y + r.y);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                   static_cast<size_t>(blockIdx.z) * p.M * p.N + o) =
            make_float2(v0, v1);
      }
    }
  }
}

// out = bf16(x + (sum over splits z = 0, 1, ... of ws[z]) + b2), four
// elements a thread; N a multiple of 4.
__global__ void __launch_bounds__(256) mkblock_reduce(const float* __restrict__ ws, int splits,
                                                      const float* __restrict__ b2,
                                                      const __nv_bfloat16* __restrict__ x,
                                                      __nv_bfloat16* __restrict__ out, int M,
                                                      int N) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 acc = __ldg(reinterpret_cast<const float4*>(ws + i));
  for (int z = 1; z < splits; ++z) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(ws + z * total + i));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const float4 bb = __ldg(reinterpret_cast<const float4*>(b2 + i % N));
  const uint2 raw = *reinterpret_cast<const uint2*>(x + i);
  const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  uint2 o;
  o.x = pack_bf16(acc.x + bb.x + r0.x, acc.y + bb.y + r0.y);
  o.y = pack_bf16(acc.z + bb.z + r1.x, acc.w + bb.w + r1.y);
  *reinterpret_cast<uint2*>(out + i) = o;
}

// ---- host side -------------------------------------------------------------------

enum HostError { NO_ENCODER = 1001, ENCODE_FAILED = 1002, BAD_C = 1003, BAD_DEVICE = 1005 };
constexpr int MAX_DEVICES = 64;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

std::mutex map_lock;
std::map<std::tuple<uintptr_t, uint64_t, uint64_t, uint32_t, uint32_t>, CUtensorMap> map_cache;

// The TMA map of a row-major bf16 matrix [rows, cols], read as boxes of
// box_rows x box_cols with the 128-byte swizzle (box_cols 64) or the
// 64-byte one (box_cols 32).
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_cols,
               uint32_t box_rows) {
  std::lock_guard<std::mutex> guard(map_lock);
  const auto key =
      std::make_tuple(reinterpret_cast<uintptr_t>(ptr), rows, cols, box_cols, box_rows);
  const auto hit = map_cache.find(key);
  if (hit != map_cache.end()) {
    *out = hit->second;
    return 0;
  }
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return NO_ENCODER;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ENCODE_FAILED;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *out);
  return 0;
}

// Sets a kernel's dynamic shared memory, and the largest shared-memory
// carveout (so that as many blocks fit an SM as their shared memory allows),
// once per device.
template <typename Kernel>
int prepare(Kernel kernel, int bytes, std::atomic<bool>* ready) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return BAD_DEVICE;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return 0;
}

int launch_cascade(const void* x, const float* taps, const float* affine, void* h0, int batch,
                   int h, int w, int c, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  const int err = prepare(mkblock_cascade, cascade::SMEM, ready);
  if (err) return err;
  const dim3 grid(((h + cascade::T - 1) / cascade::T) * ((w + cascade::T - 1) / cascade::T) *
                      (c / 4 / cascade::CC),
                  1, batch);
  mkblock_cascade<<<grid, cascade::THREADS, cascade::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), taps, affine, static_cast<__nv_bfloat16*>(h0), h, w,
      c);
  return cudaGetLastError();
}

template <int C>
int launch_mlp(const void* h0, const void* w1t, const float* b1, const void* w2t, const float* b2,
               const void* x, void* out, int m, int grid, cudaStream_t stream) {
  using F = Fused<C>;
  static std::atomic<bool> ready[MAX_DEVICES];
  int err = prepare(mkblock_mlp<C>, F::SMEM, ready);
  if (err) return err;
  CUtensorMap h0f, h0h, w1f, w1h, w2;
  if ((err = tensor_map(&h0f, h0, m, C, 64, mlp::BM))) return err;
  if ((err = tensor_map(&w1f, w1t, 4 * C, C, 64, F::HC))) return err;
  if ((err = tensor_map(&w2, w2t, C, 4 * C, 64, C))) return err;
  h0h = h0f;
  w1h = w1f;
  if (F::KHALF) {
    if ((err = tensor_map(&h0h, h0, m, C, 32, mlp::BM))) return err;
    if ((err = tensor_map(&w1h, w1t, 4 * C, C, 32, F::HC))) return err;
  }
  mkblock_mlp<C><<<grid, mlp::THREADS, F::SMEM, stream>>>(
      h0f, h0h, w1f, w1h, w2, b1, b2, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), m);
  return cudaGetLastError();
}

template <int EPI>
int launch_gemm(const void* a, const void* b, const GemmArgs& p, int splits, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  int err = prepare(mkblock_gemm<EPI>, gemm::SMEM, ready);
  if (err) return err;
  CUtensorMap ma, mb;
  if ((err = tensor_map(&ma, a, p.M, p.K, 64, gemm::BM))) return err;
  if ((err = tensor_map(&mb, b, p.N, p.K, 64, gemm::BN))) return err;
  const dim3 grid((p.M + gemm::BM - 1) / gemm::BM, (p.N + gemm::BN - 1) / gemm::BN, splits);
  mkblock_gemm<EPI><<<grid, gemm::THREADS, gemm::SMEM, stream>>>(ma, mb, p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.

extern "C" {

// The fused MLP form's shared memory at C channels (0 where C takes the
// two-GEMM form), and whether it keeps w1 and w2 resident: the wrapper's plan
// mirrors both.
int mkblock_fused_smem(int c) {
  switch (c) {
    case 32: return Fused<32>::SMEM;
    case 64: return Fused<64>::SMEM;
    case 96: return Fused<96>::SMEM;
    case 128: return Fused<128>::SMEM;
    case 160: return Fused<160>::SMEM;
    case 192: return Fused<192>::SMEM;
    default: return 0;
  }
}

int mkblock_fused_resident(int c) {
  switch (c) {
    case 32: return Fused<32>::RESIDENT;
    case 64: return Fused<64>::RESIDENT;
    case 96: return Fused<96>::RESIDENT;
    case 128: return Fused<128>::RESIDENT;
    case 160: return Fused<160>::RESIDENT;
    case 192: return Fused<192>::RESIDENT;
    default: return 0;
  }
}

// Launches the cascade and the MLP on `stream` and returns the first error
// (0 when every launch was accepted). h0 [B, H, W, C] bf16 is scratch from
// the caller; for C > 192 so are hid [B*H*W, 4C] bf16 and, where splits > 1,
// ws [splits, B*H*W, C] f32 (both may be null otherwise). grid: the fused
// form's persistent blocks; splits: the second GEMM's K splits.
int mkblock_forward(const void* x, const float* taps, const float* affine, const void* w1t,
                    const float* b1, const void* w2t, const float* b2, void* h0, void* hid,
                    void* ws, void* out, int batch, int h, int w, int c, int grid, int splits,
                    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = launch_cascade(x, taps, affine, h0, batch, h, w, c, stream);
  if (err) return err;

  const int m = batch * h * w;
  switch (c) {
    case 32: return launch_mlp<32>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    case 64: return launch_mlp<64>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    case 96: return launch_mlp<96>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    case 128: return launch_mlp<128>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    case 160: return launch_mlp<160>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    case 192: return launch_mlp<192>(h0, w1t, b1, w2t, b2, x, out, m, grid, stream);
    default: break;
  }
  if (c % 32 || hid == nullptr || (splits > 1 && ws == nullptr)) return BAD_C;
  GemmArgs p{b1, nullptr, hid, m, 4 * c, c};
  if ((err = launch_gemm<HIDDEN>(h0, w1t, p, 1, stream))) return err;
  p = GemmArgs{b2, static_cast<const __nv_bfloat16*>(x), splits > 1 ? ws : out, m, c, 4 * c};
  if (splits == 1) return launch_gemm<OUTPUT>(hid, w2t, p, 1, stream);
  if ((err = launch_gemm<PARTIAL>(hid, w2t, p, splits, stream))) return err;
  const size_t quads = static_cast<size_t>(m) * c / 4;
  mkblock_reduce<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), splits, b2, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), m, c);
  return cudaGetLastError();
}

}  // extern "C"
