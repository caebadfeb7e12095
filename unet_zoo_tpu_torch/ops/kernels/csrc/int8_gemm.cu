// P2: the int8 GEMM on Hopper's tensor cores, hand-written for sm_90a.
//
// Replaces unet_zoo_tpu's root probe _probe_int8_mosaic.py::make_matmul (its
// pallas_call tiles A[M, K] . B[K, N] into VMEM blocks, s8 x s8 -> s32 or
// bf16 x bf16 -> f32) and carries the int8 conv of the JAX package's PTQ
// serving path (unet_zoo_tpu/nn/blocks.py::_QuantConv, which XLA lowered).
// Two entry points share one tile loop:
//
//   gemm:        out[M, N] = A[M, K] . B[N, K]^T, both operands K-contiguous
//                (A row-major, B stored [N, K]); s8 -> s32 by
//                mma.sync m16n8k32, or bf16 -> f32 by mma.sync m16n8k16.
//   int8_conv3x3: a 3x3 conv (stride 1 or 2, padding 1) as an implicit GEMM
//                over NHWC int8 x and weights packed [Co, Kpad] from
//                [Co, 3, 3, Ci] (K = 9 Ci zero-padded to Kpad): M = B Ho Wo
//                output pixels, N = Co. Taps outside the image and K beyond
//                9 Ci read as zero. Its epilogue is the dequantisation
//                out = rn(rn(float(acc) * scale[n]) + bias[n]), each product
//                and sum rounded once as the plain version's ATen passes do
//                (no fused multiply-add), then one rounding to the output
//                type. The integer sums are exact, so the kernel agrees with
//                its plain version bit for bit.
//
// Bound: operations at the shapes the served models give it (a 3x3 conv of
// 128-1024 channels does 100s of int8 operations a byte), against 1,979
// TOP/s int8 and 989 TFLOP/s bf16. Design, simple first: 8 warps a block,
// each a 64 x 32 sub-tile of 4 x 4 mma tiles; a 4-stage cp.async ring of
// 64-byte K chunks in shared memory (80-byte row pitch, so ldmatrix is
// conflict-free); A and B fragments fetched by ldmatrix b16 from K-contiguous
// tiles for both element types (an int8 fragment is a bf16 fragment's bytes).
// A conv row gathers its 16-byte chunks with cp.async where Ci is a multiple
// of 16, byte by byte otherwise (the first conv's Ci = 3). wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BKB = 64;          // bytes of K a stage: 64 int8 or 32 bf16
constexpr int LDS = BKB + 16;    // shared row pitch in bytes (80)
constexpr int NSTAGE = 4;
constexpr int THREADS = 256;

template <int BM, int BN>
struct Tile {
  static_assert((BM / 64) * (BN / 32) * 32 == THREADS, "8 warps of 64 x 32");
  static constexpr int A_CHUNKS = BM * BKB / 16 / THREADS;  // 16-byte A chunks a thread
  static constexpr int B_CHUNKS = BN * BKB / 16 / THREADS;
  static constexpr int SMEM = NSTAGE * (BM + BN) * LDS;
  using Rows = unsigned char[LDS];
};

// This thread's loader role: tile rows row0() + 64 i, bytes col() .. col() + 15.
__device__ __forceinline__ int row0() { return threadIdx.x >> 2; }
__device__ __forceinline__ int col() { return (threadIdx.x & 3) * 16; }

template <bool INT8>
struct Acc;
template <>
struct Acc<true> {
  using T = int;
  __device__ static void mma(int* c, const uint32_t* a, const uint32_t* b) { mma_s8(c, a, b); }
};
template <>
struct Acc<false> {
  using T = float;
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) { mma_bf16(c, a, b); }
};

// The shared tile loop: acc += A . B^T over K bytes [0, kbytes), in BKB-byte
// stages. B is [N, ldb bytes] (rows n_blk .. n_blk + BN, zero beyond N and
// beyond kbytes); load_a(rows, k0) fills this thread's A chunks of stage k0.
// Accumulator (i, j, e) of a warp sits at tile row warp_row + 16 i + lane / 4
// + 8 (e / 2) and column warp_col + 8 j + 2 (lane % 4) + e % 2.
template <bool INT8, int BM, int BN, class LoadA>
__device__ __forceinline__ void tile_loop(unsigned char* smem, const unsigned char* b, int N,
                                          size_t ldb, int kbytes, int n_blk, LoadA load_a,
                                          typename Acc<INT8>::T (&acc)[4][4][4]) {
  using T = Tile<BM, BN>;
  using Rows = typename T::Rows;
  Rows* As = reinterpret_cast<Rows*>(smem);
  Rows* Bs = reinterpret_cast<Rows*>(smem + NSTAGE * BM * LDS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / (BN / 32)) * 64, wn = (warp % (BN / 32)) * 32;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BKB;
    load_a(As + stage * BM, k0);
#pragma unroll
    for (int i = 0; i < T::B_CHUNKS; ++i) {
      const int r = row0() + 64 * i, n = n_blk + r, kb = k0 + col();
      const bool ok = n < N && kb < kbytes;
      cp_async16(&Bs[stage * BN + r][col()], ok ? b + static_cast<size_t>(n) * ldb + kb : b, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (kbytes + BKB - 1) / BKB;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt-1
    const int nk = kt + NSTAGE - 1;
    if (nk < KT) load_stage(nk % NSTAGE, nk);
    cp_async_commit();

    const Rows* A = As + (kt % NSTAGE) * BM;
    const Rows* B = Bs + (kt % NSTAGE) * BN;
#pragma unroll
    for (int ks = 0; ks < BKB; ks += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], &A[wm + 16 * i + (lane & 15)][ks + (lane >> 4) * 16]);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldsm_x4(r, &B[wn + 16 * j2 + (lane & 7) + ((lane >> 4) << 3)][ks + ((lane >> 3) & 1) * 16]);
        bfr[2 * j2][0] = r[0];
        bfr[2 * j2][1] = r[1];
        bfr[2 * j2 + 1][0] = r[2];
        bfr[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Acc<INT8>::mma(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
}

// Visit this thread's accumulators with their output coordinates.
template <int BN, class V, class Fn>
__device__ __forceinline__ void for_each_pair(const V (&acc)[4][4][4], int m_blk, int n_blk,
                                              Fn fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / (BN / 32)) * 64, wn = (warp % (BN / 32)) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(m_blk + wm + 16 * i + (lane >> 2) + 8 * h, n_blk + wn + 8 * j + 2 * (lane & 3),
           acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// ---- the GEMM ---------------------------------------------------------------

template <bool INT8, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
                void* __restrict__ out, int M, int N, int kbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_blk = blockIdx.x * BM, n_blk = blockIdx.y * BN;
  auto load_a = [&](typename Tile<BM, BN>::Rows* rows, int k0) {
#pragma unroll
    for (int i = 0; i < Tile<BM, BN>::A_CHUNKS; ++i) {
      const int r = row0() + 64 * i, m = m_blk + r, kb = k0 + col();
      const bool ok = m < M && kb < kbytes;
      cp_async16(&rows[r][col()], ok ? a + static_cast<size_t>(m) * kbytes + kb : a, ok);
    }
  };
  typename Acc<INT8>::T acc[4][4][4];
  tile_loop<INT8, BM, BN>(smem, b, N, kbytes, kbytes, n_blk, load_a, acc);
  using O = typename Acc<INT8>::T;  // s32 or f32 out, same width
  O* o = static_cast<O*>(out);
  for_each_pair<BN>(acc, m_blk, n_blk, [&](int m, int n, O v0, O v1) {
    if (m >= M) return;
    O* p = o + static_cast<size_t>(m) * N + n;
    if (n + 1 < N && (N & 1) == 0) {
      p[0] = v0;
      p[1] = v1;
    } else {
      if (n < N) p[0] = v0;
      if (n + 1 < N) p[1] = v1;
    }
  });
}

// ---- the int8 conv ------------------------------------------------------------

struct ConvShape {
  int B, H, W, Ci, Ho, Wo, Co, stride, kpad;
};

template <int BM, int BN, bool VEC, bool BF16_OUT>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const unsigned char* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     void* __restrict__ out, ConvShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = Tile<BM, BN>::A_CHUNKS;
  const int M = s.B * s.Ho * s.Wo;
  const int m_blk = blockIdx.x * BM, n_blk = blockIdx.y * BN;
  const int k_real = 9 * s.Ci;

  // this thread's A rows: image, top-left input pixel of the 3x3 window
  int img[R], iy0[R], ix0[R];
  bool live[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m_blk + row0() + 64 * i;
    live[i] = m < M;
    const int mm = live[i] ? m : 0;
    const int ox = mm % s.Wo, t = mm / s.Wo;
    img[i] = t / s.Ho;
    iy0[i] = (t % s.Ho) * s.stride - 1;
    ix0[i] = ox * s.stride - 1;
  }
  auto at = [&](int i, int k, bool& ok) -> size_t {
    const int tap = k / s.Ci, ci = k - tap * s.Ci;
    const int ky = tap / 3, kx = tap - 3 * ky;
    const int iy = iy0[i] + ky, ix = ix0[i] + kx;
    ok = live[i] && k < k_real && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    return ((static_cast<size_t>(img[i]) * s.H + iy) * s.W + ix) * s.Ci + ci;
  };
  auto load_a = [&](typename Tile<BM, BN>::Rows* rows, int k0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = row0() + 64 * i;
      if (VEC) {  // Ci % 16 == 0: a 16-byte chunk lies in one tap
        bool ok;
        const size_t off = at(i, k0 + col(), ok);
        cp_async16(&rows[r][col()], ok ? x + off : x, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool ok;
            const size_t off = at(i, k0 + col() + 4 * q + e, ok);
            const uint32_t byte = ok ? static_cast<uint8_t>(x[off]) : 0u;
            word |= byte << (8 * e);
          }
          v[q] = word;
        }
        *reinterpret_cast<uint4*>(&rows[r][col()]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  int acc[4][4][4];
  tile_loop<true, BM, BN>(smem, w, s.Co, s.kpad, s.kpad, n_blk, load_a, acc);

  for_each_pair<BN>(acc, m_blk, n_blk, [&](int m, int n, int v0, int v1) {
    if (m >= M) return;
    const int vals[2] = {v0, v1};
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n + e < s.Co ? n + e : 0;
      y[e] = __fmul_rn(__int2float_rn(vals[e]), scale[c]);
      if (bias != nullptr) y[e] = __fadd_rn(y[e], bias[c]);
    }
    const size_t o = static_cast<size_t>(m) * s.Co + n;
    const bool pair = n + 1 < s.Co && (s.Co & 1) == 0;
    if (BF16_OUT) {
      __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y[0], y[1]);
      } else {
        if (n < s.Co) p[0] = __float2bfloat16_rn(y[0]);
        if (n + 1 < s.Co) p[1] = __float2bfloat16_rn(y[1]);
      }
    } else {
      float* p = static_cast<float*>(out) + o;
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
      } else {
        if (n < s.Co) p[0] = y[0];
        if (n + 1 < s.Co) p[1] = y[1];
      }
    }
  });
}

template <int BM, int BN, bool VEC, bool BF16_OUT>
int conv_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                const ConvShape& s, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<BM, BN, VEC, BF16_OUT>;
  constexpr int smem = Tile<BM, BN>::SMEM;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const long long M = static_cast<long long>(s.B) * s.Ho * s.Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (s.Co + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const int8_t*>(x),
                                          static_cast<const unsigned char*>(w),
                                          static_cast<const float*>(scale),
                                          static_cast<const float*>(bias), out, s);
  return cudaGetLastError();
}

template <int BM, int BN, bool VEC>
int conv_out(const void* x, const void* w, const void* scale, const void* bias, void* out,
             const ConvShape& s, int bf16_out, cudaStream_t stream) {
  return bf16_out ? conv_launch<BM, BN, VEC, true>(x, w, scale, bias, out, s, stream)
                  : conv_launch<BM, BN, VEC, false>(x, w, scale, bias, out, s, stream);
}

template <int BM, int BN>
int conv_tile(const void* x, const void* w, const void* scale, const void* bias, void* out,
              const ConvShape& s, int bf16_out, cudaStream_t stream) {
  return s.Ci % 16 == 0 ? conv_out<BM, BN, true>(x, w, scale, bias, out, s, bf16_out, stream)
                        : conv_out<BM, BN, false>(x, w, scale, bias, out, s, bf16_out, stream);
}

template <bool INT8, int BM, int BN>
int gemm_launch(const void* a, const void* b, void* out, int M, int N, int kbytes,
                cudaStream_t stream) {
  auto kernel = gemm_kernel<INT8, BM, BN>;
  constexpr int smem = Tile<BM, BN>::SMEM;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const unsigned char*>(a),
                                          static_cast<const unsigned char*>(b), out, M, N,
                                          kbytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, H, W, Ci] int8, w [Co, kpad] int8 (kpad >= 9 Ci, a multiple of 64),
// scale [Co] f32, bias [Co] f32 or null; out [B, Ho, Wo, Co] bf16 or f32.
int int8_conv3x3(const void* x, const void* w, const void* scale, const void* bias, void* out,
                 int B, int H, int W, int Ci, int Ho, int Wo, int Co, int stride, int kpad,
                 int bf16_out, void* stream) {
  const ConvShape s{B, H, W, Ci, Ho, Wo, Co, stride, kpad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Co <= 64 ? conv_tile<256, 64>(x, w, scale, bias, out, s, bf16_out, st)
                  : conv_tile<128, 128>(x, w, scale, bias, out, s, bf16_out, st);
}

// a [M, K], b [N, K] (int8 or bf16), K * element size a multiple of 16;
// out [M, N] int32 or f32; block tile 128 x 128, or 256 x 64 for bm = 256.
int gemm(const void* a, const void* b, void* out, int M, int N, int K, int int8, int bm,
         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 256)
    return int8 ? gemm_launch<true, 256, 64>(a, b, out, M, N, K, st)
                : gemm_launch<false, 256, 64>(a, b, out, M, N, 2 * K, st);
  return int8 ? gemm_launch<true, 128, 128>(a, b, out, M, N, K, st)
              : gemm_launch<false, 128, 128>(a, b, out, M, N, 2 * K, st);
}

}  // extern "C"
