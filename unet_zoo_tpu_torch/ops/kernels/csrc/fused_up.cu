// K1: the fused UNet decoder stage, written by hand for Hopper (sm_90a).
//
//   out = relu(scale * conv3x3(concat(convT2x2s2(y) + bt, skip)) + bias)
//
// Replaces unet_zoo_tpu/ops/pallas/fused_up.py::fused_up_concat_conv (the TPU
// kernel; pl.pallas_call at fused_up.py:293). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/fused_up.py.
//
// Form: two launches of one tensor-core GEMM kernel (mma.sync m16n8k16, bf16
// in, f32 accumulate), fed by a 4-stage cp.async ring in shared memory
// (gemm_mainloop in mma.cuh).
//   1. ConvT as a GEMM: [B*Hc*Wc, Cin] x [Cin, 4*Cu]. Columns are packed
//      (a, b, cu), so column (a, b, cu) of coarse pixel (m, n) belongs to fine
//      pixel (2m+a, 2n+b): the depth-to-space is index math in the store. The
//      epilogue adds bt and rounds to bf16 into a scratch `up` [B, Hf, Wf, Cu]
//      (the TPU kernel rounds the same intermediate to the compute type).
//   2. The 3x3 conv as an implicit GEMM: M = B*Hf*Wf, N = Co,
//      K = 9*(Cu+Cs) in (dy, dx, c) order. Channels below Cu are read from
//      `up`, the rest from `skip`, so the concat never exists in memory. Zero
//      padding is a bounds check (cp.async zero-fills). The epilogue is
//      relu(acc*scale + bias) with conv bias and BatchNorm folded in.
//
// Bound: at unet's stage shapes the work is ~5.4 G MAC per 256px image per
// stage against ~4-20 MB of traffic, far above the card's ~295 flop/byte
// ridge, so the kernel is bound by tensor-core operations. The design keeps
// every warp on a 64x32 output tile (16 MMAs per 6 ldmatrix per k-step) and
// picks the block tile from N: 128x128 where Co >= 128, 256x64 for the Co=64
// stage, so no block computes empty columns. Known gaps to the bound, for
// later work: mma.sync instead of wgmma, cp.async instead of TMA, `up` kept
// in device memory between the two launches.
//
// Layout: every activation is NHWC bf16 (torch channels_last), weights are
// [K, N] row-major bf16, scale/bias/bt are f32. Requirements (checked by the
// wrapper): Cin, Cu, Cs multiples of 32 (a K chunk never straddles a tap or
// the up|skip boundary), Co a multiple of 8, 16-byte-aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

struct Params {
  const __nv_bfloat16* a0;  // convT: y [M, Cin]; conv: up [B, H, W, c0]
  const __nv_bfloat16* a1;  // conv: skip [B, H, W, c1]; convT: unused
  const __nv_bfloat16* w;   // [K, N]
  const float* v0;          // convT: bt [Cu]; conv: scale [Co]
  const float* v1;          // conv: bias [Co]; convT: unused
  __nv_bfloat16* out;       // convT: up [B, 2H, 2W, Cu]; conv: out [B, H, W, Co]
  int M, N, K;
  int H, W;                 // convT: coarse Hc, Wc; conv: fine Hf, Wf
  int c0, c1;               // convT: Cin, Cu; conv: Cu, Cs
};

// CONV3 = false: the ConvT GEMM with the depth-to-space store.
// CONV3 = true: the 3x3 implicit GEMM over up|skip with the folded-BN epilogue.
// Block tile BM x BN; warps are (BM/64) x (BN/32), each on 64 rows x 32 columns
// (the main loop is gemm_mainloop in mma.cuh; this kernel adds the A loader
// and the epilogue).
template <bool CONV3, int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2) fused_up_gemm(const Params p) {
  using T = GemmTile<BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m_blk = blockIdx.x * BM;
  const int n_blk = blockIdx.y * BN;

  // Pixel coordinates of this thread's A rows, fixed across the K loop.
  int rb[T::A_ITERS], rh[T::A_ITERS], rw[T::A_ITERS];
  bool rv[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int m = m_blk + T::a_row(i);
    rv[i] = m < p.M;
    const int mm = rv[i] ? m : 0;
    rw[i] = mm % p.W;
    rh[i] = (mm / p.W) % p.H;
    rb[i] = mm / (p.W * p.H);
  }

  auto load_a = [&](typename T::ATile& tile, int k0) {
    const int a_col = T::a_col();
    if constexpr (CONV3) {
      const int c2 = p.c0 + p.c1;
      const int tap = k0 / c2;
      const int c = k0 - tap * c2 + a_col;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < T::A_ITERS; ++i) {
        const int hh = rh[i] + dy;
        const int ww = rw[i] + dx;
        const bool ok = rv[i] && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
        const __nv_bfloat16* src = p.a0;
        if (ok) {
          const size_t pix = (static_cast<size_t>(rb[i]) * p.H + hh) * p.W + ww;
          src = c < p.c0 ? p.a0 + pix * p.c0 + c : p.a1 + pix * p.c1 + (c - p.c0);
        }
        cp_async16(&tile[T::a_row(i)][a_col], src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < T::A_ITERS; ++i) {
        const int m = m_blk + T::a_row(i);
        const __nv_bfloat16* src =
            rv[i] ? p.a0 + static_cast<size_t>(m) * p.K + k0 + a_col : p.a0;
        cp_async16(&tile[T::a_row(i)][a_col], src, rv[i]);
      }
    }
  };

  float acc[4][4][4];
  gemm_mainloop<BM, BN>(smem, p.w, p.N, p.K, n_blk, load_a, acc);

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
      size_t row_base = 0;
      if constexpr (CONV3) {
        row_base = static_cast<size_t>(m) * p.N;
      } else {
        const int wc = m % p.W;
        const int hc = (m / p.W) % p.H;
        const int b = m / (p.W * p.H);
        // fine pixel (2hc, 2wc) of image b; phase (a, b) adds a*2W + b
        row_base = ((static_cast<size_t>(b) * 2 * p.H + 2 * hc) * 2 * p.W + 2 * wc) * p.c1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_blk + wn + j * 8 + tig * 2;
        if (n >= p.N) continue;
        float v0 = acc[i][j][2 * half];
        float v1 = acc[i][j][2 * half + 1];
        __nv_bfloat16* dst;
        if constexpr (CONV3) {
          v0 = fmaxf(v0 * p.v0[n] + p.v1[n], 0.f);
          v1 = fmaxf(v1 * p.v0[n + 1] + p.v1[n + 1], 0.f);
          dst = p.out + row_base + n;
        } else {
          const int cu_n = p.c1;
          const int q = n / cu_n;  // (a, b) phase of this column
          const int cu = n - q * cu_n;
          v0 += p.v0[cu];
          v1 += p.v0[cu + 1];
          dst = p.out + row_base +
                (static_cast<size_t>(q >> 1) * 2 * p.W + (q & 1)) * cu_n + cu;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <bool CONV3, int BM, int BN>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = GemmTile<BM, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fused_up_gemm<CONV3, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  fused_up_gemm<CONV3, BM, BN><<<grid, GEMM_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Block tile by the GEMM's width: 128x128 where N fills it, else 256x64.
template <bool CONV3>
int launch_for(const Params& p, cudaStream_t stream) {
  return p.N >= 128 ? launch<CONV3, 128, 128>(p, stream) : launch<CONV3, 256, 64>(p, stream);
}

}  // namespace

// C interface, loaded with ctypes. Each function launches one kernel on
// `stream` and returns the CUDA error code (0 when the launch was accepted).

extern "C" int fused_up_convt(const void* y, const void* wt, const float* bt, void* up,
                              int batch, int hc, int wc, int cin, int cu, void* stream) {
  Params p{};
  p.a0 = static_cast<const __nv_bfloat16*>(y);
  p.a1 = nullptr;
  p.w = static_cast<const __nv_bfloat16*>(wt);
  p.v0 = bt;
  p.v1 = nullptr;
  p.out = static_cast<__nv_bfloat16*>(up);
  p.M = batch * hc * wc;
  p.N = 4 * cu;
  p.K = cin;
  p.H = hc;
  p.W = wc;
  p.c0 = cin;
  p.c1 = cu;
  return launch_for<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_up_conv3x3(const void* up, const void* skip, const void* wc,
                                const float* scale, const float* bias, void* out, int batch,
                                int hf, int wf, int cu, int cs, int co, void* stream) {
  Params p{};
  p.a0 = static_cast<const __nv_bfloat16*>(up);
  p.a1 = static_cast<const __nv_bfloat16*>(skip);
  p.w = static_cast<const __nv_bfloat16*>(wc);
  p.v0 = scale;
  p.v1 = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = batch * hf * wf;
  p.N = co;
  p.K = 9 * (cu + cs);
  p.H = hf;
  p.W = wf;
  p.c0 = cu;
  p.c1 = cs;
  return launch_for<true>(p, static_cast<cudaStream_t>(stream));
}
