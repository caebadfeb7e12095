// K8: modulated deformable convolution (DCNv2, one offset group), written by
// hand for Hopper (sm_90a).
//
// For each output pixel n and tap k (row-major over the kh x kw kernel):
//   py = clamp(oy*stride - pad + (k / kw)*dil + offset[n, 2k],     -1, H) + 1
//   px = clamp(ox*stride - pad + (k % kw)*dil + offset[n, 2k + 1], -1, W) + 1
//   y0 = clamp(floor(py), 0, H), x0 = clamp(floor(px), 0, W)   (padded frame)
//   g[n, k, :] = bf16(sum over the 4 corners of x_pad[corner, :] * cw_corner)
//   out[n, :]  = bf16(sum_k g[n, k, :] @ W[k] + bias)
// with x_pad the image in a 1-pixel zero frame and cw the bilinear corner
// weights times mask[n, k], all in f32.
//
// Replaces unet_zoo_tpu/ops/pallas/deform.py::deform_conv2d_pallas (the TPU
// kernel; pl.pallas_call at deform.py:164). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/deform.py.
//
// Bound: at wranet's shapes (C 128, O 32, k 3) each output pixel reads C
// inputs (in its neighbourhood), 27 offset and mask values and writes O
// outputs for 2*9*C*O operations: about 170 operations per byte, below the
// card's ridge, so device-memory bytes bound it. Neighbouring samples share
// corners, so the gathers are served mostly from L1 and L2. The design keeps
// everything between the gather and the output on chip:
//   - one block (4 warps) per tile of 64 output pixels (flattened over the
//     batch); the f32 accumulator [64, O] stays in registers across taps
//     (each warp owns 16 rows, mma.sync m16n8k16);
//   - per tap the block computes each pixel's positions and weights itself
//     from the offset and mask it loads (the Pallas version precomputes
//     them in XLA), gathers the four corners' C channels with 16-byte loads
//     (a half warp per pixel), blends in f32, rounds once to bf16 and writes
//     the [64, C] row tile to shared memory; W_k [C, O] arrives in shared
//     memory by cp.async meanwhile; then ldmatrix + mma.sync (csrc/mma.cuh);
//   - C is padded to 16 and O to the accumulator's width with zeros in
//     shared memory, so odd C and O (and C not a multiple of 8: element
//     loads) are masked, not special-cased in the MMA.
// Known gap, for later work: the gather of tap k+1 does not overlap tap k's
// MMA (one buffer), and each block re-gathers corners its neighbours read.
//
// Layout: x [B, H, W, C], offset [B, Ho, Wo, 2K], mask [B, Ho, Wo, K],
// weight [K, C, O] (the [kh, kw, C, O] weight), out [B, Ho, Wo, O], all bf16
// and contiguous; bias [O] f32 or null. Requirements (checked by the
// wrapper): O <= 128, the shared memory of smem_bytes() <= 200 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 64;         // output pixels of one block
constexpr int NTHREADS = 128;  // 4 warps, 16 accumulator rows each

using bf16 = __nv_bfloat16;

struct Geometry {
  int B, H, W, C, Ho, Wo, O, kh, kw, stride, pad, dil;
  int cpad;  // C rounded up to 16: the MMA's K
  int a_ld;  // row pitch of the gathered tile (cpad + 8)
  int w_ld;  // row pitch of W_k (8 * NT + 8)
};

inline int smem_bytes(int cpad, int nt) { return 2 * (BM * (cpad + 8) + cpad * (8 * nt + 8)); }

// Positions and weights of pixel n at tap k, f32 rounded step by step as the
// plain version computes them.
struct Sample {
  int y0, x0;  // top-left corner in the padded frame
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Sample sample(const Geometry& g, const bf16* __restrict__ offset,
                                         const bf16* __restrict__ mask, int n, int k) {
  const int K = g.kh * g.kw;
  const int r = n % (g.Ho * g.Wo);
  const int oy = r / g.Wo, ox = r % g.Wo;
  const float offy = __bfloat162float(offset[static_cast<size_t>(n) * 2 * K + 2 * k]);
  const float offx = __bfloat162float(offset[static_cast<size_t>(n) * 2 * K + 2 * k + 1]);
  const float m = __bfloat162float(mask[static_cast<size_t>(n) * K + k]);
  const float by = static_cast<float>(oy * g.stride - g.pad + (k / g.kw) * g.dil);
  const float bx = static_cast<float>(ox * g.stride - g.pad + (k % g.kw) * g.dil);
  const float py =
      __fadd_rn(fminf(fmaxf(__fadd_rn(by, offy), -1.f), static_cast<float>(g.H)), 1.f);
  const float px =
      __fadd_rn(fminf(fmaxf(__fadd_rn(bx, offx), -1.f), static_cast<float>(g.W)), 1.f);
  Sample s;
  s.y0 = min(max(static_cast<int>(floorf(py)), 0), g.H);
  s.x0 = min(max(static_cast<int>(floorf(px)), 0), g.W);
  const float wy1 = py - static_cast<float>(s.y0);
  const float wx1 = px - static_cast<float>(s.x0);
  s.w00 = __fmul_rn(__fmul_rn(1.f - wy1, 1.f - wx1), m);
  s.w01 = __fmul_rn(__fmul_rn(1.f - wy1, wx1), m);
  s.w10 = __fmul_rn(__fmul_rn(wy1, 1.f - wx1), m);
  s.w11 = __fmul_rn(__fmul_rn(wy1, wx1), m);
  return s;
}

// 8 channels of one corner as f32, zero outside the image or beyond C.
__device__ __forceinline__ void load8(const bf16* __restrict__ xb, const Geometry& g, int yy,
                                      int xx, int c, bool vec, float* v) {
  const int y = yy - 1, x = xx - 1;  // padded frame -> image
  if (y < 0 || y >= g.H || x < 0 || x >= g.W) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    return;
  }
  const bf16* p = xb + (static_cast<size_t>(y) * g.W + x) * g.C + c;
  if (vec) {  // C a multiple of 8 and x 16-byte aligned: c < C means all 8 are in
    if (c >= g.C) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      return;
    }
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c + i < g.C ? __bfloat162float(p[i]) : 0.f;
  }
}

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
    deform_kernel(const bf16* __restrict__ x, const bf16* __restrict__ offset,
                  const bf16* __restrict__ mask, const bf16* __restrict__ weight,
                  const float* __restrict__ bias, bf16* __restrict__ out, Geometry g, int vec_x,
                  int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);       // [BM][a_ld]
  bf16* Ws = As + BM * g.a_ld;                     // [cpad][w_ld]
  constexpr int OPAD = 8 * NT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int total = g.B * g.Ho * g.Wo;
  const int n0 = blockIdx.x * BM;
  const int K = g.kh * g.kw;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  const int half = tid >> 4;  // 8 half warps, one pixel each at a time
  const int hl = tid & 15;

  for (int k = 0; k < K; ++k) {
    // W_k [C, O] -> Ws [cpad][OPAD], zero beyond C and O
    const bf16* wk = weight + static_cast<size_t>(k) * g.C * g.O;
    for (int i = tid; i < g.cpad * (OPAD / 8); i += NTHREADS) {
      const int row = i / (OPAD / 8);
      const int col = (i % (OPAD / 8)) * 8;
      bf16* dst = Ws + row * g.w_ld + col;
      if (vec_w) {
        const bool ok = row < g.C && col < g.O;
        cp_async16(dst, ok ? wk + static_cast<size_t>(row) * g.O + col : wk, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (row < g.C && col + e < g.O) ? wk[static_cast<size_t>(row) * g.O + col + e]
                                                : __float2bfloat16_rn(0.f);
      }
    }
    cp_async_commit();

    // gather, blend and round: a half warp per pixel, 8 channels a lane
    for (int p = half; p < BM; p += NTHREADS / 16) {
      const int n = n0 + p;
      bf16* arow = As + p * g.a_ld;
      if (n >= total) {
        for (int c = hl * 8; c < g.cpad; c += 128)
          *reinterpret_cast<uint4*>(arow + c) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const Sample s = sample(g, offset, mask, n, k);
      const bf16* xb = x + static_cast<size_t>(n / (g.Ho * g.Wo)) * g.H * g.W * g.C;
      for (int c = hl * 8; c < g.cpad; c += 128) {
        // products and sums rounded one by one, corners in order (no fma
        // contraction): the blend is the plain version's bit for bit
        float v[8], blend[8];
        load8(xb, g, s.y0, s.x0, c, vec_x, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) blend[i] = __fmul_rn(v[i], s.w00);
        load8(xb, g, s.y0, s.x0 + 1, c, vec_x, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) blend[i] = __fadd_rn(blend[i], __fmul_rn(v[i], s.w01));
        load8(xb, g, s.y0 + 1, s.x0, c, vec_x, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) blend[i] = __fadd_rn(blend[i], __fmul_rn(v[i], s.w10));
        load8(xb, g, s.y0 + 1, s.x0 + 1, c, vec_x, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) blend[i] = __fadd_rn(blend[i], __fmul_rn(v[i], s.w11));
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(blend[2 * i], blend[2 * i + 1]);
        *reinterpret_cast<uint4*>(arow + c) = packed;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the row tile and W_k are in shared memory

    // acc[16 rows of this warp, OPAD] += A[16, cpad] @ W_k[cpad, OPAD]
    const int m0 = warp * 16;
    for (int ks = 0; ks < g.cpad; ks += 16) {
      uint32_t af[4];
      ldsm_x4(af, As + (m0 + (lane & 15)) * g.a_ld + ks + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t r[4];
        ldsm_x4_trans(r, Ws + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * g.w_ld + j2 * 16 +
                             (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        mma_bf16(acc[2 * j2], af, b0);
        mma_bf16(acc[2 * j2 + 1], af, b1);
      }
    }
    __syncthreads();  // every warp is done with this tap's tiles
  }

  // epilogue: + bias (f32), one rounding to bf16
  const bool pair_store = (g.O % 2) == 0;
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const int n = n0 + warp * 16 + (lane >> 2) + 8 * half_row;
    if (n >= total) continue;
    bf16* orow = out + static_cast<size_t>(n) * g.O;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col >= g.O) continue;
      float v0 = acc[j][2 * half_row], v1 = acc[j][2 * half_row + 1];
      if (bias != nullptr) {
        v0 += bias[col];
        if (col + 1 < g.O) v1 += bias[col + 1];
      }
      if (pair_store) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < g.O) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int NT>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const void* bias, void* out, Geometry g, cudaStream_t stream) {
  g.w_ld = 8 * NT + 8;
  const int smem = smem_bytes(g.cpad, NT);
  const auto kernel = deform_kernel<NT>;
  static int smem_set = 0;  // the largest dynamic shared memory granted so far
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const int vec_x = (g.C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_w = (g.O % 8 == 0) && (reinterpret_cast<uintptr_t>(weight) % 16 == 0);
  const int total = g.B * g.Ho * g.Wo;
  kernel<<<(total + BM - 1) / BM, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(offset),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<bf16*>(out), g, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int deform_conv(const void* x, const void* offset, const void* mask,
                           const void* weight, const void* bias, void* out, int batch, int h,
                           int w, int c, int ho, int wo, int o, int kh, int kw, int stride,
                           int pad, int dil, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Geometry g{batch, h, w, c, ho, wo, o, kh, kw, stride, pad, dil, 0, 0, 0};
  g.cpad = (c + 15) / 16 * 16;
  g.a_ld = g.cpad + 8;
  const int nt = o <= 16 ? 2 : o <= 32 ? 4 : o <= 64 ? 8 : 16;
  switch (nt) {
    case 2: return launch<2>(x, offset, mask, weight, bias, out, g, stream);
    case 4: return launch<4>(x, offset, mask, weight, bias, out, g, stream);
    case 8: return launch<8>(x, offset, mask, weight, bias, out, g, stream);
    default: return launch<16>(x, offset, mask, weight, bias, out, g, stream);
  }
}
