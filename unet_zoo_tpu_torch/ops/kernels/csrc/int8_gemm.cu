// P2: the int8 GEMM and the int8 3x3 conv on Hopper's tensor cores, for sm_90a.
//
// Replaces unet_zoo_tpu's root probe _probe_int8_mosaic.py::make_matmul (its
// pallas_call tiles A[M, K] . B[K, N] into VMEM blocks, s8 x s8 -> s32 or
// bf16 x bf16 -> f32) and carries the int8 conv of the JAX package's PTQ
// serving path (unet_zoo_tpu/nn/blocks.py::_QuantConv, which XLA lowered).
// Two entry points share one tile loop:
//
//   gemm:         out[M, N] = A[M, K] . B[N, K]^T, both operands K-contiguous
//                 (A row-major, B stored [N, K]); s8 -> s32, or bf16 -> f32.
//   int8_conv3x3: a k x k conv (k 3 or 1; stride, padding and dilation as the
//                 wrapper's GEOMETRIES: 3x3 with padding = dilation 1, 2, 4
//                 or 8, 3x3 stride 2 padding 1, 1x1 padding 0) as an implicit
//                 GEMM of NHWC float32 or bf16 x with int8 weights packed
//                 [Co, Kpad] (K = k^2 Ci zero-padded, in pack_conv_weight's
//                 order): output pixel (oy, ox) reads input pixel (oy stride -
//                 pad + ky dil, ox stride - pad + kx dil) at tap (ky, kx).
//                 M = B Ho Wo output pixels, N = Co. x is quantised as it is loaded,
//                 q = clamp(rn(x / s_x), -127, 127) as a true IEEE division
//                 and rounding half to even give it; taps outside the image and K
//                 beyond k^2 Ci are 0. The epilogue dequantises the exact int32
//                 sums as rn(rn(float(acc) * scale[n]) + bias[n]), each product
//                 and sum rounded once as the plain version's ATen passes do (no
//                 fused multiply-add), then rounds once to bf16 or f32, NHWC.
//                 So the kernel agrees with its plain version bit for bit.
//
// Bound: operations at the served shapes (a 3x3 conv of 128-1024 channels
// does hundreds of int8 operations a byte), against 1,979 TOP/s int8 and 989
// TFLOP/s bf16. Design: a block computes a 128 x BN tile (BN 64, 128 or
// 256). Warpgroups 0 and 1 each own 64 rows and issue wgmma.mma_async
// m64nBNk32 (s8 -> s32) or m64nBNk16 (bf16 -> f32) with both operands read
// from shared memory through descriptors; one to four producer warpgroups
// follow (Threads). K streams through a ring of stages of 128 bytes of K a
// row (128 int8 or 64 bf16), each stored with the 128-byte swizzle the
// descriptors declare; a stage is announced full on one mbarrier and
// released by the consumers on another. B (the GEMM's [N, K], the conv's
// weights) and the GEMM's A arrive by TMA. The conv's A is built by the
// producer threads (TMA's tiled mode cannot gather a 3x3 window with
// padding): for Ci a multiple of 128, or 16, 32 or 64, they quantise the
// tile's input window (its rows reach dil (k - 1) beyond the tile's) once
// per block of 128 channels into a shared halo and copy each tap's rows from
// it; otherwise (the first conv's Ci = 3, Ci not a multiple of 16, a window
// too large for the halo, as at dilation 8) they gather and quantise each
// stage's chunks. They write the swizzle themselves and fence their stores into
// the async proxy. The producers' gathering and quantising bound the conv.
// setmaxnreg moves registers from the producers to the consumers, whose 64
// x 256 s32 accumulator takes 128 a thread.
//
// Small grids: the wrapper (ops/kernels/int8_gemm.py::conv_plan) may split
// the conv's K over gridDim.z blocks of a tile. Each writes its int32 partial
// tile to a workspace; the last block of the tile to arrive (a counter per
// tile, which it resets to 0) adds the others' partials and runs the
// epilogue. int32 sums are exact in any order, so the split keeps the result
// bit for bit. The bf16 GEMM never splits: that would change its rounding.
//
// Tensor maps are encoded through cudaGetDriverEntryPoint (only the runtime
// is linked) and cached by address and shape, so a served conv's weights
// are encoded once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;        // rows of a block tile: two consumer warpgroups of 64
constexpr int KSTAGE = 128;    // bytes of K a stage holds per row

enum Kind { GEMM_S8 = 0, GEMM_BF16 = 1, CONV_F32 = 2, CONV_BF16 = 3 };

// Warpgroups 0-1 consume; as many producer warpgroups as the consumers'
// accumulators leave registers for: a block's threads get at most 65536 / N
// registers each at compile time, which must hold the widest wgmma's
// operands (m64n256: more than 128, so one producer warpgroup; m64n128: two;
// m64n64: four). A producer warp spends most of an item waiting, so the more
// producer warps a scheduler can switch between, the faster a stage fills.
template <int BN>
struct Threads {
  static constexpr int PRODUCER_WGS = BN == 256 ? 1 : BN == 128 ? 2 : 4;
  static constexpr int N = 128 * (2 + PRODUCER_WGS);
  // 128 PRODUCER_WGS x PRODUCER_REGS + 256 x CONSUMER_REGS <= N x (65536 / N, to 8)
  static constexpr int PRODUCER_REGS = BN == 256 ? 128 : BN == 128 ? 104 : 72;
  static constexpr int CONSUMER_REGS = BN == 256 ? 184 : BN == 128 ? 152 : 96;
};

// Bytes of the conv's quantised halo: 400 input pixels of 128 channels (a
// 128-pixel tile of one output row at 256px reads 3 x 130).
constexpr int HALO_BYTES = 400 * KSTAGE;

// The GEMM's ring is deep (TMA latency); the conv's producer is slower than
// its wgmma, so a short ring does, and leaves room for the halo.
template <int BN, bool CONV>
struct Cfg {
  static constexpr int A_BYTES = BM * KSTAGE;
  static constexpr int B_BYTES = BN * KSTAGE;
  static constexpr int STAGES = CONV ? (BN == 256 ? 3 : 4) : (BN == 256 ? 4 : BN == 128 ? 6 : 8);
  static constexpr int RING = STAGES * (A_BYTES + B_BYTES);
  static constexpr int HALO = CONV ? HALO_BYTES : 0;
  // ring, halo, full and empty barriers, the conv's row table, the split
  // flag, and slack to align the ring to 1024 bytes
  static constexpr int SMEM = RING + HALO + 2 * STAGES * 8 + BM * 16 + 16 + 1024;
};

template <int KIND>
struct AccT {
  using T = int;
};
template <>
struct AccT<GEMM_BF16> {
  using T = float;
};

struct Params {
  int M, N, kbytes;  // out [M, N]; the conv's M = B Ho Wo, N = Co, kbytes = Kpad
  void* out;
  // the conv only
  const void* x;
  const float* s_x;
  const float* scale;
  const float* bias;
  int* ws;
  int* counters;
  int H, W, Ci, Ho, Wo, stride, bf16_out;
  int ks, pad, dil, taps;  // kernel size, padding, dilation, ks * ks
};

template <int KIND, int BN, class T>
__device__ __forceinline__ void mma(T (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (KIND == GEMM_BF16) {
    if constexpr (BN == 64) wgmma_bf16_n64(d, a, b);
    else if constexpr (BN == 128) wgmma_bf16_n128(d, a, b);
    else wgmma_bf16_n256(d, a, b);
  } else {
    if constexpr (BN == 64) wgmma_s8_n64(d, a, b);
    else if constexpr (BN == 128) wgmma_s8_n128(d, a, b);
    else wgmma_s8_n256(d, a, b);
  }
}

// ---- quantisation in the conv's producer -------------------------------------

// clamp(rn(v / s), -127, 127), v / s the IEEE quotient q, from r = rn(1 / s).
// z = fma(v, r, 1.5 2^23) rounds the exact product v r half to even into
// the low bits of z, clamped to R +- 127 its low byte is the int8. For
// |q| <= 128, v r lies within 2^-23 |q| <= 1.6e-5 of q, so where v r is
// farther than 2^-14 from every half-integer (d = v r - rn(v r), fma'd too,
// is below 1/2 - 2^-14 in size), v r and q round to the same integer, and
// beyond 128 both clamp. quick() returns the clamped z and |d| (a value is
// near when |d| >= NEAR); exact() divides. Four FP32 instructions and a
// clamp a value: a true division on every value takes a slow-path call for
// each zero numerator (half of a ReLU output), and rintf and float-to-int
// conversions issue at a quarter of the FP32 rate.
constexpr float ROUNDER = 12582912.0f;  // R = 1.5 * 2^23
constexpr float NEAR = 0.5f - 0x1p-14f;

__device__ __forceinline__ float quick(float v, float r, float& dist) {
  const float z = __fmaf_rn(v, r, ROUNDER);
  dist = fabsf(__fmaf_rn(v, r, -__fsub_rn(z, ROUNDER)));
  return fminf(fmaxf(z, ROUNDER - 127.f), ROUNDER + 127.f);
}

__device__ __forceinline__ float exact(float v, float s) {
  return __fadd_rn(fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f), ROUNDER);
}

__device__ __forceinline__ uint32_t quantize(float v, float s, float r) {
  float dist;
  const float z = quick(v, r, dist);
  return __float_as_uint(dist >= NEAR ? exact(v, s) : z);  // the int8 in the low byte
}

// The low bytes of a, b, c, d, in that order.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// 16 consecutive channels (a 16-element-aligned chunk) of x as raw 16-byte
// words: 4 of float32, 2 of bf16 (zeros where `ok` is false), and their
// quantisation to 16 int8.
template <class X>
struct Chunk {
  static constexpr int WORDS = 16 * sizeof(X) / 16;
  uint4 w[WORDS];

  __device__ __forceinline__ void load(const X* src, bool ok) {
#pragma unroll
    for (int j = 0; j < WORDS; ++j)
      w[j] = ok ? __ldg(reinterpret_cast<const uint4*>(src) + j) : make_uint4(0, 0, 0, 0);
  }

  __device__ __forceinline__ float value(int e) const {
    const uint4& u = w[e / (16 / WORDS)];
    if constexpr (sizeof(X) == 4) {
      const uint32_t c[4] = {u.x, u.y, u.z, u.w};
      return __uint_as_float(c[e % 4]);
    } else {
      const uint32_t c[4] = {u.x, u.y, u.z, u.w};
      return e % 2 ? bf16_hi(c[(e % 8) / 2]) : bf16_lo(c[(e % 8) / 2]);
    }
  }

  // The 16 values rounded without a branch (16 independent chains the
  // compiler interleaves, their |d| reduced by a tree of maxima, not a chain
  // of predicates); only a chunk with a value near a half-integer (about one
  // in 500 of a served conv's chunks) divides, all 16.
  __device__ __forceinline__ uint4 quantized(float s, float r) const {
    float t[16], dist[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) t[e] = quick(value(e), r, dist[e]);
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
#pragma unroll
      for (int e = 0; e < 16; e += 2 * w) dist[e] = fmaxf(dist[e], dist[e + w]);
    if (dist[0] >= NEAR) {
#pragma unroll
      for (int e = 0; e < 16; ++e) t[e] = exact(value(e), s);
    }
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = pack4(__float_as_uint(t[4 * j]), __float_as_uint(t[4 * j + 1]),
                   __float_as_uint(t[4 * j + 2]), __float_as_uint(t[4 * j + 3]));
    return make_uint4(q[0], q[1], q[2], q[3]);
  }
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_lo(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Where producer thread t's 16-byte chunk c = t % 8 of a row of the conv's
// A stage kt lies: its tap's offsets from the row's origin (ky dil, kx dil)
// and its channel, or no K. K is ordered as pack_conv_weight packs it: (ky,
// kx, ci), or for Ci a multiple of 128 (channel block, ky, kx, ci in the
// block), so that consecutive stages read the same channels of neighbouring
// taps, mostly from L1.
struct TapAt {
  int ky, kx, ci;
  bool kin;
  __device__ __forceinline__ TapAt(int kt, int k_hi, int c, const Params& p) {
    int tap;
    if (p.Ci % KSTAGE == 0) {
      kin = kt < k_hi;
      const int block = kt / p.taps;
      tap = kt - p.taps * block;
      ci = block * KSTAGE + 16 * c;
    } else {
      const int k = kt * KSTAGE + 16 * c;
      kin = kt < k_hi && k < p.taps * p.Ci;
      tap = kin ? k / p.Ci : 0;
      ci = k - tap * p.Ci;
    }
    const int ty = tap / p.ks;
    ky = ty * p.dil;
    kx = (tap - p.ks * ty) * p.dil;
  }
};

// The conv's A stages, Ci a multiple of 16 (a chunk is 16 channels of one
// tap): 128 rows (output pixels) x 128 bytes of K each, gathered from x and
// quantised. Producer thread t (of 128 WGS) owns chunk c = t % 8 of rows
// t / 8 + 16 WGS i; rows[] holds each row's (image offset, top-left input
// row, column, live). The thread's row chunks are a stream over the stages:
// D of them are in flight in registers while the oldest is quantised, the
// next stage's first ones loaded during this stage's last.
template <int WGS, class X, class Stage>
__device__ __forceinline__ void produce_conv_a(const X* x, const int4* rows, const Params& p,
                                               float s, float rs, int t, int k_lo, int k_hi,
                                               Stage&& stage_io) {
  constexpr int ITEMS = 8 / WGS, STRIDE = 16 * WGS, D = ITEMS < 4 ? ITEMS : 4;
  const int c = t & 7, r0 = t >> 3;
  auto load = [&](Chunk<X>& dst, const TapAt& at, int i) {
    const int4 r = rows[r0 + STRIDE * i];
    const int iy = r.y + at.ky, ix = r.z + at.kx;
    const bool ok = at.kin && r.w && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    dst.load(x + (ok ? static_cast<size_t>(r.x + iy * p.W + ix) * p.Ci + at.ci : 0), ok);
  };
  Chunk<X> ring[D];
  TapAt cur(k_lo, k_hi, c, p);
#pragma unroll
  for (int i = 0; i < D; ++i) load(ring[i], cur, i);
  for (int kt = k_lo; kt < k_hi; ++kt) {
    const TapAt next(kt + 1, k_hi, c, p);
    unsigned char* a = stage_io(kt);  // waits for the stage to be free
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int row = r0 + STRIDE * i;
      *reinterpret_cast<uint4*>(a + row * KSTAGE + ((c ^ (row & 7)) << 4)) =
          ring[i % D].quantized(s, rs);
      if (i + D < ITEMS) load(ring[i % D], cur, i + D);
      else load(ring[i % D], next, i + D - ITEMS);
    }
    stage_io(-1);  // announces the stage full
    cur = next;
  }
}

// The input window of a conv tile: every pixel that a tap of one of its
// 128 output pixels reads, as up to two images' runs of input rows
// [y_lo, y_hi] over the columns [cx0, cx1] (the full width unless the tile
// is one output row), all inside the image, `cb` bytes (channels) a pixel:
// output row oy reads input rows oy stride - pad to that plus dil (k - 1).
// `fits` is false when the tile spans more than two images or the window
// exceeds HALO_BYTES.
struct Window {
  int img0, base0, y_lo0, rows0, y_lo1, rows1, cx0, hw, cb;
  bool fits;
  __device__ __forceinline__ Window(int m_blk, int cb_, const Params& p) : cb(cb_) {
    const int m1 = min(m_blk + BM, p.M) - 1;
    const int t0 = m_blk / p.Wo, t1 = m1 / p.Wo;
    const int ox0 = m_blk - t0 * p.Wo, ox1 = m1 - t1 * p.Wo;
    img0 = t0 / p.Ho;
    const int oy0 = t0 - img0 * p.Ho, img1 = t1 / p.Ho, oy1 = t1 - img1 * p.Ho;
    base0 = img0 * p.H * p.W;
    const bool one_row = t0 == t1;
    const int reach = p.dil * (p.ks - 1) - p.pad;  // the last tap's offset from the pixel
    cx0 = one_row ? max(0, ox0 * p.stride - p.pad) : 0;
    hw = (one_row ? min(p.W - 1, ox1 * p.stride + reach) : p.W - 1) - cx0 + 1;
    const int oy_end0 = img1 == img0 ? oy1 : p.Ho - 1;
    y_lo0 = max(0, oy0 * p.stride - p.pad);
    rows0 = min(p.H - 1, oy_end0 * p.stride + reach) - y_lo0 + 1;
    y_lo1 = 0;
    rows1 = img1 > img0 ? min(p.H - 1, oy1 * p.stride + reach) + 1 : 0;
    fits = img1 <= img0 + 1 && (rows0 + rows1) * hw * cb <= HALO_BYTES;
  }
  // the halo offset of in-image input pixel (iy, ix) of the image at base
  __device__ __forceinline__ int at(int base, int iy, int ix) const {
    return ((base == base0 ? iy - y_lo0 : rows0 + iy - y_lo1) * hw + ix - cx0) * cb;
  }
};

// The conv's A stages from a quantised halo, for Ci a multiple of 128 (K in
// channel blocks of 128, each block's nine taps in a row; TapAt) or Ci 16,
// 32 or 64 (one block; a stage holds 128 / Ci taps): on the first stage of
// a channel block the producer threads quantise the tile's input window
// once, 16 channels a chunk, into `halo` (cb = min(Ci, 128) bytes a pixel);
// each of the block's stages then copies its taps' chunks from the halo
// into the swizzled A stage. Each x value is quantised once per channel
// block and tile instead of once per tap. Producer thread t (of 128 WGS)
// copies chunk c = t % 8 of rows t / 8 + 16 WGS i.
template <int WGS, class X, class Stage>
__device__ __forceinline__ void produce_conv_a_halo(const X* x, const int4* rows,
                                                    const Params& p, const Window& win, float s,
                                                    float rs, int t, int k_lo, int k_hi,
                                                    unsigned char* halo, Stage&& stage_io) {
  constexpr int NP = 128 * WGS, ITEMS = 8 / WGS, STRIDE = 16 * WGS;
  constexpr int G = sizeof(X) == 4 || WGS == 4 ? 2 : 4;  // chunks loaded at once (registers)
  const int c = t & 7, r0 = t >> 3;
  const int lg = __ffs(win.cb >> 4) - 1;  // log2 of the chunks a halo pixel holds
  const int nitems = ((win.rows0 + win.rows1) * win.hw) << lg;
  int block = -1;
  for (int kt = k_lo; kt < k_hi; ++kt) {
    unsigned char* a = stage_io(kt);  // waits for the stage to be free
    int kb = 0, tap, choff;
    if (p.Ci % KSTAGE == 0) {
      kb = kt / p.taps;
      tap = kt - p.taps * kb;
      choff = 16 * c;
    } else {
      tap = kt * (KSTAGE / win.cb) + (c >> lg);
      choff = 16 * (c & ((1 << lg) - 1));
    }
    const int ty = tap / p.ks, ky = ty * p.dil, kx = (tap - p.ks * ty) * p.dil;
    if (kb != block) {  // quantise the window's channels kb * 128 .. + cb - 1
      named_barrier(2, NP);  // every producer thread is done with the old halo
      block = kb;
      for (int i0 = t; i0 < nitems; i0 += G * NP) {
        Chunk<X> raw[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int item = i0 + g * NP, pix = item >> lg;
          const bool ok = item < nitems;
          const int hr = ok ? pix / win.hw : 0, col = pix - hr * win.hw;
          const bool second = hr >= win.rows0;
          const int iy = second ? win.y_lo1 + hr - win.rows0 : win.y_lo0 + hr;
          const size_t px = static_cast<size_t>(win.base0 + (second ? p.H * p.W : 0)) +
                            static_cast<size_t>(iy) * p.W + win.cx0 + col;
          const int ch = kb * KSTAGE + 16 * (item & ((1 << lg) - 1));
          raw[g].load(x + (ok ? px * p.Ci + ch : 0), ok);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int item = i0 + g * NP;
          if (item < nitems)
            *reinterpret_cast<uint4*>(halo + item * 16) = raw[g].quantized(s, rs);
        }
      }
      named_barrier(2, NP);  // the halo is complete
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int row = r0 + STRIDE * i;
      const int4 r = rows[row];
      const int iy = r.y + ky, ix = r.z + kx;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (tap < p.taps && r.w && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
        q = *reinterpret_cast<const uint4*>(halo + win.at(r.x, iy, ix) + choff);
      *reinterpret_cast<uint4*>(a + row * KSTAGE + ((c ^ (row & 7)) << 4)) = q;
    }
    stage_io(-1);  // announces the stage full
  }
}

// The conv's A stage element by element (Ci not a multiple of 16: the first
// conv's Ci = 3, multiresunet's 51 or 105): thread t owns chunks 8 / WGS of
// row t % 128.
template <int WGS, class X>
__device__ __forceinline__ void fill_conv_a_elementwise(unsigned char* a, const X* x,
                                                        const int4* rows, const Params& p,
                                                        float s, float rs, int kt, int t) {
  constexpr int CHUNKS = 8 / WGS;
  const int row = t & 127, c0 = (t >> 7) * CHUNKS;
  const int kreal = p.taps * p.Ci, k0 = kt * KSTAGE + 16 * c0;
  const int4 r = rows[row];
  int tap = k0 / p.Ci, ci = k0 - tap * p.Ci;
  for (int cc = c0; cc < c0 + CHUNKS; ++cc) {
    uint32_t w[4] = {0, 0, 0, 0};
    const int kc = kt * KSTAGE + 16 * cc;
    if (r.w && kc < kreal) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (kc + e < kreal) {
          const int ty = tap / p.ks;
          const int iy = r.y + ty * p.dil, ix = r.z + (tap - p.ks * ty) * p.dil;
          if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
            const float v = load1(x + (static_cast<size_t>(r.x + iy * p.W + ix) * p.Ci + ci));
            w[e / 4] |= (quantize(v, s, rs) & 0xFFu) << (8 * (e % 4));
          }
        }
        if (++ci == p.Ci) {
          ci = 0;
          ++tap;
        }
      }
    }
    *reinterpret_cast<uint4*>(a + row * KSTAGE + ((cc ^ (row & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- the kernel ----------------------------------------------------------------

template <int KIND, int BN>
__global__ void __launch_bounds__(Threads<BN>::N, 1)
    p2_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const Params p) {
  constexpr bool CONV = KIND >= CONV_F32;
  using C = Cfg<BN, CONV>;
  using Acc = typename AccT<KIND>::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_a = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring_b = ring_a + C::STAGES * C::A_BYTES;
  unsigned char* halo = ring_a + C::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(halo + C::HALO);
  uint64_t* empty = full + C::STAGES;
  int4* rows = reinterpret_cast<int4*>(empty + C::STAGES);
  int* last = reinterpret_cast<int*>(rows + BM);

  const int m_blk = blockIdx.x * BM, n_blk = blockIdx.y * BN;
  const int T = (p.kbytes + KSTAGE - 1) / KSTAGE, S = gridDim.z;
  const int k_lo = blockIdx.z * T / S, k_hi = (blockIdx.z + 1) * T / S;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      // conv: the TMA arrival plus one for each producer warp's A stores
      mbar_init(&full[s], CONV ? 1 + 4 * Threads<BN>::PRODUCER_WGS : 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  if (CONV && threadIdx.x < BM) {
    const int m = m_blk + threadIdx.x;
    int4 r = make_int4(0, 0, 0, 0);
    if (m < p.M) {
      const int ox = m % p.Wo, t = m / p.Wo;
      r = make_int4(t / p.Ho * p.H * p.W, t % p.Ho * p.stride - p.pad, ox * p.stride - p.pad, 1);
    }
    rows[threadIdx.x] = r;
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup --------------------------------------------------
    setmaxnreg_dec<Threads<BN>::PRODUCER_REGS>();
    const int t = threadIdx.x - 256;
    int stage = 0;
    uint32_t phase = 0;
    if constexpr (CONV) {
      using X = typename std::conditional<KIND == CONV_BF16, __nv_bfloat16, float>::type;
      const X* x = static_cast<const X*>(p.x);
      const float s = __ldg(p.s_x), rs = __frcp_rn(s);
      // stage_io(kt) waits for the next stage to be free, starts its B by
      // TMA and returns its A; stage_io(-1) announces it full
      auto stage_io = [&](int kt) -> unsigned char* {
        if (kt >= 0) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (t == 0) {
            mbar_arrive_expect_tx(&full[stage], C::B_BYTES);
            tma_load_2d(ring_b + stage * C::B_BYTES, &map_b, &full[stage], kt * KSTAGE, n_blk);
          }
          return ring_a + stage * C::A_BYTES;
        }
        fence_proxy_async();
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(&full[stage]);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        return nullptr;
      };
      const Window win(m_blk, min(p.Ci, KSTAGE), p);
      const bool blocks = p.Ci % KSTAGE == 0 || (p.Ci % 16 == 0 && KSTAGE % p.Ci == 0);
      if (blocks && win.fits) {
        produce_conv_a_halo<Threads<BN>::PRODUCER_WGS>(x, rows, p, win, s, rs, t, k_lo, k_hi,
                                                       halo, stage_io);
      } else if (p.Ci % 16 == 0) {
        produce_conv_a<Threads<BN>::PRODUCER_WGS>(x, rows, p, s, rs, t, k_lo, k_hi, stage_io);
      } else {
        for (int kt = k_lo; kt < k_hi; ++kt) {
          fill_conv_a_elementwise<Threads<BN>::PRODUCER_WGS>(stage_io(kt), x, rows, p, s, rs, kt,
                                                              t);
          stage_io(-1);
        }
      }
    } else if (t == 0) {
      for (int kt = k_lo; kt < k_hi; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], C::A_BYTES + C::B_BYTES);
        tma_load_2d(ring_a + stage * C::A_BYTES, &map_a, &full[stage], kt * KSTAGE, m_blk);
        tma_load_2d(ring_b + stage * C::B_BYTES, &map_b, &full[stage], kt * KSTAGE, n_blk);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1 ------------------------------------------
    setmaxnreg_inc<Threads<BN>::CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // one stage's wgmma group stays in flight while the next is issued; a
    // stage is released once the group that read it has completed
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = k_lo; kt < k_hi; ++kt) {
      mbar_wait<CONV>(&full[stage], phase);  // the conv's producer computes: sleep
      const uint32_t a = smem_addr(ring_a + stage * C::A_BYTES + wg * 64 * KSTAGE);
      const uint32_t b = smem_addr(ring_b + stage * C::B_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTAGE / 32; ++ks)
        mma<KIND, BN>(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    if constexpr (CONV) {
      if (S > 1) {
        // split K: publish this block's partial tile; the last block of the
        // tile to arrive adds the others' and runs the epilogue
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        int* ws_tile = p.ws + static_cast<size_t>(tile) * S * (BM * BN);
        int4* mine = reinterpret_cast<int4*>(ws_tile + blockIdx.z * (BM * BN));
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
          mine[q * 256 + threadIdx.x] =
              make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
        __threadfence();
        named_barrier(1, 256);
        if (threadIdx.x == 0) {
          const int prev = atomicAdd(&p.counters[tile], 1);
          *last = prev == S - 1;
          if (prev == S - 1) p.counters[tile] = 0;  // ready for the next launch
        }
        named_barrier(1, 256);
        if (!*last) return;
        __threadfence();
        for (int z = 0; z < S; ++z) {
          if (z == static_cast<int>(blockIdx.z)) continue;
          const int4* other = reinterpret_cast<const int4*>(ws_tile + z * (BM * BN));
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            const int4 v = __ldcg(other + q * 256 + threadIdx.x);
            acc[4 * q] += v.x;
            acc[4 * q + 1] += v.y;
            acc[4 * q + 2] += v.z;
            acc[4 * q + 3] += v.w;
          }
        }
      }
    }

    // ---- epilogue: register 4 j + e holds row r0 + 8 (e / 2), column c0 + 8 j + e % 2
    const int r0 = m_blk + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int c0 = n_blk + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = c0 + 8 * j;
      if (n >= p.N) continue;
      const bool pair = n + 1 < p.N && (p.N & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m >= p.M) continue;
        const Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const size_t o = static_cast<size_t>(m) * p.N + n;
        if constexpr (CONV) {
          float y0 = __fmul_rn(__int2float_rn(v0), __ldg(p.scale + n));
          float y1 = n + 1 < p.N ? __fmul_rn(__int2float_rn(v1), __ldg(p.scale + n + 1)) : 0.f;
          if (p.bias != nullptr) {
            y0 = __fadd_rn(y0, __ldg(p.bias + n));
            if (n + 1 < p.N) y1 = __fadd_rn(y1, __ldg(p.bias + n + 1));
          }
          if (p.bf16_out) {
            __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p.out) + o;
            if (pair) {
              *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(y0, y1);
            } else {
              q[0] = __float2bfloat16_rn(y0);
              if (n + 1 < p.N) q[1] = __float2bfloat16_rn(y1);
            }
          } else {
            float* q = static_cast<float*>(p.out) + o;
            if (pair) {
              *reinterpret_cast<float2*>(q) = make_float2(y0, y1);
            } else {
              q[0] = y0;
              if (n + 1 < p.N) q[1] = y1;
            }
          }
        } else {
          Acc* q = static_cast<Acc*>(p.out) + o;
          if (pair) {
            if constexpr (std::is_same<Acc, int>::value) {
              *reinterpret_cast<int2*>(q) = make_int2(v0, v1);
            } else {
              *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
            }
          } else {
            q[0] = v0;
            if (n + 1 < p.N) q[1] = v1;
          }
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------------

enum HostError {
  NO_ENCODER = 1001,
  ENCODE_FAILED = 1002,
  REGISTER_POOL = 1003,
  BAD_TILE = 1004,
  BAD_DEVICE = 1005
};
constexpr int MAX_DEVICES = 64;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

std::mutex map_lock;
std::map<std::tuple<uintptr_t, uint64_t, uint64_t, uint32_t>, CUtensorMap> map_cache;

// The TMA map of a row-major byte matrix [rows, kbytes], read as tiles of
// box_rows x 128 bytes with the 128-byte swizzle. Cached by (address, shape,
// box): a map is a function of exactly these, so a hit is always right.
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t kbytes,
               uint32_t box_rows) {
  std::lock_guard<std::mutex> guard(map_lock);
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(ptr), rows, kbytes, box_rows);
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
  const cuuint64_t dims[2] = {kbytes, rows};
  const cuuint64_t strides[1] = {kbytes};
  const cuuint32_t box[2] = {KSTAGE, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ENCODE_FAILED;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *out);
  return 0;
}

template <int KIND, int BN>
int launch(const CUtensorMap& a, const CUtensorMap& b, const Params& p, dim3 grid,
           cudaStream_t stream) {
  auto kernel = p2_kernel<KIND, BN>;
  // the shared-memory size is set per device, once each
  static std::atomic<bool> ready[MAX_DEVICES];
  int device = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return dev_err;
  if (device >= MAX_DEVICES) return BAD_DEVICE;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<BN, (KIND >= CONV_F32)>::SMEM);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // setmaxnreg.inc waits for registers the producer released; a block
    // allocated fewer than the two together need would never start
    using Th = Threads<BN>;
    if (attr.numRegs * Th::N < 128 * Th::PRODUCER_WGS * Th::PRODUCER_REGS + 256 * Th::CONSUMER_REGS)
      return REGISTER_POOL;
    ready[device] = true;
  }
  kernel<<<grid, Threads<BN>::N, Cfg<BN, (KIND >= CONV_F32)>::SMEM, stream>>>(a, b, p);
  return cudaGetLastError();
}

template <int KIND>
int launch_bn(int bn, const CUtensorMap& a, const CUtensorMap& b, const Params& p, dim3 grid,
              cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<KIND, 64>(a, b, p, grid, stream);
    case 128: return launch<KIND, 128>(a, b, p, grid, stream);
    case 256: return launch<KIND, 256>(a, b, p, grid, stream);
    default: return BAD_TILE;
  }
}

}  // namespace

extern "C" {

// x [B, H, W, Ci] f32 (x_bf16 = 0) or bf16, s_x a float32 scalar, w [Co,
// kpad] int8 (kpad >= ksize^2 Ci, a multiple of 64), scale [Co] f32, bias
// [Co] f32 or null; out [B, Ho, Wo, Co] bf16 or f32. A ksize x ksize conv
// (1 or 3) with `stride`, `pad` and `dil`. Block tile 128 x bn, K split over
// `splits` blocks of a tile: then ws holds tiles x splits x 128 x bn int32
// and counters tiles int32, all 0.
int int8_conv3x3(const void* x, const void* s_x, const void* w, const void* scale,
                 const void* bias, void* out, void* ws, void* counters, int B, int H, int W,
                 int Ci, int Ho, int Wo, int Co, int stride, int ksize, int pad, int dil,
                 int kpad, int x_bf16, int bf16_out, int bn, int splits, void* stream) {
  CUtensorMap map_w;
  const int err = tensor_map(&map_w, w, Co, kpad, bn);
  if (err) return err;
  Params p{};
  p.M = B * Ho * Wo;
  p.N = Co;
  p.kbytes = kpad;
  p.out = out;
  p.x = x;
  p.s_x = static_cast<const float*>(s_x);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Ho = Ho;
  p.Wo = Wo;
  p.stride = stride;
  p.bf16_out = bf16_out;
  p.ks = ksize;
  p.pad = pad;
  p.dil = dil;
  p.taps = ksize * ksize;
  const dim3 grid((p.M + BM - 1) / BM, (Co + bn - 1) / bn, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bn<CONV_BF16>(bn, map_w, map_w, p, grid, st)
                : launch_bn<CONV_F32>(bn, map_w, map_w, p, grid, st);
}

// a [M, K], b [N, K] (int8 or bf16), K * element size a multiple of 16;
// out [M, N] int32 or f32; block tile 128 x bn.
int gemm(const void* a, const void* b, void* out, int M, int N, int K, int int8, int bn,
         void* stream) {
  const int kbytes = int8 ? K : 2 * K;
  CUtensorMap map_a, map_b;
  int err = tensor_map(&map_a, a, M, kbytes, BM);
  if (err) return err;
  err = tensor_map(&map_b, b, N, kbytes, bn);
  if (err) return err;
  Params p{};
  p.M = M;
  p.N = N;
  p.kbytes = kbytes;
  p.out = out;
  const dim3 grid((M + BM - 1) / BM, (N + bn - 1) / bn, 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8 ? launch_bn<GEMM_S8>(bn, map_a, map_b, p, grid, st)
              : launch_bn<GEMM_BF16>(bn, map_a, map_b, p, grid, st);
}

}  // extern "C"
