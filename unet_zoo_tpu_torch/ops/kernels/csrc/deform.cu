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
// kernel; pl.pallas_call at deform.py:164). Python wrapper and plan:
// unet_zoo_tpu_torch/ops/kernels/deform.py.
//
// What bounds it. At wranet's shapes (C 128, O 32, 3x3 taps) the least bytes
// (x, offsets, masks and the output once) take 0.073 ms a forward and the tap
// products 0.049 ms of tensor-core time, but the blend is exact: each
// channel of each (pixel, tap) takes 4 products and 3 sums rounded one by
// one (no FMA contraction, so g is the plain version's bit for bit) plus the
// bf16 unpacking, about 11.5 issue slots, 0.26 ms a forward of issue at the
// card's full rate. The corners the blend reads are 24x the least bytes;
// neighbouring taps and pixels share most of them. A block-wide barrier a
// tap would leave the SM waiting on one chain of load, blend, barrier and
// product latencies after another. So the kernel is built to keep the issue
// slots busy with the blend:
//   - one persistent block an SM; each warp owns a patch of 16 output pixels
//     (4 x 4 for wranet) and walks its taps on its own: it forms its
//     patch's samples (each (pixel, tap)'s four corner weights and four
//     corner pointers, a corner in the zero frame pointing at a zero row,
//     once, by one lane, from offsets and masks loaded a tap ahead), gathers
//     and blends them into its own bf16 row tile in shared memory (a half
//     warp a sample, 8 channels a lane, four samples' corner loads in flight
//     a lane, no predicate on a load), and multiplies the tile into its f32
//     accumulators (ldmatrix + mma.sync m16n8k16). No barrier spans warps,
//     so one warp's products overlap the other warps' gathers;
//   - the block's warps cover neighbouring patches (a 16 x 16 block tile for
//     wranet), so the taps of neighbouring pixels read one neighbourhood,
//     which L1 keeps (the carve-out is set to the shared memory used);
//   - W [K, C, O] is loaded into shared memory once per block (resident)
//     where it fits beside the row tiles, else a group of taps at a time
//     (then with block barriers around each group's load);
//   - C is cut into chunks of at most 128 channels (padded to 16 with zeros
//     in shared memory), and O to the accumulator's width, so any C and O <=
//     128 run, and C not a multiple of 8 takes element loads.
//
// Layout: x [B, H, W, C], offset [B, Ho, Wo, 2K], mask [B, Ho, Wo, K],
// weight [K, C, O] (the [kh, kw, C, O] weight), out [B, Ho, Wo, O], all bf16
// and contiguous; bias [O] f32 or null. The wrapper's plan (patch, block
// tile, tap group, grid) must agree with deform_geometry() below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "mma.cuh"

namespace {

constexpr int PATCH = 16;      // output pixels a warp owns: one m16 row tile
constexpr int CK_MAX = 128;    // channels of one chunk
constexpr int MAX_C = 8192;    // channels of the zero row that outside corners read
constexpr int SAMPLE_BYTES = 48;  // a sample: four corner weights, four corner pointers
constexpr int SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory
constexpr int MAX_DEVICES = 64;

// The row an outside corner reads: MAX_C zero channels.
__device__ __align__(16) unsigned char zero_row[2 * MAX_C] = {};

using bf16 = __nv_bfloat16;

struct Geometry {
  int B, H, W, C, Ho, Wo, O, kh, kw, stride, pad, dil;
  int th, tw;             // a warp's patch: th rows x tw columns (th * tw = 16)
  int wy, wx;             // the block tile: wy x wx patches (wy * wx = warps)
  int tiles_x, tiles_y, tiles;
  int ck;                 // channels of a chunk (a multiple of 16)
  int nch;                // chunks: ceil(C / ck)
  int group;              // taps whose weight slots are in shared memory at once
  int a_ld;               // row pitch of a warp's row tile (ck + 8)
  int w_ld;               // row pitch of a weight slot (8 * NT + 8)
  int vec_x, vec_w;       // 16-byte loads of x and of W
};

__host__ __device__ constexpr int nt_of(int o) { return o <= 32 ? 4 : o <= 64 ? 8 : 16; }
// warps of a block: 16, or 8 where 128 accumulator columns need more registers
__host__ __device__ constexpr int warps_of(int nt) { return nt <= 8 ? 16 : 8; }

// Shared memory of one block: `group` taps' weight slots, and for each warp
// its row tile and sample table.
inline int smem_bytes(int ck, int nch, int group, int nt) {
  return group * nch * ck * (8 * nt + 8) * 2 + warps_of(nt) * PATCH * ((ck + 8) * 2 + SAMPLE_BYTES);
}

void fill_geometry(Geometry& g, int th, int tw, int wy, int wx, int group) {
  g.th = th;
  g.tw = tw;
  g.wy = wy;
  g.wx = wx;
  g.tiles_y = (g.Ho + th * wy - 1) / (th * wy);
  g.tiles_x = (g.Wo + tw * wx - 1) / (tw * wx);
  g.tiles = g.B * g.tiles_y * g.tiles_x;
  const int cpad = (g.C + 15) / 16 * 16;
  g.ck = cpad < CK_MAX ? cpad : CK_MAX;
  g.nch = (g.C + g.ck - 1) / g.ck;
  g.group = group;
  g.a_ld = g.ck + 8;
  g.w_ld = 8 * nt_of(g.O) + 8;
}

// Output pixel p of warp `warp`'s patch in block tile `tile` (ok false where
// the tile or the pixel lies outside). Worked out once a tile: the
// divisions would otherwise cost more than a tap's sample forming.
struct Pix {
  int b, oy, ox;
  bool ok;
};

__device__ __forceinline__ Pix patch_pixel(const Geometry& g, int tile, int warp, int p) {
  Pix px{0, 0, 0, false};
  if (tile >= g.tiles) return px;
  const int per_image = g.tiles_y * g.tiles_x;
  px.b = tile / per_image;
  const int r = tile - px.b * per_image;
  px.oy = ((r / g.tiles_x) * g.wy + warp / g.wx) * g.th + p / g.tw;
  px.ox = ((r % g.tiles_x) * g.wx + warp % g.wx) * g.tw + p % g.tw;
  px.ok = px.oy < g.Ho && px.ox < g.Wo;
  return px;
}

// One (pixel, tap)'s offset pair and mask, as bf16 bits.
struct Raw {
  unsigned short dy, dx, m;
};

__device__ __forceinline__ Raw load_raw(const Geometry& g, const bf16* __restrict__ offset,
                                        const bf16* __restrict__ mask, const Pix& px, int k) {
  Raw r{0, 0, 0};
  if (!px.ok) return r;
  const int K = g.kh * g.kw;
  const size_t n = (static_cast<size_t>(px.b) * g.Ho + px.oy) * g.Wo + px.ox;
  const unsigned short* off = reinterpret_cast<const unsigned short*>(offset) + n * 2 * K + 2 * k;
  r.dy = __ldg(off);
  r.dx = __ldg(off + 1);
  r.m = __ldg(reinterpret_cast<const unsigned short*>(mask) + n * K + k);
  return r;
}

// Forms pixel p's sample at tap (ky, kx) into the warp's table: the four
// corner weights times the mask, f32 rounded step by step as the plain
// version computes them, and the four corners' pointers into x (a corner
// outside the image, in the zero frame, points at zero_row). A pixel
// outside the output gets zero weights. Formed once, by one lane: the 16
// lanes that blend the sample only add their channel offset.
__device__ __forceinline__ void form(const Geometry& g, const bf16* __restrict__ x, const Pix& px,
                                     int ky, int kx, int p, Raw r, float4* __restrict__ sw,
                                     ulonglong2* __restrict__ sp) {
  const unsigned long long zero = reinterpret_cast<unsigned long long>(zero_row);
  if (!px.ok) {
    sw[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    sp[2 * p] = make_ulonglong2(zero, zero);
    sp[2 * p + 1] = make_ulonglong2(zero, zero);
    return;
  }
  const float offy = __bfloat162float(__ushort_as_bfloat16(r.dy));
  const float offx = __bfloat162float(__ushort_as_bfloat16(r.dx));
  const float m = __bfloat162float(__ushort_as_bfloat16(r.m));
  const float by = static_cast<float>(px.oy * g.stride - g.pad + ky * g.dil);
  const float bx = static_cast<float>(px.ox * g.stride - g.pad + kx * g.dil);
  const float py =
      __fadd_rn(fminf(fmaxf(__fadd_rn(by, offy), -1.f), static_cast<float>(g.H)), 1.f);
  const float pxf =
      __fadd_rn(fminf(fmaxf(__fadd_rn(bx, offx), -1.f), static_cast<float>(g.W)), 1.f);
  const int y0 = min(max(static_cast<int>(floorf(py)), 0), g.H);
  const int x0 = min(max(static_cast<int>(floorf(pxf)), 0), g.W);
  const float wy1 = __fsub_rn(py, static_cast<float>(y0));
  const float wx1 = __fsub_rn(pxf, static_cast<float>(x0));
  const float wy0 = __fsub_rn(1.f, wy1), wx0 = __fsub_rn(1.f, wx1);
  sw[p] = make_float4(__fmul_rn(__fmul_rn(wy0, wx0), m), __fmul_rn(__fmul_rn(wy0, wx1), m),
                      __fmul_rn(__fmul_rn(wy1, wx0), m), __fmul_rn(__fmul_rn(wy1, wx1), m));
  const int y = y0 - 1, xx = x0 - 1;  // padded frame -> image
  const bf16* row = x + static_cast<size_t>(px.b) * g.H * g.W * g.C;
  auto corner = [&](int cy, int cx) {
    return cy >= 0 && cy < g.H && cx >= 0 && cx < g.W
               ? reinterpret_cast<unsigned long long>(
                     row + (static_cast<size_t>(cy) * g.W + cx) * g.C)
               : zero;
  };
  sp[2 * p] = make_ulonglong2(corner(y, xx), corner(y, xx + 1));
  sp[2 * p + 1] = make_ulonglong2(corner(y + 1, xx), corner(y + 1, xx + 1));
}

// 8 bf16 channels as f32: a bf16 is the upper half of its f32, so a shift
// (even channels) and a mask (odd) unpack a pair in two instructions.
__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The blend of 8 channels: products and sums rounded one by one, corners in
// order (no fma contraction), then one rounding to bf16; stored as one
// 16-byte shared-memory write (left to itself, the compiler splits it into
// four 4-byte writes that conflict on the banks).
__device__ __forceinline__ void blend8_store(const float (&v)[4][8], float4 w, bf16* dst) {
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * i + e;
      float t = __fmul_rn(v[0][c], w.x);
      t = __fadd_rn(t, __fmul_rn(v[1][c], w.y));
      t = __fadd_rn(t, __fmul_rn(v[2][c], w.z));
      s[e] = __fadd_rn(t, __fmul_rn(v[3][c], w.w));
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[0], s[1]);
    packed[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(packed[0]),
               "r"(packed[1]), "r"(packed[2]), "r"(packed[3])
               : "memory");
}

// A warp's gather of one (tap, chunk): its 16 samples' four corners at
// channels [c0, c0 + ck), blended and rounded, into its row tile `as`. A
// half warp takes every other sample, a lane 8 channels; a lane keeps U
// samples' corner loads in flight.
template <int U>
__device__ __forceinline__ void gather(const Geometry& g, const float4* __restrict__ sw,
                                       const ulonglong2* __restrict__ sp,
                                       bf16* __restrict__ as, int c0) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int cl = (lane & 15) * 8;
  if (cl >= g.ck) return;
  const int c = c0 + cl;
  if (c >= g.C) {  // channels of the chunk's padding: zero
#pragma unroll
    for (int p = half; p < PATCH; p += 2)
      *reinterpret_cast<uint4*>(as + p * g.a_ld + cl) = make_uint4(0, 0, 0, 0);
    return;
  }
  const unsigned long long cb = 2ull * c;  // this lane's byte offset in a pixel
#pragma unroll
  for (int u0 = 0; u0 < PATCH / 2; u0 += U) {
    float4 w[U];
    unsigned long long ptr[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = half + 2 * (u0 + u);
      w[u] = sw[p];
      const ulonglong2 a = sp[2 * p], b = sp[2 * p + 1];
      ptr[u][0] = a.x + cb;
      ptr[u][1] = a.y + cb;
      ptr[u][2] = b.x + cb;
      ptr[u][3] = b.y + cb;
    }
    float v[4][8];
    if (g.vec_x) {
      uint4 raw[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) raw[u][q] = __ldg(reinterpret_cast<const uint4*>(ptr[u][q]));
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) unpack8(raw[u][q], v[q]);
        blend8_store(v, w[u], as + (half + 2 * (u0 + u)) * g.a_ld + cl);
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bf16* row = reinterpret_cast<const bf16*>(ptr[u][q]);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[q][i] = c + i < g.C ? __bfloat162float(row[i]) : 0.f;
        }
        blend8_store(v, w[u], as + (half + 2 * (u0 + u)) * g.a_ld + cl);
      }
    }
  }
}

// Weight slot (tap k, chunk j) -> [ck][w_ld] at `dst`: rows beyond C and
// columns beyond O are zero. 16-byte cp.async where W allows it (the caller
// commits and waits), else element copies.
template <int NT, int THREADS>
__device__ __forceinline__ void load_w(const Geometry& g, const bf16* __restrict__ weight,
                                       bf16* dst, int k, int j) {
  constexpr int OPAD = 8 * NT;
  const int c0 = j * g.ck;
  const bf16* wk = weight + static_cast<size_t>(k) * g.C * g.O;
  for (int i = threadIdx.x; i < g.ck * (OPAD / 8); i += THREADS) {
    const int row = i / (OPAD / 8);
    const int col = (i % (OPAD / 8)) * 8;
    const int c = c0 + row;
    bf16* d = dst + row * g.w_ld + col;
    if (g.vec_w) {
      const bool ok = c < g.C && col < g.O;
      cp_async16(d, ok ? wk + static_cast<size_t>(c) * g.O + col : wk, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (c < g.C && col + e < g.O) ? wk[static_cast<size_t>(c) * g.O + col + e]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

// acc[16 rows, 8 NT] += the warp's row tile [16, ck] @ a weight slot [ck, 8 NT]
// (ldmatrix + mma.sync m16n8k16); unrolled where a chunk holds CK_MAX channels.
template <int NT>
__device__ __forceinline__ void tap_product(const Geometry& g, const bf16* as, const bf16* ws,
                                            float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  auto step = [&](int ks) {
    uint32_t af[4];
    ldsm_x4(af, as + (lane & 15) * g.a_ld + ks + (lane >> 4) * 8);
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t r[4];
      ldsm_x4_trans(r, ws + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * g.w_ld + j2 * 16 +
                           (lane >> 4) * 8);
      const uint32_t b0[2] = {r[0], r[1]};
      const uint32_t b1[2] = {r[2], r[3]};
      mma_bf16(acc[2 * j2], af, b0);
      mma_bf16(acc[2 * j2 + 1], af, b1);
    }
  };
  if (g.ck == CK_MAX) {
#pragma unroll
    for (int ks = 0; ks < CK_MAX; ks += 16) step(ks);
  } else {
    for (int ks = 0; ks < g.ck; ks += 16) step(ks);
  }
}

// FAULT (entry deform_conv_fault, for the checks only): a planted fault that
// pairs each tap's row tile with the next tap's weight slot, the skew a
// pipelined tap loop can make.
template <int NT, bool RESIDENT, bool FAULT>
__global__ void __launch_bounds__(warps_of(NT) * 32, 1)
    deform_kernel(const bf16* __restrict__ x, const bf16* __restrict__ offset,
                  const bf16* __restrict__ mask, const bf16* __restrict__ weight,
                  const float* __restrict__ bias, bf16* __restrict__ out, Geometry g) {
  constexpr int WARPS = warps_of(NT);
  constexpr int THREADS = WARPS * 32;
  constexpr int U = NT <= 4 ? 4 : 2;  // samples in flight a lane (registers allowing)
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = g.kh * g.kw;
  const int slot_elems = g.ck * g.w_ld;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bf16* Ws = reinterpret_cast<bf16*>(smem);                           // [group * nch][ck][w_ld]
  bf16* As = Ws + g.group * g.nch * slot_elems + warp * PATCH * g.a_ld;   // this warp's [16][a_ld]
  float4* Sw = reinterpret_cast<float4*>(Ws + g.group * g.nch * slot_elems +
                                         WARPS * PATCH * g.a_ld) + warp * PATCH;
  ulonglong2* Sp = reinterpret_cast<ulonglong2*>(Sw - warp * PATCH + WARPS * PATCH) +
                   warp * 2 * PATCH;

  if (RESIDENT) {  // every tap's slots, once
    for (int k = 0; k < K; ++k)
      for (int j = 0; j < g.nch; ++j)
        load_w<NT, THREADS>(g, weight, Ws + (k * g.nch + j) * slot_elems, k, j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // this warp's pixel of its first tile (lanes 0-15, one each) and its
  // raw values at tap 0
  Pix cur = patch_pixel(g, lane < PATCH ? blockIdx.x : g.tiles, warp, lane);
  Raw raw = load_raw(g, offset, mask, cur, 0);

  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const Pix next = patch_pixel(g, lane < PATCH ? tile + gridDim.x : g.tiles, warp, lane);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    int ky = 0, kx = 0;  // tap k = ky * kw + kx
    for (int k0 = 0; k0 < K; k0 += g.group) {
      if (!RESIDENT) {  // this group's slots: every warp is done with the last group's
        __syncthreads();
        for (int k = k0; k < min(K, k0 + g.group); ++k)
          for (int j = 0; j < g.nch; ++j)
            load_w<NT, THREADS>(g, weight, Ws + ((k - k0) * g.nch + j) * slot_elems,
                                FAULT ? (k + 1) % K : k, j);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      for (int k = k0; k < min(K, k0 + g.group); ++k) {
        // this tap's samples; then the next tap's raw values (or the next
        // tile's first), whose latency the gather below hides
        __syncwarp();
        if (lane < PATCH) form(g, x, cur, ky, kx, lane, raw, Sw, Sp);
        raw = k + 1 < K ? load_raw(g, offset, mask, cur, k + 1)
                        : load_raw(g, offset, mask, next, 0);
        if (++kx == g.kw) {
          kx = 0;
          ++ky;
        }
        __syncwarp();
        const int slot = RESIDENT ? (FAULT ? (k + 1) % K : k) : k - k0;
        for (int j = 0; j < g.nch; ++j) {
          gather<U>(g, Sw, Sp, As, j * g.ck);
          __syncwarp();
          tap_product<NT>(g, As, Ws + (slot * g.nch + j) * slot_elems, acc);
          __syncwarp();  // the row tile is read before the next gather writes it
        }
      }
    }

    // epilogue: + bias (f32), one rounding to bf16
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Pix px = patch_pixel(g, tile, warp, (lane >> 2) + 8 * half);
      if (!px.ok) continue;
      bf16* orow = out + ((static_cast<size_t>(px.b) * g.Ho + px.oy) * g.Wo + px.ox) * g.O;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = j * 8 + 2 * (lane & 3);
        if (col >= g.O) continue;
        float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
        if (bias != nullptr) {
          v0 += bias[col];
          if (col + 1 < g.O) v1 += bias[col + 1];
        }
        if (col + 1 < g.O && (g.O % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < g.O) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
    cur = next;
  }
}

template <int NT, bool RESIDENT, bool FAULT>
int launch_instance(const void* x, const void* offset, const void* mask, const void* weight,
                    const void* bias, void* out, const Geometry& g, int grid,
                    cudaStream_t stream) {
  const int smem = smem_bytes(g.ck, g.nch, g.group, NT);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = deform_kernel<NT, RESIDENT, FAULT>;
  // The dynamic shared memory each device allows this instance, which only
  // grows, under one lock: a launch never finds its size taken back by
  // another thread's smaller one. The carve-out asks for no more shared
  // memory than that (the rest is L1, which catches the corners that
  // neighbouring samples share).
  static std::mutex lock;
  static int granted[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> hold(lock);
    if (smem > granted[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int percent = (100 * (smem + 1024) + 228 * 1024 - 1) / (228 * 1024);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 percent < 100 ? percent : 100);
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[device] = smem;
    }
  }
  kernel<<<grid, warps_of(NT) * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(offset),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAULT>
int dispatch(const void* x, const void* offset, const void* mask, const void* weight,
             const void* bias, void* out, int batch, int h, int w, int c, int ho, int wo, int o,
             int kh, int kw, int stride, int pad, int dil, int th, int tw, int wy, int wx,
             int group, int grid, cudaStream_t stream) {
  Geometry g{batch, h, w, c, ho, wo, o, kh, kw, stride, pad, dil};
  fill_geometry(g, th, tw, wy, wx, group);
  g.vec_x = (c % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  g.vec_w = (o % 8 == 0) && (reinterpret_cast<uintptr_t>(weight) % 16 == 0);
  const int nt = nt_of(o);
  if (th * tw != PATCH || wy * wx != warps_of(nt) || group < 1 || group > kh * kw || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool resident = group == kh * kw;
#define DEFORM_CASE(NT)                                                                      \
  if (nt == NT)                                                                              \
    return resident ? launch_instance<NT, true, FAULT>(x, offset, mask, weight, bias, out, \
                                                       g, grid, stream)                   \
                    : launch_instance<NT, false, FAULT>(x, offset, mask, weight, bias, out, \
                                                        g, grid, stream);
  DEFORM_CASE(4)
  DEFORM_CASE(8)
  DEFORM_CASE(16)
#undef DEFORM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int deform_conv(const void* x, const void* offset, const void* mask,
                           const void* weight, const void* bias, void* out, int batch, int h,
                           int w, int c, int ho, int wo, int o, int kh, int kw, int stride,
                           int pad, int dil, int th, int tw, int wy, int wx, int group, int grid,
                           void* stream) {
  return dispatch<false>(x, offset, mask, weight, bias, out, batch, h, w, c, ho, wo, o, kh, kw,
                         stride, pad, dil, th, tw, wy, wx, group, grid,
                         static_cast<cudaStream_t>(stream));
}

// The planted fault (see deform_kernel), for the checks; the same arguments.
extern "C" int deform_conv_fault(const void* x, const void* offset, const void* mask,
                                 const void* weight, const void* bias, void* out, int batch,
                                 int h, int w, int c, int ho, int wo, int o, int kh, int kw,
                                 int stride, int pad, int dil, int th, int tw, int wy, int wx,
                                 int group, int grid, void* stream) {
  return dispatch<true>(x, offset, mask, weight, bias, out, batch, h, w, c, ho, wo, o, kh, kw,
                        stride, pad, dil, th, tw, wy, wx, group, grid,
                        static_cast<cudaStream_t>(stream));
}

// The source's own numbers for a plan, for the wrapper's plan to be held
// against: out = {tiles, ck, nch, warps, w_ld, shared memory bytes}.
extern "C" void deform_geometry(int batch, int h, int w, int c, int ho, int wo, int o, int kh,
                                int kw, int th, int tw, int wy, int wx, int group,
                                int* result) {
  Geometry g{batch, h, w, c, ho, wo, o, kh, kw, 1, 0, 1};
  fill_geometry(g, th, tw, wy, wx, group);
  result[0] = g.tiles;
  result[1] = g.ck;
  result[2] = g.nch;
  result[3] = warps_of(nt_of(o));
  result[4] = g.w_ld;
  result[5] = smem_bytes(g.ck, g.nch, group, nt_of(o));
}
