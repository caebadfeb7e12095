// K5: channel softmax, then `repeat` rounds of 7 x 7 dilation (max pool) and
// erosion (min pool), written by hand for Hopper (sm_90a).
//
//   sm = softmax_C(x); d = e = sm
//   repeat times: d = maxpool_7(d, pad -inf), e = minpool_7(e, pad +inf)
//
// Every round pads anew, as each max_pool2d call of the reference does: cells
// outside the image are padding again before the next round.
//
// Replaces unet_zoo_tpu/ops/pallas/morph.py::fused_softmax_morph (the TPU
// kernel; pl.pallas_call at morph.py:150). Python wrapper and plan:
// unet_zoo_tpu_torch/ops/kernels/morph.py.
//
// Bound: x is read once and d and e written once (6 bytes per element in
// bf16) for about 5 + 24 * repeat operations per element: far below the
// card's ridge, so device-memory bytes bound it. The design streams rows, so
// that the pool grid reads x about once, and keeps every pool in registers
// or in one row of shared memory:
//   - softmax_morph_kernel: a block owns one image, a strip of `tw` output
//     columns, a band of `bh` output rows and `cb` channels (cb / 8 vectors of
//     8 channels). It walks down the band's rows plus R = 3 * repeat halo rows
//     on each side; each step stages one input row segment (tw + 2R pixels x
//     cb channels) by 16-byte cp.async, NS rows ahead of use. Thread
//     (column i, vector v) takes one 16-byte cell of the segment: it forms the
//     softmax once per element (exp2 of a pre-scaled exponent), rounds it to
//     bf16 and writes it back in place; then the W pass reads the 7 cells to
//     its right (a max and a min per pair of channels) and the H pass runs in
//     registers: a sliding max (min) over the last 7 W-pooled rows by doubling,
//     3 compares per row and direction, so no row is stored. The second round
//     chains on the first round's output row (held in shared memory for its
//     W pass), so it too costs one more step's work and no extra pass over x.
//     The pools compare bf16 pairs as 16-bit integers (max.s16x2,
//     min.u16x2): the softmax is non-negative, where bf16 bit patterns order
//     as integers. Cells outside the image hold -0.0 (0x8000), the least
//     value as a signed integer and the largest as an unsigned one, so
//     padding drops out of every max and min window (the -inf / +inf
//     padding of the reference); every window of an output cell holds an
//     image cell, so no padding reaches d or e.
//   - the softmax statistics: softmax_stats_kernel writes (max * log2 e,
//     1 / sum) in float32 for every pixel first (8 bytes a pixel; lanes of a
//     warp over a pixel's 16-byte chunks, combined by xor shuffles), and the
//     pool grid stages them with x, so a pool block may hold any channels.
//     (Forming them in the pool block from the staged row, where it holds
//     all C, read x once but took longer on the H100: PERF.md, section 6.)
//   - one __syncthreads a row step, and one more for a second round.
//     Rounding is monotonic, so pooling the rounded softmax is exact: d and e
//     are the rounded pools.
// The plan (grid, cb, tw, bh, shared memory) is chosen in Python
// (morph.py::plan); softmax_morph_geometry exports the same numbers so that a
// card test can hold the two together. softmax_morph_short_halo is for tests
// only: it launches the pool grid with a strip or band halo one pixel short
// of R (a template flag, so the served kernel carries no halo argument), a
// planted fault that the comparison must reject.
//
// Layout: x, d, e are NHWC bf16 (torch channels_last). Requirements (checked
// by the wrapper): C a multiple of 8, cb a multiple of 8 dividing C, k = 7,
// repeat in {1, 2}, 16-byte-aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"

namespace {

constexpr int HALF = 3;            // 7 x 7 window
constexpr int NS = 4;              // input rows staged ahead (a ring of NS slots)
// threads of a pool block, (tw + 2R) * cb / 8, at most: the second round's
// sliding windows need more registers a thread
__host__ __device__ constexpr int max_threads(int repeat) { return repeat == 1 ? 512 : 256; }
constexpr int STATS_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;
// Padding: bf16 -0.0 (0x8000). The softmax is >= +0, and the bit patterns
// of non-negative bf16 values order as integers, so the pools compare 16-bit
// integers: as signed (max), 0x8000 is below every value; as unsigned (min),
// above every value. Padding drops out of every window either way.
constexpr uint32_t PAD2 = 0x80008000u;

__device__ __forceinline__ uint4 pad8() { return make_uint4(PAD2, PAD2, PAD2, PAD2); }

template <bool MAX>
__device__ __forceinline__ uint32_t pick2(uint32_t a, uint32_t b) {
  uint32_t r;
  if constexpr (MAX) {
    asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  } else {
    asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  }
  return r;
}

template <bool MAX>
__device__ __forceinline__ uint4 pick8(const uint4& a, const uint4& b) {
  return make_uint4(pick2<MAX>(a.x, b.x), pick2<MAX>(a.y, b.y), pick2<MAX>(a.z, b.z),
                    pick2<MAX>(a.w, b.w));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    v[2 * u] = f.x * LOG2E;
    v[2 * u + 1] = f.y * LOG2E;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
  return r;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// The max (MAX) or min over the last 7 values pushed, by doubling: m2 covers
// 2 rows, m4 = m2 with m2 two rows back covers 4, m7 = m4 with m4 three rows
// back covers 7. Padding (nothing yet) drops out.
template <bool MAX>
struct Slide7 {
  uint4 p1, q1, q2, r1, r2, r3;
  __device__ __forceinline__ void reset() { p1 = q1 = q2 = r1 = r2 = r3 = pad8(); }
  __device__ __forceinline__ uint4 push(const uint4& v) {
    const uint4 m2 = pick8<MAX>(v, p1);
    p1 = v;
    const uint4 m4 = pick8<MAX>(m2, q2);
    q2 = q1;
    q1 = m2;
    const uint4 m7 = pick8<MAX>(m4, r3);
    r3 = r2;
    r2 = r1;
    r1 = m4;
    return m7;
  }
};

// The 7-cell max and min along W of vector v starting at `row[0]`, `step`
// cells apart; padding drops out.
__device__ __forceinline__ void pool_w(const uint4* row, int step, uint4& mx, uint4& mn) {
  mx = mn = row[0];
#pragma unroll
  for (int dx = 1; dx < 2 * HALF + 1; ++dx) {
    const uint4 c = row[dx * step];
    mx = pick8<true>(mx, c);
    mn = pick8<false>(mn, c);
  }
}

template <bool MAX>
__device__ __forceinline__ uint4 pool_w1(const uint4* row, int step) {
  uint4 m = row[0];
#pragma unroll
  for (int dx = 1; dx < 2 * HALF + 1; ++dx) m = pick8<MAX>(m, row[dx * step]);
  return m;
}

// Shared memory of a pool block, in bytes: the NS staged rows (16 bytes a
// cell) and their statistics (8 bytes a cell), and for a second round the
// first round's output row of d and of e.
__host__ __device__ constexpr int pool_smem(int cells, int repeat) {
  return NS * cells * (16 + 8) + (repeat == 2 ? 2 * cells * 16 : 0);
}

// Per-pixel softmax statistics for the pool grid: (max over C of x * log2 e,
// 1 / sum over C of exp2(x * log2 e - max)). `lanes` lanes of a warp share a
// pixel (a power of two dividing C / 8, at most 32); lane g reads the
// pixel's 16-byte chunks g, g + lanes, ... (coalesced across the lanes) with
// an online max and sum, then the lanes combine by xor shuffles.
__global__ void __launch_bounds__(STATS_THREADS) softmax_stats_kernel(
    const __nv_bfloat16* __restrict__ x, float2* __restrict__ stats, int npix, int C, int lanes) {
  const int chunks = C / 8;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * STATS_THREADS + threadIdx.x) >> 5;
  const int pix = warp * (32 / lanes) + lane / lanes;
  const int g = lane % lanes;
  float m = -CUDART_INF_F, s = 0.f;
  if (pix < npix) {
    const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(pix) * C);
    for (int k0 = g; k0 < chunks; k0 += 4 * lanes) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * lanes;
        raw[u] = k < chunks ? __ldg(src + k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k0 + u * lanes >= chunks) break;
        float v[8];
        unpack8(raw[u], v);
        float cm = v[0];
#pragma unroll
        for (int t = 1; t < 8; ++t) cm = fmaxf(cm, v[t]);
        const float nm = fmaxf(m, cm);
        float add = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) add += exp2f(v[t] - nm);
        s = s * exp2f(m - nm) + add;
        m = nm;
      }
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float nm = fmaxf(m, mo);
    if (nm != -CUDART_INF_F) s = s * exp2f(m - nm) + so * exp2f(mo - nm);
    m = nm;
  }
  if (pix < npix && g == 0) stats[pix] = make_float2(m, 1.f / s);
}

// Which halo the pool grid loads: R on every side (served), or, for the
// fault tests, the strip's or the band's one pixel short.
enum Halo { FULL = 0, STRIP_SHORT = 1, BAND_SHORT = 2 };

// One pool block; see the header. Thread tid takes input column i = tid / nv
// and vector v = tid % nv; its round-1 output column is the window that
// starts at input column i (image column x0 - R + 3 + i), its round-2 output
// column the window that starts at round-1 column i (image column x0 + i).
template <int REPEAT, int HALO>
__global__ void __launch_bounds__(max_threads(REPEAT)) softmax_morph_kernel(
    const __nv_bfloat16* __restrict__ x, const float2* __restrict__ stats,
    __nv_bfloat16* __restrict__ d, __nv_bfloat16* __restrict__ e, int H, int W, int C, int cb,
    int tw, int bh) {
  constexpr int R = HALF * REPEAT;
  constexpr int HALO_W = R - (HALO == STRIP_SHORT), HALO_H = R - (HALO == BAND_SHORT);
  const int nv = cb / 8;
  const int wi = tw + 2 * R;           // staged input columns
  const int w1 = tw + 2 * R - 2 * HALF;  // round-1 output columns
  const int cells = wi * nv;
  const int tid = threadIdx.x;
  const int i = tid / nv, v = tid % nv;

  extern __shared__ __align__(16) uint4 smem[];
  uint4* stage = smem;                  // [NS][cells] staged rows
  uint4* d1 = stage + NS * cells;       // [cells] round 1's row (REPEAT 2)
  uint4* e1 = d1 + cells;
  float2* st = reinterpret_cast<float2*>(REPEAT == 2 ? e1 + cells : d1);  // [NS][cells]

  const int strips = (W + tw - 1) / tw;
  const int x0 = (blockIdx.x % strips) * tw, y0 = (blockIdx.x / strips) * bh;
  const int c0 = blockIdx.y * cb;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;
  const int col = x0 - R + i;
  // the loaded window: the image within HALO_W / HALO_H of the strip and band
  const bool col_ok = col >= max(0, x0 - HALO_W) && col < min(W, x0 + tw + HALO_W);
  const int row_lo = max(0, y0 - HALO_H), row_hi = min(H, y0 + bh + HALO_H);
  const int y_end = min(y0 + bh, H);  // output rows [y0, y_end)
  const int last = y_end - 1 + R;     // the last input row a band output needs

  auto load_row = [&](int y, int slot) {
    const bool ok = col_ok && y >= row_lo && y < row_hi;
    const size_t pix = img + static_cast<size_t>(ok ? y : 0) * W + (ok ? col : 0);
    cp_async16(stage + slot * cells + tid, x + pix * C + c0 + v * 8, ok);
    cp_async8(st + slot * cells + tid, stats + pix, ok);
    cp_async_commit();
  };

  for (int k = 0; k < NS - 1; ++k) load_row(row_lo + k, k);
  Slide7<true> hd1, hd2;
  Slide7<false> he1, he2;
  hd1.reset();
  he1.reset();
  hd2.reset();
  he2.reset();

  int slot = 0;
  // unrolled by 6, the period of the sliding windows' register shifts, so
  // that the shifts become register renames
#pragma unroll 6
  for (int y = row_lo; y <= last; ++y) {
    const bool row_ok = y < row_hi;  // uniform over the block
    uint4* cur = stage + slot * cells;
    cp_async_wait<NS - 2>();
    if (row_ok) {
      // the softmax of this thread's cell, rounded to bf16, in place
      float t[8];
      unpack8(cur[tid], t);
      const float2 ms = st[slot * cells + tid];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = exp2f(t[u] - ms.x) * ms.y;
      cur[tid] = col_ok ? pack8(t) : pad8();
    }
    __syncthreads();
    // the slot of row y - 1 is free: stage row y + NS - 1 into it
    load_row(y + NS - 1, slot == 0 ? NS - 1 : slot - 1);

    // round 1: W pass over the staged row, H pass in registers
    uint4 wd = pad8(), we = pad8();
    if (row_ok && i < w1) pool_w(cur + tid, nv, wd, we);
    const uint4 rd = hd1.push(wd), re = he1.push(we);  // round 1 at row y - 3
    if constexpr (REPEAT == 1) {
      const int o = y - HALF;
      if (o >= y0 && o < y_end && i < tw && x0 + i < W) {
        const size_t at = ((img + static_cast<size_t>(o) * W + x0 + i) * C) + c0 + v * 8;
        __stcs(reinterpret_cast<uint4*>(d + at), rd);
        __stcs(reinterpret_cast<uint4*>(e + at), re);
      }
    } else {
      // round 2 on round 1's row y - 3, padded again outside the image
      const int o1 = y - HALF, c1 = x0 - HALF + i;
      const bool in = o1 >= 0 && o1 < H && c1 >= 0 && c1 < W;
      if (i < w1) {
        d1[tid] = in ? rd : pad8();
        e1[tid] = in ? re : pad8();
      }
      __syncthreads();
      uint4 wd2 = pad8(), we2 = pad8();
      if (i < tw) {
        wd2 = pool_w1<true>(d1 + tid, nv);
        we2 = pool_w1<false>(e1 + tid, nv);
      }
      const uint4 od = hd2.push(wd2), oe = he2.push(we2);  // round 2 at row y - 6
      const int o = y - 2 * HALF;
      if (o >= y0 && o < y_end && i < tw && x0 + i < W) {
        const size_t at = ((img + static_cast<size_t>(o) * W + x0 + i) * C) + c0 + v * 8;
        __stcs(reinterpret_cast<uint4*>(d + at), od);
        __stcs(reinterpret_cast<uint4*>(e + at), oe);
      }
    }
    slot = slot == NS - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// Geometry of one call: {pool grid x, y, z, pool threads, pool shared-memory
// bytes, statistics blocks, input rows a band walks (bh + 2R)}.
void geometry(int batch, int h, int w, int c, int repeat, int cb, int tw, int bh, int lanes,
              int* out) {
  const int r = HALF * repeat;
  const int cells = (tw + 2 * r) * (cb / 8);
  out[0] = ((w + tw - 1) / tw) * ((h + bh - 1) / bh);
  out[1] = c / cb;
  out[2] = batch;
  out[3] = cells;
  out[4] = pool_smem(cells, repeat);
  const long pix_per_block = static_cast<long>(STATS_THREADS / 32) * (32 / lanes);
  const long npix = static_cast<long>(batch) * h * w;
  out[5] = static_cast<int>((npix + pix_per_block - 1) / pix_per_block);
  out[6] = bh + 2 * r;
}

template <int REPEAT, int HALO>
int launch_pool(const dim3& grid, int threads, int bytes, const void* x, const float2* stats,
                void* d, void* e, int h, int w, int c, int cb, int tw, int bh,
                cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(softmax_morph_kernel<REPEAT, HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  softmax_morph_kernel<REPEAT, HALO><<<grid, threads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), stats, static_cast<__nv_bfloat16*>(d),
      static_cast<__nv_bfloat16*>(e), h, w, c, cb, tw, bh);
  return static_cast<int>(cudaGetLastError());
}

// The statistics grid, then the pool grid with halo HALO, both on `stream`.
template <int HALO>
int run(const void* x, void* d, void* e, void* stats, int batch, int h, int w, int c,
        int repeat, int cb, int tw, int bh, int lanes, cudaStream_t stream) {
  if (c % 8 || cb % 8 || cb <= 0 || c % cb || (repeat != 1 && repeat != 2) || lanes <= 0 ||
      lanes > 32 || 32 % lanes || (c / 8) % lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  int g[7];
  geometry(batch, h, w, c, repeat, cb, tw, bh, lanes, g);
  if (g[3] <= 0 || g[3] > max_threads(repeat) || g[4] > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  float2* st = static_cast<float2*>(stats);
  softmax_stats_kernel<<<g[5], STATS_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), st, batch * h * w, c, lanes);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g[0], g[1], g[2]);
  if (repeat == 1)
    return launch_pool<1, HALO>(grid, g[3], g[4], x, st, d, e, h, w, c, cb, tw, bh, stream);
  return launch_pool<2, HALO>(grid, g[3], g[4], x, st, d, e, h, w, c, cb, tw, bh, stream);
}

}  // namespace

extern "C" {

// The numbers softmax_morph launches with (see geometry), for the card test
// that holds them to morph.py::plan.
void softmax_morph_geometry(int batch, int h, int w, int c, int repeat, int cb, int tw, int bh,
                            int lanes, int* out) {
  geometry(batch, h, w, c, repeat, cb, tw, bh, lanes, out);
}

// C interface, loaded with ctypes. `stats` is float32 scratch of 2 * batch *
// h * w values: the statistics grid runs first, then the pool grid, both on
// `stream`. Returns the CUDA error code (0 when the
// launches were accepted).
int softmax_morph(const void* x, void* d, void* e, void* stats, int batch, int h, int w, int c,
                  int repeat, int cb, int tw, int bh, int lanes, void* stream_ptr) {
  return run<FULL>(x, d, e, stats, batch, h, w, c, repeat, cb, tw, bh, lanes,
                   static_cast<cudaStream_t>(stream_ptr));
}

// For the fault tests only: softmax_morph with the strip's (side 1) or the
// band's (side 2) halo one pixel short of R.
int softmax_morph_short_halo(const void* x, void* d, void* e, void* stats, int batch, int h,
                             int w, int c, int repeat, int cb, int tw, int bh, int lanes,
                             int side, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (side == STRIP_SHORT)
    return run<STRIP_SHORT>(x, d, e, stats, batch, h, w, c, repeat, cb, tw, bh, lanes, stream);
  if (side == BAND_SHORT)
    return run<BAND_SHORT>(x, d, e, stats, batch, h, w, c, repeat, cb, tw, bh, lanes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
