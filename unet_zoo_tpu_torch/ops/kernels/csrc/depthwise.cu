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
// unet_zoo_tpu_torch/ops/kernels/depthwise.py, which picks the instance
// (depthwise.py::instance) and lays out the served one (depthwise.py::plan).
//
// Bound: 2 k^2 operations per output element against one read of x and one
// write of the output (4 bytes per element in bf16): far below the card's
// ridge, so device-memory bytes bound it.
//
// The served instance, depthwise_stream_kernel<RING, FAULT> (bf16, k = 3,
// C % 8 == 0, 16-byte aligned x, w and out), is a row-streaming stencil that
// reads each input row once per band:
//   - a block of 128 threads owns TW output columns (a strip) of one chunk of
//     8 CV channels; a thread owns one 16-byte vector (8 channels) of one
//     column, TW x CV = 128. The block takes the items (image, band of BH
//     output rows, strip) of its chunk in a grid-stride loop, and walks them
//     as one stream of input rows: BH + 2 rows an item (y0 - 1 .. y0 + BH);
//   - each input row ((TW + 2) pixels of the chunk, zero outside the image and
//     beyond C, which is the SAME padding) reaches a ring of RING slots in
//     shared memory by 16-byte cp.async, RING - 1 rows ahead of the row in use,
//     across item boundaries; one barrier a row;
//   - a thread finds its copies' sources and its store address once an item
//     and moves them by one image row a row;
//   - a thread keeps its 9 x 8 taps in f32 registers and three running output
//     rows. Each arriving row is read as three 16-byte vectors (x - 1, x, x + 1),
//     unpacked by shifts, and added into the row it finishes (taps dy = 2), the
//     middle one (dy = 1) and the one it starts (dy = 0), so every output gets
//     its nine products in (dy, dx) order; then the bias (f32, staged in shared
//     memory), one rounding and one 16-byte store.
// The launch bounds hold a thread to 128 registers, so that an SM holds four
// blocks (16 warps).
// (One 4-D TMA box a row, with full and empty mbarriers, measured slower on
// the H100 than these cp.async copies.)
// depthwise_stream_fault runs it with a planted fault for the card checks:
// FAULT_BAND_HALO reads a band's halo rows one row further, inside the
// neighbouring band; FAULT_STALE_SLOT computes each row from the ring slot of
// the row before it (the first row of the stream excepted), with the copies
// issued after the compute so that the slot is not being written.
//
// The general instance, depthwise_general_kernel<T, K> (bf16 or f32, k 3, 5 or
// 7, any C, 4-byte aligned pointers; 8-byte for f32), is the first design:
//   - one block per (TH x TW output tile, chunk of 128 bytes of channels,
//     image); the tile and a halo of (k - 1) / 2 pixels (zero outside the
//     image) go to shared memory with 16-byte cp.async copies along C where
//     C allows (else element by element, zero beyond C);
//   - each thread owns a pair of channels and keeps their k x k taps and bias
//     in registers, and walks the tile's pixels with its lane row;
//   - odd H, W and odd C (a last single channel, element stores) are masked.
//
// Layout: x, out [B, H, W, C] contiguous; w [k, k, C] and bias [C] (or null)
// in x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ----------------------------------------------------------------------------
// The served instance
// ----------------------------------------------------------------------------

constexpr int STREAM_THREADS = 128;
constexpr int STREAM_BLOCKS_PER_SM = 4;  // launch bounds: at most 128 registers a thread
constexpr int FAULT_BAND_HALO = 1;   // planted faults (depthwise_stream_fault)
constexpr int FAULT_STALE_SLOT = 2;

// The launch of the served instance for [b, h, w, c] with CV = 2^lcv channel
// vectors a chunk, bands of bh rows, `ring` slots and `per_chunk` blocks a
// chunk; depthwise.py::layout mirrors it.
struct Geometry {
  int grid, threads, smem, strips, bands, chunks, items;
};

Geometry stream_geometry(int b, int h, int w, int c, int lcv, int bh, int ring, int per_chunk) {
  const int cv = 1 << lcv;
  const int tw = STREAM_THREADS >> lcv;
  Geometry g;
  g.threads = STREAM_THREADS;
  g.strips = (w + tw - 1) / tw;
  g.bands = (h + bh - 1) / bh;
  g.chunks = (c + 8 * cv - 1) / (8 * cv);
  g.items = b * g.bands * g.strips;
  g.grid = g.chunks * per_chunk;
  g.smem = ring * (tw + 2) * cv * 16 + cv * 8 * static_cast<int>(sizeof(float));
  return g;
}

struct StreamArgs {
  const bf16* x;
  bf16* out;
  uint4* ring;
  const float* bias;   // the chunk's bias in shared memory, f32
  int H, W, C, lcv, tw, bh, strips, bands, items, per_chunk, c0, c, col, total, slot_vecs;
  long long row_elems;  // W * C: one image row
};

// The item (image, band, strip) `item` of the block's chunk: its image b,
// first output row y0 and first output column x0.
__device__ __forceinline__ void locate(int item, const StreamArgs& a, int& b, int& y0, int& x0) {
  const int rest = item / a.strips;
  x0 = (item - rest * a.strips) * a.tw;
  b = rest / a.bands;
  y0 = (rest - b * a.bands) * a.bh;
}

// The copy side of the stream: the item and row being fetched, this thread's
// (at most two) 16-byte copies of a row, set up once an item and advanced by
// one image row a row (src at input row gy; ok when the copy's column and
// channels lie inside the tensor), and the ring slot the row goes to.
struct Producer {
  int item, i, gy;
  const bf16* src[2];
  bool ok[2];
  uint4* slot;
};

__device__ __forceinline__ void start_item(Producer& p, const StreamArgs& a) {
  int b, x0;
  locate(p.item, a, b, p.gy, x0);
  p.gy -= 1;
  const int vmask = (1 << a.lcv) - 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int k = threadIdx.x + n * STREAM_THREADS;
    const int gx = x0 - 1 + (k >> a.lcv);
    const int ch = a.c0 + ((k & vmask) << 3);
    p.ok[n] = k < a.slot_vecs && gx >= 0 && gx < a.W && ch < a.C && p.item < a.items;
    p.src[n] = a.x + ((static_cast<long long>(b) * a.H + p.gy) * a.W + gx) * a.C + ch;
  }
}

// Issue the copy of the producer's next row into its ring slot, or nothing
// past the stream's end (`row` is its place in the stream); one commit group
// either way.
template <int RING, int FAULT>
__device__ __forceinline__ void produce(const StreamArgs& a, Producer& p, int row) {
  if (row < a.total) {
    int gy = p.gy;
    const bf16* src[2] = {p.src[0], p.src[1]};
    if (FAULT == FAULT_BAND_HALO) {
      const int d = p.i == 0 ? -1 : (p.i == a.bh + 1 ? 1 : 0);
      gy += d;
      src[0] += d * static_cast<long long>(a.row_elems);
      src[1] += d * static_cast<long long>(a.row_elems);
    }
    const bool in = gy >= 0 && gy < a.H;
    uint4* dst = p.slot + threadIdx.x;
    cp_async16(dst, in && p.ok[0] ? src[0] : a.x, in && p.ok[0]);
    if (threadIdx.x + STREAM_THREADS < a.slot_vecs)
      cp_async16(dst + STREAM_THREADS, in && p.ok[1] ? src[1] : a.x, in && p.ok[1]);
    p.slot += a.slot_vecs;
    if (p.slot == a.ring + RING * a.slot_vecs) p.slot = a.ring;
    if (++p.i == a.bh + 2) {
      p.i = 0;
      p.item += a.per_chunk;
      start_item(p, a);
    } else {
      ++p.gy;
      p.src[0] += a.row_elems;
      p.src[1] += a.row_elems;
    }
  }
  cp_async_commit();
}

// The compute side: the item and row in use, the ring slot it is read from,
// and where this thread stores its column: dst at output row y, the next the
// stream finishes; ok when the column and channels lie inside the tensor.
struct Consumer {
  int item, i, y;
  bf16* dst;
  bool ok;
  const uint4* slot;
};

__device__ __forceinline__ void start_item(Consumer& q, const StreamArgs& a) {
  int b, x0;
  locate(q.item, a, b, q.y, x0);
  const int gx = x0 + a.col;
  q.ok = gx < a.W && a.c < a.C && q.item < a.items;
  q.dst = a.out + ((static_cast<long long>(b) * a.H + q.y) * a.W + gx) * a.C + a.c;
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&v)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(u[e] << 16);
    v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One row of the stream: wait for it, keep the copies flowing, add it into the
// three running rows (fin: taps dy = 2, then stored; mid: dy = 1; fresh: dy = 0,
// started here). The caller rotates the three arrays' roles.
template <int RING, int FAULT>
__device__ __forceinline__ void stream_row(const StreamArgs& a, Producer& prod, Consumer& cons,
                                           int& j, const float (&t)[9][8], float (&fin)[8],
                                           float (&mid)[8], float (&fresh)[8]) {
  if (j >= a.total) return;
  cp_async_wait<RING - 2>();
  __syncthreads();
  if (FAULT != FAULT_STALE_SLOT) produce<RING, FAULT>(a, prod, j + RING - 1);
  const uint4* row = cons.slot + threadIdx.x;
  if (FAULT == FAULT_STALE_SLOT && j > 0)
    row = (cons.slot == a.ring ? a.ring + RING * a.slot_vecs : cons.slot) - a.slot_vecs +
          threadIdx.x;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float v[8];
    unpack8(row[dx << a.lcv], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      fin[e] = fmaf(v[e], t[6 + dx][e], fin[e]);
      mid[e] = fmaf(v[e], t[3 + dx][e], mid[e]);
      fresh[e] = dx == 0 ? v[e] * t[dx][e] : fmaf(v[e], t[dx][e], fresh[e]);
    }
  }
  if (cons.i >= 2) {
    if (cons.ok && cons.y < a.H) {
      const float4* bv = reinterpret_cast<const float4*>(a.bias + (a.c - a.c0));
      const float4 b0 = bv[0], b1 = bv[1];
      uint4 o;
      o.x = pack2(fin[0] + b0.x, fin[1] + b0.y);
      o.y = pack2(fin[2] + b0.z, fin[3] + b0.w);
      o.z = pack2(fin[4] + b1.x, fin[5] + b1.y);
      o.w = pack2(fin[6] + b1.z, fin[7] + b1.w);
      *reinterpret_cast<uint4*>(cons.dst) = o;
    }
    ++cons.y;
    cons.dst += a.row_elems;
  }
  cons.slot += a.slot_vecs;
  if (cons.slot == a.ring + RING * a.slot_vecs) cons.slot = a.ring;
  if (++cons.i == a.bh + 2) {
    cons.i = 0;
    cons.item += a.per_chunk;
    start_item(cons, a);
  }
  ++j;
  if (FAULT == FAULT_STALE_SLOT) {
    __syncthreads();
    produce<RING, FAULT>(a, prod, j + RING - 2);
  }
}

template <int RING, int FAULT>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_BLOCKS_PER_SM)
    depthwise_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                            int C, int lcv, int bh, int strips, int bands, int items,
                            int chunks, int per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  StreamArgs a;
  a.x = x;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.lcv = lcv;
  a.tw = STREAM_THREADS >> lcv;
  a.bh = bh;
  a.strips = strips;
  a.bands = bands;
  a.items = items;
  a.per_chunk = per_chunk;
  a.slot_vecs = (a.tw + 2) << lcv;
  a.row_elems = static_cast<long long>(W) * C;
  a.ring = reinterpret_cast<uint4*>(smem);
  float* sbias = reinterpret_cast<float*>(a.ring + RING * a.slot_vecs);
  a.bias = sbias;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks;
  const int first = blockIdx.x / chunks;
  a.c0 = chunk << (lcv + 3);
  a.c = a.c0 + ((tid & ((1 << lcv) - 1)) << 3);
  a.col = tid >> lcv;
  const int mine = first < items ? (items - 1 - first) / per_chunk + 1 : 0;
  a.total = mine * (bh + 2);

  Producer prod;
  prod.item = first;
  prod.i = 0;
  prod.slot = a.ring;
  start_item(prod, a);
#pragma unroll
  for (int r = 0; r < RING - 1; ++r) produce<RING, FAULT>(a, prod, r);
  Consumer cons;
  cons.item = first;
  cons.i = 0;
  cons.slot = a.ring;
  start_item(cons, a);

  if (tid < (8 << lcv)) {
    const int ch = a.c0 + tid;
    sbias[tid] = (bias != nullptr && ch < C) ? __bfloat162float(bias[ch]) : 0.f;
  }
  float t[9][8];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (a.c < C) {
      unpack8(*reinterpret_cast<const uint4*>(w + k * C + a.c), t[k]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[k][e] = 0.f;
    }
  }
  float r0[8], r1[8], r2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r0[e] = r1[e] = r2[e] = 0.f;

  for (int j = 0; j < a.total;) {
    stream_row<RING, FAULT>(a, prod, cons, j, t, r0, r1, r2);
    stream_row<RING, FAULT>(a, prod, cons, j, t, r1, r2, r0);
    stream_row<RING, FAULT>(a, prod, cons, j, t, r2, r0, r1);
  }
}

template <int RING>
int launch_stream_r(const void* x, const void* w, const void* bias, void* out, int batch, int h,
                    int wd, int c, int lcv, int bh, int per_chunk, int fault,
                    cudaStream_t stream) {
  const Geometry g = stream_geometry(batch, h, wd, c, lcv, bh, RING, per_chunk);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* bp = static_cast<const bf16*>(bias);
  bf16* op = static_cast<bf16*>(out);
  switch (fault) {
    case 0:
      depthwise_stream_kernel<RING, 0><<<g.grid, g.threads, g.smem, stream>>>(
          xp, wp, bp, op, h, wd, c, lcv, bh, g.strips, g.bands, g.items, g.chunks, per_chunk);
      break;
    case FAULT_BAND_HALO:
      depthwise_stream_kernel<RING, FAULT_BAND_HALO><<<g.grid, g.threads, g.smem, stream>>>(
          xp, wp, bp, op, h, wd, c, lcv, bh, g.strips, g.bands, g.items, g.chunks, per_chunk);
      break;
    case FAULT_STALE_SLOT:
      depthwise_stream_kernel<RING, FAULT_STALE_SLOT><<<g.grid, g.threads, g.smem, stream>>>(
          xp, wp, bp, op, h, wd, c, lcv, bh, g.strips, g.bands, g.items, g.chunks, per_chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_stream(const void* x, const void* w, const void* bias, void* out, int batch, int h,
                  int wd, int c, int lcv, int bh, int ring, int per_chunk, int fault,
                  void* stream_ptr) {
  if (lcv < 2 || lcv > 4 || bh < 1 || per_chunk < 1 || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (ring) {
    case 3:
      return launch_stream_r<3>(x, w, bias, out, batch, h, wd, c, lcv, bh, per_chunk, fault,
                                stream);
    case 4:
      return launch_stream_r<4>(x, w, bias, out, batch, h, wd, c, lcv, bh, per_chunk, fault,
                                stream);
    case 6:
      return launch_stream_r<6>(x, w, bias, out, batch, h, wd, c, lcv, bh, per_chunk, fault,
                                stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int RING>
int stream_occupancy(int smem) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, depthwise_stream_kernel<RING, 0>, STREAM_THREADS, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// ----------------------------------------------------------------------------
// The general instance (the first design)
// ----------------------------------------------------------------------------

constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile columns
constexpr int NTHREADS = 256;
constexpr int CHUNK_BYTES = 128; // channels of one block: 64 bf16 or 32 f32

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
    depthwise_general_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ bias, T* __restrict__ out, int H, int W,
                             int C, int tiles_w, int vec) {
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
int launch_general(const void* x, const void* w, const void* bias, void* out, int batch, int h,
                   int wd, int c, cudaStream_t stream) {
  constexpr int CB = CHUNK_BYTES / sizeof(T);
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const int vec = (c % (16 / static_cast<int>(sizeof(T))) == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(tiles_w * tiles_h, (c + CB - 1) / CB, batch);
  depthwise_general_kernel<T, K><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), h, wd, c, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_general_k(const void* x, const void* w, const void* bias, void* out, int batch, int h,
                     int wd, int c, int k, cudaStream_t stream) {
  switch (k) {
    case 3: return launch_general<T, 3>(x, w, bias, out, batch, h, wd, c, stream);
    case 5: return launch_general<T, 5>(x, w, bias, out, batch, h, wd, c, stream);
    case 7: return launch_general<T, 7>(x, w, bias, out, batch, h, wd, c, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The numbers depthwise_stream launches with: (blocks, threads, shared memory
// bytes, strips, bands, chunks, items a chunk), for the card test that holds
// them to depthwise.py::layout.
void depthwise_geometry(int batch, int h, int wd, int c, int lcv, int bh, int ring,
                        int per_chunk, int* out) {
  const Geometry g = stream_geometry(batch, h, wd, c, lcv, bh, ring, per_chunk);
  const int v[7] = {g.grid, g.threads, g.smem, g.strips, g.bands, g.chunks, g.items};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// Blocks of the served instance with `ring` slots that one SM holds at `smem`
// bytes of shared memory a block; a negative CUDA error code if the query
// fails.
int depthwise_stream_occupancy(int ring, int smem) {
  switch (ring) {
    case 3: return stream_occupancy<3>(smem);
    case 4: return stream_occupancy<4>(smem);
    case 6: return stream_occupancy<6>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// C interface of the served instance, loaded with ctypes: bf16 x, out [B, H,
// W, C] and w [3, 3, C] 16-byte aligned, bias [C] (or null), C % 8 == 0;
// chunks of 8 * 2^lcv channels (lcv 2, 3 or 4), bands of bh rows, `ring`
// slots (3, 4 or 6), per_chunk blocks a chunk. Launches one grid on `stream`
// and returns the CUDA error code (0 when it was accepted).
int depthwise_stream(const void* x, const void* w, const void* bias, void* out, int batch, int h,
                     int wd, int c, int lcv, int bh, int ring, int per_chunk, void* stream_ptr) {
  return launch_stream(x, w, bias, out, batch, h, wd, c, lcv, bh, ring, per_chunk, 0,
                       stream_ptr);
}

// The served instance with planted fault `fault` (FAULT_BAND_HALO 1,
// FAULT_STALE_SLOT 2), for the card checks.
int depthwise_stream_fault(const void* x, const void* w, const void* bias, void* out, int batch,
                           int h, int wd, int c, int lcv, int bh, int ring, int per_chunk,
                           int fault, void* stream_ptr) {
  if (fault != FAULT_BAND_HALO && fault != FAULT_STALE_SLOT)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_stream(x, w, bias, out, batch, h, wd, c, lcv, bh, ring, per_chunk, fault,
                       stream_ptr);
}

// C interface of the general instance: bf16 (is_f32 0) or f32 x, w, bias and
// out, k 3, 5 or 7, any C.
int depthwise_general(const void* x, const void* w, const void* bias, void* out, int batch,
                      int h, int wd, int c, int k, int is_f32, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_f32) return launch_general_k<float>(x, w, bias, out, batch, h, wd, c, k, stream);
  return launch_general_k<bf16>(x, w, bias, out, batch, h, wd, c, k, stream);
}

}  // extern "C"
