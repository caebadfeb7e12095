// K5: channel softmax, then `repeat` rounds of k x k dilation (max pool) and
// erosion (min pool), written by hand for Hopper (sm_90a).
//
//   sm = softmax_C(x); d = e = sm
//   repeat times: d = maxpool_k(d, pad -inf), e = minpool_k(e, pad +inf)
//
// Every round pads anew, as each max_pool2d call of the reference does: cells
// outside the image are reset to -inf (d) / +inf (e) before the next round.
//
// Replaces unet_zoo_tpu/ops/pallas/morph.py::fused_softmax_morph (the TPU
// kernel; pl.pallas_call at morph.py:150). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/morph.py.
//
// Bound: it reads x once and writes d and e once (6 bytes per element in
// bf16) for about 5 + 24*repeat operations per element (k = 7): far below the
// card's ridge, so it is bound by device-memory bytes. The design reads x
// from device memory in one pass per block and keeps every intermediate
// (the softmax, each pooling round) in shared memory:
//   - one block per 16x16 output tile, batch image and group of channel
//     chunks; the tile carries a halo of R = repeat * (k/2) on each side;
//   - phase 1: one thread per haloed pixel walks all C channels (16-byte
//     loads) with an online max and sum of exponentials;
//   - phase 2: for each chunk of 8 channels, one thread per pixel handles the
//     chunk's 8 channels as one 16-byte vector: the softmax, rounded to bf16,
//     into shared memory (-inf/+inf outside the image), each round's
//     separable pool (a pass along W, then along H) with bf16x2 max/min, and
//     a 16-byte store of d and of e. Pooling the rounded values is exact:
//     rounding is monotonic, so the max of the rounded values is the rounded
//     max. cp.async fetches the next chunk of x into shared memory while the
//     current one pools. repeat is a template argument and k = 7 a constant
//     (mmunet's only window), so the tile geometry is compile-time and the
//     pools unroll.
// Small images split the channel chunks over several blocks (the wrapper's
// `groups`), each of which repeats phase 1, so the grid fills the card.
// Known gap, for later work: x is read twice per block (phase 1 and phase 2)
// and the halo is re-read by neighbouring blocks; both mostly hit L2.
//
// Layout: x, d, e are NHWC bf16 (torch channels_last). Requirements (checked
// by the wrapper): C a multiple of 8, k = 7, repeat in {1, 2}, 16-byte-aligned
// pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TILE = 16;
constexpr int CC = 8;  // channels per chunk: one 16-byte bf16 vector
constexpr int NTHREADS = 256;
constexpr int K = 7;   // pooling window

using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint4 splat8(float f) {
  const bf162 h = __float2bfloat162_rn(f);
  uint4 r;
  bf162* o = reinterpret_cast<bf162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = h;
  return r;
}

__device__ __forceinline__ uint4 max8(const uint4& a, const uint4& b) {
  uint4 r;
  const bf162* x = reinterpret_cast<const bf162*>(&a);
  const bf162* y = reinterpret_cast<const bf162*>(&b);
  bf162* o = reinterpret_cast<bf162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = __hmax2(x[u], y[u]);
  return r;
}

__device__ __forceinline__ uint4 min8(const uint4& a, const uint4& b) {
  uint4 r;
  const bf162* x = reinterpret_cast<const bf162*>(&a);
  const bf162* y = reinterpret_cast<const bf162*>(&b);
  bf162* o = reinterpret_cast<bf162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = __hmin2(x[u], y[u]);
  return r;
}

template <int REPEAT>
struct Geometry {
  static constexpr int HALF = K / 2;
  static constexpr int R = REPEAT * HALF;  // halo
  static constexpr int S = TILE + 2 * R;   // haloed tile side
  static constexpr int SS = S * S;
  // shared memory per haloed pixel: max and 1/sum (f32), then five 8-channel
  // bf16 vectors: the staged x chunk, d, e and the two W-pass results
  static constexpr int SMEM = (2 * 4 + 5 * 16) * SS;
};

template <int REPEAT>
__global__ void __launch_bounds__(NTHREADS) softmax_morph_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ d,
    __nv_bfloat16* __restrict__ e, int H, int W, int C, int groups) {
  using G = Geometry<REPEAT>;
  constexpr int S = G::S, SS = G::SS, R = G::R, HALF = G::HALF;
  extern __shared__ __align__(16) float smem[];
  float* mx = smem;                                      // [SS] max over C
  float* rs = mx + SS;                                   // [SS] 1 / sum exp(x - max)
  uint4* stage = reinterpret_cast<uint4*>(rs + SS);      // [SS] x, this chunk
  uint4* bd = stage + SS;                                // [SS] dilate
  uint4* be = bd + SS;                                   // [SS] erode
  uint4* td = be + SS;                                   // [SS] after the W pass
  uint4* te = td + SS;

  const int tiles_w = (W + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_w) * TILE - R;  // image row of haloed cell 0
  const int tx0 = (blockIdx.x % tiles_w) * TILE - R;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W * C;
  const __nv_bfloat16* xb = x + img;
  const int tid = threadIdx.x;
  const int nchunks = C / CC;
  auto inside = [&](int r, int s) {
    const int gy = ty0 + r, gx = tx0 + s;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto pixel = [&](int r, int s) {
    return (static_cast<size_t>(ty0 + r) * W + tx0 + s) * C;
  };
  auto prefetch = [&](int chunk) {
    for (int p = tid; p < SS; p += NTHREADS) {
      const int r = p / S, s = p % S;
      const bool ok = inside(r, s);
      cp_async16(stage + p, ok ? xb + pixel(r, s) + chunk * CC : xb, ok);
    }
    cp_async_commit();
  };

  prefetch(blockIdx.y);

  // phase 1: softmax statistics of every haloed pixel over all C channels
  for (int p = tid; p < SS; p += NTHREADS) {
    const int r = p / S, s = p % S;
    float m = -CUDART_INF_F, sum = 0.f;
    if (inside(r, s)) {
      const uint4* src = reinterpret_cast<const uint4*>(xb + pixel(r, s));
      for (int c8 = 0; c8 < nchunks; ++c8) {
        const uint4 raw = src[c8];
        const bf162* h = reinterpret_cast<const bf162*>(&raw);
        float v[CC];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(h[u]);
          v[2 * u] = f.x;
          v[2 * u + 1] = f.y;
        }
        float cm = v[0];
#pragma unroll
        for (int u = 1; u < CC; ++u) cm = fmaxf(cm, v[u]);
        const float nm = fmaxf(m, cm);
        float add = 0.f;
#pragma unroll
        for (int u = 0; u < CC; ++u) add += expf(v[u] - nm);
        sum = sum * expf(m - nm) + add;
        m = nm;
      }
    }
    mx[p] = m;
    rs[p] = sum > 0.f ? 1.f / sum : 0.f;
  }

  const uint4 neg = splat8(-CUDART_INF_F), pos = splat8(CUDART_INF_F);
  for (int chunk = blockIdx.y; chunk < nchunks; chunk += groups) {
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the statistics are complete
    // the chunk's softmax over the haloed tile, -inf / +inf outside the image
    for (int p = tid; p < SS; p += NTHREADS) {
      if (inside(p / S, p % S)) {
        const uint4 raw = stage[p];
        const bf162* h = reinterpret_cast<const bf162*>(&raw);
        uint4 out;
        bf162* o = reinterpret_cast<bf162*>(&out);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(h[u]);
          o[u] = __floats2bfloat162_rn(expf(f.x - mx[p]) * rs[p], expf(f.y - mx[p]) * rs[p]);
        }
        bd[p] = out;
        be[p] = out;
      } else {
        bd[p] = neg;
        be[p] = pos;
      }
    }
    __syncthreads();  // the stage is consumed: fetch the next chunk behind the pools
    if (chunk + groups < nchunks) prefetch(chunk + groups);

#pragma unroll
    for (int rep = 0; rep < REPEAT; ++rep) {
      const int lo = rep * HALF;      // valid region [lo, S - lo) before this round
      const int lo2 = lo + HALF;      // and after it
      const int nr = S - 2 * lo, nc = S - 2 * lo2;
      // pass along W: rows [lo, S - lo), columns [lo2, S - lo2)
      for (int p = tid; p < nr * nc; p += NTHREADS) {
        const int r = lo + p / nc, s = lo2 + p % nc;
        const int base = r * S + s - HALF;
        uint4 vd = bd[base], ve = be[base];
#pragma unroll
        for (int dx = 1; dx < K; ++dx) {
          vd = max8(vd, bd[base + dx]);
          ve = min8(ve, be[base + dx]);
        }
        td[r * S + s] = vd;
        te[r * S + s] = ve;
      }
      __syncthreads();
      // pass along H: rows and columns [lo2, S - lo2); re-pad between rounds
      for (int p = tid; p < nc * nc; p += NTHREADS) {
        const int r = lo2 + p / nc, s = lo2 + p % nc;
        const int o = r * S + s;
        if (rep + 1 < REPEAT && !inside(r, s)) {
          bd[o] = neg;
          be[o] = pos;
          continue;
        }
        const int base = (r - HALF) * S + s;
        uint4 vd = td[base], ve = te[base];
#pragma unroll
        for (int dy = 1; dy < K; ++dy) {
          vd = max8(vd, td[base + dy * S]);
          ve = min8(ve, te[base + dy * S]);
        }
        bd[o] = vd;
        be[o] = ve;
      }
      __syncthreads();
    }

    // the 16x16 output tile: one pixel per thread
    const int r = R + tid / TILE, s = R + tid % TILE;
    if (inside(r, s)) {
      const size_t o = img + pixel(r, s) + chunk * CC;
      *reinterpret_cast<uint4*>(d + o) = bd[r * S + s];
      *reinterpret_cast<uint4*>(e + o) = be[r * S + s];
    }
  }
}

template <int REPEAT>
int launch(const void* x, void* d, void* e, int batch, int h, int w, int c, int groups,
           cudaStream_t stream) {
  static_assert(TILE * TILE == NTHREADS, "one output pixel per thread");
  constexpr int bytes = Geometry<REPEAT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(softmax_morph_kernel<REPEAT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE), groups, batch);
  softmax_morph_kernel<REPEAT><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(d),
      static_cast<__nv_bfloat16*>(e), h, w, c, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Launches one grid (7x7 window, `repeat`
// rounds) on `stream` and returns the CUDA error code (0 when the launch was
// accepted).
extern "C" int softmax_morph(const void* x, void* d, void* e, int batch, int h, int w, int c,
                             int repeat, int groups, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (repeat == 1) return launch<1>(x, d, e, batch, h, w, c, groups, stream);
  if (repeat == 2) return launch<2>(x, d, e, batch, h, w, c, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
