// K6: MedT axial attention along one image axis, in eval, written by hand for
// Hopper (sm_90a). For each row n of the pass, group g and query i:
//
//   sim[i, :] = softmax_j( a_qk Σ_c q[i,c] k[j,c] + a_qr Σ_c q[i,c] rel_q[c][i-j]
//                          + a_kr Σ_c k[j,c] rel_k[c][j-i] )
//   out[i, p] = a_sv[p] Σ_j sim v[j,p] + a_sve[p] Σ_j sim rel_v[p][i-j] + shift[p]
//
// where rel_*[c][d] = relative[row, d + ks - 1] (the MedT relative embeddings,
// emb[c,a,b] = relative[c, a-b+ks-1]; k's term reads the transposed table).
// wopos (relative == nullptr) keeps only the qk term and sv. The eval BNs and
// the gated variant's gates are folded into a_* and shift by the wrapper.
//
// Replaces unet_zoo_tpu/ops/pallas/axial_attention.py::fused_axial_attention
// (the TPU kernel; pl.pallas_call at axial_attention.py:141). Python wrapper
// and launch plan: unet_zoo_tpu_torch/ops/kernels/axial_attention.py.
//
// Bound: about 6c + 4gp + 5 f32 operations per (row, group, i, j) (2c + 2gp
// + 5 for wopos) with c = gp/2, on the CUDA cores; the bytes (qkv read once,
// the output written once) are 2-10x smaller. Every term is f32, as the TPU
// kernel computes. The previous design (one warp per (group, query), lanes
// over keys) spent about one shared-memory load per FMA, reloaded every key
// for every query and reduced each query across the warp by shuffles. This
// one is one grid, one pass over the keys:
//   - a block holds one row n and `gb` of its groups: their q/k/v as f32 in
//     shared memory, position-major (each position's channels of the block's
//     groups contiguous, as channels_last stores them; staged by 16-byte
//     loads, several in flight a thread), and the 2 LP columns of `relative`
//     that offsets i - j need (LP = the length rounded up to R), the k rows
//     stored at -o so that all three tables index alike;
//   - `warps` warps per group; a lane owns R consecutive query rows (a query
//     tile) and walks the keys in tiles of R: an R x R micro-tile whose keys
//     are warp-wide broadcast loads and whose 2R - 1 diagonals of each table
//     row are one or two aligned vector loads, not a load per pair;
//   - where 32 R exceeds the length, groups of lanes split the keys and their
//     partial (reference, sum, sums) merge once by shuffles; where it is
//     below, the group's warps take the query tiles in chunks of 32;
//   - one online softmax in log2 units (log2 e folded into the scales, one
//     ex2.approx a pair) with a lazy rescale: a row's reference rises only when
//     a logit exceeds it by more than MARGIN, and the sums are rescaled then.
//     The numerator and the denominator share the reference, so the result
//     does not depend on when it moved;
//   - the lane holds its rows' sums in registers and writes its rows' outputs.
// Blocks of at most 4 warps at 128 registers a thread (4 blocks an SM): about
// 55-60% of the SM's instruction rate goes to the pairs' arithmetic at L = 128;
// neither the exps, the diagonals' loads nor the staging bound it alone (PERF.md).
// Every output is summed by one lane in a fixed order: two launches agree bit
// for bit. Layout: qkv and out are NHWC bf16 (torch channels_last); the
// wrapper passes element strides of (image, row, position), so the height
// pass reads and writes columns in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 4;          // warps of a block (axial_attention.py::MAX_WARPS)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MARGIN = 8.f;         // lazy rescale: 2^8 above the reference at most

// Planted faults, reached only through axial_attention_fault (card checks).
enum Fault { NONE = 0, NO_RESCALE = 1, DROP_PARTIAL_TILE = 2, NO_MERGE = 3 };

// Query (and key) rows of a lane's tile: the most that keep a tile's
// operands, logits and 2 GP R sums in registers without spills.
__host__ __device__ constexpr int rows_per_lane(int gp) { return gp <= 4 ? 4 : gp == 8 ? 2 : 1; }

__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}
__host__ __device__ inline int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// How a length of L splits over a warp at R rows a lane (plan() in
// axial_attention.py mirrors it): T query (and key) tiles; lanes of one key
// split; key splits; chunks of 32 query tiles.
struct Split {
  int T, LP, lanes, splits, chunks;
  __host__ __device__ Split(int L, int R) {
    T = (L + R - 1) / R;
    LP = T * R;
    lanes = T < 32 ? pow2_ceil(T) : 32;
    splits = 32 / lanes < pow2_floor(T) ? 32 / lanes : pow2_floor(T);
    chunks = (T + 31) / 32;
  }
};

size_t smem_bytes(int L, int gp, int gb, bool wopos) {
  const Split s(L, rows_per_lane(gp));
  return sizeof(float) * (static_cast<size_t>(s.LP) * gb * 2 * gp +
                          (wopos ? 0 : static_cast<size_t>(2 * gp) * 2 * s.LP));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive floats of shared memory whose first is aligned to A floats.
template <int N, int A>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (A % 4 == 0 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else if constexpr (A % 2 == 0 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      x[i] = v.x, x[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

// The 2R - 1 diagonals of one table row for a tile (slot s: offset
// R (t - J) + s - (R - 1)), from its R-aligned first column; read as 2R.
template <int R>
__device__ __forceinline__ void diagonals(const float* p, float (&w)[2 * R]) {
  lds<2 * R, R>(p, w);
}

struct Params {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  const float *relative, *sim_scale, *out_scale, *out_shift;
  int rows_per_image, L, ks, groups, gb, warps;
  long long s_img, s_row, s_pos, o_img, o_row, o_pos;
};

// The largest of N values by a tree of fmaxf (a short dependency chain).
template <int N>
__device__ __forceinline__ float row_max(const float (&x)[N]) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    float h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = fmaxf(x[2 * i], x[2 * i + 1]);
    return row_max<N / 2>(h);
  }
}

// Stores a row's GP outputs (bf16, contiguous, 2 GP bytes) in 4-byte pairs.
template <int GP>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&y)[GP]) {
#pragma unroll
  for (int p = 0; p < GP; p += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + p) = __floats2bfloat162_rn(y[p], y[p + 1]);
}

constexpr int STAGE = 4;  // loads in flight a thread while a block stages

// The row's q|k|v of the block's groups, `cb` channels a position, into
// shared memory as f32 (positions L .. LP - 1 zero). 16-byte loads where the
// tensor's base and strides allow (channels_last from torch.empty always
// does), else 4-byte pairs; STAGE loads in flight a thread.
__device__ __forceinline__ void stage_rows(const Params& p, const __nv_bfloat16* src, float* ops,
                                           int L, int LP, int cb) {
  const bool wide = cb % 8 == 0 && (reinterpret_cast<uintptr_t>(p.qkv) & 15) == 0 &&
                    (p.s_img | p.s_row | p.s_pos) % 8 == 0;
  const int per = cb / (wide ? 8 : 2), n = LP * per;  // vectors a position; in all
  for (int e0 = threadIdx.x; e0 < n; e0 += STAGE * blockDim.x) {
    uint4 raw[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int e = e0 + u * blockDim.x, l = e / per;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n && l < L) {
        const __nv_bfloat16* s = src + l * p.s_pos + (e - l * per) * (wide ? 8 : 2);
        if (wide)
          raw[u] = *reinterpret_cast<const uint4*>(s);
        else if ((reinterpret_cast<uintptr_t>(s) & 3) == 0)
          raw[u].x = *reinterpret_cast<const unsigned*>(s);
        else
          raw[u].x = static_cast<unsigned>(__bfloat16_as_ushort(s[0])) |
                     static_cast<unsigned>(__bfloat16_as_ushort(s[1])) << 16;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= n) break;
      const int l = e / per;
      float* d = ops + l * cb + (e - l * per) * (wide ? 8 : 2);
      const unsigned w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      // a bf16 is the top half of its f32
      if (wide) {
        *reinterpret_cast<float4*>(d) =
            make_float4(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                        __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u));
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(__uint_as_float(w[2] << 16), __uint_as_float(w[2] & 0xffff0000u),
                        __uint_as_float(w[3] << 16), __uint_as_float(w[3] & 0xffff0000u));
      } else {
        *reinterpret_cast<float2*>(d) =
            make_float2(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u));
      }
    }
  }
}

template <int GP, bool WOPOS, int FAULT>
__global__ void __launch_bounds__(MAX_WARPS * 32, GP >= 32 ? 2 : 4)
    axial_attention_kernel(const Params p) {
  constexpr int C = GP / 2;    // q and k channels of a group
  constexpr int CH = 2 * GP;   // a group's qkv channels: [q | k | v]
  constexpr int R = rows_per_lane(GP);
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, gb = p.gb, cb = gb * CH;
  const Split sp(L, R);
  const int LP = sp.LP, T = sp.T, rw = 2 * LP;
  float* ops = smem;              // [LP][cb]: q|k|v of the block's groups, f32
  float* rel = ops + LP * cb;     // [2 GP][2 LP]: column o + LP - 1 holds offset o

  const int g0 = blockIdx.y * gb;
  const long long img = blockIdx.x / p.rows_per_image, row = blockIdx.x % p.rows_per_image;
  const __nv_bfloat16* src = p.qkv + img * p.s_img + row * p.s_row + g0 * CH;
  stage_rows(p, src, ops, L, LP, cb);
  if (!WOPOS) {
    // STAGE loads in flight a thread: the table's columns come from L2
    const int width = 2 * p.ks - 1, n = 2 * GP * rw;
    for (int e0 = threadIdx.x; e0 < n; e0 += STAGE * blockDim.x) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * blockDim.x, r = e / rw, o = e - r * rw - (LP - 1);
        v[u] = e < n && o > -L && o < L
                   ? p.relative[r * width + (r >= C && r < GP ? -o : o) + p.ks - 1] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (e0 + u * blockDim.x < n) rel[e0 + u * blockDim.x] = v[u];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = warp / p.warps, wq = warp - gl * p.warps;
  const int g = g0 + gl, G = p.groups;
  const float aqk = p.sim_scale[g] * LOG2E;
  const float aqr = WOPOS ? 0.f : p.sim_scale[G + g] * LOG2E;
  const float akr = WOPOS ? 0.f : p.sim_scale[2 * G + g] * LOG2E;
  const int split = lane / sp.lanes, tl = lane - split * sp.lanes;
  const float* gops = ops + gl * CH;

  for (int chunk = wq; chunk < sp.chunks; chunk += p.warps) {
    const int t = chunk * 32 + tl;  // the lane's query tile: rows t R .. t R + R - 1
    const bool active = t < T && split < sp.splits;
    const int J0 = active ? split * T / sp.splits : 0;
    int J1 = active ? (split + 1) * T / sp.splits : 0;
    if (FAULT == DROP_PARTIAL_TILE && L % R && J1 == T) --J1;

    float qa[R][C], qb[R][C];  // q scaled by a_qk and a_qr (log2 units)
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float q[C];
      lds<C, (C % 4 == 0 ? 4 : C)>(gops + (t < T ? t * R + a : 0) * cb, q);
#pragma unroll
      for (int c = 0; c < C; ++c) qa[a][c] = q[c] * aqk, qb[a][c] = q[c] * aqr;
    }
    float m[R], sum[R], acc[R][GP], acce[R][GP];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      m[a] = sum[a] = 0.f;
#pragma unroll
      for (int c = 0; c < GP; ++c) acc[a][c] = acce[a][c] = 0.f;
    }

    for (int J = J0; J < J1; ++J) {
      const float* kv = gops + J * R * cb;  // key rows J R .. J R + R - 1
      const float* diag = rel + R * (t - J + T - 1);
      float x[R][R], kk[R][C];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) x[a][b] = 0.f;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float k[C];
        lds<C, (C % 4 == 0 ? 4 : C)>(kv + b * cb + C, k);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          kk[b][c] = k[c] * akr;
#pragma unroll
          for (int a = 0; a < R; ++a) x[a][b] = fmaf(qa[a][c], k[c], x[a][b]);
        }
      }
      if (!WOPOS) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float dq[2 * R], dk[2 * R];
          diagonals<R>(diag + c * rw, dq);
          diagonals<R>(diag + (C + c) * rw, dk);
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b) {
              x[a][b] = fmaf(qb[a][c], dq[a - b + R - 1], x[a][b]);
              x[a][b] = fmaf(kk[b][c], dk[a - b + R - 1], x[a][b]);
            }
        }
      }
      // the logit first, then its row's reference off, as the softmax takes
      // the max off (summing from -m rounds each step at the reference's size)
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) x[a][b] -= m[a];
      if ((J + 1) * R > L) {  // the last key tile: keys at or beyond L weigh nothing
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (J * R + b >= L)
#pragma unroll
            for (int a = 0; a < R; ++a) x[a][b] = -CUDART_INF_F;
      }
      // Lazy rescale. The first tile of a split sets each row's reference
      // to its largest logit there; later a row's reference moves only when a
      // logit exceeds it by more than MARGIN.
      const bool first = J == J0;
      float top = row_max<R>(x[0]);
#pragma unroll
      for (int a = 1; a < R; ++a) top = fmaxf(top, row_max<R>(x[a]));
      if (first || top > MARGIN) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float r = row_max<R>(x[a]);
          if (first || r > MARGIN) {
            // the step the reference takes, as it is rounded: old and new
            // terms then share one reference exactly
            const float step = (m[a] + r) - m[a];
            const float f = (first || FAULT == NO_RESCALE) ? 1.f : ex2(-step);
            sum[a] *= f;
#pragma unroll
            for (int c = 0; c < GP; ++c) acc[a][c] *= f, acce[a][c] *= f;
            m[a] += step;
#pragma unroll
            for (int b = 0; b < R; ++b) x[a][b] -= step;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          x[a][b] = ex2(x[a][b]);
          sum[a] += x[a][b];
        }
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float v[GP];
        lds<GP, (GP % 4 == 0 ? 4 : 2)>(kv + b * cb + GP, v);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < GP; ++c) acc[a][c] = fmaf(x[a][b], v[c], acc[a][c]);
      }
      if (!WOPOS) {
#pragma unroll
        for (int c = 0; c < GP; ++c) {
          float w[2 * R];
          diagonals<R>(diag + (GP + c) * rw, w);
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b) acce[a][c] = fmaf(x[a][b], w[a - b + R - 1], acce[a][c]);
        }
      }
    }

    // Merge the key splits: lanes split * lanes + tl hold one query tile.
    if (FAULT != NO_MERGE) {
      for (int off = sp.lanes; off < sp.lanes * sp.splits; off *= 2) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float mo = __shfl_xor_sync(FULL, m[a], off);
          const float so = __shfl_xor_sync(FULL, sum[a], off);
          const float top = fmaxf(m[a], mo);
          const float fs = ex2(m[a] - top), fo = ex2(mo - top);
          sum[a] = fmaf(sum[a], fs, so * fo);
#pragma unroll
          for (int c = 0; c < GP; ++c) {
            acc[a][c] = fmaf(acc[a][c], fs, __shfl_xor_sync(FULL, acc[a][c], off) * fo);
            if (!WOPOS)
              acce[a][c] = fmaf(acce[a][c], fs, __shfl_xor_sync(FULL, acce[a][c], off) * fo);
          }
          m[a] = top;
        }
      }
    }

    if (active && split == 0) {
      const float* sv = p.out_scale + g * GP;
      const float* sve = p.out_scale + (G + g) * GP;
      const float* shift = p.out_shift + g * GP;
      __nv_bfloat16* dst = p.out + img * p.o_img + row * p.o_row + g * GP;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = t * R + a;
        if (i < L) {
          const float inv = 1.f / sum[a];
          float y[GP];
#pragma unroll
          for (int c = 0; c < GP; ++c) {
            const float r = WOPOS ? sv[c] * acc[a][c] : fmaf(sv[c], acc[a][c], sve[c] * acce[a][c]);
            y[c] = fmaf(r, inv, shift[c]);
          }
          store_row<GP>(dst + i * p.o_pos, y);
        }
      }
    }
  }
}

template <int GP, bool WOPOS, int FAULT>
int launch(const Params& a, int n_rows, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.L, GP, a.gb, WOPOS);
  const cudaError_t err = cudaFuncSetAttribute(axial_attention_kernel<GP, WOPOS, FAULT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_rows, a.groups / a.gb);
  axial_attention_kernel<GP, WOPOS, FAULT><<<grid, 32 * a.gb * a.warps, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool WOPOS, int FAULT>
int by_planes(int gp, const Params& a, int n_rows, cudaStream_t stream) {
  switch (gp) {
    case 2: return launch<2, WOPOS, FAULT>(a, n_rows, stream);
    case 4: return launch<4, WOPOS, FAULT>(a, n_rows, stream);
    case 8: return launch<8, WOPOS, FAULT>(a, n_rows, stream);
    case 16: return launch<16, WOPOS, FAULT>(a, n_rows, stream);
    case 32: return launch<32, WOPOS, FAULT>(a, n_rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(int n_rows, int L, int ks, bool wopos, int groups, int gp, int gb, int warps) {
  return L >= 1 && L <= 512 && (wopos || L <= ks) && n_rows >= 1 && gb >= 1 && warps >= 1 &&
         groups % gb == 0 && gb * warps <= MAX_WARPS &&
         warps <= Split(L, rows_per_lane(gp)).chunks &&
         smem_bytes(L, gp, gb, wopos) <= 232448;
}

Params params(const void* qkv, void* out, const void* relative, const void* sim_scale,
              const void* out_scale, const void* out_shift, int rows_per_image, int L, int ks,
              int groups, int gb, int warps, long long s_img, long long s_row, long long s_pos,
              long long o_img, long long o_row, long long o_pos) {
  return Params{static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
                static_cast<const float*>(relative), static_cast<const float*>(sim_scale),
                static_cast<const float*>(out_scale), static_cast<const float*>(out_shift),
                rows_per_image, L, ks, groups, gb, warps,
                s_img, s_row, s_pos, o_img, o_row, o_pos};
}

}  // namespace

extern "C" {

// The shared memory one block of the launch uses, for the card test that
// holds axial_attention.py::plan to it.
long long axial_attention_smem(int L, int gp, int gb, int wopos) {
  return static_cast<long long>(smem_bytes(L, gp, gb, wopos != 0));
}

// C interface, loaded with ctypes. One axis pass: `n_rows` rows of `L`
// positions (`rows_per_image` rows per image), `groups` groups of `gp`
// channels, `gb` groups a block with `warps` warps each (plan() in
// axial_attention.py). Strides are in elements. `relative` may be null
// (wopos). Launches one grid on `stream` and returns the CUDA error code (0
// when the launch was accepted).
int axial_attention(const void* qkv, void* out, const void* relative, const void* sim_scale,
                    const void* out_scale, const void* out_shift, int n_rows,
                    int rows_per_image, int L, int ks, int groups, int gp, int gb, int warps,
                    long long s_img, long long s_row, long long s_pos, long long o_img,
                    long long o_row, long long o_pos, void* stream_ptr) {
  if (!valid(n_rows, L, ks, !relative, groups, gp, gb, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a = params(qkv, out, relative, sim_scale, out_scale, out_shift, rows_per_image,
                          L, ks, groups, gb, warps, s_img, s_row, s_pos, o_img, o_row, o_pos);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return relative ? by_planes<false, NONE>(gp, a, n_rows, stream)
                  : by_planes<true, NONE>(gp, a, n_rows, stream);
}

// The same launch with a planted fault (Fault, positional modes only): the
// rescale skipped when a row's reference moves, the last partial key tile
// dropped, or the key splits' merge dropped. For the card checks only.
int axial_attention_fault(const void* qkv, void* out, const void* relative,
                          const void* sim_scale, const void* out_scale, const void* out_shift,
                          int n_rows, int rows_per_image, int L, int ks, int groups, int gp,
                          int gb, int warps, long long s_img, long long s_row, long long s_pos,
                          long long o_img, long long o_row, long long o_pos, int fault,
                          void* stream_ptr) {
  if (!relative || !valid(n_rows, L, ks, false, groups, gp, gb, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a = params(qkv, out, relative, sim_scale, out_scale, out_shift, rows_per_image,
                          L, ks, groups, gb, warps, s_img, s_row, s_pos, o_img, o_row, o_pos);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (fault) {
    case NO_RESCALE: return by_planes<false, NO_RESCALE>(gp, a, n_rows, stream);
    case DROP_PARTIAL_TILE: return by_planes<false, DROP_PARTIAL_TILE>(gp, a, n_rows, stream);
    case NO_MERGE: return by_planes<false, NO_MERGE>(gp, a, n_rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
