// K2: SwinV2 cosine window attention, written by hand for Hopper (sm_90a).
// For each window b, head h and query i:
//
//   a[i, j] = (q_i.k_j / max(|q_i| |k_j|, 1e-6)) / max(tau[h,i,j], 0.01)
//             + bias[h,i,j] + mask[b % nW, i, j]
//   out[i]  = sum_j softmax_j(a[i, :]) v_j
//
// q arrives already multiplied by the attention scale; tau is a per-element
// divisor clipped from below only; mask (0 / -100) is null for unshifted
// windows. Norms, logits and the softmax are float32 from the bf16 (or
// float32) inputs, as the TPU kernel computes; the output is rounded to the
// input type once.
//
// Replaces unet_zoo_tpu/ops/pallas/window_attention.py:77
// swin_window_attention (the TPU kernel; pl.pallas_call at :104). Python
// wrapper and launch plan: unet_zoo_tpu_torch/ops/kernels/window_attention.py.
//
// Bound: per (window, head) 2 N^2 hd operations for q.k and 2 N^2 hd for P.V
// and about 10 N^2 for the cosine, tau, bias, mask and softmax; with N = 49
// or 64 and hd = 32 the bytes of q, k, v and the output bound the function
// once both products run on the tensor cores (window_attention.py's work).
//
// Two instances; the wrapper picks one by shape, type and alignment.
//
// The served instance, window_attention_mma_kernel<HD, FAULT> (bf16, N <= 64, hd 16
// or 32, 16-byte aligned rows), is one block of 4 warps for several windows
// of one head:
//   - the windows of a block share their tables: b = m + nW t for one mask
//     index m (any windows where there is no mask). The block reads
//     clip(tau) and bias + mask[m] once, into registers in the layout of the
//     S fragment, with log2 e folded in (32 + 32 floats a thread); padded
//     keys get a -inf logit, padded queries finite ones that are never
//     stored. The plan (window_attention.py::plan) picks the windows a
//     block takes so that the grid still fills the SMs;
//   - q, k and v of a window are copied by 16-byte cp.async (zero fill past
//     N) into one of RING slots of [64][hd + 8] bf16 tiles (16 bytes of
//     padding a row keep ldmatrix free of bank conflicts); the next window's
//     copies are in flight while the current one computes, and one barrier
//     a window orders the ring;
//   - warp w owns query rows 16w..16w+15 of the window padded to 64: S =
//     q.k^T is mma.sync m16n8k16 (bf16 products are exact in f32, only the
//     order of the sums differs), its fragment stays in registers through
//     the cosine, tau, bias, mask and a softmax in log2 units (ex2.approx),
//     whose row max and sum are shuffles over the 4 lanes of a row; the
//     norms come from the staged rows, one lane a row, by shuffles;
//   - P.V is mma.sync too, without rounding P once to bf16: the normalised
//     f32 P is split into bf16 P_hi + P_lo and both pass against V (ldmatrix
//     .trans), accumulating in f32, so P keeps about 16 bits;
//   - the warp's output rows go through its own q rows of the slot and out
//     by 16-byte stores, token-major.
// window_attention_fault runs the same instance with a planted fault for the
// card checks: FAULT_MASK makes a block's windows consecutive (b = m T + t)
// while they keep the group's mask index m; FAULT_P_ONCE drops P_lo, so P is
// rounded once to bf16.
//
// The general instance, window_attention_general_kernel<T, JT> (float32 or
// bf16, N <= 256, hd <= 128, any strides whose last is 1), is the first
// design: one block of 4 warps per (window, head), q, k and v staged as f32,
// one warp per query with lanes over keys, both products as f32 FMAs and the
// tables read per (i, j) from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The served instance
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps; warp w owns query rows 16w..16w+15
constexpr int MMA_ROWS = 64;       // a window padded to 64 tokens
constexpr int MMA_MAX_TOKENS = 64;
constexpr int PREFETCH = 1;        // windows in flight ahead (two ran slower: PERF.md)
constexpr int RING = PREFETCH + 2; // window slots: computing, in flight, draining
constexpr int FAULT_MASK = 1;      // planted faults (window_attention_fault)
constexpr int FAULT_P_ONCE = 2;

// One block's shared memory: RING slots of q, k and v as [64][hd + 8] bf16.
size_t mma_smem(int hd) {
  return sizeof(__nv_bfloat16) * RING * 3 * MMA_ROWS * static_cast<size_t>(hd + 8);
}

struct MmaArgs {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* out;
  const float *tau, *bias, *mask;
  int nh, n;
  int nwe;        // mask windows (1 without a mask): a group is (head, mask index)
  int per_group;  // windows of a group, windows / nwe
  int wpb;        // windows a block takes from its group
  int chunks;     // blocks a group, ceil(per_group / wpb)
  long long sq[3], sk[3], sv[3], so[3];  // element strides of (window, head, token)
};

// Blocks of a launch: nh groups of heads x nwe mask indices x chunks.
void mma_geometry(int windows, int nh, int hd, int nw, int masked, int wpb, int* out) {
  const int nwe = masked ? nw : 1;
  const int per_group = windows / nwe;
  const int chunks = (per_group + wpb - 1) / wpb;
  out[0] = nh * nwe * chunks;
  out[1] = MMA_THREADS;
  out[2] = static_cast<int>(mma_smem(hd));
  out[3] = per_group;
  out[4] = chunks;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// |row| of a staged bf16 row of HD values, summed in f32 from 16-byte loads.
template <int HD>
__device__ __forceinline__ float row_norm(const __nv_bfloat16* row) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[p]));
      s = fmaf(f.x, f.x, s);
      s = fmaf(f.y, f.y, s);
    }
  }
  return sqrtf(s);
}

// x0, x1 as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD, int FAULT>
__global__ void __launch_bounds__(MMA_THREADS, 3) window_attention_mma_kernel(MmaArgs a) {
  constexpr int LD = HD + 8;        // staged row stride (bf16)
  constexpr int CH = HD / 8;        // 16-byte chunks a row
  constexpr int TILE = MMA_ROWS * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragment's row group and lane in it
  const int c = blockIdx.x % a.chunks;
  const int m = (blockIdx.x / a.chunks) % a.nwe;
  const int h = blockIdx.x / (a.chunks * a.nwe);
  const int first = c * a.wpb;
  const int count = min(a.wpb, a.per_group - first);
  const int n = a.n;
  auto window = [&](int u) -> long long {
    const long long tt = first + u;
    return FAULT == FAULT_MASK ? static_cast<long long>(m) * a.per_group + tt : m + a.nwe * tt;
  };

  // q, k and v of the block's u-th window into slot u % RING, rows past N
  // zero-filled.
  auto load = [&](int u) {
    const long long b = window(u);
    __nv_bfloat16* slot = ring + (u % RING) * 3 * TILE;
    const __nv_bfloat16* src[3] = {a.q + b * a.sq[0] + h * a.sq[1],
                                   a.k + b * a.sk[0] + h * a.sk[1],
                                   a.v + b * a.sv[0] + h * a.sv[1]};
    const long long step[3] = {a.sq[2], a.sk[2], a.sv[2]};
#pragma unroll
    for (int which = 0; which < 3; ++which) {
#pragma unroll
      for (int e = tid; e < MMA_ROWS * CH; e += MMA_THREADS) {
        const int r = e / CH, ch = e - r * CH;
        const bool valid = r < n;
        cp_async16(slot + which * TILE + r * LD + 8 * ch,
                   src[which] + (valid ? r : 0) * step[which] + 8 * ch, valid);
      }
    }
  };
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) {
    if (u < count) load(u);
    cp_async_commit();
  }

  // The head's tables in the S fragment's layout: rows 16 warp + g + 8 hf,
  // keys 8 j + 2 t + e; log2 e folded in.
  float itau[2][8][2], bm[2][8][2];
  {
    const size_t nn = static_cast<size_t>(n) * n;
    const float* tau = a.tau + h * nn;
    const float* bias = a.bias + h * nn;
    const float* mask = a.mask ? a.mask + m * nn : nullptr;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * warp + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 8 * j + 2 * t + e;
          float it = 0.f, b = -CUDART_INF_F;
          if (jj < n) {
            b = 0.f;
            if (i < n) {
              const size_t ij = static_cast<size_t>(i) * n + jj;
              it = LOG2E / fmaxf(tau[ij], 0.01f);
              b = bias[ij];
              if (mask) b += mask[ij];
              b *= LOG2E;
            }
          }
          itau[hf][j][e] = it;
          bm[hf][j][e] = b;
        }
      }
    }
  }

  for (int u = 0; u < count; ++u) {
    if (u + PREFETCH < count) load(u + PREFETCH);
    cp_async_commit();
    cp_async_wait<PREFETCH>();
    __syncthreads();  // window u is staged; every warp is done with window u - 2
    __nv_bfloat16* qs = ring + (u % RING) * 3 * TILE;
    const __nv_bfloat16* ks = qs + TILE;
    const __nv_bfloat16* vs = ks + TILE;
    __nv_bfloat16* own = qs + 16 * warp * LD;   // the warp's q rows, later its output

    // Norms: lane l takes key rows l and l + 32 and query row 16 warp + l % 16.
    const float kn_lo = row_norm<HD>(ks + lane * LD);
    const float kn_hi = row_norm<HD>(ks + (lane + 32) * LD);
    const float qn_own = row_norm<HD>(own + (lane & 15) * LD);
    const float qn[2] = {__shfl_sync(FULL, qn_own, g), __shfl_sync(FULL, qn_own, g + 8)};

    // S = q k^T: 16 rows x 64 keys a warp, HD / 16 steps of k16.
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], own + (lane & 15) * LD + 16 * kk + (lane >> 4) * 8);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int x = 0; x < HD / 4; ++x) {   // 8 x 8 blocks (key tile j, chunk ch), 4 a load
      const int mm = 4 * x + (lane >> 3);
      uint32_t b[4];
      ldsm_x4(b, ks + (8 * (mm / CH) + (lane & 7)) * LD + 8 * (mm % CH));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 2 * (2 * x + hh);    // the first block of this k16 pair
        mma_bf16(s[p / CH], qa[(p % CH) / 2], b + 2 * hh);
      }
    }

    // Logits and softmax in log2 units; a row spans the 4 lanes of its group.
    // |k| of key 8 j + 2 t + e comes from the lane that holds it.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float kn = __shfl_sync(FULL, j < 4 ? kn_lo : kn_hi, 8 * (j & 3) + 2 * t + e);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 2 * hf + e;
          const float den = fmaxf(qn[hf] * kn, 1e-6f);
          const float x = fmaf(__fdividef(s[j][r], den), itau[hf][j][e], bm[hf][j][e]);
          s[j][r] = x;
          mx[hf] = fmaxf(mx[hf], x);
        }
      }
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ex2(s[j][r] - mx[r >> 1]);
        s[j][r] = e;
        sum[r >> 1] += e;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] += __shfl_xor_sync(FULL, sum[hf], 1);
      sum[hf] += __shfl_xor_sync(FULL, sum[hf], 2);
      inv[hf] = 1.f / sum[hf];
    }

    // O = P_hi V + P_lo V: P's fragment is the A operand, keys 16 a step.
    float o[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[d][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0], ph[0], pl[0]);
      split_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (16 * kk + (lane & 15)) * LD + 16 * dp + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, b);
        mma_bf16(o[2 * dp + 1], ph, b + 2);
        if (FAULT != FAULT_P_ONCE) {
          mma_bf16(o[2 * dp], pl, b);
          mma_bf16(o[2 * dp + 1], pl, b + 2);
        }
      }
    }

    // The warp's 16 output rows through its own q rows, then 16-byte stores.
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(own + g * LD + 8 * d + 2 * t) =
          __floats2bfloat162_rn(o[d][0], o[d][1]);
      *reinterpret_cast<__nv_bfloat162*>(own + (g + 8) * LD + 8 * d + 2 * t) =
          __floats2bfloat162_rn(o[d][2], o[d][3]);
    }
    __syncwarp();
    __nv_bfloat16* out = a.out + window(u) * a.so[0] + h * a.so[1];
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, ch = e - r * CH;
      const int i = 16 * warp + r;
      if (i < n)
        *reinterpret_cast<uint4*>(out + i * a.so[2] + 8 * ch) =
            *reinterpret_cast<const uint4*>(own + r * LD + 8 * ch);
    }
  }
}

template <int HD, int FAULT>
int launch_mma(const MmaArgs& a, int blocks, cudaStream_t stream) {
  const size_t bytes = mma_smem(HD);
  const cudaError_t err = cudaFuncSetAttribute(window_attention_mma_kernel<HD, FAULT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_mma_kernel<HD, FAULT><<<blocks, MMA_THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int FAULT>
int run_mma(const void* q, const void* k, const void* v, void* out, const void* tau,
            const void* bias, const void* mask, int windows, int nh, int n, int hd, int nw,
            int wpb, const long long* st, void* stream_ptr) {
  const int nwe = mask ? nw : 1;
  bool ok = windows >= 1 && nh >= 1 && n >= 1 && n <= MMA_MAX_TOKENS && (hd == 16 || hd == 32) &&
            nw >= 1 && windows % nwe == 0 && wpb >= 1 && aligned16(q) && aligned16(k) &&
            aligned16(v) && aligned16(out);
  for (int i = 0; i < 12; ++i) ok = ok && st[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int geo[5];
  mma_geometry(windows, nh, hd, nw, mask != nullptr, wpb, geo);
  if (static_cast<long long>(nh) * nwe * geo[4] >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                  static_cast<const float*>(tau), static_cast<const float*>(bias),
                  static_cast<const float*>(mask), nh, n, nwe, geo[3], wpb, geo[4],
                  {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
                  {st[9], st[10], st[11]}};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return hd == 16 ? launch_mma<16, FAULT>(a, geo[0], stream)
                  : launch_mma<32, FAULT>(a, geo[0], stream);
}

// ---------------------------------------------------------------------------
// The general instance
// ---------------------------------------------------------------------------

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int n, int hd) {
  const int ld = hd | 1;
  return sizeof(float) * (2 * static_cast<size_t>(n) * ld + static_cast<size_t>(n) * hd +
                          2 * n + NWARPS * n);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const float *tau, *bias, *mask;
  int nh, n, hd, nw;
  long long sq[3], sk[3], sv[3], so[3];  // element strides of (window, head, token)
};

template <typename T, int JT>
__global__ void __launch_bounds__(NTHREADS) window_attention_general_kernel(Args a) {
  const int n = a.n, hd = a.hd, ld = hd | 1;
  extern __shared__ float smem[];
  float* qs = smem;          // [n][ld]
  float* ks = qs + n * ld;   // [n][ld]
  float* vs = ks + n * ld;   // [n][hd]
  float* qn = vs + n * hd;   // [n]
  float* kn = qn + n;        // [n]
  float* ps = kn + n;        // [NWARPS][n]

  const long long w = blockIdx.x / a.nh;
  const int h = blockIdx.x - static_cast<int>(w) * a.nh;
  const T* q = static_cast<const T*>(a.q) + w * a.sq[0] + h * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + w * a.sk[0] + h * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + w * a.sv[0] + h * a.sv[1];
  T* out = static_cast<T*>(a.out) + w * a.so[0] + h * a.so[1];
  const int tid = threadIdx.x;
  for (int e = tid; e < n * hd; e += NTHREADS) {
    const int t = e / hd, d = e - t * hd;
    qs[t * ld + d] = to_float(q[t * a.sq[2] + d]);
    ks[t * ld + d] = to_float(k[t * a.sk[2] + d]);
    vs[t * hd + d] = to_float(v[t * a.sv[2] + d]);
  }
  __syncthreads();
  for (int t = tid; t < 2 * n; t += NTHREADS) {
    const float* row = t < n ? qs + t * ld : ks + (t - n) * ld;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(row[d], row[d], s);
    (t < n ? qn[t] : kn[t - n]) = sqrtf(s);
  }
  __syncthreads();

  const size_t nn = static_cast<size_t>(n) * n;
  const float* tau = a.tau + h * nn;
  const float* bias = a.bias + h * nn;
  const float* mask = a.mask ? a.mask + (w % a.nw) * nn : nullptr;
  const int warp = tid >> 5, lane = tid & 31;
  float* p = ps + warp * n;
  for (int i = warp; i < n; i += NWARPS) {
    const float* qi = qs + i * ld;
    const float qni = qn[i];
    float s[JT];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -CUDART_INF_F;
      if (j < n) {
        const float* kj = ks + j * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qi[d], kj[d], dot);
        const int ij = i * n + j;
        float x = dot / fmaxf(qni * kn[j], 1e-6f);
        x = x / fmaxf(tau[ij], 0.01f) + bias[ij];
        if (mask) x += mask[ij];
        s[t] = x;
        m = fmaxf(m, x);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const float e = (lane + 32 * t < n) ? expf(s[t] - m) : 0.f;
      s[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < n) p[j] = s[t] / sum;
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * hd + d], acc);
      store(out + i * a.so[2] + d, acc);
    }
    __syncwarp();  // p is rewritten by the warp's next query
  }
}

template <typename T, int JT>
int launch_general(const Args& a, int windows, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.n, a.hd);
  const cudaError_t err = cudaFuncSetAttribute(window_attention_general_kernel<T, JT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_general_kernel<T, JT><<<windows * a.nh, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tokens(const Args& a, int windows, cudaStream_t stream) {
  if (a.n <= 32) return launch_general<T, 1>(a, windows, stream);
  if (a.n <= 64) return launch_general<T, 2>(a, windows, stream);
  if (a.n <= 128) return launch_general<T, 4>(a, windows, stream);
  return launch_general<T, 8>(a, windows, stream);
}

}  // namespace

extern "C" {

// The numbers window_attention_mma launches with for `wpb` windows a block:
// (blocks, threads, shared memory bytes, windows a group, blocks a group),
// for the card test that holds them to window_attention.py::plan.
void window_attention_geometry(int windows, int nh, int hd, int nw, int masked, int wpb,
                               int* out) {
  mma_geometry(windows, nh, hd, nw, masked, wpb, out);
}

// C interface of the served instance, loaded with ctypes. `windows` windows
// of `n` <= 64 tokens, `nh` heads of `hd` (16 or 32) channels; q, k, v, out
// bf16 with element strides of (window, head, token) that are multiples of 8,
// 16-byte aligned, the channel stride 1; tau and bias [nh, n, n] float32;
// mask [nw, n, n] float32 or null; `wpb` windows of one group a block.
// Launches one grid on `stream` and returns the CUDA error code (0 when it
// was accepted).
int window_attention_mma(const void* q, const void* k, const void* v, void* out,
                         const void* tau, const void* bias, const void* mask, int windows,
                         int nh, int n, int hd, int nw, int wpb, long long q_w, long long q_h,
                         long long q_n, long long k_w, long long k_h, long long k_n,
                         long long v_w, long long v_h, long long v_n, long long o_w,
                         long long o_h, long long o_n, void* stream_ptr) {
  const long long st[12] = {q_w, q_h, q_n, k_w, k_h, k_n, v_w, v_h, v_n, o_w, o_h, o_n};
  return run_mma<0>(q, k, v, out, tau, bias, mask, windows, nh, n, hd, nw, wpb, st, stream_ptr);
}

// The served instance with planted fault `fault` (FAULT_MASK: a block's
// windows consecutive but given the group's mask index; FAULT_P_ONCE: P_lo
// dropped), for the card checks only.
int window_attention_fault(const void* q, const void* k, const void* v, void* out,
                           const void* tau, const void* bias, const void* mask, int windows,
                           int nh, int n, int hd, int nw, int wpb, long long q_w, long long q_h,
                           long long q_n, long long k_w, long long k_h, long long k_n,
                           long long v_w, long long v_h, long long v_n, long long o_w,
                           long long o_h, long long o_n, int fault, void* stream_ptr) {
  const long long st[12] = {q_w, q_h, q_n, k_w, k_h, k_n, v_w, v_h, v_n, o_w, o_h, o_n};
  if (fault == FAULT_MASK)
    return run_mma<FAULT_MASK>(q, k, v, out, tau, bias, mask, windows, nh, n, hd, nw, wpb, st,
                               stream_ptr);
  if (fault == FAULT_P_ONCE)
    return run_mma<FAULT_P_ONCE>(q, k, v, out, tau, bias, mask, windows, nh, n, hd, nw, wpb,
                                 st, stream_ptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C interface of the general instance. `windows` windows of `n` <= 256
// tokens, `nh` heads of `hd` <= 128 channels; q, k, v, out bf16 (or float32
// with is_f32), with element strides of (window, head, token) and the
// channel stride 1; tau and bias [nh, n, n] float32; mask [nw, n, n] float32
// or null. Launches one grid on `stream` and returns the CUDA error code.
int window_attention_general(const void* q, const void* k, const void* v, void* out,
                             const void* tau, const void* bias, const void* mask, int windows,
                             int nh, int n, int hd, int nw, int is_f32, long long q_w,
                             long long q_h, long long q_n, long long k_w, long long k_h,
                             long long k_n, long long v_w, long long v_h, long long v_n,
                             long long o_w, long long o_h, long long o_n, void* stream_ptr) {
  if (windows < 1 || nh < 1 || n < 1 || n > 256 || hd < 1 || hd > 128 || nw < 1 ||
      (mask && windows % nw) || static_cast<long long>(windows) * nh >= (1LL << 31) ||
      smem_bytes(n, hd) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out,
               static_cast<const float*>(tau), static_cast<const float*>(bias),
               static_cast<const float*>(mask), nh, n, hd, nw,
               {q_w, q_h, q_n}, {k_w, k_h, k_n}, {v_w, v_h, v_n}, {o_w, o_h, o_n}};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_f32 ? by_tokens<float>(a, windows, stream)
                : by_tokens<__nv_bfloat16>(a, windows, stream);
}

}  // extern "C"
