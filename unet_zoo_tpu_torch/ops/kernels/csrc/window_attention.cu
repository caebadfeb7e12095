// K2: SwinV2 cosine window attention, written by hand for Hopper (sm_90a).
// For each window b, head h and query i:
//
//   a[i, j] = (q_i.k_j / max(|q_i| |k_j|, 1e-6)) / max(tau[h,i,j], 0.01)
//             + bias[h,i,j] + mask[b % nW, i, j]
//   out[i]  = sum_j softmax_j(a[i, :]) v_j
//
// q arrives already multiplied by the attention scale; tau is a per-element
// divisor clipped from below only; mask (0 / -100) is null for unshifted
// windows. Everything is float32 from the bf16 (or float32) inputs, as the
// TPU kernel computes; the output is rounded to the input type once.
//
// Replaces unet_zoo_tpu/ops/pallas/window_attention.py:77
// swin_window_attention (the TPU kernel; pl.pallas_call at :104). Python
// wrapper: unet_zoo_tpu_torch/ops/kernels/window_attention.py.
//
// Bound: per (window, head) 2 N^2 hd operations for q.k (exact products of
// the bf16 inputs, so the tensor cores could take them), 2 N^2 hd for P.V,
// which must stay float32 (rounding P to bf16 would fall below the f32 the
// TPU kernel computes), and about 10 N^2 for the cosine, tau, bias, mask
// and softmax. With N = 49 or 64 and hd = 32 that is 26-34 operations per
// byte of q, k, v and output: with q.k on the tensor cores the bytes bound
// the work; computed as here, both products in float32 FMAs, the float32
// operations do, at about 1.3x the bytes' time (chip_smoke.py's k2_work).
// The windows are tiny ([N, hd] = [49, 32]), so the design keeps one
// window's head on chip and spends nothing on tiling:
//   - one block per (window, head): q, k and v of that head are read once
//     from device memory (any strides, last dimension contiguous, so the
//     model hands over views of its qkv projection) into shared memory as
//     f32, q and k with an odd row stride so that lanes over keys hit
//     distinct banks; the norms |q_i|, |k_j| once per block;
//   - one warp per query i, lanes over keys j (up to 8 per lane): the
//     cosine, tau, bias and mask per (i, j) straight from device memory
//     (the [nh, N, N] tables are shared by every window and stay in L2),
//     max and sum by shuffles;
//   - the warp's probabilities go to shared memory and lane d sums
//     p_j v[j][d] over j (consecutive lanes, consecutive addresses), so P
//     stays f32 and each output row is written by one warp, token-major.
// No window blocking as on the TPU: blocks run in parallel on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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
__global__ void __launch_bounds__(NTHREADS) window_attention_kernel(Args a) {
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
int launch(const Args& a, int windows, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.n, a.hd);
  const cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, JT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T, JT><<<windows * a.nh, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tokens(const Args& a, int windows, cudaStream_t stream) {
  if (a.n <= 32) return launch<T, 1>(a, windows, stream);
  if (a.n <= 64) return launch<T, 2>(a, windows, stream);
  if (a.n <= 128) return launch<T, 4>(a, windows, stream);
  return launch<T, 8>(a, windows, stream);
}

}  // namespace

// C interface, loaded with ctypes. `windows` windows of `n` tokens, `nh`
// heads of `hd` channels; q, k, v, out bf16 (or float32 with is_f32), with
// element strides of (window, head, token) and the channel stride 1; tau
// and bias [nh, n, n] float32; mask [nw, n, n] float32 or null. Launches one
// grid on `stream` and returns the CUDA error code (0 when it was accepted).
extern "C" int window_attention(const void* q, const void* k, const void* v, void* out,
                                const void* tau, const void* bias, const void* mask,
                                int windows, int nh, int n, int hd, int nw, int is_f32,
                                long long q_w, long long q_h, long long q_n, long long k_w,
                                long long k_h, long long k_n, long long v_w, long long v_h,
                                long long v_n, long long o_w, long long o_h, long long o_n,
                                void* stream_ptr) {
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
