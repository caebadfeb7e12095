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
// (the TPU kernel; pl.pallas_call at axial_attention.py:141). Python wrapper:
// unet_zoo_tpu_torch/ops/kernels/axial_attention.py.
//
// Bound: about 6c + 4gp + 5 f32 operations per (row, group, i, j) (2c + 2gp
// + 5 for wopos) with c = gp/2. The bytes (qkv read once, the output written
// once, bf16) are small beside the operations, so it is bound by the CUDA
// cores' f32 rate. qk, qr and kr contract over c <= 16 and give the tensor
// cores next to nothing. sv is, per (row, group), an [L x L] by [L x gp]
// product over j and most of the operations; the tensor cores could take
// it, but only in bf16 or TF32, below the f32 the TPU kernel computes in,
// and the f32 bound and the card check would no longer describe it. Here
// every term is f32. The design keeps everything on chip:
//   - one block per (row n, chunk of groups): the row's q/k/v for those
//     groups are read once from device memory into shared memory as f32,
//     with an odd row stride so that lanes over j hit distinct banks;
//   - the embedding tables are never built: the 2L-1 columns of `relative`
//     that offsets i-j in (-L, L) need go into shared memory, and each term
//     indexes them (the Toeplitz index, with the ks-1 offset of tables built
//     at the model's kernel size: L may be shorter than ks);
//   - one warp per (group, query i), lanes over keys j (up to 16 per lane):
//     max and sum by shuffles; sv and sve are summed per lane for all gp
//     values, scaled by a_sv and a_sve, and reduced in one reduce-scatter
//     (gp - 1 + 5 - log2 gp shuffles for gp values instead of 5 gp), after
//     which lane p holds output p.
// Per-(g, p) scales apply after the sum over j: no per-group copy of v_emb.
// Layout: qkv and out are NHWC bf16 (torch channels_last); the wrapper passes
// element strides of (image, row, position), so the height pass reads and
// writes columns in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
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

// Sums each of the N values of every lane over the warp. On return, lane l
// holds the warp's sum of value l % N. Each halving step keeps one half of
// the values and sends the other to the partner lane.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int half = N / 2; half >= 1; half /= 2) {
    const bool upper = lane & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float lo = v[i], hi = v[i + half];
      const float recv = __shfl_xor_sync(FULL, upper ? lo : hi, half);
      v[i] = (upper ? hi : lo) + recv;
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = N; o < 32; o *= 2) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

size_t smem_bytes(int L, int gb, int gp, bool wopos) {
  return sizeof(float) * (static_cast<size_t>(L) * (gb * 2 * gp + 1) +
                          (wopos ? 0 : 2 * gp * (2 * L - 1)) + 3 * gb + 3 * gb * gp);
}

template <int GP, int JT, bool WOPOS>
__global__ void __launch_bounds__(NTHREADS) axial_attention_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ relative, const float* __restrict__ sim_scale,
    const float* __restrict__ out_scale, const float* __restrict__ out_shift,
    int rows_per_image, int L, int ks, int groups, int gb,
    long long s_img, long long s_row, long long s_pos,
    long long o_img, long long o_row, long long o_pos) {
  constexpr int C = GP / 2;    // q and k channels of a group
  constexpr int CH = 2 * GP;   // a group's qkv channels: [q | k | v]
  const int cb = gb * CH;
  const int lds = cb + 1;      // odd: lanes over j read distinct banks
  const int rl = 2 * L - 1;    // embedding columns for offsets i - j in (-L, L)
  extern __shared__ float smem[];
  float* tile = smem;                               // [L][lds] q|k|v, f32
  float* rel = tile + L * lds;                      // [2GP][rl]
  float* scal = rel + (WOPOS ? 0 : 2 * GP * rl);    // [3][gb]: a_qk, a_qr, a_kr
  float* a_sv = scal + 3 * gb;                      // [gb][GP]
  float* a_sve = a_sv + gb * GP;                    // [gb][GP]
  float* shift = a_sve + gb * GP;                   // [gb][GP]

  const int g0 = blockIdx.y * gb;
  const long long img = blockIdx.x / rows_per_image, row = blockIdx.x % rows_per_image;
  const int tid = threadIdx.x;
  const __nv_bfloat16* src = qkv + img * s_img + row * s_row + g0 * CH;
  for (int e = tid; e < L * cb; e += NTHREADS) {
    const int l = e / cb, ch = e - l * cb;
    tile[l * lds + ch] = __bfloat162float(src[l * s_pos + ch]);
  }
  if (!WOPOS) {
    for (int e = tid; e < 2 * GP * rl; e += NTHREADS) {
      const int r = e / rl, col = e - r * rl;
      rel[e] = relative[static_cast<size_t>(r) * (2 * ks - 1) + ks - L + col];
    }
  }
  for (int e = tid; e < gb; e += NTHREADS) {
#pragma unroll
    for (int t = 0; t < 3; ++t) scal[t * gb + e] = sim_scale[t * groups + g0 + e];
  }
  for (int e = tid; e < gb * GP; e += NTHREADS) {
    a_sv[e] = out_scale[g0 * GP + e];
    a_sve[e] = out_scale[(groups + g0) * GP + e];
    shift[e] = out_shift[g0 * GP + e];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int task = warp; task < gb * L; task += NWARPS) {
    const int gl = task / L, i = task - gl * L;
    const float* qi = tile + i * lds + gl * CH;
    float q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = qi[c];
    const float aqk = scal[gl], aqr = scal[gb + gl], akr = scal[2 * gb + gl];

    float s[JT];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -CUDART_INF_F;
      if (j < L) {
        const float* kj = tile + j * lds + gl * CH + C;
        float qk = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) qk = fmaf(q[c], kj[c], qk);
        float v = aqk * qk;
        if (!WOPOS) {
          const int d = i - j + L - 1;  // column of offset i - j; j - i is 2L-2-d
          float qr = 0.f, kr = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            qr = fmaf(q[c], rel[c * rl + d], qr);
            kr = fmaf(kj[c], rel[(C + c) * rl + 2 * L - 2 - d], kr);
          }
          v = fmaf(aqr, qr, fmaf(akr, kr, v));
        }
        s[t] = v;
        m = fmaxf(m, v);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const float e = (lane + 32 * t < L) ? expf(s[t] - m) : 0.f;
      s[t] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);

    float acc[GP], acce[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) acc[p] = acce[p] = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < L) {
        const float* vj = tile + j * lds + gl * CH + GP;
#pragma unroll
        for (int p = 0; p < GP; ++p) acc[p] = fmaf(s[t], vj[p], acc[p]);
        if (!WOPOS) {
          const float* ve = rel + GP * rl + i - j + L - 1;
#pragma unroll
          for (int p = 0; p < GP; ++p) acce[p] = fmaf(s[t], ve[p * rl], acce[p]);
        }
      }
    }
    const float* sv = a_sv + gl * GP;
    const float* sve = a_sve + gl * GP;
#pragma unroll
    for (int p = 0; p < GP; ++p)
      acc[p] = WOPOS ? sv[p] * acc[p] : fmaf(sv[p], acc[p], sve[p] * acce[p]);
    const float r = reduce_scatter<GP>(acc, lane);
    if (lane < GP) {
      out[img * o_img + row * o_row + i * o_pos + (g0 + gl) * GP + lane] =
          __float2bfloat16(fmaf(r, inv, shift[gl * GP + lane]));
    }
  }
}

struct Args {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  const float *relative, *sim_scale, *out_scale, *out_shift;
  int n_rows, rows_per_image, L, ks, groups, split;
  long long s_img, s_row, s_pos, o_img, o_row, o_pos;
};

template <int GP, int JT, bool WOPOS>
int launch(const Args& a, cudaStream_t stream) {
  const int gb = a.groups / a.split;
  const size_t bytes = smem_bytes(a.L, gb, GP, WOPOS);
  const cudaError_t err = cudaFuncSetAttribute(axial_attention_kernel<GP, JT, WOPOS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_rows, a.split);
  axial_attention_kernel<GP, JT, WOPOS><<<grid, NTHREADS, bytes, stream>>>(
      a.qkv, a.out, a.relative, a.sim_scale, a.out_scale, a.out_shift, a.rows_per_image, a.L,
      a.ks, a.groups, gb, a.s_img, a.s_row, a.s_pos, a.o_img, a.o_row, a.o_pos);
  return static_cast<int>(cudaGetLastError());
}

template <int GP, bool WOPOS>
int by_length(const Args& a, cudaStream_t stream) {
  if (a.L <= 32) return launch<GP, 1, WOPOS>(a, stream);
  if (a.L <= 64) return launch<GP, 2, WOPOS>(a, stream);
  if (a.L <= 128) return launch<GP, 4, WOPOS>(a, stream);
  if (a.L <= 256) return launch<GP, 8, WOPOS>(a, stream);
  return launch<GP, 16, WOPOS>(a, stream);
}

template <bool WOPOS>
int by_planes(int gp, const Args& a, cudaStream_t stream) {
  switch (gp) {
    case 2: return by_length<2, WOPOS>(a, stream);
    case 4: return by_length<4, WOPOS>(a, stream);
    case 8: return by_length<8, WOPOS>(a, stream);
    case 16: return by_length<16, WOPOS>(a, stream);
    case 32: return by_length<32, WOPOS>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes. One axis pass: `n_rows` rows of `L`
// positions (`rows_per_image` rows per image), `groups` groups of `gp`
// channels, split into `split` blocks per row. Strides are in elements.
// `relative` may be null (wopos). Launches one grid on `stream` and returns
// the CUDA error code (0 when the launch was accepted).
extern "C" int axial_attention(const void* qkv, void* out, const void* relative,
                               const void* sim_scale, const void* out_scale,
                               const void* out_shift, int n_rows, int rows_per_image, int L,
                               int ks, int groups, int gp, int split, long long s_img,
                               long long s_row, long long s_pos, long long o_img,
                               long long o_row, long long o_pos, void* stream_ptr) {
  if (L < 1 || L > 512 || (relative && L > ks) || split < 1 || groups % split || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
               static_cast<const float*>(relative), static_cast<const float*>(sim_scale),
               static_cast<const float*>(out_scale), static_cast<const float*>(out_shift),
               n_rows, rows_per_image, L, ks, groups, split,
               s_img, s_row, s_pos, o_img, o_row, o_pos};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return relative ? by_planes<false>(gp, a, stream) : by_planes<true>(gp, a, stream);
}
