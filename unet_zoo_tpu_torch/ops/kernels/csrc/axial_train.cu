// K7: MedT axial attention in training, written by hand for Hopper (sm_90a):
// BatchNorm with batch statistics on the three similarity terms, softmax over
// keys, sv/sve, and the exact gradients, in four grids. For a row n of the axis
// pass, group g, query i and key j (c < C = GP/2, p < GP):
//
//   qk = Σ_c q[i,c] k[j,c]    qr = Σ_c qg[i,c] rel_q[c](i-j)    kr = Σ_c kg[j,c] rel_k[c](j-i)
//   sim[i,:] = softmax_j(a_qk qk + a_qr qr + a_kr kr),   a_t = gamma_t rsqrt(var_t + eps)
//   sv[i,p] = Σ_j sim v[j,p]                            sve[i,p] = Σ_j sim rel_v[p](i-j)
//
// where rel_*[c](o) = relative[row, o + ks - 1] (the MedT relative embeddings,
// emb[c,a,b] = relative[c, a-b+ks-1]: k's term reads the transposed table).
//
//   stats  per block, Σ and Σ² of qk, qr, kr per (term, group) over (i, j), in f64;
//          the wrapper finishes mu and the biased var in f64;
//   fwd    sim and sv, sve;
//   B1     dsim = Σ_p v[j,p] dsv[i,p] + rel_v[p](i-j) dsve[i,p],
//          dpre = sim (dsim - Σ_j dsim sim); S_t = Σ dpre x̂_t (f64 per block),
//          d_v[j,p] = Σ_i sim dsv[i,p], d_rel_v[p](i-j) += sim dsve[i,p];
//   B2     dtot_t = a_t dpre + e_t x̂_t with e_t = -a_t S_t / M from the wrapper,
//          x̂_t = (term_t - mu_t) rsqrt(var_t + eps); d_q = Σ_j dtot_qk k,
//          d_k = Σ_i dtot_qk q, d_qg = Σ_j dtot_qr rel_q, d_kg = Σ_i dtot_kr rel_k,
//          d_rel_q(i-j) += dtot_qr qg, d_rel_k(j-i) += dtot_kr kg.
//
// Every grid rebuilds sim with the same device functions (row_terms,
// row_softmax, and row_dpre in B1 and B2), with rounding fixed by explicit
// __fmaf_rn/__fmul_rn, so the gradient is that of the forward that ran.
//
// Replaces unet_zoo_tpu/ops/pallas/axial_train.py::fused_axial_train
// (pl.pallas_call: stats :229, forward :263, B1 :302, B2 :324). Python wrapper
// and autograd Function: unet_zoo_tpu_torch/ops/kernels/axial_train.py.
//
// Bound: f32 operations on the CUDA cores. The least work per (row, group, i,
// j) is about 6C + 4GP + 18 operations forward (terms, moments, softmax, sv,
// sve) and 18C + 8GP + 25 backward (sim once more, dsim, dpre, S and dtot,
// d_v and d_v_emb, the q and k contractions); the bytes (bf16 operands and gradients read and written
// once) are a few per (row, group, position) and never bound it. The TPU
// kernel laid its grid over rows n and carried d_v_emb, d_q_emb and d_k_emb
// from one grid step to the next; here blocks run in no order, so:
//   - one block per (row n, chunk of gb groups), the row's operands in shared
//     memory as f32 (odd row stride: lanes over j read distinct banks), and
//     the 2L-1 columns of `relative` the offsets i-j in (-L, L) need (no
//     L x L tables; the ks-1 offset of tables built at the model's kernel
//     size: L may be shorter than ks);
//   - one warp per (group, query i), lanes over keys j (up to 4 per lane);
//     sums over j are warp shuffles (deterministic);
//   - sums over queries i (d_v, d_k, d_kg) stay in registers over a warp's
//     queries of one group and add into shared memory once per (warp,
//     group), in a [channel][j] layout with an odd stride (lanes over j on
//     distinct banks: a [j][channel] layout put 16 lanes on one bank and
//     took B1 at gp 4, L 128 to 12.7 ms); sums over diagonals (d_rel) add
//     per query. Both are float atomics; each block then writes its own
//     rows of d_v, d_k, d_kg and its partial of d_rel, which the wrapper sums
//     over blocks in a fixed order. The atomics' order varies, so those
//     gradients may differ between runs in the last bits of f32;
//   - the moments and S: per lane in f64 over the lane's keys and queries,
//     per warp by shuffles, per block over warps in a fixed order, then over
//     blocks by the wrapper in f64 (deterministic). E[x²] - mu² over
//     M = N L² ~ 1.7e7 elements keeps its digits.
// The kernels do more than the least work: stats, fwd, B1 and B2 each rebuild
// the terms and the softmax, and B1 and B2 each form dpre.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STATS = 0, FWD = 1, B1 = 2, B2 = 3;
constexpr int MAX_L = 128;

typedef __nv_bfloat16 bf16;

struct Strides {
  long long n, l, g;  // elements between rows, positions, groups; channels contiguous
};

struct Args {
  const bf16* in[7];      // q, k, qg, kg [N,L,g,C]; v, dsv, dsve [N,L,g,GP]
  Strides s[7];
  const float* relative;  // [2GP][2ks - 1]: q rows, k rows, v rows
  const float* consts;    // [4][3][groups]: a, mu, rsqrt(var + eps), e
  void* out[5];
  int L, ks, groups, gb, split;
};

// A group's channels in a row of the shared tile: q, k, qg, kg (C each), then
// v, dsv, dsve (GP each); the stats grid loads the first four, fwd five, B1/B2 all.
template <int KIND>
struct Kind {
  static constexpr int n_in = KIND == STATS ? 4 : KIND == FWD ? 5 : 7;
  static constexpr int acc = KIND == STATS ? 6 : KIND == B1 ? 3 : 0;  // f64 sums per group
};

__host__ __device__ inline int channels(int kind, int gp) {
  return kind == STATS ? 2 * gp : kind == FWD ? 3 * gp : 5 * gp;
}

// Dynamic shared memory of one block; the carve in `Smem` and _smem_bytes in
// axial_train.py follow this.
size_t smem_bytes(int kind, int L, int gb, int gp) {
  const size_t c = gp / 2, rl = 2 * L - 1;
  size_t floats = L * (gb * channels(kind, gp) + 1) + 2 * gp * rl + 12 * gb;
  if (kind == B1) floats += (L | 1) * gb * gp + gp * rl;
  if (kind == B2) floats += 2 * (L | 1) * gb * c + 2 * c * rl;
  const size_t doubles = NWARPS * gb * (kind == STATS ? 6 : kind == B1 ? 3 : 0);
  return 8 * doubles + 4 * floats;
}

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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sums each of the N values of every lane over the warp; lane l ends with the
// sum of value l % N (as in csrc/axial_attention.cu).
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

template <int GP, int KIND>
struct Smem {
  static constexpr int C = GP / 2, CH = KIND == STATS ? 2 * GP : KIND == FWD ? 3 * GP : 5 * GP;
  double* wsum;  // [NWARPS][gb][acc]
  float* tile;   // [L][lds]
  float* rel;    // [2GP][rl]
  float* cst;    // [4][3][gb]
  float* red;    // B1: d_v [gb GP][lp]; B2: d_k then d_kg, [gb C][lp] each
  float* drel;   // B1: [GP][rl] (v rows); B2: [2C][rl] (q, k rows)
  int lds, rl, lp;

  __device__ Smem(unsigned char* raw, int L, int gb) {
    lds = gb * CH + 1;
    rl = 2 * L - 1;
    lp = L | 1;  // odd: lanes over j, and the write-out over channels, hit distinct banks
    wsum = reinterpret_cast<double*>(raw);
    tile = reinterpret_cast<float*>(wsum + NWARPS * gb * Kind<KIND>::acc);
    rel = tile + L * lds;
    cst = rel + 2 * GP * rl;
    red = cst + 12 * gb;
    drel = red + (KIND == B1 ? lp * gb * GP : KIND == B2 ? 2 * lp * gb * C : 0);
  }
};

// Loads row n's operands for groups g0.. g0+gb-1 as f32, the embedding columns
// and the per-(term, group) constants; zeroes the atomic accumulators.
template <int GP, int KIND>
__device__ void load_block(const Args& a, const Smem<GP, KIND>& sm, long long n, int g0) {
  constexpr int C = GP / 2, CH = Smem<GP, KIND>::CH;
  const int L = a.L, gb = a.gb, rl = sm.rl;
#pragma unroll 1
  for (int w = 0; w < Kind<KIND>::n_in; ++w) {
    const int width = w < 4 ? C : GP, off = w < 4 ? w * C : 4 * C + (w - 4) * GP;
    const bf16* src = a.in[w];
    const Strides s = a.s[w];
    for (int e = threadIdx.x; e < L * gb * width; e += NTHREADS) {
      const int l = e / (gb * width), r = e - l * gb * width, gl = r / width, ch = r - gl * width;
      sm.tile[l * sm.lds + gl * CH + off + ch] =
          __bfloat162float(src[n * s.n + l * s.l + (g0 + gl) * s.g + ch]);
    }
  }
  for (int e = threadIdx.x; e < 2 * GP * rl; e += NTHREADS) {
    const int r = e / rl, col = e - r * rl;
    sm.rel[e] = a.relative[static_cast<size_t>(r) * (2 * a.ks - 1) + a.ks - L + col];
  }
  if (KIND != STATS) {
    for (int e = threadIdx.x; e < 12 * gb; e += NTHREADS) {
      const int r = e / gb, gl = e - r * gb;
      sm.cst[e] = a.consts[r * a.groups + g0 + gl];
    }
  }
  const int n_red = KIND == B1   ? sm.lp * gb * GP + GP * rl
                    : KIND == B2 ? 2 * sm.lp * gb * C + 2 * C * rl
                                 : 0;
  for (int e = threadIdx.x; e < n_red; e += NTHREADS) sm.red[e] = 0.f;
}

// The three raw similarity terms of query i against the lane's keys
// j = lane + 32 t (0 for j >= L). `grp` is the group's first channel in row 0.
template <int GP, int JT>
__device__ __forceinline__ void row_terms(const float* grp, int lds, const float* rel, int L, int i,
                                          int lane, float (&qk)[JT], float (&qr)[JT],
                                          float (&kr)[JT]) {
  constexpr int C = GP / 2;
  const int rl = 2 * L - 1;
  const float* ri = grp + i * lds;
  float q[C], qg[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q[c] = ri[c];
    qg[c] = ri[2 * C + c];
  }
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    const int j = lane + 32 * t;
    float x = 0.f, y = 0.f, z = 0.f;
    if (j < L) {
      const float* rj = grp + j * lds;
      const int d = i - j + L - 1;  // column of offset i - j; offset j - i is column rl - 1 - d
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x = __fmaf_rn(q[c], rj[C + c], x);
        y = __fmaf_rn(qg[c], rel[c * rl + d], y);
        z = __fmaf_rn(rj[3 * C + c], rel[(C + c) * rl + rl - 1 - d], z);
      }
    }
    qk[t] = x;
    qr[t] = y;
    kr[t] = z;
  }
}

// sim = softmax over keys of a0 qk + a1 qr + a2 kr; 0 for keys j >= L.
template <int JT>
__device__ __forceinline__ void row_softmax(const float (&qk)[JT], const float (&qr)[JT],
                                            const float (&kr)[JT], float a0, float a1, float a2,
                                            int L, int lane, float (&sim)[JT]) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    sim[t] = __fmaf_rn(a2, kr[t], __fmaf_rn(a1, qr[t], __fmul_rn(a0, qk[t])));
    if (lane + 32 * t < L) m = fmaxf(m, sim[t]);
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    sim[t] = lane + 32 * t < L ? expf(__fsub_rn(sim[t], m)) : 0.f;
    sum = __fadd_rn(sum, sim[t]);
  }
  const float inv = __frcp_rn(warp_sum(sum));
#pragma unroll
  for (int t = 0; t < JT; ++t) sim[t] = __fmul_rn(sim[t], inv);
}

// dpre = sim (dsim - Σ_j dsim sim): the gradient of the logits.
template <int GP, int JT>
__device__ __forceinline__ void row_dpre(const float* grp, int lds, const float* rel, int L, int i,
                                         int lane, const float (&sim)[JT], float (&dpre)[JT]) {
  const int rl = 2 * L - 1;
  const float* ri = grp + i * lds;
  float r = 0.f;
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    const int j = lane + 32 * t;
    float ds = 0.f;
    if (j < L) {
      const float* vj = grp + j * lds + 2 * GP;
      const float* ve = rel + GP * rl + i - j + L - 1;
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        ds = __fmaf_rn(vj[p], ri[3 * GP + p], ds);
        ds = __fmaf_rn(ve[p * rl], ri[4 * GP + p], ds);
      }
    }
    dpre[t] = ds;
    r = __fmaf_rn(ds, sim[t], r);
  }
  r = warp_sum(r);
#pragma unroll
  for (int t = 0; t < JT; ++t) dpre[t] = __fmul_rn(sim[t], __fsub_rn(dpre[t], r));
}

__device__ __forceinline__ float xhat(float x, float mu, float inv) {
  return __fmul_rn(__fsub_rn(x, mu), inv);
}

// Per-block sums of `acc` values per group: the warps' shares added in a fixed order.
template <int ACC>
__device__ void write_sums(const double* wsum, int gb, double* out) {
  for (int e = threadIdx.x; e < ACC * gb; e += NTHREADS) {
    const int x = e / gb, gl = e - x * gb;
    double tot = 0.0;
    for (int w = 0; w < NWARPS; ++w) tot += wsum[(w * gb + gl) * ACC + x];
    out[e] = tot;
  }
}

template <int GP, int JT>
__global__ void __launch_bounds__(NTHREADS) axial_train_stats_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<GP, STATS> sm(smem_raw, a.L, a.gb);
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * a.gb, L = a.L, gb = a.gb;
  load_block<GP, STATS>(a, sm, n, g0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gl = 0; gl < gb; ++gl) {
    double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = warp; i < L; i += NWARPS) {
      float qk[JT], qr[JT], kr[JT];
      row_terms<GP, JT>(sm.tile + gl * Smem<GP, STATS>::CH, sm.lds, sm.rel, L, i, lane, qk, qr, kr);
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < JT; ++t) {  // keys j >= L hold 0 and add nothing
        s[0] += qk[t];
        s[1] += qr[t];
        s[2] += kr[t];
        s[3] = fmaf(qk[t], qk[t], s[3]);
        s[4] = fmaf(qr[t], qr[t], s[4]);
        s[5] = fmaf(kr[t], kr[t], s[5]);
      }
#pragma unroll
      for (int x = 0; x < 6; ++x) acc[x] += s[x];
    }
#pragma unroll
    for (int x = 0; x < 6; ++x) acc[x] = warp_sum(acc[x]);
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < 6; ++x) sm.wsum[(warp * gb + gl) * 6 + x] = acc[x];
    }
  }
  __syncthreads();
  write_sums<6>(sm.wsum, gb,
                static_cast<double*>(a.out[0]) + (n * a.split + blockIdx.y) * 6 * gb);
}

template <int GP, int JT>
__global__ void __launch_bounds__(NTHREADS) axial_train_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<GP, FWD> sm(smem_raw, a.L, a.gb);
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * a.gb, L = a.L, gb = a.gb, rl = sm.rl;
  load_block<GP, FWD>(a, sm, n, g0);
  __syncthreads();

  bf16* sv_out = static_cast<bf16*>(a.out[0]);
  bf16* sve_out = static_cast<bf16*>(a.out[1]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < gb * L; task += NWARPS) {
    const int gl = task / L, i = task - gl * L;
    const float* grp = sm.tile + gl * Smem<GP, FWD>::CH;
    float qk[JT], qr[JT], kr[JT], sim[JT];
    row_terms<GP, JT>(grp, sm.lds, sm.rel, L, i, lane, qk, qr, kr);
    row_softmax<JT>(qk, qr, kr, sm.cst[gl], sm.cst[gb + gl], sm.cst[2 * gb + gl], L, lane, sim);
    float acc[GP], acce[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) acc[p] = acce[p] = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < L) {
        const float* vj = grp + j * sm.lds + 2 * GP;
        const float* ve = sm.rel + GP * rl + i - j + L - 1;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          acc[p] = fmaf(sim[t], vj[p], acc[p]);
          acce[p] = fmaf(sim[t], ve[p * rl], acce[p]);
        }
      }
    }
    const float r_sv = reduce_scatter<GP>(acc, lane);
    const float r_sve = reduce_scatter<GP>(acce, lane);
    if (lane < GP) {
      const long long o = ((n * L + i) * a.groups + g0 + gl) * GP + lane;
      sv_out[o] = __float2bfloat16(r_sv);
      sve_out[o] = __float2bfloat16(r_sve);
    }
  }
}

template <int GP, int JT>
__global__ void __launch_bounds__(NTHREADS) axial_train_b1_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<GP, B1> sm(smem_raw, a.L, a.gb);
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * a.gb, L = a.L, gb = a.gb, rl = sm.rl, lp = sm.lp;
  load_block<GP, B1>(a, sm, n, g0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gl = 0; gl < gb; ++gl) {
    const float* grp = sm.tile + gl * Smem<GP, B1>::CH;
    const float* c = sm.cst + gl;  // c[(r * 3 + t) * gb]: r = a, mu, inv, e
    float* dv = sm.red + gl * GP * lp;  // d_v[p][j] of this group
    double acc[3] = {0.0, 0.0, 0.0};
    float dvr[JT][GP] = {};  // d_v over this warp's queries
    for (int i = warp; i < L; i += NWARPS) {
      float qk[JT], qr[JT], kr[JT], sim[JT], dpre[JT];
      row_terms<GP, JT>(grp, sm.lds, sm.rel, L, i, lane, qk, qr, kr);
      row_softmax<JT>(qk, qr, kr, c[0], c[gb], c[2 * gb], L, lane, sim);
      row_dpre<GP, JT>(grp, sm.lds, sm.rel, L, i, lane, sim, dpre);
      const float* ri = grp + i * sm.lds;
      float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        const int j = lane + 32 * t;
        if (j < L) {
          s[0] = fmaf(dpre[t], xhat(qk[t], c[3 * gb], c[6 * gb]), s[0]);
          s[1] = fmaf(dpre[t], xhat(qr[t], c[4 * gb], c[7 * gb]), s[1]);
          s[2] = fmaf(dpre[t], xhat(kr[t], c[5 * gb], c[8 * gb]), s[2]);
          float* dve = sm.drel + i - j + L - 1;
#pragma unroll
          for (int p = 0; p < GP; ++p) {
            dvr[t][p] += sim[t] * ri[3 * GP + p];
            atomicAdd(dve + p * rl, sim[t] * ri[4 * GP + p]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 3; ++x) acc[x] += s[x];
    }
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < L) {
#pragma unroll
        for (int p = 0; p < GP; ++p) atomicAdd(dv + p * lp + j, dvr[t][p]);
      }
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) acc[x] = warp_sum(acc[x]);
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < 3; ++x) sm.wsum[(warp * gb + gl) * 3 + x] = acc[x];
    }
  }
  __syncthreads();
  const long long blk = n * a.split + blockIdx.y;
  write_sums<3>(sm.wsum, gb, static_cast<double*>(a.out[0]) + blk * 3 * gb);
  bf16* dv_out = static_cast<bf16*>(a.out[1]);
  for (int e = threadIdx.x; e < L * gb * GP; e += NTHREADS) {
    const int l = e / (gb * GP), r = e - l * gb * GP;  // r = gl GP + p
    dv_out[((n * L + l) * a.groups + g0) * GP + r] = __float2bfloat16(sm.red[r * lp + l]);
  }
  float* rel_out = static_cast<float*>(a.out[2]) + blk * GP * rl;
  for (int e = threadIdx.x; e < GP * rl; e += NTHREADS) rel_out[e] = sm.drel[e];
}

template <int GP, int JT>
__global__ void __launch_bounds__(NTHREADS) axial_train_b2_kernel(const Args a) {
  constexpr int C = GP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<GP, B2> sm(smem_raw, a.L, a.gb);
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * a.gb, L = a.L, gb = a.gb, rl = sm.rl, lp = sm.lp;
  load_block<GP, B2>(a, sm, n, g0);
  __syncthreads();

  bf16* dq_out = static_cast<bf16*>(a.out[0]);
  bf16* dqg_out = static_cast<bf16*>(a.out[2]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gl = 0; gl < gb; ++gl) {
    const float* grp = sm.tile + gl * Smem<GP, B2>::CH;
    const float* c = sm.cst + gl;  // c[(r * 3 + t) * gb]: r = a, mu, inv, e
    float* dk = sm.red + gl * C * lp;             // d_k[c][j] of this group
    float* dkg = sm.red + (gb + gl) * C * lp;     // d_kg[c][j]
    float dkr[JT][C] = {}, dkgr[JT][C] = {};  // d_k, d_kg over this warp's queries
    for (int i = warp; i < L; i += NWARPS) {
      float qk[JT], qr[JT], kr[JT], sim[JT], dpre[JT];
      row_terms<GP, JT>(grp, sm.lds, sm.rel, L, i, lane, qk, qr, kr);
      row_softmax<JT>(qk, qr, kr, c[0], c[gb], c[2 * gb], L, lane, sim);
      row_dpre<GP, JT>(grp, sm.lds, sm.rel, L, i, lane, sim, dpre);
      const float* ri = grp + i * sm.lds;
      float dq[C], dqg[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) dq[cc] = dqg[cc] = 0.f;
#pragma unroll
      for (int t = 0; t < JT; ++t) {
        const int j = lane + 32 * t;
        if (j < L) {
          const float* rj = grp + j * sm.lds;
          const int d = i - j + L - 1, dt = rl - 1 - d;
          const float t0 = fmaf(c[0], dpre[t], c[9 * gb] * xhat(qk[t], c[3 * gb], c[6 * gb]));
          const float t1 = fmaf(c[gb], dpre[t], c[10 * gb] * xhat(qr[t], c[4 * gb], c[7 * gb]));
          const float t2 = fmaf(c[2 * gb], dpre[t], c[11 * gb] * xhat(kr[t], c[5 * gb], c[8 * gb]));
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            dq[cc] = fmaf(t0, rj[C + cc], dq[cc]);
            dqg[cc] = fmaf(t1, sm.rel[cc * rl + d], dqg[cc]);
            dkr[t][cc] += t0 * ri[cc];
            dkgr[t][cc] += t2 * sm.rel[(C + cc) * rl + dt];
            atomicAdd(sm.drel + cc * rl + d, t1 * ri[2 * C + cc]);
            atomicAdd(sm.drel + (C + cc) * rl + dt, t2 * rj[3 * C + cc]);
          }
        }
      }
      const float r_q = reduce_scatter<C>(dq, lane);
      const float r_qg = reduce_scatter<C>(dqg, lane);
      if (lane < C) {
        const long long o = ((n * L + i) * a.groups + g0 + gl) * C + lane;
        dq_out[o] = __float2bfloat16(r_q);
        dqg_out[o] = __float2bfloat16(r_qg);
      }
    }
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < L) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          atomicAdd(dk + cc * lp + j, dkr[t][cc]);
          atomicAdd(dkg + cc * lp + j, dkgr[t][cc]);
        }
      }
    }
  }
  __syncthreads();
  bf16* dk_out = static_cast<bf16*>(a.out[1]);
  bf16* dkg_out = static_cast<bf16*>(a.out[3]);
  for (int e = threadIdx.x; e < L * gb * C; e += NTHREADS) {
    const int l = e / (gb * C), r = e - l * gb * C;  // r = gl C + c
    const long long o = ((n * L + l) * a.groups + g0) * C + r;
    dk_out[o] = __float2bfloat16(sm.red[r * lp + l]);
    dkg_out[o] = __float2bfloat16(sm.red[(gb * C + r) * lp + l]);
  }
  float* rel_out = static_cast<float*>(a.out[4]) + (n * a.split + blockIdx.y) * 2 * C * rl;
  for (int e = threadIdx.x; e < 2 * C * rl; e += NTHREADS) rel_out[e] = sm.drel[e];
}

template <int GP, int JT>
int launch(int kind, const Args& a, int n_rows, cudaStream_t stream) {
  void (*kernel)(const Args) = kind == STATS ? axial_train_stats_kernel<GP, JT>
                               : kind == FWD ? axial_train_fwd_kernel<GP, JT>
                               : kind == B1  ? axial_train_b1_kernel<GP, JT>
                                             : axial_train_b2_kernel<GP, JT>;
  const size_t bytes = smem_bytes(kind, a.L, a.gb, GP);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_rows, a.split), NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int GP>
int by_length(int kind, const Args& a, int n_rows, cudaStream_t stream) {
  if (a.L <= 32) return launch<GP, 1>(kind, a, n_rows, stream);
  if (a.L <= 64) return launch<GP, 2>(kind, a, n_rows, stream);
  return launch<GP, 4>(kind, a, n_rows, stream);
}

}  // namespace

// C interface, loaded with ctypes. One grid `kind` (0 stats, 1 fwd, 2 B1, 3 B2)
// of one axis pass: `n_rows` rows of `L` positions, `groups` groups of `gp`
// channels, `split` blocks per row. ptrs: q, k, qg, kg, v, dsv, dsve (bf16),
// relative, consts (f32), then the grid's outputs:
//   stats: Σ/Σ² partials, f64 [n_rows, split, 6, gb];
//   fwd:   sv, sve, bf16 [n_rows, L, groups, gp];
//   B1:    S partials f64 [n_rows, split, 3, gb], d_v bf16, d_rel v rows f32 [blocks, gp, 2L-1];
//   B2:    d_q, d_k, d_qg, d_kg bf16 [n_rows, L, groups, gp/2], d_rel q|k rows f32 [blocks, gp, 2L-1].
// strides: (row, position, group) element strides of q, k, qg, kg, v; dsv and
// dsve are contiguous. Returns the CUDA error code (0 when the launch was accepted).
extern "C" int axial_train(int kind, void* const* ptrs, const long long* strides, int n_rows, int L,
                           int ks, int groups, int gp, int split, void* stream_ptr) {
  if (kind < STATS || kind > B2 || L < 1 || L > MAX_L || L > ks || split < 1 ||
      groups % split || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int w = 0; w < 7; ++w) {
    a.in[w] = static_cast<const bf16*>(ptrs[w]);
    a.s[w] = w < 5 ? Strides{strides[3 * w], strides[3 * w + 1], strides[3 * w + 2]}
                   : Strides{static_cast<long long>(L) * groups * gp,
                             static_cast<long long>(groups) * gp, gp};
  }
  a.relative = static_cast<const float*>(ptrs[7]);
  a.consts = static_cast<const float*>(ptrs[8]);
  for (int o = 0; o < 5; ++o) a.out[o] = ptrs[9 + o];
  a.L = L;
  a.ks = ks;
  a.groups = groups;
  a.gb = groups / split;
  a.split = split;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (gp) {
    case 2: return by_length<2>(kind, a, n_rows, stream);
    case 4: return by_length<4>(kind, a, n_rows, stream);
    case 8: return by_length<8>(kind, a, n_rows, stream);
    case 16: return by_length<16>(kind, a, n_rows, stream);
    case 32: return by_length<32>(kind, a, n_rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
