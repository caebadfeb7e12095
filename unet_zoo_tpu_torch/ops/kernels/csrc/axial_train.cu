// K7: MedT axial attention in training, written by hand for Hopper (sm_90a):
// BatchNorm with batch statistics on the three similarity terms, softmax over
// keys, sv/sve, and the exact gradients. For a row n of the axis pass, group
// g, query i, key j and offset o = i - j (c < C = GP/2, p < GP):
//
//   qk = Σ_c q[i,c] k[j,c]    qr = Σ_c qg[i,c] rel_q[c](o)    kr = Σ_c kg[j,c] rel_k[c](-o)
//   sim[i,:] = softmax_j(a_qk qk + a_qr qr + a_kr kr),   a_t = gamma_t rsqrt(var_t + eps)
//   sv[i,p] = Σ_j sim v[j,p]                            sve[i,p] = Σ_j sim rel_v[p](o)
//
// where rel_*[c](o) = relative[row, o + ks - 1] (the MedT relative embeddings;
// k's term reads the table at -o). Five grids, two forward and three backward:
//
//   stats    Σ and Σ² of qk, qr, kr per (term, group) over (n, i, j): float32
//            over a tile of pairs, float64 from there on; the last block to
//            finish (a ticket counter per stream, which that block resets)
//            sums the blocks' float64 partials in block order and writes mu,
//            the biased var, a, rsqrt(var + eps) and -mu rsqrt(var + eps);
//   fwd      two passes over the keys per query row: the row's max and sum
//            of exp(logit - max) (online), kept for the backward; then
//            sim = exp(logit - max) / sum, bit for bit the sims the backward
//            forms, into sv, sve (bf16 outputs and float32 copies);
//   bwd      ONE pass over the pairs. With sim from the saved row max and
//            sum and D_i = Σ_p dsv sv + dsve sve from the float32 sv, sve (no
//            softmax rebuild, no row reductions; the forward summed the same
//            sims). A row's sims must sum to 1 to float32 rounding, as a
//            softmax's do: an error that scales a whole row (exp(logit - lse)
//            with lse rounded) scales D but not dsim, so the row of dpre no
//            longer sums to zero and d_q, a sum over keys, takes it:
//              dsim = Σ_p v[j,p] dsv[i,p] + rel_v[p](o) dsve[i,p],
//              dpre = sim (dsim - D_i),  x̂_t = (term_t - mu_t) rsqrt(var_t + eps),
//              S_t = Σ dpre x̂_t (float64 per block),
//            and BatchNorm's input gradient a_t dpre + e_t x̂_t, e_t = -a_t S_t / M,
//            is linear in e: every output that needs it is emitted as two float32
//            partials, Σ dpre·operand and Σ x̂·operand (d_q, d_k, d_qg, d_kg and
//            the q and k rows of d_relative); d_v and the v rows of d_relative
//            need no e and are final;
//   fin      one block: S per (term, group) from the blocks' float64 partials in
//            block order, e = -a S / M, d_gamma = S;
//   combine  output = a·(dpre part) + e·(x̂ part), rounded to bf16 once; the
//            d_relative partials summed over blocks in a fixed order.
//
// Split (a data-parallel step, whose batch statistics are the global batch's:
// each rank holds its rows, and the caller sums over the ranks between grids):
// the stats grid's last block writes its float64 Σ and Σ² per (term, group)
// and stops; after the caller's all-reduce, stats_finish (one block) forms mu,
// var and the constants from the global sums. fin writes S of this rank's
// pairs and d_gamma = that S (the rank's share of the gradient, which the
// step averages over the ranks) and stops; after the all-reduce, s_finish
// (one block) forms e = -a S / M from the global S. M counts the global rows
// (D_GROWS). A split call over one rank computes what an unsplit one does,
// bit for bit: the same float64 sums reach the same arithmetic.
//
// Replaces unet_zoo_tpu/ops/pallas/axial_train.py::fused_axial_train
// (pl.pallas_call: stats :229, forward :263, B1 :302, B2 :324). Python wrapper
// and autograd Function: unet_zoo_tpu_torch/ops/kernels/axial_train.py.
//
// Bound: float32 operations on the CUDA cores (the pairs' arithmetic; bytes
// are a few per (row, group, position)). What kept the previous design, one
// warp per query row over four grids, at 11-13x that bound at L = 128 was
// a shared-memory load per FMA, a shared atomic per pair and output channel
// (d_relative's diagonal sums), warp reductions per query row and the softmax
// rebuilt in every grid. This design:
//   - register-tiled pairs: a thread owns an R x R micro-tile of R queries and
//     R keys, holding both sides' operands in registers; the tile's 2R - 1
//     diagonals of `relative` are loaded once per tile (forward) or once per
//     band (backward), not once per FMA;
//   - the backward walks diagonal bands: lane d of a warp takes the tiles
//     (I, J) with I = (J + d) mod T (T tiles per side), so at every step the
//     warp's lanes hold one key tile J and T different query tiles, and each
//     lane stays on two fixed bands of diagonals (d, then d - T). So
//       - d_relative's diagonal sums stay in registers for a whole band and
//         leave once per band (a global float atomic, one lane at a time);
//       - sums over queries (d_k, d_kg, d_v) reduce across the warp by one
//         reduce-scatter per step (no atomics);
//       - sums over keys (d_q, d_qg) add into the lane's own query rows in
//         shared memory (distinct rows per lane, no atomics);
//   - the forward's row sums stay in the thread that owns the row (no
//     shuffles), and keys are broadcast loads.
// mu, var, S and d_gamma are deterministic (float64, fixed orders); so are
// sv, sve and every gradient but d_relative, whose block partials come from
// float atomics and may differ between runs in the last bits of float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_L = 128;
constexpr int THREADS = 256;  // stats, fwd, fin and combine blocks
constexpr int MAX_WARPS = 4;  // bwd blocks

enum Kind { STATS, FWD, BWD, FIN, COMBINE, STATS_FINISH, S_FINISH };
// Pointers of the C interface, in this order (axial_train.py::_PTRS).
enum Ptr {
  P_Q, P_K, P_QG, P_KG, P_V, P_DSV, P_DSVE, P_REL, P_GAMMA, P_TICKET, P_MU, P_VAR,
  P_CONSTS, P_STAT, P_ROWS, P_SVF, P_SV, P_SVE, P_SPART, P_E, P_PI, P_PJ, P_DRELP,
  P_DQ, P_DK, P_DQG, P_DKG, P_DV, P_DREL, P_DGAMMA, P_STAT_SUMS, P_S_SUMS, NPTR
};
// Integer arguments: rows N, length L, kernel size, groups G, gp, rows (or
// units) per block, grid.x of this launch, warps per bwd block, stats and bwd
// blocks per group, split (0/1) and the rows of the global batch (N unsplit).
enum Dim {
  D_N, D_L, D_KS, D_G, D_GP, D_ROWS, D_BLOCKS, D_WARPS, D_SBLOCKS, D_BBLOCKS, D_SPLIT, D_GROWS,
  NDIM
};

struct Operand {  // bf16 [N, L, G, width], channels contiguous; null reads as zero
  const bf16* p;
  long long sn, sl, sg;
  __device__ float at(long long n, int l, int g, int ch) const {
    return p ? __bfloat162float(p[n * sn + l * sl + g * sg + ch]) : 0.f;
  }
  __device__ bf16 raw(long long n, int l, int g, int ch) const {
    return p ? p[n * sn + l * sl + g * sg + ch] : __float2bfloat16(0.f);
  }
};

struct Args {
  Operand in[7];  // q, k, qg, kg, v, dsv, dsve
  void* p[NPTR];
  int d[NDIM];
  float eps;
};

template <typename T>
__device__ __forceinline__ T* ptr(const Args& a, int i) {
  return static_cast<T*>(a.p[i]);
}

__host__ __device__ inline int ceil_div(int x, int y) { return (x + y - 1) / y; }
__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}
__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }

// Rows a thread owns per tile (forward: R_f x R_f tiles; backward: R_b x R_b):
// the most that keep a tile's operands, diagonals and sums in registers.
__host__ __device__ constexpr int r_fwd(int gp) { return gp <= 4 ? 4 : gp == 8 ? 2 : 1; }
__host__ __device__ constexpr int r_bwd(int gp) { return gp == 2 ? 4 : gp == 4 ? 2 : 1; }

// The three raw terms of one pair; the same function (and order of
// operations) in every grid, so the backward differentiates the logits the
// forward ran.
template <int C>
__device__ __forceinline__ void pair_terms(const float (&q)[C], const float (&k)[C],
                                           const float (&qg)[C], const float (&kg)[C],
                                           const float (&rq)[C], const float (&rk)[C],
                                           float& qk, float& qr, float& kr) {
  qk = qr = kr = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qk = __fmaf_rn(q[c], k[c], qk);
    qr = __fmaf_rn(qg[c], rq[c], qr);
    kr = __fmaf_rn(kg[c], rk[c], kr);
  }
}

// The logit a_qk qk + a_qr qr + a_kr kr; every grid forms a pair's sim as
// exp(logit - max) / sum with the row's max and sum from the fwd grid.
__device__ __forceinline__ float logit(float qk, float qr, float kr, const float (&a)[3]) {
  return __fmaf_rn(a[2], kr, __fmaf_rn(a[1], qr, __fmul_rn(a[0], qk)));
}

// ---------------------------------------------------------------------------
// stats and fwd: a block holds `units` rows n of one group g in shared memory
// (f32, position p at (p % R) T + p / R so that threads over query tiles read
// consecutive words), and the diagonals of `relative` in a layout that makes
// a tile's slot s of every thread consecutive as well. Thread (u, t) owns the
// query tile t (rows tR .. tR + R - 1) of unit u and walks all key tiles.
// ---------------------------------------------------------------------------

struct FwdGeom {
  int L, T, LP, units, ustride, nrel, nch;
  __device__ FwdGeom(const Args& a, int R, int nch_, int nrel_) {
    L = a.d[D_L];
    T = ceil_div(L, R);
    LP = T * R;
    units = a.d[D_ROWS];
    nch = nch_;
    nrel = nrel_;
    ustride = round32(nch * LP) + (T & 31);  // units of one warp on distinct banks
  }
};

// Rows of `relative` in the forward's table: q rows, then k rows read at -o,
// then v rows. Slot (m, t') holds offset o = m + R t' - (LP - 1); 0 where |o| >= L.
// The index is mirrored by axial_train.py::fwd_table_index, which the CPU
// tests check: change both together.
__device__ void load_rel_table(const Args& a, float* rel, int rows, int R, int L, int T) {
  const int LP = R * T, C = a.d[D_GP] / 2, ks = a.d[D_KS], width = 2 * ks - 1;
  const float* src = ptr<const float>(a, P_REL);
  for (int e = threadIdx.x; e < rows * 2 * LP; e += blockDim.x) {
    const int r = e / (2 * LP), op = e - r * 2 * LP;
    const int o = op - (LP - 1);
    float val = 0.f;
    if (op < 2 * LP - 1 && o > -L && o < L) {
      const int col = (r >= C && r < 2 * C) ? ks - 1 - o : ks - 1 + o;
      val = src[static_cast<long long>(r) * width + col];
    }
    rel[r * 2 * LP + (op % R) * 2 * T + op / R] = val;
  }
}

// Operands w0 .. w0 + nw - 1 (widths C for q, k, qg, kg; GP for v) of rows
// n0 .. n0 + units - 1 into the units' tiles; zero for rows >= N and positions >= L.
__device__ void load_units(const Args& a, const FwdGeom& f, float* ops, long long n0, int g,
                           int R) {
  const int C = a.d[D_GP] / 2, GP = a.d[D_GP];
  const long long N = a.d[D_N];
  for (int w = 0, base = 0; base < f.nch; ++w) {
    const int width = w < 4 ? C : GP;
    for (int e = threadIdx.x; e < f.units * f.LP * width; e += blockDim.x) {
      const int ch = e % width, pos = (e / width) % f.LP, u = e / (width * f.LP);
      const long long n = n0 + u;
      const float val = (n < N && pos < f.L) ? a.in[w].at(n, pos, g, ch) : 0.f;
      ops[u * f.ustride + (base + ch) * f.LP + (pos % R) * f.T + pos / R] = val;
    }
    base += width;
  }
}

// Operands of one thread's tile: rows (or keys) tR + a of channels [c0, c0 + W).
template <int R, int W>
__device__ __forceinline__ void tile_rows(const float* ops, int LP, int T, int c0, int t,
                                          float (&x)[R][W]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) x[r][c] = ops[(c0 + c) * LP + r * T + t];
}

template <int R, int W>
__device__ __forceinline__ void tile_rows(const bf16* ops, int LP, int T, int c0, int t,
                                          float (&x)[R][W]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) x[r][c] = __bfloat162float(ops[(c0 + c) * LP + r * T + t]);
}

// The tile's 2R - 1 diagonal slots for query tile t and key tile J (slot s:
// offset R (t - J) + s - (R - 1)) of table rows [r0, r0 + W). The index is
// mirrored by axial_train.py::fwd_slot_index: change both together.
template <int R, int W>
__device__ __forceinline__ void tile_slots(const float* rel, int LP, int T, int r0, int t, int J,
                                           float (&x)[2 * R - 1][W]) {
#pragma unroll
  for (int s = 0; s < 2 * R - 1; ++s)
#pragma unroll
    for (int c = 0; c < W; ++c)
      x[s][c] = rel[(r0 + c) * 2 * LP + (s % R) * 2 * T + t - J + T - 1 + s / R];
}

// Per-(term, group) constants for group g: a, inv, -mu inv.
__device__ __forceinline__ void group_consts(const Args& a, int g, float (&l)[3], float (&inv)[3],
                                             float (&nmi)[3]) {
  const int G = a.d[D_G];
  const float* cst = ptr<const float>(a, P_CONSTS);  // [3][3][G]: a, inv, -mu inv
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    l[t] = cst[t * G + g];
    inv[t] = cst[(3 + t) * G + g];
    nmi[t] = cst[(6 + t) * G + g];
  }
}

// mu, the biased var and the constants of (term, group) e from the Σ and Σ²
// of its M = global rows x L² pairs.
__device__ __forceinline__ void stats_consts(const Args& a, int e, double s1, double s2) {
  const int G = a.d[D_G], L = a.d[D_L];
  const double m = static_cast<double>(a.d[D_GROWS]) * L * L;
  const double mu = s1 / m;
  const float muf = static_cast<float>(mu), var = static_cast<float>(s2 / m - mu * mu);
  const float inv = rsqrtf(var + a.eps);
  float* cst = ptr<float>(a, P_CONSTS);
  ptr<float>(a, P_MU)[e] = muf;
  ptr<float>(a, P_VAR)[e] = var;
  cst[e] = ptr<const float>(a, P_GAMMA)[e] * inv;
  cst[3 * G + e] = inv;
  cst[6 * G + e] = -muf * inv;
}

template <int GP>
__global__ void __launch_bounds__(THREADS) axial_train_stats_kernel(const Args a) {
  constexpr int C = GP / 2, R = r_fwd(GP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdGeom f(a, R, 4 * C, 2 * C);
  double* red = reinterpret_cast<double*>(smem_raw);              // [THREADS][6]
  float* rel = reinterpret_cast<float*>(red + THREADS * 6);      // [2C][2 LP]
  float* ops = rel + f.nrel * 2 * f.LP;                           // [units][ustride]
  const int g = blockIdx.y, L = f.L, T = f.T;
  const long long N = a.d[D_N];
  load_rel_table(a, rel, f.nrel, R, L, T);

  const int u = threadIdx.x / T, t = threadIdx.x - u * T;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int chunks = ceil_div(static_cast<int>(N), f.units);
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const long long n0 = static_cast<long long>(chunk) * f.units;
    __syncthreads();
    load_units(a, f, ops, n0, g, R);
    __syncthreads();
    if (u >= f.units || n0 + u >= N) continue;
    const float* uo = ops + u * f.ustride;
    float q[R][C], qg[R][C];
    tile_rows<R, C>(uo, f.LP, T, 0, t, q);
    tile_rows<R, C>(uo, f.LP, T, 2 * C, t, qg);
    for (int J = 0; J < T; ++J) {
      float k[R][C], kg[R][C], rq[2 * R - 1][C], rk[2 * R - 1][C];
      tile_rows<R, C>(uo, f.LP, T, C, J, k);
      tile_rows<R, C>(uo, f.LP, T, 3 * C, J, kg);
      tile_slots<R, C>(rel, f.LP, T, 0, t, J, rq);
      tile_slots<R, C>(rel, f.LP, T, C, t, J, rk);
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ai = 0; ai < R; ++ai)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          float qk, qr, kr;
          pair_terms<C>(q[ai], k[b], qg[ai], kg[b], rq[ai - b + R - 1], rk[ai - b + R - 1], qk,
                        qr, kr);
          if (t * R + ai < L && J * R + b < L) {
            s[0] += qk;
            s[1] += qr;
            s[2] += kr;
            s[3] = fmaf(qk, qk, s[3]);
            s[4] = fmaf(qr, qr, s[4]);
            s[5] = fmaf(kr, kr, s[5]);
          }
        }
#pragma unroll
      for (int x = 0; x < 6; ++x) acc[x] += s[x];
    }
  }
  // the block's sums in thread order, then the last block sums the blocks
#pragma unroll
  for (int x = 0; x < 6; ++x) red[threadIdx.x * 6 + x] = acc[x];
  __syncthreads();
  const int nb = a.d[D_SBLOCKS], G = a.d[D_G];
  double* part = ptr<double>(a, P_STAT);  // [G][nb][6]
  if (threadIdx.x < 6) {
    double tot = 0.0;
    for (int i = 0; i < THREADS; ++i) tot += red[i * 6 + threadIdx.x];
    part[(static_cast<long long>(g) * nb + blockIdx.x) * 6 + threadIdx.x] = tot;
    __threadfence();
  }
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned int* ticket = ptr<unsigned int>(a, P_TICKET);
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(nb * G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double* sums = ptr<double>(a, P_STAT_SUMS);  // split: [2][3G], Σ then Σ²
  for (int e = threadIdx.x; e < 3 * G; e += blockDim.x) {
    const int tt = e / G, gg = e - tt * G;
    double s1 = 0.0, s2 = 0.0;
    for (int b = 0; b < nb; ++b) {
      s1 += __ldcg(part + (static_cast<long long>(gg) * nb + b) * 6 + tt);
      s2 += __ldcg(part + (static_cast<long long>(gg) * nb + b) * 6 + 3 + tt);
    }
    if (a.d[D_SPLIT]) {
      sums[e] = s1;
      sums[3 * G + e] = s2;
    } else {
      stats_consts(a, e, s1, s2);
    }
  }
  if (threadIdx.x == 0) *ptr<unsigned int>(a, P_TICKET) = 0u;  // ready for the next call
}

// Split calls: mu, var and the constants from the sums over every rank.
__global__ void __launch_bounds__(THREADS) axial_train_stats_finish_kernel(const Args a) {
  const int G = a.d[D_G];
  const double* sums = ptr<const double>(a, P_STAT_SUMS);
  for (int e = threadIdx.x; e < 3 * G; e += blockDim.x) stats_consts(a, e, sums[e], sums[3 * G + e]);
}

template <int GP>
__global__ void __launch_bounds__(THREADS, 2) axial_train_fwd_kernel(const Args a) {
  constexpr int C = GP / 2, R = r_fwd(GP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdGeom f(a, R, 4 * C + GP, 2 * GP);
  float* rel = reinterpret_cast<float*>(smem_raw);  // [2GP][2 LP]
  float* ops = rel + f.nrel * 2 * f.LP;
  const int g = blockIdx.y, L = f.L, T = f.T, G = a.d[D_G];
  const long long N = a.d[D_N], n0 = static_cast<long long>(blockIdx.x) * f.units;
  load_rel_table(a, rel, f.nrel, R, L, T);
  load_units(a, f, ops, n0, g, R);
  __syncthreads();
  const int u = threadIdx.x / T, t = threadIdx.x - u * T;
  const long long n = n0 + u;
  if (u >= f.units || n >= N) return;

  float av[3], inv[3], nmi[3];
  group_consts(a, g, av, inv, nmi);
  const float* uo = ops + u * f.ustride;
  float q[R][C], qg[R][C];
  tile_rows<R, C>(uo, f.LP, T, 0, t, q);
  tile_rows<R, C>(uo, f.LP, T, 2 * C, t, qg);
  // pass 1: each row's max and sum of exp(logit - max), online
  float mx[R], sum[R];
#pragma unroll
  for (int ai = 0; ai < R; ++ai) {
    mx[ai] = -CUDART_INF_F;
    sum[ai] = 0.f;
  }
  for (int J = 0; J < T; ++J) {
    float k[R][C], kg[R][C], rq[2 * R - 1][C], rk[2 * R - 1][C];
    tile_rows<R, C>(uo, f.LP, T, C, J, k);
    tile_rows<R, C>(uo, f.LP, T, 3 * C, J, kg);
    tile_slots<R, C>(rel, f.LP, T, 0, t, J, rq);
    tile_slots<R, C>(rel, f.LP, T, C, t, J, rk);
#pragma unroll
    for (int ai = 0; ai < R; ++ai) {
      float lg[R], top = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float qk, qr, kr;
        pair_terms<C>(q[ai], k[b], qg[ai], kg[b], rq[ai - b + R - 1], rk[ai - b + R - 1], qk, qr,
                      kr);
        lg[b] = J * R + b < L ? logit(qk, qr, kr, av) : -CUDART_INF_F;
        top = fmaxf(top, lg[b]);
      }
      const float m_new = fmaxf(mx[ai], top);
      float add = 0.f;
#pragma unroll
      for (int b = 0; b < R; ++b) add += __expf(lg[b] - m_new);
      sum[ai] = fmaf(sum[ai], __expf(mx[ai] - m_new), add);
      mx[ai] = m_new;
    }
  }
  float rs[R];
#pragma unroll
  for (int ai = 0; ai < R; ++ai) rs[ai] = 1.f / sum[ai];
  // pass 2: sim = exp(logit - max) / sum, the backward's own sims, into sv and sve
  float acc[R][2 * GP];
#pragma unroll
  for (int ai = 0; ai < R; ++ai)
#pragma unroll
    for (int p = 0; p < 2 * GP; ++p) acc[ai][p] = 0.f;
  for (int J = 0; J < T; ++J) {
    float k[R][C], kg[R][C], v[R][GP], rq[2 * R - 1][C], rk[2 * R - 1][C], rv[2 * R - 1][GP];
    tile_rows<R, C>(uo, f.LP, T, C, J, k);
    tile_rows<R, C>(uo, f.LP, T, 3 * C, J, kg);
    tile_rows<R, GP>(uo, f.LP, T, 4 * C, J, v);
    tile_slots<R, C>(rel, f.LP, T, 0, t, J, rq);
    tile_slots<R, C>(rel, f.LP, T, C, t, J, rk);
    tile_slots<R, GP>(rel, f.LP, T, 2 * C, t, J, rv);
#pragma unroll
    for (int ai = 0; ai < R; ++ai)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float qk, qr, kr;
        pair_terms<C>(q[ai], k[b], qg[ai], kg[b], rq[ai - b + R - 1], rk[ai - b + R - 1], qk, qr,
                      kr);
        const float pr = J * R + b < L ? __expf(logit(qk, qr, kr, av) - mx[ai]) * rs[ai] : 0.f;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          acc[ai][p] = fmaf(pr, v[b][p], acc[ai][p]);
          acc[ai][GP + p] = fmaf(pr, rv[ai - b + R - 1][p], acc[ai][GP + p]);
        }
      }
  }
  float* rows_g = ptr<float>(a, P_ROWS);  // [N][G][L][2]: max, 1 / sum
  float* svf = ptr<float>(a, P_SVF);    // [N][G][L][2GP]
  bf16* sv = ptr<bf16>(a, P_SV);
  bf16* sve = ptr<bf16>(a, P_SVE);
#pragma unroll
  for (int ai = 0; ai < R; ++ai) {
    const int i = t * R + ai;
    if (i >= L) continue;
    const long long row = (n * G + g) * L + i;
    rows_g[2 * row] = mx[ai];
    rows_g[2 * row + 1] = rs[ai];
#pragma unroll
    for (int p = 0; p < 2 * GP; ++p) {
      svf[row * 2 * GP + p] = acc[ai][p];
      (p < GP ? sv : sve)[((n * L + i) * G + g) * GP + p % GP] = __float2bfloat16(acc[ai][p]);
    }
  }
}

// ---------------------------------------------------------------------------
// bwd: a block of W warps holds one group g and the 2L - 1 columns of
// `relative` its offsets need; each warp takes rows n of the block's chunk one
// at a time. Per warp and row, shared memory holds the row's operands (bf16,
// as they come; position p at (p % R) T + p / R), its max, 1 / sum and D (f32), the
// sums over keys (per query row, [R 4C][T]) and the sums over queries
// (per key, [R(4C+GP)][T+1]).
// ---------------------------------------------------------------------------

template <int GP>
struct BwdGeom {
  static constexpr int C = GP / 2, R = r_bwd(GP), NOP = 4 * C + 3 * GP;  // bf16 channels
  static constexpr int NJ = 4 * C + GP, NV = R * NJ;  // per-key sums, per key and per tile
  static constexpr int NI = 4 * C;                    // per-query sums
  int L, T, LP, loops, wstride, o_f, o_pi, o_pj, rel_floats;
  __host__ __device__ BwdGeom(int L_) {
    L = L_;
    T = pow2_ceil(ceil_div(L, R));
    LP = R * T;
    loops = T > 32 ? T / 32 : 1;
    o_f = round32(NOP * LP / 2);
    o_pi = o_f + round32(3 * LP);
    o_pj = o_pi + round32(R * NI * T);
    wstride = o_pj + round32(NV * (T + 1));
    rel_floats = round32(2 * GP * (2 * L - 1));
  }
  __host__ __device__ size_t smem(int warps) const {
    return (static_cast<size_t>(warps) * wstride + rel_floats) * 4 + MAX_WARPS * 3 * 8;
  }
};

__host__ __device__ constexpr int pow2_ceil_c(int x) { return x <= 1 ? 1 : 2 * pow2_ceil_c((x + 1) / 2); }

// Sums each of the NP values of every lane over the warp (NP a power of two,
// at least 32); lane l ends with the totals of values [l NP/32, (l + 1) NP/32).
template <int NP>
__device__ __forceinline__ void reduce_scatter(float (&v)[NP], int lane) {
  int size = NP;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const int half = size / 2;
    const bool upper = lane & m;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) {
      if (i < half) {
        const float lo = v[i], hi = v[i + half];
        const float recv = __shfl_xor_sync(FULL, upper ? lo : hi, m);
        v[i] = (upper ? hi : lo) + recv;
      }
    }
    size = half;
  }
}

// Band D's slots s = 0 .. 2R - 2 (offset o = R D + s - (R - 1)) of the q, k
// (read at -o) and v rows of the block's copy of `relative`; 0 where |o| >= L.
template <int GP>
__device__ __forceinline__ void load_band(const float* relt, int D, int L,
                                          float (&rq)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                          float (&rk)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                          float (&rv)[2 * BwdGeom<GP>::R - 1][GP]) {
  constexpr int C = GP / 2, R = BwdGeom<GP>::R;
  const int w2 = 2 * L - 1;
#pragma unroll
  for (int s = 0; s < 2 * R - 1; ++s) {
    const int o = R * D + s - (R - 1);
    const bool in = o > -L && o < L;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      rq[s][c] = in ? relt[c * w2 + o + L - 1] : 0.f;
      rk[s][c] = in ? relt[(C + c) * w2 - o + L - 1] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) rv[s][p] = in ? relt[(GP + p) * w2 + o + L - 1] : 0.f;
  }
}

// Band D's diagonal sums into the block's partial of d_relative ([4C + GP][2L - 1]:
// q rows dpre- and x̂-part, k rows likewise at the k table's offset -o, v rows).
template <int GP>
__device__ __forceinline__ void flush_band(float* part, int D, int L,
                                           float (&dqa)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                           float (&dqx)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                           float (&dka)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                           float (&dkx)[2 * BwdGeom<GP>::R - 1][GP / 2],
                                           float (&dve)[2 * BwdGeom<GP>::R - 1][GP]) {
  constexpr int C = GP / 2, R = BwdGeom<GP>::R;
  const int w = 2 * L - 1;
#pragma unroll
  for (int s = 0; s < 2 * R - 1; ++s) {
    const int o = R * D + s - (R - 1);
    if (o > -L && o < L) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        atomicAdd(part + c * w + o + L - 1, dqa[s][c]);
        atomicAdd(part + (C + c) * w + o + L - 1, dqx[s][c]);
        atomicAdd(part + (2 * C + c) * w - o + L - 1, dka[s][c]);
        atomicAdd(part + (3 * C + c) * w - o + L - 1, dkx[s][c]);
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) atomicAdd(part + (4 * C + p) * w + o + L - 1, dve[s][p]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dqa[s][c] = dqx[s][c] = dka[s][c] = dkx[s][c] = 0.f;
#pragma unroll
    for (int p = 0; p < GP; ++p) dve[s][p] = 0.f;
  }
}

template <int GP>
__global__ void __launch_bounds__(MAX_WARPS * 32) axial_train_bwd_kernel(const Args a) {
  typedef BwdGeom<GP> Geo;
  constexpr int C = Geo::C, R = Geo::R, NJ = Geo::NJ, NV = Geo::NV, NI = Geo::NI, NS = 2 * R - 1;
  constexpr int NP = NV > 32 ? pow2_ceil_c(NV) : 32, VPL = NP / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.y, G = a.d[D_G], W = a.d[D_WARPS], nb = a.d[D_BBLOCKS];
  const long long N = a.d[D_N];
  const Geo geo(a.d[D_L]);
  const int L = geo.L, T = geo.T, LP = geo.LP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* relt = reinterpret_cast<float*>(smem_raw);  // [2GP][2L - 1]
  float* ws = relt + geo.rel_floats + warp * geo.wstride;
  bf16* ops = reinterpret_cast<bf16*>(ws);  // [NOP][LP]: q k qg kg (C), v dsv dsve (GP)
  float* opf = ws + geo.o_f;                   // [3][LP]: max, 1 / sum, D
  float* sp_i = ws + geo.o_pi;     // [R NI][T]
  float* sp_j = ws + geo.o_pj;     // [NV][T + 1]
  double* sred = reinterpret_cast<double*>(relt + geo.rel_floats + W * geo.wstride);

  const int w2 = 2 * L - 1;
  float* part = ptr<float>(a, P_DRELP) + (static_cast<long long>(g) * nb + blockIdx.x) * NJ * w2;
  for (int e = threadIdx.x; e < NJ * w2; e += blockDim.x) part[e] = 0.f;
  {  // the columns of `relative` for offsets -(L - 1) .. L - 1
    const int ks = a.d[D_KS], width = 2 * ks - 1;
    const float* rel = ptr<const float>(a, P_REL);
    for (int e = threadIdx.x; e < 2 * GP * w2; e += blockDim.x) {
      const int r = e / w2, col = e - r * w2;
      relt[e] = rel[r * width + ks - L + col];
    }
  }
  __syncthreads();

  float av[3], inv[3], nmi[3];
  group_consts(a, g, av, inv, nmi);
  const int rows = a.d[D_ROWS];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < N ? r0 + rows : N;
  double s64[3] = {0.0, 0.0, 0.0};
  const float* rows_g = ptr<const float>(a, P_ROWS);
  const float* svf_g = ptr<const float>(a, P_SVF);

  for (long long n = r0 + warp; n < r1; n += W) {
    // the row's operands, max, 1 / sum and D; zero sums
    for (int w = 0, base = 0; w < 7; ++w) {
      const int width = w < 4 ? C : GP;
      for (int e = lane; e < width * LP; e += 32) {
        const int ch = e % width, pos = e / width;
        ops[(base + ch) * LP + (pos % R) * T + pos / R] =
            pos < L ? a.in[w].raw(n, pos, g, ch) : __float2bfloat16(0.f);
      }
      base += width;
    }
    for (int e = lane; e < R * NI * T; e += 32) sp_i[e] = 0.f;
    for (int e = lane; e < NV * (T + 1); e += 32) sp_j[e] = 0.f;
    __syncwarp();
    for (int pos = lane; pos < LP; pos += 32) {
      const int at = (pos % R) * T + pos / R;
      float mx = 0.f, rs = 0.f, dd = 0.f;
      if (pos < L) {
        const long long row = (n * G + g) * L + pos;
        mx = rows_g[2 * row];
        rs = rows_g[2 * row + 1];
        const float* sf = svf_g + row * 2 * GP;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          dd = fmaf(__bfloat162float(ops[(4 * C + GP + p) * LP + at]), sf[p], dd);
          dd = fmaf(__bfloat162float(ops[(4 * C + 2 * GP + p) * LP + at]), sf[GP + p], dd);
        }
      }
      opf[at] = mx;
      opf[LP + at] = rs;
      opf[2 * LP + at] = dd;
    }
    __syncwarp();

    float sacc[3] = {0.f, 0.f, 0.f};
    // The band walk (lane d, step J, query tile I, band D) is mirrored by
    // axial_train.py::band_tiles, which the CPU tests check: change both together.
    for (int lp = 0; lp < geo.loops; ++lp) {
      const int d = lane + 32 * lp;
      const bool active = d < T;
      int D = d;
      float rq[NS][C], rk[NS][C], rv[NS][GP];
      float dqa[NS][C], dqx[NS][C], dka[NS][C], dkx[NS][C], dve[NS][GP];
      load_band<GP>(relt, D, L, rq, rk, rv);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int c = 0; c < C; ++c) dqa[s][c] = dqx[s][c] = dka[s][c] = dkx[s][c] = 0.f;
#pragma unroll
        for (int p = 0; p < GP; ++p) dve[s][p] = 0.f;
      }
      for (int J = 0; J < T; ++J) {
        if (active && d > 0 && J == T - d) {  // the second band, d - T
          flush_band<GP>(part, D, L, dqa, dqx, dka, dkx, dve);
          D = d - T;
          load_band<GP>(relt, D, L, rq, rk, rv);
        }
        float pj[NP];
#pragma unroll
        for (int x = 0; x < NP; ++x) pj[x] = 0.f;
        if (active) {
          const int I = (J + d) & (T - 1);
          float k[R][C], kg[R][C], v[R][GP];
          tile_rows<R, C>(ops, LP, T, C, J, k);
          tile_rows<R, C>(ops, LP, T, 3 * C, J, kg);
          tile_rows<R, GP>(ops, LP, T, 4 * C, J, v);
#pragma unroll
          for (int ai = 0; ai < R; ++ai) {
            const int at = ai * T + I;
            float q[C], qg[C], dsv[GP], dsve[GP];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              q[c] = __bfloat162float(ops[c * LP + at]);
              qg[c] = __bfloat162float(ops[(2 * C + c) * LP + at]);
            }
#pragma unroll
            for (int p = 0; p < GP; ++p) {
              dsv[p] = __bfloat162float(ops[(4 * C + GP + p) * LP + at]);
              dsve[p] = __bfloat162float(ops[(4 * C + 2 * GP + p) * LP + at]);
            }
            const float mx = opf[at], rs = opf[LP + at], dd = opf[2 * LP + at];
            const bool iv = I * R + ai < L;
            float pi[NI];
#pragma unroll
            for (int x = 0; x < NI; ++x) pi[x] = 0.f;
#pragma unroll
            for (int b = 0; b < R; ++b) {
              const int s = ai - b + R - 1;
              const bool valid = iv && J * R + b < L;
              float qk, qr, kr;
              pair_terms<C>(q, k[b], qg, kg[b], rq[s], rk[s], qk, qr, kr);
              const float sim = valid ? __expf(logit(qk, qr, kr, av) - mx) * rs : 0.f;
              float ds = 0.f;
#pragma unroll
              for (int p = 0; p < GP; ++p) {
                ds = fmaf(dsv[p], v[b][p], ds);
                ds = fmaf(dsve[p], rv[s][p], ds);
              }
              const float dp = sim * (ds - dd);
              const float xqk = valid ? fmaf(qk, inv[0], nmi[0]) : 0.f;
              const float xqr = valid ? fmaf(qr, inv[1], nmi[1]) : 0.f;
              const float xkr = valid ? fmaf(kr, inv[2], nmi[2]) : 0.f;
              sacc[0] = fmaf(dp, xqk, sacc[0]);
              sacc[1] = fmaf(dp, xqr, sacc[1]);
              sacc[2] = fmaf(dp, xkr, sacc[2]);
#pragma unroll
              for (int c = 0; c < C; ++c) {
                pi[c] = fmaf(dp, k[b][c], pi[c]);
                pi[C + c] = fmaf(xqk, k[b][c], pi[C + c]);
                pi[2 * C + c] = fmaf(dp, rq[s][c], pi[2 * C + c]);
                pi[3 * C + c] = fmaf(xqr, rq[s][c], pi[3 * C + c]);
                pj[b * NJ + c] = fmaf(dp, q[c], pj[b * NJ + c]);
                pj[b * NJ + C + c] = fmaf(xqk, q[c], pj[b * NJ + C + c]);
                pj[b * NJ + 2 * C + c] = fmaf(dp, rk[s][c], pj[b * NJ + 2 * C + c]);
                pj[b * NJ + 3 * C + c] = fmaf(xkr, rk[s][c], pj[b * NJ + 3 * C + c]);
                dqa[s][c] = fmaf(dp, qg[c], dqa[s][c]);
                dqx[s][c] = fmaf(xqr, qg[c], dqx[s][c]);
                dka[s][c] = fmaf(dp, kg[b][c], dka[s][c]);
                dkx[s][c] = fmaf(xkr, kg[b][c], dkx[s][c]);
              }
#pragma unroll
              for (int p = 0; p < GP; ++p) {
                pj[b * NJ + 4 * C + p] = fmaf(sim, dsv[p], pj[b * NJ + 4 * C + p]);
                dve[s][p] = fmaf(sim, dsve[p], dve[s][p]);
              }
            }
#pragma unroll
            for (int x = 0; x < NI; ++x) sp_i[(ai * NI + x) * T + I] += pi[x];
          }
        }
        reduce_scatter<NP>(pj, lane);
#pragma unroll
        for (int e = 0; e < VPL; ++e) {
          const int vi = lane * VPL + e;
          if (vi < NV) sp_j[vi * (T + 1) + J] += pj[e];
        }
      }
      if (active) flush_band<GP>(part, D, L, dqa, dqx, dka, dkx, dve);
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) s64[x] += sacc[x];
    __syncwarp();

    // sums over keys (per query) and over queries (per key) of this row
    float* pi_g = ptr<float>(a, P_PI) + (n * G + g) * L * 4 * C;
    float* pj_g = ptr<float>(a, P_PJ) + (n * G + g) * L * 4 * C;
    bf16* dv = ptr<bf16>(a, P_DV);
    for (int e = lane; e < L * 4 * C; e += 32) {
      const int i = e / (4 * C), x = e - i * 4 * C;
      pi_g[e] = sp_i[((i % R) * NI + x) * T + i / R];
    }
    for (int e = lane; e < L * NJ; e += 32) {
      const int j = e / NJ, x = e - j * NJ;
      const float val = sp_j[((j % R) * NJ + x) * (T + 1) + j / R];
      if (x < 4 * C)
        pj_g[j * 4 * C + x] = val;
      else
        dv[((n * L + j) * G + g) * GP + x - 4 * C] = __float2bfloat16(val);
    }
    __syncwarp();
  }

  // S: the lanes' float64 sums by a fixed tree, then the warps in order
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int o = 16; o; o >>= 1) s64[x] += __shfl_xor_sync(FULL, s64[x], o);
  if (lane == 0)
#pragma unroll
    for (int x = 0; x < 3; ++x) sred[warp * 3 + x] = s64[x];
  __syncthreads();
  if (threadIdx.x < 3) {
    double tot = 0.0;
    for (int w = 0; w < W; ++w) tot += sred[w * 3 + threadIdx.x];
    ptr<double>(a, P_SPART)[(static_cast<long long>(g) * nb + blockIdx.x) * 3 + threadIdx.x] = tot;
  }
}

// e = -a S / M for (term, group) e, M = global rows x L² (as the JAX
// kernel's backward forms it).
__device__ __forceinline__ void form_e(const Args& a, int e, double s) {
  const int L = a.d[D_L];
  const double m = static_cast<double>(a.d[D_GROWS]) * L * L;
  const float* cst = ptr<const float>(a, P_CONSTS);
  ptr<float>(a, P_E)[e] = static_cast<float>(-(static_cast<double>(cst[e]) * s) / m);
}

// One block: S per (term, group) over the bwd blocks in order; d_gamma = S,
// then e (split calls: S to the sums, e by s_finish from every rank's S).
__global__ void __launch_bounds__(THREADS) axial_train_fin_kernel(const Args a) {
  const int G = a.d[D_G], nb = a.d[D_BBLOCKS];
  const double* part = ptr<const double>(a, P_SPART);  // [G][nb][3]
  for (int e = threadIdx.x; e < 3 * G; e += blockDim.x) {
    const int t = e / G, g = e - t * G;
    double s = 0.0;
    for (int b = 0; b < nb; ++b) s += part[(static_cast<long long>(g) * nb + b) * 3 + t];
    ptr<float>(a, P_DGAMMA)[e] = static_cast<float>(s);
    if (a.d[D_SPLIT])
      ptr<double>(a, P_S_SUMS)[e] = s;
    else
      form_e(a, e, s);
  }
}

// Split calls: e from S summed over every rank.
__global__ void __launch_bounds__(THREADS) axial_train_s_finish_kernel(const Args a) {
  const int G = a.d[D_G];
  const double* sums = ptr<const double>(a, P_S_SUMS);
  for (int e = threadIdx.x; e < 3 * G; e += blockDim.x) form_e(a, e, sums[e]);
}

// Blocks [0, elem_blocks): d_q, d_k, d_qg, d_kg = a (dpre part) + e (x̂ part),
// bf16. The rest: 8 columns of one row of d_relative each, the bwd blocks'
// partials summed in 32 fixed slices and the slices in order.
__global__ void __launch_bounds__(THREADS) axial_train_combine_kernel(const Args a) {
  const int G = a.d[D_G], GP = a.d[D_GP], C = GP / 2, L = a.d[D_L], ks = a.d[D_KS];
  const int nb = a.d[D_BBLOCKS], elem_blocks = a.d[D_ROWS];
  const long long N = a.d[D_N];
  const float* cst = ptr<const float>(a, P_CONSTS);
  const float* e = ptr<const float>(a, P_E);
  if (static_cast<int>(blockIdx.x) < elem_blocks) {
    const float* pi = ptr<const float>(a, P_PI);
    const float* pj = ptr<const float>(a, P_PJ);
    const long long total = N * L * G * C;
    for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; x < total;
         x += static_cast<long long>(elem_blocks) * blockDim.x) {
      const int c = static_cast<int>(x % C), g = static_cast<int>((x / C) % G);
      const long long nl = x / (C * G), n = nl / L, i = nl % L;
      const long long src = ((n * G + g) * L + i) * 4 * C;
      const float* P = pi + src;
      const float* Q = pj + src;
      ptr<bf16>(a, P_DQ)[x] = __float2bfloat16(cst[g] * P[c] + e[g] * P[C + c]);
      ptr<bf16>(a, P_DQG)[x] =
          __float2bfloat16(cst[G + g] * P[2 * C + c] + e[G + g] * P[3 * C + c]);
      ptr<bf16>(a, P_DK)[x] = __float2bfloat16(cst[g] * Q[c] + e[g] * Q[C + c]);
      ptr<bf16>(a, P_DKG)[x] =
          __float2bfloat16(cst[2 * G + g] * Q[2 * C + c] + e[2 * G + g] * Q[3 * C + c]);
    }
    return;
  }
  __shared__ float slices[32][8];
  const int width = 2 * ks - 1, per_row = ceil_div(width, 8);
  const int blk = blockIdx.x - elem_blocks, r = blk / per_row;
  const int col = (blk - r * per_row) * 8 + (threadIdx.x & 7), slice = threadIdx.x >> 3;
  const int o = col - (ks - 1), w2 = 2 * L - 1, NJ = 4 * C + GP;
  float s = 0.f;
  if (col < width && o > -L && o < L) {
    // table row r: q rows (dpre, x̂ parts with a_qr, e_qr), k rows (a_kr, e_kr), v rows
    const int t = r < C ? 1 : 2, c = r < GP ? r % C : r - GP;
    const int ra = r < C ? c : r < GP ? 2 * C + c : 4 * C + c;
    const float* part = ptr<const float>(a, P_DRELP);
    for (int b = slice; b < G * nb; b += 32) {
      const float* pb = part + static_cast<long long>(b) * NJ * w2;
      const int g = b / nb;
      if (r < GP)
        s += cst[t * G + g] * pb[ra * w2 + o + L - 1] +
             e[t * G + g] * pb[(ra + C) * w2 + o + L - 1];
      else
        s += pb[ra * w2 + o + L - 1];
    }
  }
  slices[slice][threadIdx.x & 7] = s;
  __syncthreads();
  if (threadIdx.x < 8 && col < width) {
    float tot = 0.f;
    for (int i = 0; i < 32; ++i) tot += slices[i][threadIdx.x];
    ptr<float>(a, P_DREL)[r * width + col] = tot;
  }
}

size_t fwd_smem(int kind, int gp, int L, int units) {
  const int R = r_fwd(gp), T = ceil_div(L, R), LP = R * T, C = gp / 2;
  const int nch = kind == STATS ? 4 * C : 4 * C + gp, nrel = kind == STATS ? 2 * C : 2 * gp;
  const size_t floats =
      static_cast<size_t>(nrel) * 2 * LP + static_cast<size_t>(units) * (round32(nch * LP) + (T & 31));
  return 4 * floats + (kind == STATS ? 8 * THREADS * 6 : 0);
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t bytes, const Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int GP>
int by_kind(int kind, const Args& a, cudaStream_t stream) {
  const int G = a.d[D_G], L = a.d[D_L];
  const dim3 grid(a.d[D_BLOCKS], G);
  switch (kind) {
    case STATS:
      return launch(axial_train_stats_kernel<GP>, grid, THREADS,
                    fwd_smem(STATS, GP, L, a.d[D_ROWS]), a, stream);
    case FWD:
      return launch(axial_train_fwd_kernel<GP>, grid, THREADS, fwd_smem(FWD, GP, L, a.d[D_ROWS]),
                    a, stream);
    case BWD:
      return launch(axial_train_bwd_kernel<GP>, grid, 32 * a.d[D_WARPS],
                    BwdGeom<GP>(L).smem(a.d[D_WARPS]), a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of one block of grid `kind` (0 stats, 1 fwd: `per` units per
// block; 2 bwd: `per` warps), as axial_train.py::plan carves it.
extern "C" long long axial_train_smem(int kind, int gp, int L, int per) {
  switch (gp) {
    case 2: return kind == BWD ? BwdGeom<2>(L).smem(per) : fwd_smem(kind, gp, L, per);
    case 4: return kind == BWD ? BwdGeom<4>(L).smem(per) : fwd_smem(kind, gp, L, per);
    case 8: return kind == BWD ? BwdGeom<8>(L).smem(per) : fwd_smem(kind, gp, L, per);
    case 16: return kind == BWD ? BwdGeom<16>(L).smem(per) : fwd_smem(kind, gp, L, per);
    case 32: return kind == BWD ? BwdGeom<32>(L).smem(per) : fwd_smem(kind, gp, L, per);
    default: return -1;
  }
}

// C interface, loaded with ctypes. One grid `kind` (0 stats, 1 fwd, 2 bwd,
// 3 fin, 4 combine; split calls 5 stats_finish, 6 s_finish) of one axis pass. ptrs: the NPTR pointers of `Ptr`
// (unused ones may be null); strides: (row, position, group) element strides
// of q, k, qg, kg, v, dsv, dsve; dims: the NDIM integers of `Dim`. Returns the
// CUDA error code (0 when the launch was accepted).
extern "C" int axial_train(int kind, void* const* ptrs, const long long* strides, const int* dims,
                           float eps, void* stream_ptr) {
  Args a;
  for (int i = 0; i < NPTR; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < NDIM; ++i) a.d[i] = dims[i];
  for (int w = 0; w < 7; ++w)
    a.in[w] = Operand{static_cast<const bf16*>(ptrs[P_Q + w]), strides[3 * w], strides[3 * w + 1],
                      strides[3 * w + 2]};
  a.eps = eps;
  const int L = a.d[D_L], gp = a.d[D_GP];
  if (kind < STATS || kind > S_FINISH || L < 1 || L > MAX_L || L > a.d[D_KS] || a.d[D_N] < 1 ||
      a.d[D_G] < 1 || a.d[D_BLOCKS] < 1 || a.d[D_WARPS] < 1 || a.d[D_WARPS] > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kind == FIN) return launch(axial_train_fin_kernel, dim3(1), THREADS, 0, a, stream);
  if (kind == STATS_FINISH)
    return launch(axial_train_stats_finish_kernel, dim3(1), THREADS, 0, a, stream);
  if (kind == S_FINISH)
    return launch(axial_train_s_finish_kernel, dim3(1), THREADS, 0, a, stream);
  if (kind == COMBINE)
    return launch(axial_train_combine_kernel, dim3(a.d[D_BLOCKS]), THREADS, 0, a, stream);
  switch (gp) {
    case 2: return by_kind<2>(kind, a, stream);
    case 4: return by_kind<4>(kind, a, stream);
    case 8: return by_kind<8>(kind, a, stream);
    case 16: return by_kind<16>(kind, a, stream);
    case 32: return by_kind<32>(kind, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
