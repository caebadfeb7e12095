// Device helpers shared by the hand-written GEMM kernels (sm_90a): 16-byte
// cp.async with zero fill, ldmatrix, the bf16 mma.sync m16n8k16 tile, and the
// block-tile GEMM main loop of K1 (fused_up.cu).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- block-tile GEMM: acc = A @ W over one BM x BN output tile ---------------
//
// A block of GEMM_THREADS (8 warps) computes a BM x BN tile; each warp owns a
// 64 x 32 sub-tile (16 MMAs per 6 ldmatrix a k-step). A GEMM_NSTAGE-deep
// cp.async ring in shared memory feeds it GEMM_BK-wide chunks of K. W is
// [K, N] bf16 row-major and K a multiple of GEMM_BK; A is whatever the
// caller's loader makes of it (a matrix, an implicit-GEMM gather).

constexpr int GEMM_BK = 32;
constexpr int GEMM_NSTAGE = 4;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_A_LD = GEMM_BK + 8;  // A tile row pitch: 80 B, ldmatrix conflict-free

template <int BM, int BN>
struct GemmTile {
  static_assert((BM / 64) * (BN / 32) * 32 == GEMM_THREADS, "8 warps of 64x32");
  static constexpr int B_LD = BN + 8;  // B tile row pitch, ldmatrix conflict-free
  static constexpr int A_ITERS = BM * GEMM_BK / 8 / GEMM_THREADS;  // 16-byte A chunks a thread
  static constexpr int B_ITERS = GEMM_BK * BN / 8 / GEMM_THREADS;  // 16-byte B chunks a thread
  static constexpr int SMEM = GEMM_NSTAGE * (BM * GEMM_A_LD + GEMM_BK * B_LD) * 2;
  using ATile = __nv_bfloat16[BM][GEMM_A_LD];
  using BTile = __nv_bfloat16[GEMM_BK][B_LD];

  // Loader role: this thread copies the 16 bytes at column a_col() of tile
  // rows a_row(i), i < A_ITERS, of every A chunk.
  __device__ static int a_row(int i) { return (threadIdx.x >> 2) + i * 64; }
  __device__ static int a_col() { return (threadIdx.x & 3) * 8; }
  // Origin of this warp's 64 x 32 sub-tile. Accumulator (i, j, 2*half + e)
  // sits at row warp_row() + 16i + lane/4 + 8*half and column
  // warp_col() + 8j + 2*(lane%4) + e of the block tile.
  __device__ static int warp_row() { return ((threadIdx.x >> 5) / (BN / 32)) * 64; }
  __device__ static int warp_col() { return ((threadIdx.x >> 5) % (BN / 32)) * 32; }
};

// The K loop. `load_a(ATile& tile, int k0)` starts the cp.async copies of
// this thread's A chunks (GemmTile::a_row / a_col) of K chunk [k0, k0 + BK)
// into `tile`; the W chunk is loaded here, columns from n_blk, zero beyond N.
// `smem` holds GemmTile<BM, BN>::SMEM bytes.
template <int BM, int BN, class LoadA>
__device__ __forceinline__ void gemm_mainloop(unsigned char* smem, const __nv_bfloat16* w,
                                              int N, int K, int n_blk, LoadA load_a,
                                              float (&acc)[4][4][4]) {
  using T = GemmTile<BM, BN>;
  using ATile = typename T::ATile;
  using BTile = typename T::BTile;
  ATile* As = reinterpret_cast<ATile*>(smem);
  BTile* Bs = reinterpret_cast<BTile*>(smem + GEMM_NSTAGE * sizeof(ATile));
  const int tid = threadIdx.x;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * GEMM_BK;
    load_a(As[stage], k0);
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i) {
      const int chunk = tid + i * GEMM_THREADS;
      const int row = chunk / (BN / 8);
      const int col = (chunk % (BN / 8)) * 8;
      const int n = n_blk + col;
      const bool ok = n < N;
      const __nv_bfloat16* src = ok ? w + static_cast<size_t>(k0 + row) * N + n : w;
      cp_async16(&Bs[stage][row][col], src, ok);
    }
  };

  const int lane = tid & 31;
  const int wm = T::warp_row();
  const int wn = T::warp_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = K / GEMM_BK;
#pragma unroll
  for (int s = 0; s < GEMM_NSTAGE - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GEMM_NSTAGE - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt-1
    const int nk = kt + GEMM_NSTAGE - 1;
    if (nk < KT) load_tile(nk % GEMM_NSTAGE, nk);
    cp_async_commit();

    const int st = kt % GEMM_NSTAGE;
#pragma unroll
    for (int ks = 0; ks < GEMM_BK; ks += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4(af[i], &As[st][wm + i * 16 + (lane & 15)][ks + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[st][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                            [wn + j2 * 16 + (lane >> 4) * 8]);
        bf[2 * j2][0] = r[0];
        bf[2 * j2][1] = r[1];
        bf[2 * j2 + 1][0] = r[2];
        bf[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();
}

}  // namespace
