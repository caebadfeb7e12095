// K1: the fused UNet decoder stage, written by hand for Hopper (sm_90a).
//
//   up  = bf16(convT2x2s2(y) + bt)
//   out = bf16(relu(scale * conv3x3(concat(up, skip)) + bias))
//
// Replaces unet_zoo_tpu/ops/pallas/fused_up.py::fused_up_concat_conv (the TPU
// kernel; pl.pallas_call at fused_up.py:293). Python wrapper and tile plan:
// unet_zoo_tpu_torch/ops/kernels/fused_up.py.
//
// Bound: at unet's stages (B=8, 256px) each decoder stage is about 86 GFLOP
// (77 of them the 3x3 conv) against 20-120 MB of traffic, far above the
// card's ~295 FLOP/byte ridge: tensor-core operations bound it (the ConvT
// alone is bound by writing up at the last stage).
//
// Form: two persistent grids of one warp-specialised wgmma GEMM (bf16 in,
// f32 accumulate). A block of 288 threads: a producer warp keeps a ring of
// shared-memory stages full by TMA (mbarrier handshakes, no block barrier in
// the k-loop); two consumer warpgroups issue wgmma with both operands read
// from shared memory through 128-byte-swizzled descriptors. Blocks walk the
// tiles round-robin, Co (N) fastest, so neighbouring blocks read the same
// activations from L2 at the same time.
//   1. fused_up_convt_kernel: the ConvT as a GEMM [B*Hc*Wc, Cin] x [Cin, 4Cu]
//      over 128 x 128 tiles, a stage a 64-wide chunk of Cin (2-D maps of y
//      and of the K-major weight); two blocks an SM where Cin <= 256, so
//      that one block's epilogue runs beside the other's mainloop. Columns
//      are packed (a, b, cu): column (a, b, cu) of coarse pixel (m, n)
//      belongs to fine pixel (2m+a, 2n+b).
//   2. fused_up_conv3x3_kernel: the 3x3 conv as an implicit GEMM over tiles
//      of BH x BW fine pixels of one image by BN output channels, K = 9 (Cu
//      + Cs). A stage is one 64-channel chunk and one column shift dx: a 4-D
//      TMA box (64 channels, BW, BH + 2, 1) of up or skip (NHWC) at (c0, w0
//      + dx - 1, h0 - 1, b), and the weight tiles of taps (dy, dx), dy =
//      0..2. The rows of a box are its pixels in row-major order, so tap
//      (dy, dx) of tile pixel r = oh BW + ow is box row r + dy BW: the dy
//      shift is a row offset of whole 8-row swizzle atoms (BW = 16), and
//      wgmma reads all three taps from the one box through aligned
//      descriptors. Each input pixel of a chunk arrives 3 (BH + 2) / BH
//      times (3.75 for 8 x 16 tiles, 3.375 for 16 x 16) instead of 9.
//      Out-of-image halo pixels arrive as zeros from TMA: the padding costs
//      no instruction. Chunks of up come first, then chunks of skip, each
//      from its own tensor map, so the concat never exists; a chunk that
//      passes the end of its tensor (Cu or Cs not a multiple of 64) reads
//      zeros there, which cancel the weight rows of the next channels.
//      Co > 64: 128-pixel tiles by 128 channels, a warpgroup's 64 pixels as
//      wgmma's M (m64n128k16). Co <= 64: 256-pixel tiles, transposed: the
//      64 channels as M and a warpgroup's 128 pixels as N, so a wgmma reads
//      6 KB of shared memory for twice the products m64n64k16 gets from 4 KB
//      (shared-memory bandwidth, wgmma's reads and TMA's writes together,
//      is what the N = 64 form ran out of).
//   Both epilogues stage a warpgroup's tile, 64 channels at a time, in
//   shared memory (144-byte rows: conflict-free) and leave it in 16-byte
//   stores: the ConvT's through the depth-to-space (a row's 64 columns are
//   runs of whole (a, b) phases), the conv's after relu(acc * scale + bias)
//   (conv bias and BatchNorm folded).
//
// Layout: activations NHWC bf16 (torch channels_last); the weights K-major
// bf16: wt_k [4Cu, Cin] (row (a, b, cu)), wc_k [Co, 9 (Cu + Cs)] (K in (dy,
// dx, c) order, up channels first); bt, scale, bias f32. Requirements
// (checked by the wrapper): Cin, Cu, Cs multiples of 32, Co a multiple of 8,
// 16-byte-aligned pointers. Every sum runs in a fixed order and no block
// shares an output: two launches agree bit for bit.
//
// Tensor maps: the activations' (y, up, skip) are encoded at every call;
// the weights' are cached by device, address, shape and box.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

constexpr int KC = 64;         // channels of a K chunk
constexpr int BW = 16;         // CONV3: a tile's width in fine pixels
constexpr int ROW = 2 * KC;    // bytes of a box row: one 128-byte swizzle row
constexpr int THREADS = 288;   // consumer warpgroups 0-1, producer warp 8
constexpr int EPI_LD = 72;     // epilogue staging pitch, bf16 (144 bytes)
constexpr int SMEM_LIMIT = 232448;          // an H100 block's dynamic shared memory
constexpr int SMEM_HALF = 114688;           // a block's share where two share an SM
constexpr int MAX_STAGES = 6;

enum Mode { CONVT = 0, CONV3 = 1 };
// Planted faults, for the card checks only (the entry fused_up_fault): the
// bottom halo row never read (taps dy = 2 read row dy = 1), the weights of
// tap (dx, dy) against the box of (dy, dx), skip's chunks against the weight
// rows one 32-channel chunk later, bt dropped from up.
enum Fault { NONE = 0, HALO_SHORT = 1, TAPS_SWAPPED = 2, BOUNDARY = 3, BT_DROPPED = 4 };

// A tile is BM = 2 PIX output rows (CONV3: BH x BW fine pixels) by BN
// columns; each consumer warpgroup owns PIX rows. PIX 64: the rows are
// wgmma's M and the columns its N (m64nBNk16). PIX 128 (CONV3 with BN 64):
// the transposed product, the tile's 64 output channels as M and a
// warpgroup's 128 pixels as N (m64n128k16), so each wgmma reads 6 KB of
// shared memory for 128 x 64 x 16 products where m64n64k16 reads 4 KB for
// half as many. CTAS: blocks an SM (1 or 2); a second block's mainloop runs
// beside the first one's epilogue.
template <int MODE, int BN, int CTAS>
struct Geometry {
  static constexpr int PIX = MODE == CONV3 && BN == 64 ? 128 : 64;
  static constexpr int BM = 2 * PIX;
  static constexpr int BH = BM / BW;  // CONV3: tile rows
  static constexpr int A_BYTES = MODE == CONV3 ? (BH + 2) * BW * ROW : BM * ROW;
  static constexpr int W_TAP = BN * ROW;
  static constexpr int W_BYTES = (MODE == CONV3 ? 3 : 1) * W_TAP;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int EPI_BYTES = PIX * EPI_LD * 2;  // a warpgroup's staged PIX x 64 tile
  static constexpr int FIT =
      ((CTAS == 1 ? SMEM_LIMIT : SMEM_HALF) - 1024 - 2 * EPI_BYTES) / (STAGE + 16);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * EPI_BYTES + 16 * STAGES;
  static_assert(BW % 8 == 0 && BM % BW == 0, "box rows in whole 8-row swizzle atoms");
  static_assert(A_BYTES % 1024 == 0 && W_TAP % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(BN == 64 || BN == 128, "64 channels (transposed) or 128");
  static_assert(STAGES >= 2 && SMEM <= (CTAS == 1 ? SMEM_LIMIT : SMEM_HALF),
                "a ring of two stages at least");
};

struct Args {
  const float* v0;     // CONVT: bt [Cu]; CONV3: scale [Co]
  const float* v1;     // CONV3: bias [Co]
  __nv_bfloat16* out;  // CONVT: up [B, 2Hc, 2Wc, Cu]; CONV3: out [B, Hf, Wf, Co]
  int M, N;            // CONVT: B Hc Wc, 4 Cu; CONV3: unused, Co
  int H, W;            // CONVT: Hc, Wc; CONV3: Hf, Wf
  int cu, cs;          // channels of up and skip (CONVT: cu only)
  int k_chunks;        // CONVT: 64-wide chunks of Cin; CONV3: chunks of up, then skip
  int chunks_u;        // CONV3: chunks of up
  int tiles, n_tiles;  // tiles in all, tiles along N
  int th, tw;          // CONV3: tiles along H and W
};

// Where tile `tile` lies: CONV3 (b, h0, w0, n0), CONVT (m0, n0); Co fastest.
template <int MODE, int BN, int BM>
__device__ __forceinline__ void tile_origin(const Args& p, int tile, int& b, int& h0, int& w0,
                                            int& n0) {
  n0 = (tile % p.n_tiles) * BN;
  int r = tile / p.n_tiles;
  if (MODE == CONV3) {
    w0 = (r % p.tw) * BW;
    r /= p.tw;
    h0 = (r % p.th) * (BM / BW);
    b = r / p.th;
  } else {
    b = 0;
    h0 = r * BM;  // m0
    w0 = 0;
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&acc)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 128)
    wgmma_bf16_n128(acc, a, b);
  else
    wgmma_bf16_n64(acc, a, b);
}

template <int MODE, int BN, int CTAS, int FAULT>
__device__ __forceinline__ void fused_up_body(const CUtensorMap* map_a0, const CUtensorMap* map_a1,
                                              const CUtensorMap* map_w, const Args& p) {
  using G = Geometry<MODE, BN, CTAS>;
  constexpr int PIX = G::PIX;
  constexpr bool TRANSPOSED = PIX == 128;
  constexpr int ACC = TRANSPOSED ? 64 : BN / 2;  // f32 accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(ring + G::STAGES * G::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE + 2 * G::EPI_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int steps = MODE == CONV3 ? 3 * p.k_chunks : p.k_chunks;
  const int c2 = p.cu + p.cs;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: one lane issues every load
    if (threadIdx.x != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int b, h0, w0, n0;
      tile_origin<MODE, BN, G::BM>(p, tile, b, h0, w0, n0);
      for (int step = 0; step < steps; ++step) {
        mbar_wait<true>(&empty[s], ph ^ 1);
        unsigned char* a = ring + s * G::STAGE;
        unsigned char* w = a + G::A_BYTES;
        mbar_arrive_expect_tx(&full[s], G::STAGE);
        if constexpr (MODE == CONV3) {
          const int chunk = step / 3, dx = step - 3 * chunk;
          const bool from_up = chunk < p.chunks_u;
          const int c0 = (from_up ? chunk : chunk - p.chunks_u) * KC;
          int kbase = from_up ? c0 : p.cu + c0;
          if (FAULT == BOUNDARY && !from_up) kbase += 32;
          tma_load_4d(a, from_up ? map_a0 : map_a1, &full[s], c0, w0 + dx - 1, h0 - 1, b);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int tap = FAULT == TAPS_SWAPPED ? 3 * dx + dy : 3 * dy + dx;
            tma_load_2d(w + dy * G::W_TAP, map_w, &full[s], tap * c2 + kbase, n0);
          }
        } else {
          tma_load_2d(a, map_a0, &full[s], step * KC, h0);
          tma_load_2d(w, map_w, &full[s], step * KC, n0);
        }
        if (++s == G::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  __nv_bfloat16* buf = epi + wg * PIX * EPI_LD;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int b, h0, w0, n0;
    tile_origin<MODE, BN, G::BM>(p, tile, b, h0, w0, n0);
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int step = 0; step < steps; ++step) {
      mbar_wait(&full[s], ph);
      const uint32_t a = smem_addr(ring + s * G::STAGE);
      const uint32_t w = a + G::A_BYTES;
      fence_regs(acc);
      wgmma_fence();
      if constexpr (MODE == CONV3) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int shift = FAULT == HALO_SHORT && dy == 2 ? 1 : dy;
          const uint32_t px = a + (PIX * wg + shift * BW) * ROW;  // this warpgroup's pixels
          const uint32_t wt = w + dy * G::W_TAP;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (TRANSPOSED)
              wgmma_tile<128>(acc, sw128_desc(wt + 32 * k), sw128_desc(px + 32 * k));
            else
              wgmma_tile<BN>(acc, sw128_desc(px + 32 * k), sw128_desc(wt + 32 * k));
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_tile<BN>(acc, sw128_desc(a + 64 * wg * ROW + 32 * k), sw128_desc(w + 32 * k));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      // the group that read the previous stage has completed
      if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == G::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) mbar_arrive(&empty[prev]);

    // Epilogue: the warpgroup's PIX rows go through its staging tile 64
    // columns at a time. A thread then stores 16-byte chunk t % 8 of staged
    // rows t / 8 + 16 i: their destinations (pixel offsets, -1 outside the
    // output) are found once a tile.
    constexpr int RI = PIX / 16;
    long long dst_row[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = PIX * wg + (t >> 3) + 16 * i;
      dst_row[i] = -1;
      if (MODE == CONV3) {
        const int h = h0 + r / BW, x = w0 + r % BW;
        if (h < p.H && x < p.W) dst_row[i] = (static_cast<long long>(b) * p.H + h) * p.W + x;
      } else {
        const int m = h0 + r;
        if (m < p.M) {
          const int wc = m % p.W, q = m / p.W, hc = q % p.H, bb = q / p.H;
          // fine pixel (2 hc, 2 wc) of image bb; phase (a, b) adds a 2W + b
          dst_row[i] = (static_cast<long long>(bb) * 2 * p.H + 2 * hc) * 2 * p.W + 2 * wc;
        }
      }
    }
#pragma unroll
    for (int half = 0; half < BN / 64; ++half) {
      named_barrier(1 + wg, 128);  // the staging tile's last reads are done
      if constexpr (TRANSPOSED) {
        // register 4 j + e: channel 16 warp + lane / 4 + 8 (e / 2), pixel 8 j
        // + 2 (lane % 4) + e % 2
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = 16 * warp + (lane >> 2) + 8 * e2, n = n0 + col;
          const float mul = n < p.N ? __ldg(p.v0 + n) : 0.f;
          const float add = n < p.N ? __ldg(p.v1 + n) : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = 8 * j + 2 * (lane & 3) + e;
              buf[row * EPI_LD + col] =
                  __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * e2 + e] * mul + add, 0.f));
            }
        }
      } else {
        // register 4 j + e: row 16 warp + lane / 4 + 8 (e / 2), column 8 j +
        // 2 (lane % 4) + e % 2
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * half + jj;
          const int col = 8 * jj + 2 * (lane & 3);
          const int n = n0 + 64 * half + col;
          float2 mul = make_float2(1.f, 1.f), add = make_float2(0.f, 0.f);
          if (MODE == CONV3 && n < p.N) {
            mul = __ldg(reinterpret_cast<const float2*>(p.v0 + n));
            add = __ldg(reinterpret_cast<const float2*>(p.v1 + n));
          } else if (MODE == CONVT && FAULT != BT_DROPPED) {
            add = __ldg(reinterpret_cast<const float2*>(p.v0 + n % p.cu));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h] * mul.x + add.x;
            float v1 = acc[4 * j + 2 * h + 1] * mul.y + add.y;
            if (MODE == CONV3) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const int row = 16 * warp + (lane >> 2) + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(buf + row * EPI_LD + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      named_barrier(1 + wg, 128);
      const int ch = t & 7, n = n0 + 64 * half + 8 * ch;
      long long col = n;  // CONV3: the channel; CONVT: the phase's pixel step and cu
      if (MODE == CONVT) {
        const int phase = n / p.cu;
        col = (static_cast<long long>(phase >> 1) * 2 * p.W + (phase & 1)) * p.cu + n -
              phase * p.cu;
      }
      if (n < p.N) {
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          if (dst_row[i] < 0) continue;
          const int row = (t >> 3) + 16 * i;
          *reinterpret_cast<uint4*>(p.out + dst_row[i] * (MODE == CONV3 ? p.N : p.cu) + col) =
              *reinterpret_cast<const uint4*>(buf + row * EPI_LD + 8 * ch);
        }
      }
    }
  }
}

template <int CTAS, int FAULT>
__global__ void __launch_bounds__(THREADS, CTAS)
    fused_up_convt_kernel(const __grid_constant__ CUtensorMap map_y,
                          const __grid_constant__ CUtensorMap map_w, const Args p) {
  fused_up_body<CONVT, 128, CTAS, FAULT>(&map_y, &map_y, &map_w, p);
}

template <int BN, int FAULT>
__global__ void __launch_bounds__(THREADS, 1)
    fused_up_conv3x3_kernel(const __grid_constant__ CUtensorMap map_up,
                            const __grid_constant__ CUtensorMap map_skip,
                            const __grid_constant__ CUtensorMap map_w, const Args p) {
  fused_up_body<CONV3, BN, 1, FAULT>(&map_up, &map_skip, &map_w, p);
}

// ---- host side -------------------------------------------------------------------

enum HostError { NO_ENCODER = 1001, ENCODE_FAILED = 1002, BAD_PLAN = 1003, BAD_DEVICE = 1005 };
constexpr int MAX_DEVICES = 64;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 map of `rank` dims (innermost first; strides in bytes of dims 1..)
// read in boxes whose rows are 128-byte swizzled; elements outside the
// tensor arrive as zeros.
int encode(CUtensorMap* out, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled fn = nullptr;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> guard(lock);
    if (fn == nullptr) {
      void* f = nullptr;
      cudaDriverEntryPointQueryResult found;
      if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
              cudaSuccess ||
          found != cudaDriverEntryPointSuccess || f == nullptr)
        return NO_ENCODER;
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ENCODE_FAILED;
}

// A K-contiguous matrix [rows, cols] in boxes of 64 x box_rows.
int matrix_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {KC, box_rows};
  return encode(out, ptr, 2, dims, strides, box);
}

// The packed weights' maps, cached: a map is a function of exactly the
// device, address, shape and box, so a hit is always right.
int weight_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  static std::mutex lock;
  static std::map<std::tuple<int, uintptr_t, uint64_t, uint64_t, uint32_t>, CUtensorMap> cache;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return BAD_DEVICE;
  const auto key =
      std::make_tuple(device, reinterpret_cast<uintptr_t>(ptr), rows, cols, box_rows);
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  const int err = matrix_map(out, ptr, rows, cols, box_rows);
  if (err) return err;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

// An NHWC tensor [B, H, W, C] in boxes of (64 channels, bw, bh, 1).
int nhwc_map(CUtensorMap* out, const void* ptr, int b, int h, int w, int c, int bw, int bh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * c;
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {KC, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), 1};
  return encode(out, ptr, 4, dims, strides, box);
}

// Sets a kernel's dynamic shared memory, and the largest shared-memory
// carveout (so that two blocks of half the memory share an SM), once per
// device.
template <typename Kernel>
int prepare(Kernel kernel, int bytes, std::atomic<bool>* ready) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return BAD_DEVICE;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return 0;
}

struct Shape {
  int batch, hc, wc, cin, cu, cs, co;
};

template <int CTAS, int FAULT>
int launch_convt(const void* y, const void* wt_k, const float* bt, void* up, const Shape& d,
                 int grid, cudaStream_t stream) {
  using G = Geometry<CONVT, 128, CTAS>;
  static std::atomic<bool> ready[MAX_DEVICES];
  int err = prepare(fused_up_convt_kernel<CTAS, FAULT>, G::SMEM, ready);
  if (err) return err;
  Args p{};
  p.v0 = bt;
  p.out = static_cast<__nv_bfloat16*>(up);
  p.M = d.batch * d.hc * d.wc;
  p.N = 4 * d.cu;
  p.H = d.hc;
  p.W = d.wc;
  p.cu = d.cu;
  p.k_chunks = (d.cin + KC - 1) / KC;
  p.n_tiles = (p.N + 127) / 128;
  p.tiles = ((p.M + G::BM - 1) / G::BM) * p.n_tiles;
  CUtensorMap my, mw;
  if ((err = matrix_map(&my, y, p.M, d.cin, G::BM))) return err;
  if ((err = weight_map(&mw, wt_k, p.N, d.cin, 128))) return err;
  fused_up_convt_kernel<CTAS, FAULT><<<grid, THREADS, G::SMEM, stream>>>(my, mw, p);
  return cudaGetLastError();
}

template <int BN, int FAULT>
int launch_conv3(const void* up, const void* skip, const void* wc_k, const float* scale,
                 const float* bias, void* out, const Shape& d, int grid, cudaStream_t stream) {
  using G = Geometry<CONV3, BN, 1>;
  static std::atomic<bool> ready[MAX_DEVICES];
  int err = prepare(fused_up_conv3x3_kernel<BN, FAULT>, G::SMEM, ready);
  if (err) return err;
  const int hf = 2 * d.hc, wf = 2 * d.wc;
  Args p{};
  p.v0 = scale;
  p.v1 = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = d.co;
  p.H = hf;
  p.W = wf;
  p.cu = d.cu;
  p.cs = d.cs;
  p.chunks_u = (d.cu + KC - 1) / KC;
  p.k_chunks = p.chunks_u + (d.cs + KC - 1) / KC;
  p.n_tiles = (d.co + BN - 1) / BN;
  p.th = (hf + G::BH - 1) / G::BH;
  p.tw = (wf + BW - 1) / BW;
  p.tiles = d.batch * p.th * p.tw * p.n_tiles;
  CUtensorMap mu, ms, mw;
  if ((err = nhwc_map(&mu, up, d.batch, hf, wf, d.cu, BW, G::BH + 2))) return err;
  if ((err = nhwc_map(&ms, skip, d.batch, hf, wf, d.cs, BW, G::BH + 2))) return err;
  if ((err = weight_map(&mw, wc_k, d.co, 9 * (d.cu + d.cs), BN))) return err;
  fused_up_conv3x3_kernel<BN, FAULT><<<grid, THREADS, G::SMEM, stream>>>(mu, ms, mw, p);
  return cudaGetLastError();
}

// The ConvT's blocks an SM (1 or 2) and the conv's tile width (64 or 128),
// each grid's persistent blocks.
struct Plan {
  int ctas_t, grid_t, bn_c, grid_c;
};

template <int FAULT>
int conv3_for(const Plan& pl, const void* up, const void* skip, const void* wc_k,
              const float* scale, const float* bias, void* out, const Shape& d,
              cudaStream_t stream) {
  if (pl.bn_c == 128)
    return launch_conv3<128, FAULT>(up, skip, wc_k, scale, bias, out, d, pl.grid_c, stream);
  if (pl.bn_c == 64)
    return launch_conv3<64, FAULT>(up, skip, wc_k, scale, bias, out, d, pl.grid_c, stream);
  return BAD_PLAN;
}

int forward(int fault, const void* y, const void* wt_k, const float* bt, const void* skip,
            const void* wc_k, const float* scale, const float* bias, void* up, void* out,
            const Shape& d, const Plan& pl, cudaStream_t stream) {
  if (pl.grid_t < 1 || pl.grid_c < 1 || (pl.ctas_t != 1 && pl.ctas_t != 2)) return BAD_PLAN;
  int err;
  if (fault == BT_DROPPED)
    err = pl.ctas_t == 1 ? launch_convt<1, BT_DROPPED>(y, wt_k, bt, up, d, pl.grid_t, stream)
                         : launch_convt<2, BT_DROPPED>(y, wt_k, bt, up, d, pl.grid_t, stream);
  else
    err = pl.ctas_t == 1 ? launch_convt<1, NONE>(y, wt_k, bt, up, d, pl.grid_t, stream)
                         : launch_convt<2, NONE>(y, wt_k, bt, up, d, pl.grid_t, stream);
  if (err) return err;
  switch (fault) {
    case HALO_SHORT:
      return conv3_for<HALO_SHORT>(pl, up, skip, wc_k, scale, bias, out, d, stream);
    case TAPS_SWAPPED:
      return conv3_for<TAPS_SWAPPED>(pl, up, skip, wc_k, scale, bias, out, d, stream);
    case BOUNDARY:
      return conv3_for<BOUNDARY>(pl, up, skip, wc_k, scale, bias, out, d, stream);
    case NONE:
    case BT_DROPPED:
      return conv3_for<NONE>(pl, up, skip, wc_k, scale, bias, out, d, stream);
    default:
      return BAD_PLAN;
  }
}

template <int MODE, int BN, int CTAS>
void geometry(int* out) {
  using G = Geometry<MODE, BN, CTAS>;
  out[0] = G::STAGES;
  out[1] = G::STAGE;
  out[2] = G::A_BYTES;
  out[3] = G::SMEM;
}

}  // namespace

// C interface, loaded with ctypes.

extern "C" {

// The ring of one grid as the source lays it out: {stages, bytes a stage, A
// bytes a stage, dynamic shared memory}; mode 0 the ConvT (bn 128), 1 the
// conv. The wrapper's plan mirrors it. All zero for a grid it has no
// instance of.
void fused_up_geometry(int mode, int bn, int ctas, int* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
  if (mode == CONVT && bn == 128 && ctas == 1) geometry<CONVT, 128, 1>(out);
  if (mode == CONVT && bn == 128 && ctas == 2) geometry<CONVT, 128, 2>(out);
  if (mode == CONV3 && bn == 128 && ctas == 1) geometry<CONV3, 128, 1>(out);
  if (mode == CONV3 && bn == 64 && ctas == 1) geometry<CONV3, 64, 1>(out);
}

// Launches the ConvT grid (y -> up) and the conv grid (up | skip -> out) on
// `stream` and returns the first error (0 when both launches were
// accepted). up [B, 2Hc, 2Wc, Cu] bf16 is scratch from the caller. ctas_t:
// the ConvT's blocks an SM; bn_c: the conv's tile width (64: the transposed
// form); grid_t, grid_c: each grid's persistent blocks.
int fused_up_forward(const void* y, const void* wt_k, const float* bt, const void* skip,
                     const void* wc_k, const float* scale, const float* bias, void* up, void* out,
                     int batch, int hc, int wc, int cin, int cu, int cs, int co, int ctas_t,
                     int grid_t, int bn_c, int grid_c, void* stream) {
  const Shape d{batch, hc, wc, cin, cu, cs, co};
  return forward(NONE, y, wt_k, bt, skip, wc_k, scale, bias, up, out, d,
                 Plan{ctas_t, grid_t, bn_c, grid_c}, static_cast<cudaStream_t>(stream));
}

// Test-only: the same launches with one planted fault (enum Fault, 1-4).
int fused_up_fault(int fault, const void* y, const void* wt_k, const float* bt, const void* skip,
                   const void* wc_k, const float* scale, const float* bias, void* up, void* out,
                   int batch, int hc, int wc, int cin, int cu, int cs, int co, int ctas_t,
                   int grid_t, int bn_c, int grid_c, void* stream) {
  if (fault < HALO_SHORT || fault > BT_DROPPED) return BAD_PLAN;
  const Shape d{batch, hc, wc, cin, cu, cs, co};
  return forward(fault, y, wt_k, bt, skip, wc_k, scale, bias, up, out, d,
                 Plan{ctas_t, grid_t, bn_c, grid_c}, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
