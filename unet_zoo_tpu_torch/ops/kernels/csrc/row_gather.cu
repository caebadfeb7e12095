// P1: dynamic row gather, out[i, :] = tab[idx[i], :], hand-written for sm_90a.
//
// Replaces unet_zoo_tpu's root probe _probe_gather.py::run (its pallas_call
// gathers rows of a VMEM-resident [4096, 128] f32 table by jnp.take, the
// pattern of the deformable conv's per-pixel corner reads, which K8 does
// in deform.cu). Bound: bytes (each gathered row read once, each output row
// written once, the indices once; no arithmetic) against 3.35 TB/s. Design:
// a warp per output row, each lane moving float4s (one each for C = 128), so
// a row is one 512-byte coalesced read and write; the row's index is read
// once by the warp. An index outside [0, rows) is clamped to the table, so
// no read leaves it (the plain version, index_select, raises instead).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
    row_gather_kernel(const float4* __restrict__ tab, const int* __restrict__ idx,
                      float4* __restrict__ out, int rows, int n, int c4) {
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  int r = __ldg(idx + i);
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  const float4* src = tab + static_cast<size_t>(r) * c4;
  float4* dst = out + static_cast<size_t>(i) * c4;
  for (int q = lane; q < c4; q += 32) dst[q] = __ldg(src + q);
}

}  // namespace

extern "C" {

// tab [rows, C] f32, idx [n] int32, out [n, C] f32; C a multiple of 4.
int row_gather(const void* tab, const void* idx, void* out, int rows, int n, int c,
               void* stream) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  row_gather_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tab), static_cast<const int*>(idx), static_cast<float4*>(out),
      rows, n, c / 4);
  return cudaGetLastError();
}

}  // extern "C"
