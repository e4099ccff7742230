// K12 paged_gather: out[l, i*block:(i+1)*block, :] = x[l, table[i]*block : ..., :]
//
// Replaces the Pallas TPU kernel paged_gather
// (src/repro/kernels/paged/gather.py:54, _gather_kernel).
//
// A pure copy, so it is bitwise-equal to the plain gather by construction.
// Bound on the H100: bytes only — every gathered row is read once and
// written once (2 * L * n * block * row_bytes) at 3.35 TB/s; at one decode
// step of the serving path (512 blocks of 16 rows × 256 B, 24 layers) that
// is 100 MB, 0.030 ms.
//
// The TPU ran one grid step per (layer, entry).  The first port did the
// same with one CTA per item: 12 288 CTAs that each lived about a
// microsecond, waited on a dependent load of table[i], then issued a single
// 16-byte load per thread — the card ran through CTA launches, not bytes.
// Design here: a grid of a few CTAs per SM (sized by the wrapper from the
// SM count) walks the (layer, entry) items with a grid stride, one warp per
// item.  Lane 0 reads the block id through the read-only path and
// broadcasts it with a shuffle; each lane then issues all its 16-byte loads
// of the block's contiguous chunk (8 per lane for a 4 KB chunk) before any
// store, so a warp keeps 4 KB in flight.  Ids are clamped into the pool as
// JAX's dynamic_slice clamps its start, so a device table can never read
// outside it (host tables are checked by the wrapper).  A byte loop covers
// chunks that are not a multiple of 16 bytes or unaligned pointers.  No
// shared memory, nothing allocated.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W (runs of 100 launches in one CUDA graph, device
// table): 0.0378 ms for that decode step, 1.26× the bound; index_select on
// the same table 0.0833 ms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // warps per CTA, one item each at a time
constexpr int UNROLL = 8;    // 16-byte loads per lane in flight

__global__ void __launch_bounds__(32 * WARPS)
gather_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ table,
              uint8_t* __restrict__ out, int64_t nt, int n, int block,
              int64_t row_bytes, int vec, int64_t items) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  const int64_t chunk = (int64_t)block * row_bytes;
  const int nblocks = (int)(nt / block);
  for (int64_t item = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
       item < items; item += warps) {
    const int64_t l = item / n;
    const int i = (int)(item - l * n);
    int t = 0;
    if (lane == 0) t = min(max(__ldg(table + i), 0), nblocks - 1);
    t = __shfl_sync(0xffffffffu, t, 0);
    const uint8_t* src = x + (l * nt + (int64_t)t * block) * row_bytes;
    uint8_t* dst = out + (l * n + i) * chunk;
    if (vec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const int64_t nv = chunk / 16;
      for (int64_t j0 = 0; j0 < nv; j0 += 32 * UNROLL) {
        uint4 r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t j = j0 + u * 32 + lane;
          if (j < nv) r[u] = __ldg(s4 + j);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t j = j0 + u * 32 + lane;
          if (j < nv) d4[j] = r[u];
        }
      }
    } else {
      for (int64_t j = lane; j < chunk; j += 32) dst[j] = src[j];
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (L, nt, row) and out (L, n*block, row) are contiguous, row_bytes wide
// rows; table (n,) int32 block ids on the device (clamped into
// [0, nt / block)); ctas: the grid size the wrapper chose.
int paged_gather(const void* x, const int32_t* table, void* out, int L,
                 int64_t nt, int n, int block, int64_t row_bytes, int ctas,
                 void* stream) {
  if (L <= 0 || n <= 0) return 0;
  if (block <= 0 || nt < block || ctas <= 0) return (int)cudaErrorInvalidValue;
  const int64_t chunk = (int64_t)block * row_bytes;
  const int vec = (chunk % 16 == 0) && ((uintptr_t)x % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const int64_t items = (int64_t)L * n;
  const int64_t need = (items + WARPS - 1) / WARPS;
  const int grid = (int)(need < ctas ? need : ctas);
  gather_kernel<<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, table, (uint8_t*)out, nt, n, block, row_bytes, vec,
      items);
  return (int)cudaGetLastError();
}

}  // extern "C"
