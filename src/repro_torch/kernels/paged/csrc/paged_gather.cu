// K12 paged_gather: out[l, i*block:(i+1)*block, :] = x[l, table[i]*block : ..., :]
//
// Replaces the Pallas TPU kernel paged_gather
// (src/repro/kernels/paged/gather.py:54, _gather_kernel).
//
// A pure copy, so it is bitwise-equal to the plain gather by construction.
// Bound on the H100: bytes only — every gathered row is read once and
// written once (2 * L * n * block * row_bytes) at 3.35 TB/s.  Design: one CTA
// per (table entry, layer); the CTA reads its block id from the table in
// device memory and streams the block's contiguous block*row_bytes bytes with
// 16-byte vector loads and stores (a byte loop covers sizes that are not a
// multiple of 16).  No shared memory, nothing allocated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_kernel(const uint8_t* x, const int32_t* table,
                              uint8_t* out, int64_t nt, int n, int block,
                              int64_t row_bytes, int vec) {
  const int i = blockIdx.x;
  const int l = blockIdx.y;
  const int64_t chunk = (int64_t)block * row_bytes;
  const int64_t t = table[i];
  const uint8_t* src = x + (int64_t)l * nt * row_bytes + t * chunk;
  uint8_t* dst = out + ((int64_t)l * n + i) * chunk;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t j = threadIdx.x; j < chunk / 16; j += blockDim.x) d4[j] = s4[j];
  } else {
    for (int64_t j = threadIdx.x; j < chunk; j += blockDim.x) dst[j] = src[j];
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (L, nt, row) and out (L, n*block, row) are contiguous, row_bytes wide
// rows; table (n,) int32 block ids in [0, nt / block) on the device.
int paged_gather(const void* x, const int32_t* table, void* out, int L,
                 int64_t nt, int n, int block, int64_t row_bytes,
                 void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const int64_t chunk = (int64_t)block * row_bytes;
  const int vec = (chunk % 16 == 0) && ((uintptr_t)x % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  dim3 grid((unsigned)n, (unsigned)L);
  gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, table, (uint8_t*)out, nt, n, block, row_bytes, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
