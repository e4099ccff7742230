// K1 zo_affine: y = a*x + b*z(seed, flat index), z regenerated in registers.
//
// Replaces the Pallas TPU kernel zo_affine_2d
// (src/repro/kernels/zo_fused/kernel.py:233, _zo_affine_kernel/_tile_affine).
//
// The z stream and the affine combine live in zo_stream.cuh, shared with the
// multi-seed kernels (zo_multi.cu, zo_sqnorm.cu); see there for the bitwise
// recipe (-fmad=false, __fmaf_rn exactly where XLA:CPU fuses).
//
// Bound on the H100: each element is read once and written once (4 bytes in
// bf16, 8 in f32) against ~62 f32 flops and ~26 integer hash ops of the
// gaussian stream, so in bf16 the CUDA-core rate (67 TFLOP/s) and memory
// (3.35 TB/s) bound it about equally.  Design: one element per thread per grid-stride
// step, no shared memory, no z in memory at all; the counter is the flat
// index of the unpadded leaf as uint32, so there is no padded view and the
// write may go in place (x == y).
#include "zo_stream.cuh"

namespace {

template <typename T, int DIST>
__global__ void zo_affine_kernel(const T* x, T* y, int64_t n, uint32_t seed,
                                 float a, float b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float z = zo::z_at<DIST>((uint32_t)i, seed);
    zo::store(y, i, zo::affine(a, zo::load(x, i), b, z));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, uint32_t seed, float a,
                   float b, int dist, cudaStream_t stream) {
  const int threads = 256;
  int64_t want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  if (dist == 0) {
    zo_affine_kernel<T, 0><<<blocks, threads, 0, stream>>>(
        (const T*)x, (T*)y, n, seed, a, b);
  } else {
    zo_affine_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        (const T*)x, (T*)y, n, seed, a, b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16; dist: 0 = gaussian, 1 = rademacher.
int zo_affine(const void* x, void* y, int64_t n, int dtype, uint32_t seed,
              float a, float b, int dist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (dist != 0 && dist != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, n, seed, a, b, dist, s);
    case 1: return (int)launch<__nv_bfloat16>(x, y, n, seed, a, b, dist, s);
    case 2: return (int)launch<__half>(x, y, n, seed, a, b, dist, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
