// K6 zo_sqnorm: ||z(seed)[0:n]||^2 as one f32, z never in memory.
//
// Replaces the Pallas TPU kernel zo_sqnorm_2d
// (src/repro/kernels/zo_fused/multi.py:200), pass 1 of the sphere rescale.
//
// The TPU ran its grid in order and carried the sum from one tile to the
// next (@pl.when(i == 0) init, then add).  Blocks here run in parallel, and
// float atomics would make the sum change from run to run, so the order is
// fixed in two passes - the order the plain version in multi.py repeats:
//
//   1. one block of 1024 threads per tile of 256*512 = 131072 elements (the
//      TPU's tile); thread t adds z^2 at tile offsets t, t+1024, ...,
//      t+127*1024 in that order into an f32 register starting at 0
//      (elements at or past n add +0); then the 1024 partials are halved in
//      shared memory: s[t] += s[t+h] for h = 512, 256, ..., 1;
//   2. one thread folds the tile partials in tile order in f32.
//
// Inside a tile XLA chose its own order for jnp.sum, so K6 agrees with
// JAX's zo_sqnorm_ref within a stated relative tolerance, and with its plain
// version bitwise.  z and z^2 are zo_stream.cuh's (the gaussian stream the
// affine kernels read).
//
// Bound on the H100: no tensor is read or written (a 4-byte partial per
// tile), ~66 f32 flops per element: operations bound at 67 TFLOP/s.
#include "zo_stream.cuh"

#define TILE_ELEMS 131072
#define TILE_THREADS 1024
#define PER_THREAD (TILE_ELEMS / TILE_THREADS)

namespace {

template <int DIST>
__global__ void __launch_bounds__(TILE_THREADS)
tile_sums(float* partials, int64_t n, uint32_t seed) {
  __shared__ float s[TILE_THREADS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * TILE_ELEMS + t;
  float acc = 0.0f;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t i = base + (int64_t)k * TILE_THREADS;
    float sq = 0.0f;
    if (i < n) {
      float z = zo::z_at<DIST>((uint32_t)i, seed);
      sq = __fmul_rn(z, z);
    }
    acc = __fadd_rn(acc, sq);
  }
  s[t] = acc;
  __syncthreads();
  for (int h = TILE_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
    __syncthreads();
  }
  if (t == 0) partials[blockIdx.x] = s[0];
}

__global__ void fold_tiles(const float* partials, int64_t tiles, float* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float acc = partials[0];
  for (int64_t i = 1; i < tiles; ++i) acc = __fadd_rn(acc, partials[i]);
  out[0] = acc;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// partials: ceil(n / TILE_ELEMS) floats of scratch; out: one float.
// dist: 0 = gaussian, 1 = rademacher.
int zo_sqnorm(float* partials, float* out, int64_t n, uint32_t seed, int dist,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || (dist != 0 && dist != 1)) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + TILE_ELEMS - 1) / TILE_ELEMS;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (dist == 0)
    tile_sums<0><<<(unsigned)tiles, TILE_THREADS, 0, s>>>(partials, n, seed);
  else
    tile_sums<1><<<(unsigned)tiles, TILE_THREADS, 0, s>>>(partials, n, seed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_tiles<<<1, 32, 0, s>>>(partials, tiles, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
