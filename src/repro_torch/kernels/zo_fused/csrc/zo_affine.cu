// K1 zo_affine: y = a*x + b*z(seed, flat index), z regenerated in registers.
//
// Replaces the Pallas TPU kernel zo_affine_2d
// (src/repro/kernels/zo_fused/kernel.py:233, _zo_affine_kernel/_tile_affine).
//
// The z stream is specified to the bit and must equal JAX's: a murmur3
// counter hash of (seed, flat index) feeding a polynomial Box-Muller (or the
// sign of one stream for rademacher).  Every float op is spelled out with a
// correctly rounded intrinsic and this file is compiled with -fmad=false, so
// the compiler contracts nothing on its own; __fmaf_rn appears exactly where
// the reference graphs fuse a multiply-add (each Horner step of the log and
// cos polynomials, fma(e, LN2, log_m), and the affine combine
// fma(a, x, round(b*z))).  The plain torch version in kernel.py is the same
// arithmetic with an exact FMA emulation.
//
// Bound on the H100: each element is read once and written once (4 bytes in
// bf16, 8 in f32) against ~62 f32 flops and ~26 integer hash ops of the
// gaussian stream, so in bf16 the CUDA-core rate (67 TFLOP/s) and memory
// (3.35 TB/s) bound it about equally.  Design: one element per thread per grid-stride
// step, no shared memory, no z in memory at all; the counter is the flat
// index of the unpadded leaf as uint32, so there is no padded view and the
// write may go in place (x == y).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

// f32 constants, bit-exact copies of jnp.float32(<double literal>)
__device__ __forceinline__ float bits(uint32_t u) { return __uint_as_float(u); }

__device__ __forceinline__ uint32_t murmur_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float counter_uniform(uint32_t idx, uint32_t seed,
                                                 uint32_t salt) {
  uint32_t h = idx * 0x9E3779B1u;
  h ^= seed * 0x7FEB352Du;
  h += salt * 0x846CA68Bu;
  h = murmur_mix(h);
  float u = __uint2float_rn(h >> 8);  // exact: < 2^24
  return __fadd_rn(__fmul_rn(u, 5.9604644775390625e-08f),   // 2^-24
                   2.98023223876953125e-08f);                 // 2^-25
}

__device__ __forceinline__ float det_log(float u) {
  uint32_t b = __float_as_uint(u);
  float e = __int2float_rn((int)(b >> 23) - 127);
  float m = __uint_as_float((b & 0x007FFFFFu) | 0x3F800000u);
  float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  float s2 = __fmul_rn(s, s);
  float p = bits(0x3d9d89d9u);                   // 1/13
  p = __fmaf_rn(p, s2, bits(0x3dba2e8cu));       // 1/11
  p = __fmaf_rn(p, s2, bits(0x3de38e39u));       // 1/9
  p = __fmaf_rn(p, s2, bits(0x3e124925u));       // 1/7
  p = __fmaf_rn(p, s2, bits(0x3e4ccccdu));       // 1/5
  p = __fmaf_rn(p, s2, bits(0x3eaaaaabu));       // 1/3
  p = __fmaf_rn(p, s2, 1.0f);
  float log_m = __fmul_rn(2.0f, __fmul_rn(s, p));
  return __fmaf_rn(e, bits(0x3f317218u), log_m);   // + e*ln2
}

__device__ __forceinline__ float det_cos2pi(float t) {
  float t4 = __fmul_rn(t, 4.0f);                 // exact
  float k = floorf(t4);                          // exact
  float f = __fsub_rn(t4, k);                    // exact
  float phi = __fmul_rn(f, bits(0x3fc90fdbu));   // pi/2
  float p2 = __fmul_rn(phi, phi);
  float c = bits(0xad49cba5u);
  c = __fmaf_rn(c, p2, bits(0x310f76c7u));
  c = __fmaf_rn(c, p2, bits(0xb493f27eu));
  c = __fmaf_rn(c, p2, bits(0x37d00d01u));
  c = __fmaf_rn(c, p2, bits(0xbab60b61u));
  c = __fmaf_rn(c, p2, bits(0x3d2aaaabu));
  c = __fmaf_rn(c, p2, -0.5f);
  c = __fmaf_rn(c, p2, 1.0f);
  float s = bits(0x2f309231u);
  s = __fmaf_rn(s, p2, bits(0xb2d7322bu));
  s = __fmaf_rn(s, p2, bits(0x3638ef1du));
  s = __fmaf_rn(s, p2, bits(0xb9500d01u));
  s = __fmaf_rn(s, p2, bits(0x3c088889u));
  s = __fmaf_rn(s, p2, bits(0xbe2aaaabu));
  s = __fmaf_rn(s, p2, 1.0f);
  s = __fmul_rn(phi, s);
  int ki = ((int)k) & 3;
  return ki == 0 ? c : (ki == 1 ? -s : (ki == 2 ? -c : s));
}

template <int DIST>
__device__ __forceinline__ float z_at(uint32_t idx, uint32_t seed) {
  if (DIST == 1) {  // rademacher: sign of the salt-1 stream
    return counter_uniform(idx, seed, 1u) >= 0.5f ? 1.0f : -1.0f;
  }
  float u1 = counter_uniform(idx, seed, 1u);
  float u2 = counter_uniform(idx, seed, 2u);
  float t = __fmul_rn(-2.0f, det_log(u1));
  float r = __fsqrt_rn(fmaxf(t, 0.0f));
  return __fmul_rn(r, det_cos2pi(u2));
}

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load(const __half* p, int64_t i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
}

template <typename T, int DIST>
__global__ void zo_affine_kernel(const T* x, T* y, int64_t n, uint32_t seed,
                                 float a, float b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float z = z_at<DIST>((uint32_t)i, seed);
    store(y, i, __fmaf_rn(a, load(x, i), __fmul_rn(b, z)));
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
