// K1 zo_affine: y = a*x + b*z(seed, flat index), z regenerated in registers.
//
// Replaces the Pallas TPU kernel zo_affine_2d
// (src/repro/kernels/zo_fused/kernel.py:233, _zo_affine_kernel/_tile_affine).
//
// The z stream and the affine combine live in zo_stream.cuh, shared with the
// multi-seed kernels (zo_multi.cu, zo_sqnorm.cu, zo_rows.cu); see there for
// the bitwise recipe (-fmad=false, __fmaf_rn exactly where XLA:CPU fuses)
// and for the rewrites that make z cheaper than its specification.
//
// Bound on the H100: each element is read once and written once (4 bytes in
// bf16, 8 in f32) against ~64 f32 flops of the gaussian stream, so the byte
// and f32 bounds are close (0.75 ms per qwen2-0.5b record); what the card
// actually runs out of is instruction issue — about 100 SASS instructions
// per z at 4 warp-instructions per SM per clock.  Design: each thread takes
// one 16-byte vector per grid-stride step (8 bf16/f16 or 4 f32 elements:
// one load, one store, one bounds test and one address for all of them),
// with a 32-bit index inside the leaf; the vectors' z are independent, which
// gives the scheduler 4-8 chains to interleave.  A scalar head and tail take
// the elements before the first 16-byte boundary and after the last whole
// vector; x and y that lie differently against 16 bytes run all scalar.  The
// grid is sized from the kernel's occupancy times the SM count.  No shared
// memory and no z in memory; the counter is the flat index of the unpadded
// leaf as uint32, so the write may go in place (x == y).  A leaf of 2^31
// elements or more runs as consecutive launches whose counters continue.
//
// The shard route (zo_affine_shard) writes a rank's shard of a leaf under
// tensor parallelism: each element's counter is its index in the whole leaf
// (zo::ShardMap), one 32-bit divide a 16-byte vector, so the shard's write
// is bitwise the slice of the whole leaf's.
//
// zo_selftest holds z_of's pieces against zo::ref over their whole domains.
#include "zo_stream.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int DIST>
__global__ void __launch_bounds__(THREADS)
zo_affine_kernel(const T* x, T* y, uint32_t n, uint32_t base, zo::Split sp,
                 uint32_t key, float a, float b) {
  constexpr int N = zo::Vec<T>::N;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < sp.nvec; v += nthreads) {
    const uint32_t i0 = sp.head + v * N;
    float xs[N];
    zo::load_vec<T, N>(x + i0, xs);
    const uint32_t im = (base + i0) * zo::IDX_MUL;
#pragma unroll
    for (int k = 0; k < N; ++k)
      xs[k] = zo::affine(a, xs[k], b,
                         zo::z_of<DIST>(im + (uint32_t)k * zo::IDX_MUL, key));
    zo::store_vec<T, N>(y + i0, xs);
  }
  const uint32_t body_end = sp.head + sp.nvec * N;
  for (uint32_t r = tid; r < n - sp.nvec * N; r += nthreads) {
    const uint32_t i = r < sp.head ? r : body_end + (r - sp.head);
    const float z = zo::z_of<DIST>((base + i) * zo::IDX_MUL, key);
    zo::store(y, i, zo::affine(a, zo::load(x, i), b, z));
  }
}

template <typename T, int DIST>
cudaError_t launch_t(const void* x, void* y, int64_t n, uint32_t seed,
                     float a, float b, cudaStream_t stream) {
  const uint32_t key = zo::seed_key(seed);
  return zo::for_chunks<T>(x, y, n, [&](const T* xc, T* yc, uint32_t len,
                                        uint32_t base, zo::Split sp,
                                        uint32_t work) {
    const int grid =
        zo::resident_grid<zo_affine_kernel<T, DIST>>(THREADS, work);
    zo_affine_kernel<T, DIST><<<grid, THREADS, 0, stream>>>(
        xc, yc, len, base, sp, key, a, b);
  });
}

// The shard route: a rank's shard of a leaf, each element's counter its
// index in the whole leaf (zo::ShardMap), so the write is bitwise that
// slice of the whole leaf's.
template <typename T, int DIST, bool VEC>
__global__ void __launch_bounds__(THREADS)
zo_affine_shard_kernel(const T* x, T* y, uint32_t n, zo::ShardMap m,
                       uint32_t key, float a, float b) {
  zo::shard_walk<T, VEC>(x, y, n, m, [&](float v, uint32_t im) {
    return zo::affine(a, v, b, zo::z_of<DIST>(im, key));
  });
}

template <typename T, int DIST, bool VEC>
void launch_shard_t(const void* x, void* y, uint32_t n, zo::ShardMap m,
                    uint32_t key, float a, float b, cudaStream_t stream) {
  const uint32_t work = VEC ? n / zo::Vec<T>::N : n;
  const int grid =
      zo::resident_grid<zo_affine_shard_kernel<T, DIST, VEC>>(THREADS, work);
  zo_affine_shard_kernel<T, DIST, VEC><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, n, m, key, a, b);
}

template <typename T>
cudaError_t launch_shard(const void* x, void* y, uint32_t n, uint32_t seed,
                         float a, float b, int dist, zo::ShardMap m,
                         cudaStream_t stream) {
  const uint32_t key = zo::seed_key(seed);
  const bool vec = zo::shard_vec<T>(x, y, m);
  if (dist == 0) {
    if (vec) launch_shard_t<T, 0, true>(x, y, n, m, key, a, b, stream);
    else launch_shard_t<T, 0, false>(x, y, n, m, key, a, b, stream);
  } else {
    if (vec) launch_shard_t<T, 1, true>(x, y, n, m, key, a, b, stream);
    else launch_shard_t<T, 1, false>(x, y, n, m, key, a, b, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, uint32_t seed, float a,
                   float b, int dist, cudaStream_t stream) {
  return dist == 0 ? launch_t<T, 0>(x, y, n, seed, a, b, stream)
                   : launch_t<T, 1>(x, y, n, seed, a, b, stream);
}

// ---------------------------------------------------------------------------
// zo_selftest: z_of's pieces against zo::ref over their whole domains
// ---------------------------------------------------------------------------
enum Check {
  UNIFORM,      // uniform(m << 8) == ref uniform, all 2^24 m
  UNIFORM_X4,   // uniform_x4 == 4 * ref uniform
  EXPONENT,     // the magic-number exponent == I2F((b >> 23) - 127)
  MANTISSA,     // b | 0x3F800000 == (b & 0x7FFFFF) | 0x3F800000
  DIVISION,     // div_rn_fast(2(m-1), m+1) == 2 __fdiv_rn(m-1, m+1), 2^23 m
  NEG2LOG,      // neg2log(b) == -2 ref::det_log(u), all 2^24 uniforms
  SQRT,         // sqrt_t == __fsqrt_rn(fmaxf(t, 0)) on those t
  QUADRANT,     // floor(4u) & 3 and 4u - floor(4u) by the magic FADD
  COS,          // cos2pi_x4(4u) == ref::det_cos2pi(u), all 2^24 uniforms
  RADEMACHER,   // bit 31 == (ref uniform >= 0.5)
  Z_SAMPLE,     // z_of == ref::z_at on 2^24 (index, seed) pairs
  N_CHECKS
};

__global__ void selftest_kernel(unsigned long long* bad) {
  const uint32_t m = blockIdx.x * blockDim.x + threadIdx.x;   // < 2^24
  if (m >= (1u << 24)) return;
  // the hash's low 8 bits vary in a real stream: give them bits of m
  const uint32_t hi = (m << 8) | (m * 0x9Du & 0xFFu);
  const uint32_t h24 = hi & 0xFFFFFF00u;
  const float u_ref = zo::ref::uniform_of(m);
  unsigned fails[N_CHECKS] = {};
  fails[UNIFORM] = __float_as_uint(zo::uniform(h24)) != __float_as_uint(u_ref);
  const float t4 = zo::uniform_x4(h24);
  fails[UNIFORM_X4] =
      __float_as_uint(t4) != __float_as_uint(__fmul_rn(u_ref, 4.0f));
  const uint32_t b = __float_as_uint(u_ref);
  fails[EXPONENT] =
      __float_as_uint(__fsub_rn(__uint_as_float((b >> 23) + 0x4B000000u),
                                8388735.0f)) !=
      __float_as_uint(__int2float_rn((int)(b >> 23) - 127));
  fails[MANTISSA] = (b | 0x3F800000u) != ((b & 0x007FFFFFu) | 0x3F800000u);
  if (m < (1u << 23)) {
    const float mm = __uint_as_float(0x3F800000u | m);
    const float d = __fadd_rn(mm, 1.0f);
    fails[DIVISION] =
        __float_as_uint(zo::div_rn_fast(__fmaf_rn(mm, 2.0f, -2.0f), d)) !=
        __float_as_uint(__fmul_rn(2.0f, __fdiv_rn(__fsub_rn(mm, 1.0f), d)));
  }
  const float t_ref = __fmul_rn(-2.0f, zo::ref::det_log(u_ref));
  const float t_new = zo::neg2log(b);
  fails[NEG2LOG] = __float_as_uint(t_new) != __float_as_uint(t_ref);
  fails[SQRT] = __float_as_uint(zo::sqrt_t(t_ref)) !=
                __float_as_uint(__fsqrt_rn(fmaxf(t_ref, 0.0f)));
  const float K = __fadd_rd(t4, 8388608.0f);
  const float k_ref = floorf(__fmul_rn(u_ref, 4.0f));
  fails[QUADRANT] =
      ((__float_as_uint(K) & 3u) != ((uint32_t)(int)k_ref & 3u)) ||
      (__float_as_uint(__fsub_rn(t4, __fsub_rn(K, 8388608.0f))) !=
       __float_as_uint(__fsub_rn(__fmul_rn(u_ref, 4.0f), k_ref)));
  fails[COS] = __float_as_uint(zo::cos2pi_x4(t4)) !=
               __float_as_uint(zo::ref::det_cos2pi(u_ref));
  fails[RADEMACHER] = ((hi >> 31) != 0) != (u_ref >= 0.5f);
  // whole z at a spread of (index, seed) pairs: the hash's hoisting
  const uint32_t idx = m * 0x2545F491u, seed = (m >> 7) * 0x6C8E9CF5u + m;
  fails[Z_SAMPLE] =
      __float_as_uint(zo::z_of<0>(idx * zo::IDX_MUL, zo::seed_key(seed))) !=
          __float_as_uint(zo::ref::z_at<0>(idx, seed)) ||
      __float_as_uint(zo::z_of<1>(idx * zo::IDX_MUL, zo::seed_key(seed))) !=
          __float_as_uint(zo::ref::z_at<1>(idx, seed));
#pragma unroll
  for (int c = 0; c < N_CHECKS; ++c)
    if (fails[c]) atomicAdd(&bad[c], 1ull);
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

// One launch of the shard route over n < 2^31 local elements of a rank's
// shard: local element l at global index base + (l / R) * G + l % R (mod
// 2^32; kernels/_build.py ShardMap.segments cuts a shard into launches).
int zo_affine_shard(const void* x, void* y, uint32_t n, int dtype,
                    uint32_t seed, float a, float b, int dist, uint32_t R,
                    uint32_t G, uint32_t base, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if ((dist != 0 && dist != 1) || R == 0 || n > (1u << 31))
    return (int)cudaErrorInvalidValue;
  const zo::ShardMap m{R, G, base};
  switch (dtype) {
    case 0: return (int)launch_shard<float>(x, y, n, seed, a, b, dist, m, s);
    case 1:
      return (int)launch_shard<__nv_bfloat16>(x, y, n, seed, a, b, dist, m, s);
    case 2: return (int)launch_shard<__half>(x, y, n, seed, a, b, dist, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The number of checks zo_selftest runs (the length of its `bad` array).
int zo_selftest_checks() { return N_CHECKS; }

// Adds to bad[c] (device, zo_selftest_checks() zeroed u64) the number of
// inputs on which check c's rewrite differs from zo::ref.
int zo_selftest(unsigned long long* bad, void* stream) {
  selftest_kernel<<<(1u << 24) / 256, 256, 0, (cudaStream_t)stream>>>(bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
