// The sub-leaf zo_fused kernels: the affine kernels restricted to the
// row-blocks a rows(block=R, k=K) selection picks at a phase.
//
// Replaces four Pallas TPU kernels (src/repro/kernels/zo_fused/rows.py):
//   K7  zo_affine_rows       <- zo_affine_2d_rows       (rows.py:161)
//       y[e] = a*x[e] + b*z(seed, e) at every selected e, in place
//   K8  zo_affine_multi_rows <- zo_affine_multi_2d_rows (rows.py:219)
//       y[j][e] = a_j*x[e] + b_j*z(seed_j, e) at selected e, x[e] elsewhere
//   K9  zo_affine_chain_rows <- zo_affine_chain_2d_rows (rows.py:287)
//       the K3 fold over the streams at selected e, in place
//   K10 zo_sqnorm_rows       <- zo_sqnorm_2d_rows       (rows.py:355)
//       sum of z(seed, e)^2 over the selected e, one f32
//
// Element e of a leaf of n elements is selected iff (e / be) % k == phase,
// be = R * row_width (block_elems).  On the TPU the grid walked fixed
// 131072-element tiles, gathered the selected ones into a compact operand
// and stitched the result back with dynamic_update_slice; tiles straddling
// a block boundary were masked after the cast.  Those are BlockSpec
// artifacts.  Here the grid walks the selected elements themselves: compact
// index j in [0, sel) maps to
//     e = (phase + (j / be) * k) * be + j % be,
// so K7, K9 and K10 generate z, read and write only where the selection is
// (at rows(block=1, k=4) a quarter of each leaf, where the TPU's tile plan
// touched every tile).  The wrapper clamps be to n and requires n < 2^32,
// so every index fits 32 bits (e < n for every j < sel).  The z generator
// and the affine combine are zo_stream.cuh's, the code K1 and K3-K6 run, so
// each selected value is bitwise what K1 (or the K3 fold) writes there and
// K8 is bitwise the stacked K7 singles by construction.
//
// K8 writes a new (B, n) output: it walks every e, reads x once, generates
// z only at selected e and copies x's bits elsewhere (B copies, one per
// stream's slice).  K10's order of summation is fixed, as K6's is: one block
// of 1024 threads per tile of 131072 COMPACT indices, thread t adding z^2 at
// tile offsets t, t+1024, ..., t+127*1024 (j >= sel adds +0), a halving tree
// in shared memory, then one thread folding the tile partials in order; the
// plain version in rows.py repeats it op for op.
//
// Bound on the H100: K7 and K9 move 2 * sel * sizeof(T) bytes against ~64
// f32 flops per selected element per stream (operations bound for B > 1 in
// bf16, about even for one stream); K8 writes all of B * n * sizeof(T), so
// bytes bound it; K10 moves nothing and is operations bound.
#include "zo_stream.cuh"

#define ZO_MAX_STREAMS 64
#define TILE_ELEMS 131072
#define TILE_THREADS 1024
#define PER_THREAD (TILE_ELEMS / TILE_THREADS)

namespace {

struct Rows {
  uint32_t be;     // elements per row-block, clamped to n
  uint32_t k;      // schedule period
  uint32_t phase;  // selected residue
};

struct Streams {
  uint32_t seed[ZO_MAX_STREAMS];
  float a[ZO_MAX_STREAMS];
  float b[ZO_MAX_STREAMS];
};

// flat element of compact index j (j < sel, hence the result < n < 2^32)
__device__ __forceinline__ uint32_t flat_of(uint32_t j, const Rows r) {
  const uint32_t q = j / r.be;
  return (r.phase + q * r.k) * r.be + (j - q * r.be);
}

__device__ __forceinline__ bool selected(uint32_t e, const Rows r) {
  return (e / r.be) % r.k == r.phase;
}

// K7: x and y may alias (in place); only selected elements are touched
template <typename T, int DIST>
__global__ void affine_rows_kernel(const T* x, T* y, int64_t sel,
                                   const Rows r, uint32_t seed, float a,
                                   float b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < sel;
       i += stride) {
    const uint32_t e = flat_of((uint32_t)i, r);
    const float z = zo::z_at<DIST>(e, seed);
    zo::store(y, (int64_t)e, zo::affine(a, zo::load(x, (int64_t)e), b, z));
  }
}

// K9: the K3 fold at selected elements, cast through T between streams
template <typename T, int DIST>
__global__ void chain_rows_kernel(const T* x, T* y, int64_t sel,
                                  const Rows r, int nb, const Streams s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < sel;
       i += stride) {
    const uint32_t e = flat_of((uint32_t)i, r);
    float v = zo::load(x, (int64_t)e);
    for (int j = 0; j < nb; ++j) {
      const float z = zo::z_at<DIST>(e, s.seed[j]);
      v = zo::round_to(x, zo::affine(s.a[j], v, s.b[j], z));
    }
    zo::store(y, (int64_t)e, v);
  }
}

// K8: every element once; z only where selected, x's bits elsewhere
template <typename T, int DIST>
__global__ void multi_rows_kernel(const T* x, T* y, int64_t n, const Rows r,
                                  int nb, const Streams s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t e = (uint32_t)i;
    if (selected(e, r)) {
      const float xv = zo::load(x, i);
      for (int j = 0; j < nb; ++j) {
        const float z = zo::z_at<DIST>(e, s.seed[j]);
        zo::store(y, (int64_t)j * n + i, zo::affine(s.a[j], xv, s.b[j], z));
      }
    } else {
      const T raw = x[i];
      for (int j = 0; j < nb; ++j) y[(int64_t)j * n + i] = raw;
    }
  }
}

// K10 pass 1: one tile of TILE_ELEMS compact indices per block
template <int DIST>
__global__ void __launch_bounds__(TILE_THREADS)
sqnorm_rows_tiles(float* partials, int64_t sel, const Rows r, uint32_t seed) {
  __shared__ float s[TILE_THREADS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * TILE_ELEMS + t;
  float acc = 0.0f;
  for (int q = 0; q < PER_THREAD; ++q) {
    const int64_t j = base + (int64_t)q * TILE_THREADS;
    float sq = 0.0f;
    if (j < sel) {
      const float z = zo::z_at<DIST>(flat_of((uint32_t)j, r), seed);
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

// K10 pass 2: the tile partials folded in tile order
__global__ void fold_tiles(const float* partials, int64_t tiles, float* out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float acc = partials[0];
  for (int64_t i = 1; i < tiles; ++i) acc = __fadd_rn(acc, partials[i]);
  out[0] = acc;
}

int grid_for(int64_t n, int threads) {
  int64_t want = (n + threads - 1) / threads;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

bool rows_ok(const Rows& r) { return r.be >= 1 && r.k >= 1 && r.phase < r.k; }

Streams pack(const uint32_t* seeds, const float* a, const float* b, int nb) {
  Streams s;
  for (int j = 0; j < ZO_MAX_STREAMS; ++j) {
    bool live = j < nb;
    s.seed[j] = live ? seeds[j] : 0u;
    s.a[j] = live ? a[j] : 0.0f;
    s.b[j] = live ? b[j] : 0.0f;
  }
  return s;
}

template <typename T>
cudaError_t launch_affine(const void* x, void* y, int64_t sel, const Rows& r,
                          uint32_t seed, float a, float b, int dist,
                          cudaStream_t st) {
  const int threads = 256, blocks = grid_for(sel, threads);
  if (dist == 0)
    affine_rows_kernel<T, 0><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, sel, r, seed, a, b);
  else
    affine_rows_kernel<T, 1><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, sel, r, seed, a, b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chain(const void* x, void* y, int64_t sel, const Rows& r,
                         int nb, const Streams& s, int dist, cudaStream_t st) {
  const int threads = 256, blocks = grid_for(sel, threads);
  if (dist == 0)
    chain_rows_kernel<T, 0><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, sel, r, nb, s);
  else
    chain_rows_kernel<T, 1><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, sel, r, nb, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_multi(const void* x, void* y, int64_t n, const Rows& r,
                         int nb, const Streams& s, int dist, cudaStream_t st) {
  const int threads = 256, blocks = grid_for(n, threads);
  if (dist == 0)
    multi_rows_kernel<T, 0><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, n, r, nb, s);
  else
    multi_rows_kernel<T, 1><<<blocks, threads, 0, st>>>(
        (const T*)x, (T*)y, n, r, nb, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16; dist: 0 = gaussian, 1 = rademacher.
// sel is the selected element count; y may be x.
int zo_affine_rows(const void* x, void* y, int64_t sel, int dtype,
                   uint32_t be, uint32_t k, uint32_t phase, uint32_t seed,
                   float a, float b, int dist, void* stream) {
  const Rows r{be, k, phase};
  cudaStream_t st = (cudaStream_t)stream;
  if (sel <= 0) return 0;
  if (!rows_ok(r) || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_affine<float>(x, y, sel, r, seed, a, b, dist, st);
    case 1:
      return (int)launch_affine<__nv_bfloat16>(x, y, sel, r, seed, a, b, dist,
                                               st);
    case 2: return (int)launch_affine<__half>(x, y, sel, r, seed, a, b, dist, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// seeds, a, b: host arrays of nb (<= ZO_MAX_STREAMS) entries; y may be x.
int zo_affine_chain_rows(const void* x, void* y, int64_t sel, int dtype,
                         uint32_t be, uint32_t k, uint32_t phase,
                         const uint32_t* seeds, const float* a,
                         const float* b, int nb, int dist, void* stream) {
  const Rows r{be, k, phase};
  cudaStream_t st = (cudaStream_t)stream;
  if (sel <= 0) return 0;
  if (!rows_ok(r) || nb < 1 || nb > ZO_MAX_STREAMS || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  const Streams s = pack(seeds, a, b, nb);
  switch (dtype) {
    case 0: return (int)launch_chain<float>(x, y, sel, r, nb, s, dist, st);
    case 1:
      return (int)launch_chain<__nv_bfloat16>(x, y, sel, r, nb, s, dist, st);
    case 2: return (int)launch_chain<__half>(x, y, sel, r, nb, s, dist, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y holds nb slices of n elements.
int zo_affine_multi_rows(const void* x, void* y, int64_t n, int dtype,
                         uint32_t be, uint32_t k, uint32_t phase,
                         const uint32_t* seeds, const float* a,
                         const float* b, int nb, int dist, void* stream) {
  const Rows r{be, k, phase};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (!rows_ok(r) || nb < 1 || nb > ZO_MAX_STREAMS || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  const Streams s = pack(seeds, a, b, nb);
  switch (dtype) {
    case 0: return (int)launch_multi<float>(x, y, n, r, nb, s, dist, st);
    case 1:
      return (int)launch_multi<__nv_bfloat16>(x, y, n, r, nb, s, dist, st);
    case 2: return (int)launch_multi<__half>(x, y, n, r, nb, s, dist, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// partials: ceil(sel / TILE_ELEMS) floats of scratch; out: one float.
int zo_sqnorm_rows(float* partials, float* out, int64_t sel, uint32_t be,
                   uint32_t k, uint32_t phase, uint32_t seed, int dist,
                   void* stream) {
  const Rows r{be, k, phase};
  cudaStream_t st = (cudaStream_t)stream;
  if (sel <= 0 || !rows_ok(r) || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (sel + TILE_ELEMS - 1) / TILE_ELEMS;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (dist == 0)
    sqnorm_rows_tiles<0><<<(unsigned)tiles, TILE_THREADS, 0, st>>>(
        partials, sel, r, seed);
  else
    sqnorm_rows_tiles<1><<<(unsigned)tiles, TILE_THREADS, 0, st>>>(
        partials, sel, r, seed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_tiles<<<1, 32, 0, st>>>(partials, tiles, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
