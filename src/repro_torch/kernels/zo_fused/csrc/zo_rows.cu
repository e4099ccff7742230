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
//       sum of z(seed, e)^2 over the selected e, one f32 per leaf, every
//       partial rows leaf of a sphere pass in one call
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
// in shared memory, then the tile partials folded in order; the plain
// version in rows.py repeats it op for op.
//
// Bound on the H100: K7 and K9 move 2 * sel * sizeof(T) bytes against ~64
// f32 flops per selected element per stream (operations bound for B > 1 in
// bf16, about even for one stream); K8 writes all of B * n * sizeof(T), so
// bytes bound it; K10 moves nothing and is operations bound, and below that
// bound by the issue of its SASS instructions per z.
//
// K10's design is K6's (zo_sqnorm.cu): one call measures every partial rows
// leaf of a sphere pass, since a launch over one leaf of a few tiles would
// leave most of the card idle:
//   * the leaves' table rides in the launch's parameters (RowsLeaves: at
//     most ROWS_MAX_LEAVES = 64 leaves, 3 080 bytes, under the 4 KB of
//     parameters that every nvcc takes; a longer list runs as consecutive
//     launches), and the tiles of all leaves form one flat list that the
//     resident grid walks with a grid stride; one warp per leaf folds its
//     tile partials;
//   * compact index j -> flat e without a hardware division: a thread's
//     first index in a tile is split by a multiply-high-and-shift divide by
//     be (Granlund and Montgomery's round-up method, exact for every 32-bit
//     j), and each later step of 1024 by an incremental carry: 1024 =
//     blocks*be + B with B < be, so the remainder r gains B and carries at
//     most once, and e * IDX_MUL (the hash's first product) gains one of two
//     constants.
//     The wrapper (rows.py, _rows_leaf) computes every constant in Python,
//     where the CPU tests prove them;
//   * the z loop is K1's: a 32-bit counter, the seed key hoisted per leaf,
//     no bounds test except in a leaf's last tile (its own copy of the loop).
// The order of every sum is the one above whichever block runs a tile, so
// no bit of a norm depends on how the leaves are grouped into calls.
#include "zo_stream.cuh"

#define ZO_MAX_STREAMS 64
#define TILE_ELEMS 131072
#define TILE_THREADS 1024
#define PER_THREAD (TILE_ELEMS / TILE_THREADS)
#define ROWS_MAX_LEAVES 64
#define FOLD_WARPS 4
#define FOLD_STAGE 1024

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

// K10's per-launch leaf table, passed by value (3 080 bytes of parameters):
// leaf l owns tiles [first[l], first[l + 1]) of the flat list.  Per leaf, in
// the order of rows.py's _rows_leaf: sel, key = seed * SEED_MUL, be, the
// divide's multiplier and shifts (sh1 | sh2 << 8), e of compact index 0
// (phase * be), k * be, the carry's threshold be - B, its step B, and the
// two steps of e * IDX_MUL per 1024 compact indices (no carry, carry).
constexpr int LEAF_FIELDS = 11;
struct RowsLeaves {
  uint32_t sel[ROWS_MAX_LEAVES], key[ROWS_MAX_LEAVES], be[ROWS_MAX_LEAVES];
  uint32_t mul[ROWS_MAX_LEAVES], shifts[ROWS_MAX_LEAVES];
  uint32_t e0[ROWS_MAX_LEAVES], kbe[ROWS_MAX_LEAVES];
  uint32_t thresh[ROWS_MAX_LEAVES], rstep[ROWS_MAX_LEAVES];
  uint32_t step0[ROWS_MAX_LEAVES], step1[ROWS_MAX_LEAVES];
  uint32_t first[ROWS_MAX_LEAVES + 1];
  int count;
};

// the leaf owning flat tile `tile`: the last l with first[l] <= tile
__device__ __forceinline__ int leaf_of(const RowsLeaves& lv, uint32_t tile) {
  int lo = 0, hi = lv.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lv.first[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// K10 pass 1: each block walks the flat tile list; one tile of TILE_ELEMS
// compact indices at a time
template <int DIST>
__global__ void __launch_bounds__(TILE_THREADS)
rows_tile_sums(float* __restrict__ partials,
               const __grid_constant__ RowsLeaves lv) {
  __shared__ float s[TILE_THREADS];
  const int t = threadIdx.x;
  const uint32_t tiles = lv.first[lv.count];
  for (uint32_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int l = leaf_of(lv, tile);
    const uint32_t key = lv.key[l], thresh = lv.thresh[l];
    const uint32_t up = lv.rstep[l], down = 0u - thresh;   // r + B, r + B - be
    const uint32_t step0 = lv.step0[l], step1 = lv.step1[l];
    const uint32_t start = (tile - lv.first[l]) * TILE_ELEMS;
    // the thread's first compact index, j = q * be + r
    const uint32_t j = start + (uint32_t)t;
    const uint32_t hi = __umulhi(j, lv.mul[l]);
    const uint32_t sh = lv.shifts[l];
    const uint32_t q = (hi + ((j - hi) >> (sh & 0xFFu))) >> (sh >> 8);
    uint32_t r = j - q * lv.be[l];
    uint32_t im = (lv.e0[l] + q * lv.kbe[l] + r) * zo::IDX_MUL;
    float acc = 0.0f;
    const uint32_t left = lv.sel[l] - start;
    if (left >= TILE_ELEMS) {
#pragma unroll 4
      for (int k = 0; k < PER_THREAD; ++k) {
        const float z = zo::z_of<DIST>(im, key);
        acc = __fadd_rn(acc, __fmul_rn(z, z));
        const bool carry = r >= thresh;       // j += 1024 crosses a block
        r += carry ? down : up;
        im += carry ? step1 : step0;
      }
    } else {   // the leaf's last tile: indices at or past sel add +0
      for (int k = 0; k < PER_THREAD; ++k) {
        float sq = 0.0f;
        if ((uint32_t)(t + k * TILE_THREADS) < left) {
          const float z = zo::z_of<DIST>(im, key);
          sq = __fmul_rn(z, z);
        }
        acc = __fadd_rn(acc, sq);
        const bool carry = r >= thresh;
        r += carry ? down : up;
        im += carry ? step1 : step0;
      }
    }
    s[t] = acc;   // every read of the previous tile's s[] is behind a barrier
    __syncthreads();
    for (int h = TILE_THREADS / 2; h > 0; h >>= 1) {
      if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
      __syncthreads();
    }
    if (t == 0) partials[tile] = s[0];
  }
}

// K10 pass 2, one warp per leaf: out[l] = the leaf's tile partials folded
// in tile order
__global__ void __launch_bounds__(32 * FOLD_WARPS)
rows_fold_leaves(const float* __restrict__ partials, float* __restrict__ out,
                 const __grid_constant__ RowsLeaves lv) {
  __shared__ float stage[FOLD_WARPS][FOLD_STAGE];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * FOLD_WARPS + w;
  if (l >= lv.count) return;
  const uint32_t t0 = lv.first[l], t1 = lv.first[l + 1];
  float acc = 0.0f;
  for (uint32_t base = t0; base < t1; base += FOLD_STAGE) {
    const int m = (int)(t1 - base < FOLD_STAGE ? t1 - base : FOLD_STAGE);
    for (int i = lane; i < m; i += 32) stage[w][i] = partials[base + i];
    __syncwarp();
    if (lane == 0) {
      int i = 0;
      if (base == t0) acc = stage[w][i++];
      for (; i < m; ++i) acc = __fadd_rn(acc, stage[w][i]);
    }
    __syncwarp();
  }
  if (lane == 0) out[l] = acc;
}

template <int DIST>
cudaError_t launch_sqnorm(float* partials, float* out, const RowsLeaves& lv,
                          cudaStream_t st) {
  const uint64_t tiles = lv.first[lv.count];
  const uint64_t work64 = tiles * TILE_THREADS;
  const uint32_t work = work64 > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)work64;
  const int grid = zo::resident_grid<rows_tile_sums<DIST>>(TILE_THREADS, work);
  rows_tile_sums<DIST><<<grid, TILE_THREADS, 0, st>>>(partials, lv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_fold_leaves<<<(lv.count + FOLD_WARPS - 1) / FOLD_WARPS,
                     32 * FOLD_WARPS, 0, st>>>(partials, out, lv);
  return cudaGetLastError();
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

// K10 over n_leaves partial rows leaves: out[l] = sum of z(seed_l, e)^2
// over leaf l's selected e.  table: host array of n_leaves rows of
// zo_rows_leaf_fields() uint32 fields (rows.py's _rows_leaf; every sel
// >= 1); out on the card, n_leaves floats; partials: scratch of
// sum_l ceil(sel_l / TILE_ELEMS) floats on the card.  dist: 0 = gaussian,
// 1 = rademacher.  Lists longer than ROWS_MAX_LEAVES run as consecutive
// launches (zo_rows_max_leaves() per launch).
int zo_sqnorm_rows_many(float* partials, float* out, const uint32_t* table,
                        int n_leaves, int dist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_leaves < 1 || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_leaves; ++l)
    if (table[(int64_t)l * LEAF_FIELDS] == 0u)
      return (int)cudaErrorInvalidValue;
  uint64_t tile0 = 0;
  for (int l0 = 0; l0 < n_leaves; l0 += ROWS_MAX_LEAVES) {
    RowsLeaves lv;
    lv.count = n_leaves - l0 < ROWS_MAX_LEAVES ? n_leaves - l0
                                               : ROWS_MAX_LEAVES;
    uint32_t tiles = 0;
    for (int l = 0; l < lv.count; ++l) {
      const uint32_t* f = table + (int64_t)(l0 + l) * LEAF_FIELDS;
      lv.sel[l] = f[0]; lv.key[l] = f[1]; lv.be[l] = f[2];
      lv.mul[l] = f[3]; lv.shifts[l] = f[4]; lv.e0[l] = f[5];
      lv.kbe[l] = f[6]; lv.thresh[l] = f[7]; lv.rstep[l] = f[8];
      lv.step0[l] = f[9]; lv.step1[l] = f[10];
      lv.first[l] = tiles;
      tiles += (f[0] - 1u) / TILE_ELEMS + 1u;   // < 2^15 per leaf
    }
    lv.first[lv.count] = tiles;
    const cudaError_t err =
        dist == 0 ? launch_sqnorm<0>(partials + tile0, out + l0, lv, st)
                  : launch_sqnorm<1>(partials + tile0, out + l0, lv, st);
    if (err != cudaSuccess) return (int)err;
    tile0 += tiles;
  }
  return 0;
}

int zo_rows_leaf_fields() { return LEAF_FIELDS; }
int zo_rows_max_leaves() { return ROWS_MAX_LEAVES; }

}  // extern "C"
