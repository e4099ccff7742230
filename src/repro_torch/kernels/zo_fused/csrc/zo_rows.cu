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
// K7 and K9 take K1's vector design (zo_affine.cu), one device function
// (rows_walk) for both, K7 at one stream.  A row-block run is be
// contiguous flat elements, so when be * sizeof(T) is a multiple of 16 and
// the leaf starts on 16 bytes (the vector route), N = 16 / sizeof(T)
// consecutive compact indices from a multiple of N are N consecutive flat
// elements on 16 bytes, inside one block: each thread takes one such
// vector v per grid-stride step, with a 32-bit index, finds its block q =
// v / (be / N) by a multiply-high divide whose constants the wrapper
// computes (rows.py, divisor_magic) and whose e is
//     e0 = phase * be + v * N + q * (k - 1) * be   (mod 2^32, exact: < n),
// loads it once, walks the streams with each stream's key, a and b loaded
// once per vector (the cast through T between streams, round_vec), and
// stores it once.  The compact indices past the last whole vector (fewer
// than N, from a ragged last block) and every index of a launch on the
// scalar route (be * sizeof(T) not a multiple of 16, as the 1-D leaves'
// be = 1, or a leaf off 16 bytes) take the scalar loop: the flat index by
// a hardware division, one z at a time, the key hoisted per stream.  The
// launcher decides the route (route_of; rows.py's rows_route repeats the
// rule and the wrapper counts it), the grid is the kernel's occupancy
// times the SM count.
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

constexpr int THREADS = 256;

// flat element of compact index j (j < sel, hence the result < n < 2^32)
__device__ __forceinline__ uint32_t flat_of(uint32_t j, const Rows r) {
  const uint32_t q = j / r.be;
  return (r.phase + q * r.k) * r.be + (j - q * r.be);
}

__device__ __forceinline__ bool selected(uint32_t e, const Rows r) {
  return (e / r.be) % r.k == r.phase;
}

// K7's and K9's walk of one launch: the vector loop takes vectors
// [0, nvec), the scalar loop compact indices [j0, sel) (j0 = nvec * N on the
// vector route; on the scalar route 0, or 2^31 in a leaf's second launch,
// so that j0 + the grid's threads never wraps).
struct Walk {
  Rows r;
  uint32_t nvec;     // whole vectors (0 on the scalar route)
  uint32_t j0, sel;  // the scalar loop's compact indices
  uint32_t mul, shifts;   // the divide by be / N: sh1 | sh2 << 8
  uint32_t e_base;   // phase * be, e of compact index 0
  uint32_t gap;      // (k - 1) * be mod 2^32, e's jump from block to block
};

// K7's one stream, by value
struct One {
  uint32_t seed[1];
  float a[1], b[1];
};

// y = the fold over streams 0..nb-1 of round_T(a_j * y + b_j * z_j) at the
// walk's elements, x read once and y written once (y may be x)
template <typename T, int DIST, typename S>
__device__ __forceinline__ void rows_walk(const T* x, T* y, const Walk& w,
                                          int nb, const S& s) {
  constexpr int N = zo::Vec<T>::N;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  const uint32_t sh1 = w.shifts & 0xFFu, sh2 = w.shifts >> 8;
  for (uint32_t v = tid; v < w.nvec; v += nthreads) {
    const uint32_t hi = __umulhi(v, w.mul);
    const uint32_t q = (hi + ((v - hi) >> sh1)) >> sh2;   // v / (be / N)
    const uint32_t e0 = w.e_base + v * N + q * w.gap;
    float xs[N];
    zo::load_vec<T, N>(x + e0, xs);
    const uint32_t im = e0 * zo::IDX_MUL;
    for (int j = 0; j < nb; ++j) {
      const uint32_t key = zo::seed_key(s.seed[j]);
      const float a = s.a[j], b = s.b[j];
#pragma unroll
      for (int l = 0; l < N; ++l)
        xs[l] = zo::affine(a, xs[l], b,
                           zo::z_of<DIST>(im + (uint32_t)l * zo::IDX_MUL, key));
      if (j + 1 < nb) zo::round_vec(x, xs);   // the cast between launches
    }
    zo::store_vec<T, N>(y + e0, xs);
  }
  for (uint32_t i = tid; i < w.sel - w.j0; i += nthreads) {
    const uint32_t e = flat_of(w.j0 + i, w.r);
    const uint32_t im = e * zo::IDX_MUL;
    float v = zo::load(x, e);
    for (int j = 0; j < nb; ++j) {
      const float z = zo::z_of<DIST>(im, zo::seed_key(s.seed[j]));
      v = zo::round_to(x, zo::affine(s.a[j], v, s.b[j], z));
    }
    zo::store(y, e, v);
  }
}

// K7: y = a*x + b*z at the selected elements, in place when y == x
template <typename T, int DIST>
__global__ void __launch_bounds__(THREADS)
affine_rows_kernel(const T* x, T* y, const Walk w, const One s) {
  rows_walk<T, DIST>(x, y, w, 1, s);
}

// K9: the K3 fold at the selected elements, cast through T between streams
template <typename T, int DIST>
__global__ void __launch_bounds__(THREADS)
chain_rows_kernel(const T* x, T* y, const Walk w, int nb, const Streams s) {
  rows_walk<T, DIST>(x, y, w, nb, s);
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

// K7's and K9's route: vector when x and y start on 16 bytes and a row-block
// is a whole number of 16-byte vectors (rows.py's rows_route repeats it)
bool vector_route(const void* x, const void* y, uint32_t be, size_t size) {
  return (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
         (uint64_t)be * size % 16 == 0;
}

// v / d by the divide's constants (mul, sh1 | sh2 << 8), as the kernel
// computes it
uint32_t divide(uint32_t v, uint32_t mul, uint32_t shifts) {
  const uint32_t hi = (uint32_t)(((uint64_t)v * mul) >> 32);
  return (hi + ((v - hi) >> (shifts & 0xFFu))) >> (shifts >> 8);
}

// Launches Kernel (K7's or K9's) over sel selected elements, its streams in
// args: once on the vector route (mul and shifts divide by be / N, checked
// at the first block boundary and the last vector), on the scalar route
// once per 2^31 compact indices.
template <auto Kernel, typename T, typename... A>
cudaError_t launch_walk(const void* x, void* y, uint32_t sel, const Rows& r,
                        uint32_t mul, uint32_t shifts, cudaStream_t st,
                        const A&... args) {
  constexpr uint32_t N = zo::Vec<T>::N;
  Walk w{r, 0u, 0u, sel, mul, shifts, r.phase * r.be, (r.k - 1u) * r.be};
  auto run = [&](uint32_t work) {
    const int grid = zo::resident_grid<Kernel>(THREADS, work);
    Kernel<<<grid, THREADS, 0, st>>>((const T*)x, (T*)y, w, args...);
    return cudaGetLastError();
  };
  if (vector_route(x, y, r.be, sizeof(T))) {
    const uint32_t bv = r.be / N, last = sel / N ? sel / N - 1u : 0u;
    if (divide(bv, mul, shifts) != 1u || divide(bv - 1u, mul, shifts) != 0u ||
        divide(last, mul, shifts) != last / bv)
      return cudaErrorInvalidValue;
    w.nvec = sel / N;
    w.j0 = w.nvec * N;
    return run(w.nvec > sel - w.j0 ? w.nvec : sel - w.j0);
  }
  constexpr uint32_t HALF = 1u << 31;
  for (uint64_t j0 = 0; j0 < sel; j0 += HALF) {
    w.j0 = (uint32_t)j0;
    w.sel = sel - j0 > HALF ? (uint32_t)(j0 + HALF) : sel;
    const cudaError_t err = run(w.sel - w.j0);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K7 (nb == 0: the stream in s1) or K9 (the nb streams in s) by dtype and
// dist
template <typename T>
cudaError_t launch_rows(const void* x, void* y, uint32_t sel, const Rows& r,
                        uint32_t mul, uint32_t shifts, const One& s1, int nb,
                        const Streams& s, int dist, cudaStream_t st) {
  if (nb == 0)
    return dist == 0 ? launch_walk<affine_rows_kernel<T, 0>, T>(
                           x, y, sel, r, mul, shifts, st, s1)
                     : launch_walk<affine_rows_kernel<T, 1>, T>(
                           x, y, sel, r, mul, shifts, st, s1);
  return dist == 0 ? launch_walk<chain_rows_kernel<T, 0>, T>(
                         x, y, sel, r, mul, shifts, st, nb, s)
                   : launch_walk<chain_rows_kernel<T, 1>, T>(
                         x, y, sel, r, mul, shifts, st, nb, s);
}

int dispatch_rows(const void* x, void* y, int64_t sel, int dtype,
                  const Rows& r, uint32_t mul, uint32_t shifts, const One& s1,
                  int nb, const Streams& s, int dist, cudaStream_t st) {
  if (sel <= 0) return 0;
  if (!rows_ok(r) || sel > 0xFFFFFFFFll || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  const uint32_t n = (uint32_t)sel;
  switch (dtype) {
    case 0:
      return (int)launch_rows<float>(x, y, n, r, mul, shifts, s1, nb, s, dist,
                                     st);
    case 1:
      return (int)launch_rows<__nv_bfloat16>(x, y, n, r, mul, shifts, s1, nb,
                                             s, dist, st);
    case 2:
      return (int)launch_rows<__half>(x, y, n, r, mul, shifts, s1, nb, s,
                                      dist, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
// sel is the selected element count (< 2^32); y may be x.  mul and shifts
// (sh1 | sh2 << 8) divide by be / N on the vector route (rows.py,
// _vector_divide); the scalar route reads neither.
int zo_affine_rows(const void* x, void* y, int64_t sel, int dtype,
                   uint32_t be, uint32_t k, uint32_t phase, uint32_t mul,
                   uint32_t shifts, uint32_t seed, float a, float b, int dist,
                   void* stream) {
  const One s1{{seed}, {a}, {b}};
  return dispatch_rows(x, y, sel, dtype, Rows{be, k, phase}, mul, shifts, s1,
                       0, Streams{}, dist, (cudaStream_t)stream);
}

// seeds, a, b: host arrays of nb (<= ZO_MAX_STREAMS) entries; y may be x.
int zo_affine_chain_rows(const void* x, void* y, int64_t sel, int dtype,
                         uint32_t be, uint32_t k, uint32_t phase,
                         uint32_t mul, uint32_t shifts, const uint32_t* seeds,
                         const float* a, const float* b, int nb, int dist,
                         void* stream) {
  if (nb < 1 || nb > ZO_MAX_STREAMS) return (int)cudaErrorInvalidValue;
  return dispatch_rows(x, y, sel, dtype, Rows{be, k, phase}, mul, shifts,
                       One{}, nb, pack(seeds, a, b, nb), dist,
                       (cudaStream_t)stream);
}

// The route K7 and K9 take for a leaf at x written at y: 1 = vector,
// 0 = scalar; -1 for an unknown dtype.
int zo_rows_route(const void* x, const void* y, uint32_t be, int dtype) {
  static const size_t sizes[] = {4, 2, 2};
  if (dtype < 0 || dtype > 2) return -1;
  return vector_route(x, y, be, sizes[dtype]) ? 1 : 0;
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
