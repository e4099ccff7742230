// K6 zo_sqnorm: ||z(seed_l)[0:n_l]||^2 for each of L leaves, one f32 each,
// z never in memory.
//
// Replaces the Pallas TPU kernel zo_sqnorm_2d
// (src/repro/kernels/zo_fused/multi.py:200), pass 1 of the sphere rescale.
//
// The TPU ran its grid in order and carried the sum from one tile to the
// next (@pl.when(i == 0) init, then add).  Blocks here run in parallel, and
// float atomics would make the sum change from run to run, so the order is
// fixed in two passes - the order the plain version in multi.py repeats:
//
//   1. per tile of 256*512 = 131072 elements of a leaf (the TPU's tile),
//      one block of 1024 threads: thread t adds z^2 at tile offsets t,
//      t+1024, ..., t+127*1024 in that order into an f32 register starting
//      at 0 (elements at or past n add +0); then the 1024 partials are
//      halved in shared memory: s[t] += s[t+h] for h = 512, 256, ..., 1;
//   2. each leaf's tile partials are folded in tile order in f32.
//
// Inside a tile XLA chose its own order for jnp.sum, so K6 agrees with
// JAX's zo_sqnorm_ref within a stated relative tolerance, and with its plain
// version bitwise.  z and z^2 are zo_stream.cuh's (the gaussian stream the
// affine kernels read).
//
// Bound on the H100: no tensor is read or written (a 4-byte partial per
// tile), ~66 f32 flops per element: operations bound at 67 TFLOP/s - and
// below that the card's instruction issue, ~80 SASS instructions per z.
//
// Design.  One call measures every leaf of a sphere pass (leaf by leaf, two
// launches each, a leaf of 1-21 tiles left most of the card idle and a
// 1 039-tile leaf ended in a partly filled wave):
//   * the leaves' (n, seed key, first tile) ride in the launch's parameters
//     (a table of up to MAX_LEAVES; a longer list runs as consecutive
//     launches), and the tiles of all leaves form one flat list;
//   * tile_sums runs the resident grid (occupancy x SMs) and each block
//     walks that list with a grid stride, so only the last wave is partial;
//   * the z loop is K1's: a 32-bit counter stepped by a constant idx*IDX_MUL
//     increment, the seed key hoisted per leaf, no bounds test except in a
//     leaf's last tile (its own copy of the loop);
//   * fold_leaves runs one warp per leaf: the lanes stage the leaf's tile
//     partials in shared memory, coalesced, and lane 0 folds them in order.
// The order of every sum is the one above, so no bit of a norm depends on
// how the leaves are grouped into calls.
//
// Under tensor parallelism the P ranks of the model axis split the norm's
// work (z depends on the seed and the global index only, never on theta):
// zo_sqnorm_share runs tile_sums over rank r's contiguous share of the flat
// tile list, the caller all-gathers the shares' partials (4 bytes a tile),
// and zo_sqnorm_fold folds every leaf's partials in tile order - the same
// partials and the same fold as one process's, so every rank's norms are
// bitwise the one-process norms.
#include "zo_stream.cuh"

#define TILE_ELEMS 131072
#define TILE_THREADS 1024
#define PER_THREAD (TILE_ELEMS / TILE_THREADS)
#define MAX_LEAVES 96
#define FOLD_WARPS 4
#define FOLD_STAGE 1024

namespace {

// the per-launch leaf table, passed by value (1.9 KB of parameters):
// leaf l owns tiles [first[l], first[l + 1]) of the flat list
struct Leaves {
  int64_t n[MAX_LEAVES];
  uint32_t key[MAX_LEAVES];
  int64_t first[MAX_LEAVES + 1];
  int count;
};

// the leaf owning flat tile `tile`: the last l with first[l] <= tile
__device__ __forceinline__ int leaf_of(const Leaves& lv, int64_t tile) {
  int lo = 0, hi = lv.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lv.first[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the sums of the table's tiles [t0, t1), tile t into partials[t - t0]
template <int DIST>
__global__ void __launch_bounds__(TILE_THREADS)
tile_sums(float* __restrict__ partials, const __grid_constant__ Leaves lv,
          int64_t t0, int64_t t1) {
  __shared__ float s[TILE_THREADS];
  const int t = threadIdx.x;
  constexpr uint32_t STEP = (uint32_t)TILE_THREADS * zo::IDX_MUL;
  for (int64_t tile = t0 + blockIdx.x; tile < t1; tile += gridDim.x) {
    const int l = leaf_of(lv, tile);
    const uint32_t key = lv.key[l];
    const int64_t start = (tile - lv.first[l]) * TILE_ELEMS;
    // the counter is the flat index in the leaf as uint32 (JAX's)
    uint32_t im = ((uint32_t)start + (uint32_t)t) * zo::IDX_MUL;
    float acc = 0.0f;
    if (start + TILE_ELEMS <= lv.n[l]) {
#pragma unroll 4
      for (int k = 0; k < PER_THREAD; ++k, im += STEP) {
        const float z = zo::z_of<DIST>(im, key);
        acc = __fadd_rn(acc, __fmul_rn(z, z));
      }
    } else {   // the leaf's last tile: elements at or past n add +0
      const int64_t left = lv.n[l] - start;   // in (0, TILE_ELEMS)
      for (int k = 0; k < PER_THREAD; ++k, im += STEP) {
        float sq = 0.0f;
        if (t + k * TILE_THREADS < left) {
          const float z = zo::z_of<DIST>(im, key);
          sq = __fmul_rn(z, z);
        }
        acc = __fadd_rn(acc, sq);
      }
    }
    s[t] = acc;   // every read of the previous tile's s[] is behind a barrier
    __syncthreads();
    for (int h = TILE_THREADS / 2; h > 0; h >>= 1) {
      if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
      __syncthreads();
    }
    if (t == 0) partials[tile - t0] = s[0];
  }
}

// one warp per leaf: out[l] = the leaf's tile partials folded in tile order
__global__ void __launch_bounds__(32 * FOLD_WARPS)
fold_leaves(const float* __restrict__ partials, float* __restrict__ out,
            const __grid_constant__ Leaves lv) {
  __shared__ float stage[FOLD_WARPS][FOLD_STAGE];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * FOLD_WARPS + w;
  if (l >= lv.count) return;
  const int64_t t0 = lv.first[l], t1 = lv.first[l + 1];
  float acc = 0.0f;
  for (int64_t base = t0; base < t1; base += FOLD_STAGE) {
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
cudaError_t launch_sums(float* partials, const Leaves& lv, int64_t t0,
                        int64_t t1, cudaStream_t s) {
  if (t1 <= t0) return cudaSuccess;
  const int64_t tiles = t1 - t0;
  const uint32_t work =
      tiles * TILE_THREADS > 0xFFFFFFFFll ? 0xFFFFFFFFu
                                          : (uint32_t)(tiles * TILE_THREADS);
  const int grid = zo::resident_grid<tile_sums<DIST>>(TILE_THREADS, work);
  tile_sums<DIST><<<grid, TILE_THREADS, 0, s>>>(partials, lv, t0, t1);
  return cudaGetLastError();
}

cudaError_t launch_fold(const float* partials, float* out, const Leaves& lv,
                        cudaStream_t s) {
  fold_leaves<<<(lv.count + FOLD_WARPS - 1) / FOLD_WARPS, 32 * FOLD_WARPS, 0,
                s>>>(partials, out, lv);
  return cudaGetLastError();
}

// leaves [l0, l0 + MAX_LEAVES) of the list as one launch's table, their
// tiles counted from 0
Leaves table(const int64_t* ns, const uint32_t* seeds, int n_leaves, int l0) {
  Leaves lv;
  lv.count = n_leaves - l0 < MAX_LEAVES ? n_leaves - l0 : MAX_LEAVES;
  int64_t tiles = 0;
  for (int l = 0; l < lv.count; ++l) {
    lv.n[l] = ns[l0 + l];
    lv.key[l] = seeds ? zo::seed_key(seeds[l0 + l]) : 0u;
    lv.first[l] = tiles;
    tiles += (lv.n[l] + TILE_ELEMS - 1) / TILE_ELEMS;
  }
  lv.first[lv.count] = tiles;
  return lv;
}

int check_list(const int64_t* ns, int n_leaves, int dist) {
  if (n_leaves < 1 || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_leaves; ++l)
    if (ns[l] <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out[l] = ||z(seeds[l])[0:ns[l]]||^2 for l < n_leaves (host arrays ns and
// seeds; out on the card, n_leaves floats).  partials: scratch of
// sum_l ceil(ns[l] / TILE_ELEMS) floats on the card.  dist: 0 = gaussian,
// 1 = rademacher.  Every n must be >= 1.  Lists longer than MAX_LEAVES run
// as consecutive launches.
int zo_sqnorm_many(float* partials, float* out, const int64_t* ns,
                   const uint32_t* seeds, int n_leaves, int dist,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (const int bad = check_list(ns, n_leaves, dist)) return bad;
  int64_t tile0 = 0;
  for (int l0 = 0; l0 < n_leaves; l0 += MAX_LEAVES) {
    const Leaves lv = table(ns, seeds, n_leaves, l0);
    const int64_t tiles = lv.first[lv.count];
    cudaError_t err =
        dist == 0 ? launch_sums<0>(partials + tile0, lv, 0, tiles, s)
                  : launch_sums<1>(partials + tile0, lv, 0, tiles, s);
    if (err == cudaSuccess) err = launch_fold(partials + tile0, out + l0, lv, s);
    if (err != cudaSuccess) return (int)err;
    tile0 += tiles;
  }
  return 0;
}

// partials[t - lo] = the sum of flat tile t of the list, for t in [lo, hi)
// (tiles numbered over all leaves in order, as zo_sqnorm_many lays them
// out): one rank's share of the norm's work.
int zo_sqnorm_share(float* partials, const int64_t* ns, const uint32_t* seeds,
                    int n_leaves, int64_t lo, int64_t hi, int dist,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (const int bad = check_list(ns, n_leaves, dist)) return bad;
  if (lo < 0 || hi < lo) return (int)cudaErrorInvalidValue;
  int64_t tile0 = 0;
  for (int l0 = 0; l0 < n_leaves && tile0 < hi; l0 += MAX_LEAVES) {
    const Leaves lv = table(ns, seeds, n_leaves, l0);
    const int64_t tiles = lv.first[lv.count];
    const int64_t a = lo > tile0 ? lo - tile0 : 0;
    const int64_t b = hi - tile0 < tiles ? hi - tile0 : tiles;
    if (a < b) {
      const cudaError_t err =
          dist == 0 ? launch_sums<0>(partials + (tile0 + a - lo), lv, a, b, s)
                    : launch_sums<1>(partials + (tile0 + a - lo), lv, a, b, s);
      if (err != cudaSuccess) return (int)err;
    }
    tile0 += tiles;
  }
  return 0;
}

// out[l] = leaf l's tile partials (the whole flat list, zo_sqnorm_share's
// shares gathered in order) folded in tile order.
int zo_sqnorm_fold(const float* partials, float* out, const int64_t* ns,
                   int n_leaves, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (const int bad = check_list(ns, n_leaves, 0)) return bad;
  int64_t tile0 = 0;
  for (int l0 = 0; l0 < n_leaves; l0 += MAX_LEAVES) {
    const Leaves lv = table(ns, nullptr, n_leaves, l0);
    const cudaError_t err = launch_fold(partials + tile0, out + l0, lv, s);
    if (err != cudaSuccess) return (int)err;
    tile0 += lv.first[lv.count];
  }
  return 0;
}

}  // extern "C"
