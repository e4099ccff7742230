// The multi-seed zo_fused kernels: B z streams against one read of x.
//
// Replaces three Pallas TPU kernels:
//   K4 zo_affine_multi   <- zo_affine_multi_2d   (src/repro/kernels/zo_fused/multi.py:80)
//      y[j] = a_j*x + b_j*z(seed_j), stacked (B, n)
//   K5 zo_affine_batched <- zo_affine_2d_batched (src/repro/kernels/zo_fused/kernel.py:283)
//      the same fan-out with one shared (a, b) - its own entry point and
//      launch count, on the same device code as K4
//   K3 zo_affine_chain   <- zo_affine_chain_2d   (src/repro/kernels/zo_fused/multi.py:137)
//      y = fold_j round_T(a_j*y + b_j*z(seed_j)), one read and one write of x
//
// On the TPU the grid kept a VMEM tile of x resident while an inner batch
// axis walked the B streams.  Here both kernels take K1's design: each
// thread takes one 16-byte vector (8 bf16/f16 or 4 f32 elements) per
// grid-stride step with a 32-bit index inside the chunk, computes the
// vector's counter (idx * IDX_MUL) once, and walks the B streams with the
// per-stream key, a and b loaded once per vector; the vector's z are
// independent of each other, which gives the scheduler 4-8 chains.  The
// grid is the kernel's occupancy times the SM count, and a scalar head and
// tail take the elements off the 16-byte grid, as in K1.
//   * The fan-out loads the x vector once into registers and stores one
//     vector per stream, into its slice y + j*n.  When n * sizeof(T) is not
//     a multiple of 16 bytes, slices j >= 1 lie differently against 16
//     bytes than x does; such a launch (and one whose x and y differ in
//     alignment) takes the scalar route, every element in the scalar loop,
//     and the wrapper counts which route each launch took (fanout_route in
//     kernel.py repeats this rule).  Every leaf of qwen2-0.5b is a multiple
//     of 8 elements, so its fan-outs take the vector route.
//   * The chain, which every fzoo step and seed-group update runs, carries
//     the vector's running values in registers through the B streams
//     (interleaving two streams' z as well measured no faster) and stores
//     once, so it may run in place.
// The z generator and the affine combine are zo_stream.cuh's, the same code
// K1 runs, so each fan-out slice is bitwise K1(x, seed_j, a_j, b_j) and the
// chain is bitwise B sequential K1 launches: the cast through T between
// streams (round_to) is the write/read boundary of one launch
// (multi.py:101-117).
//
// zo_affine_chain_shard runs the chain on a rank's shard of a leaf under
// tensor parallelism, each element's counters its index in the whole leaf
// (zo::ShardMap in zo_stream.cuh), bitwise the slice of the whole chain;
// zo_affine_fanout_shard runs the fan-out (K4 and K5 alike) on such a
// shard, storing stream j's slice at y + j * stride, bitwise the slices of
// the whole fan-out.
//
// Seeds and coefficients travel by value in the kernel's parameters, at
// most ZO_MAX_STREAMS per launch; the wrapper splits a longer list into
// consecutive launches (a chain of chains is the same fold).  Nothing is
// allocated here.
//
// Bound on the H100: fan-out reads x once and writes B outputs, chain reads
// and writes x once; each stream costs ~64 f32 flops per element, so for
// B >= 2 in bf16 the CUDA-core rate (67 TFLOP/s) bounds both, not memory —
// and, below it, the issue of ~82 SASS instructions per z (zo_stream.cuh).
#include "zo_stream.cuh"

#define ZO_MAX_STREAMS 64

namespace {

struct Streams {
  uint32_t seed[ZO_MAX_STREAMS];
  float a[ZO_MAX_STREAMS];
  float b[ZO_MAX_STREAMS];
};

constexpr int THREADS = 256;

// y holds nb slices of the leaf, `stride` elements apart; sp splits x and
// slice 0 (every slice alike on the vector route, all scalar otherwise)
template <typename T, int DIST>
__global__ void __launch_bounds__(THREADS)
fanout_kernel(const T* x, T* y, uint32_t n, uint32_t base, zo::Split sp,
              int64_t stride, int nb, const Streams s) {
  constexpr int N = zo::Vec<T>::N;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < sp.nvec; v += nthreads) {
    const uint32_t i0 = sp.head + v * N;
    float xs[N];
    zo::load_vec<T, N>(x + i0, xs);
    const uint32_t im = (base + i0) * zo::IDX_MUL;
    T* yj = y + i0;
    for (int j = 0; j < nb; ++j, yj += stride) {
      const uint32_t key = zo::seed_key(s.seed[j]);
      const float a = s.a[j], b = s.b[j];
      float out[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        out[k] = zo::affine(a, xs[k], b,
                            zo::z_of<DIST>(im + (uint32_t)k * zo::IDX_MUL,
                                           key));
      zo::store_vec<T, N>(yj, out);
    }
  }
  const uint32_t body_end = sp.head + sp.nvec * N;
  for (uint32_t r = tid; r < n - sp.nvec * N; r += nthreads) {
    const uint32_t i = r < sp.head ? r : body_end + (r - sp.head);
    const uint32_t im = (base + i) * zo::IDX_MUL;
    const float xv = zo::load(x, i);
    T* yj = y + i;
    for (int j = 0; j < nb; ++j, yj += stride) {
      const float z = zo::z_of<DIST>(im, zo::seed_key(s.seed[j]));
      zo::store(yj, 0, zo::affine(s.a[j], xv, s.b[j], z));
    }
  }
}

template <typename T, int DIST>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const T* x, T* y, uint32_t n, uint32_t base, zo::Split sp,
             int nb, const Streams s) {
  constexpr int N = zo::Vec<T>::N;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < sp.nvec; v += nthreads) {
    const uint32_t i0 = sp.head + v * N;
    float xs[N];
    zo::load_vec<T, N>(x + i0, xs);
    const uint32_t im = (base + i0) * zo::IDX_MUL;
    for (int j = 0; j < nb; ++j) {
      const uint32_t key = zo::seed_key(s.seed[j]);
      const float a = s.a[j], b = s.b[j];
#pragma unroll
      for (int k = 0; k < N; ++k)
        xs[k] = zo::affine(a, xs[k], b,
                           zo::z_of<DIST>(im + (uint32_t)k * zo::IDX_MUL, key));
      if (j + 1 < nb) zo::round_vec(x, xs);   // the cast between launches
    }
    zo::store_vec<T, N>(y + i0, xs);
  }
  const uint32_t body_end = sp.head + sp.nvec * N;
  for (uint32_t r = tid; r < n - sp.nvec * N; r += nthreads) {
    const uint32_t i = r < sp.head ? r : body_end + (r - sp.head);
    const uint32_t im = (base + i) * zo::IDX_MUL;
    float v = zo::load(x, i);
    for (int j = 0; j < nb; ++j) {
      const float z = zo::z_of<DIST>(im, zo::seed_key(s.seed[j]));
      v = zo::round_to(x, zo::affine(s.a[j], v, s.b[j], z));
    }
    zo::store(y, i, v);
  }
}

template <typename T, int DIST>
cudaError_t launch_chain(const void* x, void* y, int64_t n, int nb,
                         const Streams& s, cudaStream_t stream) {
  return zo::for_chunks<T>(x, y, n, [&](const T* xc, T* yc, uint32_t len,
                                        uint32_t base, zo::Split sp,
                                        uint32_t work) {
    const int grid =
        zo::resident_grid<chain_kernel<T, DIST>>(THREADS, work);
    chain_kernel<T, DIST><<<grid, THREADS, 0, stream>>>(xc, yc, len, base, sp,
                                                         nb, s);
  });
}

// The chain on a rank's shard of a leaf (zo::ShardMap): the same fold, each
// element's counters its index in the whole leaf.
template <typename T, int DIST, bool VEC>
__global__ void __launch_bounds__(THREADS)
chain_shard_kernel(const T* x, T* y, uint32_t n, zo::ShardMap m, int nb,
                   const Streams s) {
  zo::shard_walk<T, VEC>(x, y, n, m, [&](float v, uint32_t im) {
    for (int j = 0; j < nb; ++j)
      v = zo::round_to(x, zo::affine(s.a[j], v, s.b[j],
                                     zo::z_of<DIST>(im,
                                                    zo::seed_key(s.seed[j]))));
    return v;
  });
}

template <typename T, int DIST, bool VEC>
void launch_chain_shard_t(const void* x, void* y, uint32_t n, zo::ShardMap m,
                          int nb, const Streams& s, cudaStream_t stream) {
  const uint32_t work = VEC ? n / zo::Vec<T>::N : n;
  const int grid =
      zo::resident_grid<chain_shard_kernel<T, DIST, VEC>>(THREADS, work);
  chain_shard_kernel<T, DIST, VEC><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, n, m, nb, s);
}

template <typename T>
cudaError_t launch_chain_shard(const void* x, void* y, uint32_t n, int nb,
                               const Streams& s, int dist, zo::ShardMap m,
                               cudaStream_t st) {
  const bool vec = zo::shard_vec<T>(x, y, m);
  if (dist == 0) {
    if (vec) launch_chain_shard_t<T, 0, true>(x, y, n, m, nb, s, st);
    else launch_chain_shard_t<T, 0, false>(x, y, n, m, nb, s, st);
  } else {
    if (vec) launch_chain_shard_t<T, 1, true>(x, y, n, m, nb, s, st);
    else launch_chain_shard_t<T, 1, false>(x, y, n, m, nb, s, st);
  }
  return cudaGetLastError();
}

// The fan-out on a rank's shard (zo::ShardMap): local element l draws
// z at its index in the whole leaf, as shard_walk's; x is read once per
// vector and stream j's output goes to y + j * stride.  16-byte vectors
// when VEC (shard_vec, and every slice on 16 bytes: stride * sizeof(T) a
// multiple of 16), else one element a step.
template <typename T, int DIST, bool VEC>
__global__ void __launch_bounds__(THREADS)
fanout_shard_kernel(const T* x, T* y, uint32_t n, zo::ShardMap m,
                    int64_t stride, int nb, const Streams s) {
  constexpr int N = VEC ? zo::Vec<T>::N : 1;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < n / N; v += nthreads) {
    const uint32_t l0 = v * N;
    const uint32_t im = zo::shard_index(l0, m) * zo::IDX_MUL;
    float xs[N];
    if constexpr (VEC) zo::load_vec<T, N>(x + l0, xs);
    else xs[0] = zo::load(x, l0);
    T* yj = y + l0;
    for (int j = 0; j < nb; ++j, yj += stride) {
      const uint32_t key = zo::seed_key(s.seed[j]);
      const float a = s.a[j], b = s.b[j];
      float out[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        out[k] = zo::affine(a, xs[k], b,
                            zo::z_of<DIST>(im + (uint32_t)k * zo::IDX_MUL,
                                           key));
      if constexpr (VEC) zo::store_vec<T, N>(yj, out);
      else zo::store(yj, 0, out[0]);
    }
  }
}

template <typename T, int DIST, bool VEC>
void launch_fanout_shard_t(const void* x, void* y, uint32_t n,
                           zo::ShardMap m, int64_t stride, int nb,
                           const Streams& s, cudaStream_t stream) {
  const uint32_t work = VEC ? n / zo::Vec<T>::N : n;
  const int grid =
      zo::resident_grid<fanout_shard_kernel<T, DIST, VEC>>(THREADS, work);
  fanout_shard_kernel<T, DIST, VEC><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, n, m, stride, nb, s);
}

template <typename T>
cudaError_t launch_fanout_shard(const void* x, void* y, uint32_t n,
                                int64_t stride, int nb, const Streams& s,
                                int dist, zo::ShardMap m, cudaStream_t st) {
  const bool vec = zo::shard_vec<T>(x, y, m) &&
                   (stride * (int64_t)sizeof(T)) % 16 == 0;
  if (dist == 0) {
    if (vec) launch_fanout_shard_t<T, 0, true>(x, y, n, m, stride, nb, s, st);
    else launch_fanout_shard_t<T, 0, false>(x, y, n, m, stride, nb, s, st);
  } else {
    if (vec) launch_fanout_shard_t<T, 1, true>(x, y, n, m, stride, nb, s, st);
    else launch_fanout_shard_t<T, 1, false>(x, y, n, m, stride, nb, s, st);
  }
  return cudaGetLastError();
}

// The fan-out's route: vector when every slice lies against 16 bytes as x
// does (n * sizeof(T) a multiple of 16; split_of checks x against y),
// scalar otherwise.
template <typename T, int DIST>
cudaError_t launch_fanout(const void* x, void* y, int64_t n, int nb,
                          const Streams& s, cudaStream_t stream) {
  const bool vec = (n * (int64_t)sizeof(T)) % 16 == 0;
  return zo::for_chunks<T>(x, y, n, [&](const T* xc, T* yc, uint32_t len,
                                        uint32_t base, zo::Split sp,
                                        uint32_t work) {
    if (!vec) {
      sp = zo::Split{len, 0};
      work = len;
    }
    const int grid =
        zo::resident_grid<fanout_kernel<T, DIST>>(THREADS, work);
    fanout_kernel<T, DIST><<<grid, THREADS, 0, stream>>>(xc, yc, len, base,
                                                         sp, n, nb, s);
  });
}

template <typename T>
cudaError_t launch(bool chain, const void* x, void* y, int64_t n, int nb,
                   const Streams& s, int dist, cudaStream_t stream) {
  if (chain)
    return dist == 0 ? launch_chain<T, 0>(x, y, n, nb, s, stream)
                     : launch_chain<T, 1>(x, y, n, nb, s, stream);
  return dist == 0 ? launch_fanout<T, 0>(x, y, n, nb, s, stream)
                   : launch_fanout<T, 1>(x, y, n, nb, s, stream);
}

int dispatch(bool chain, const void* x, void* y, int64_t n, int dtype,
             const Streams& s, int nb, int dist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (nb < 1 || nb > ZO_MAX_STREAMS || (dist != 0 && dist != 1))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch<float>(chain, x, y, n, nb, s, dist, st);
    case 1: return (int)launch<__nv_bfloat16>(chain, x, y, n, nb, s, dist, st);
    case 2: return (int)launch<__half>(chain, x, y, n, nb, s, dist, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Streams pack(const uint32_t* seeds, const float* a, const float* b, int nb,
             float a_all, float b_all) {
  Streams s;
  for (int j = 0; j < ZO_MAX_STREAMS; ++j) {
    bool live = j < nb;
    s.seed[j] = live ? seeds[j] : 0u;
    s.a[j] = live ? (a ? a[j] : a_all) : 0.0f;
    s.b[j] = live ? (b ? b[j] : b_all) : 0.0f;
  }
  return s;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16; dist: 0 = gaussian, 1 = rademacher.
// seeds, a, b are host arrays of nb entries; y holds nb slices of n.
int zo_affine_multi(const void* x, void* y, int64_t n, int dtype,
                    const uint32_t* seeds, const float* a, const float* b,
                    int nb, int dist, void* stream) {
  if (nb < 1 || nb > ZO_MAX_STREAMS) return (int)cudaErrorInvalidValue;
  return dispatch(false, x, y, n, dtype, pack(seeds, a, b, nb, 0.f, 0.f), nb,
                  dist, stream);
}

int zo_affine_batched(const void* x, void* y, int64_t n, int dtype,
                      const uint32_t* seeds, int nb, float a, float b,
                      int dist, void* stream) {
  if (nb < 1 || nb > ZO_MAX_STREAMS) return (int)cudaErrorInvalidValue;
  return dispatch(false, x, y, n, dtype,
                  pack(seeds, nullptr, nullptr, nb, a, b), nb, dist, stream);
}

// y may be x (in place)
int zo_affine_chain(const void* x, void* y, int64_t n, int dtype,
                    const uint32_t* seeds, const float* a, const float* b,
                    int nb, int dist, void* stream) {
  if (nb < 1 || nb > ZO_MAX_STREAMS) return (int)cudaErrorInvalidValue;
  return dispatch(true, x, y, n, dtype, pack(seeds, a, b, nb, 0.f, 0.f), nb,
                  dist, stream);
}

// The chain on one launch of a rank's shard (zo_affine_shard's map);
// y may be x (in place).
int zo_affine_chain_shard(const void* x, void* y, uint32_t n, int dtype,
                          const uint32_t* seeds, const float* a,
                          const float* b, int nb, int dist, uint32_t R,
                          uint32_t G, uint32_t base, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (nb < 1 || nb > ZO_MAX_STREAMS || (dist != 0 && dist != 1) || R == 0 ||
      n > (1u << 31))
    return (int)cudaErrorInvalidValue;
  const Streams s = pack(seeds, a, b, nb, 0.f, 0.f);
  const zo::ShardMap m{R, G, base};
  switch (dtype) {
    case 0: return (int)launch_chain_shard<float>(x, y, n, nb, s, dist, m, st);
    case 1:
      return (int)launch_chain_shard<__nv_bfloat16>(x, y, n, nb, s, dist, m,
                                                    st);
    case 2: return (int)launch_chain_shard<__half>(x, y, n, nb, s, dist, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fan-out (K4 / K5) on one launch of a rank's shard (zo_affine_shard's
// map): stream j's n outputs at y + j * stride, stride >= n elements.
int zo_affine_fanout_shard(const void* x, void* y, uint32_t n, int dtype,
                           const uint32_t* seeds, const float* a,
                           const float* b, int nb, int dist, uint32_t R,
                           uint32_t G, uint32_t base, int64_t stride,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (nb < 1 || nb > ZO_MAX_STREAMS || (dist != 0 && dist != 1) || R == 0 ||
      n > (1u << 31) || stride < (int64_t)n)
    return (int)cudaErrorInvalidValue;
  const Streams s = pack(seeds, a, b, nb, 0.f, 0.f);
  const zo::ShardMap m{R, G, base};
  switch (dtype) {
    case 0:
      return (int)launch_fanout_shard<float>(x, y, n, stride, nb, s, dist, m,
                                             st);
    case 1:
      return (int)launch_fanout_shard<__nv_bfloat16>(x, y, n, stride, nb, s,
                                                     dist, m, st);
    case 2:
      return (int)launch_fanout_shard<__half>(x, y, n, stride, nb, s, dist, m,
                                              st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
