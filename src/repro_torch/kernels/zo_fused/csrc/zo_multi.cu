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
// axis walked the B streams.  Here each thread owns one element per
// grid-stride step: it loads x once into a register and generates the B
// streams' z against it (fan-out: B coalesced stores, one per output slice;
// chain: the fold stays in the register and is stored once, so it may run
// in place).  The z generator and the affine combine are zo_stream.cuh's,
// the same code K1 runs, so each fan-out slice is bitwise K1(x, seed_j,
// a_j, b_j) and the chain is bitwise B sequential K1 launches: the cast
// through T between streams (round_to) is the write/read boundary of one
// launch (multi.py:101-117).
//
// Seeds and coefficients travel by value in the kernel's parameters, at
// most ZO_MAX_STREAMS per launch; the wrapper splits a longer list into
// consecutive launches (a chain of chains is the same fold).  Nothing is
// allocated here.
//
// Bound on the H100: fan-out reads x once and writes B outputs, chain reads
// and writes x once; each stream costs ~64 f32 flops per element, so for
// B >= 2 in bf16 the CUDA-core rate (67 TFLOP/s) bounds both, not memory.
#include "zo_stream.cuh"

#define ZO_MAX_STREAMS 64

namespace {

struct Streams {
  uint32_t seed[ZO_MAX_STREAMS];
  float a[ZO_MAX_STREAMS];
  float b[ZO_MAX_STREAMS];
};

template <typename T, int DIST>
__global__ void fanout_kernel(const T* x, T* y, int64_t n, int nb,
                              const Streams s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xv = zo::load(x, i);
    for (int j = 0; j < nb; ++j) {
      float z = zo::z_at<DIST>((uint32_t)i, s.seed[j]);
      zo::store(y, (int64_t)j * n + i, zo::affine(s.a[j], xv, s.b[j], z));
    }
  }
}

template <typename T, int DIST>
__global__ void chain_kernel(const T* x, T* y, int64_t n, int nb,
                             const Streams s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = zo::load(x, i);
    for (int j = 0; j < nb; ++j) {
      float z = zo::z_at<DIST>((uint32_t)i, s.seed[j]);
      v = zo::round_to(x, zo::affine(s.a[j], v, s.b[j], z));
    }
    zo::store(y, i, v);
  }
}

int grid_for(int64_t n, int threads) {
  int64_t want = (n + threads - 1) / threads;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

template <typename T>
cudaError_t launch(bool chain, const void* x, void* y, int64_t n, int nb,
                   const Streams& s, int dist, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads);
  if (chain) {
    if (dist == 0)
      chain_kernel<T, 0><<<blocks, threads, 0, stream>>>((const T*)x, (T*)y,
                                                         n, nb, s);
    else
      chain_kernel<T, 1><<<blocks, threads, 0, stream>>>((const T*)x, (T*)y,
                                                         n, nb, s);
  } else {
    if (dist == 0)
      fanout_kernel<T, 0><<<blocks, threads, 0, stream>>>((const T*)x, (T*)y,
                                                          n, nb, s);
    else
      fanout_kernel<T, 1><<<blocks, threads, 0, stream>>>((const T*)x, (T*)y,
                                                          n, nb, s);
  }
  return cudaGetLastError();
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

}  // extern "C"
