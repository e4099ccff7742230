// X1 zo_affine_threefry: y = a*x + b*z over one leaf, z the threefry-normal
// (or rademacher) stream of jax.random under the partitionable layout — the
// port's form of JAX's default `xla` perturbation backend
// (src/repro/perturb/xla.py:38-325).  JAX has no Pallas kernel here: XLA
// lowers threefry, erf_inv and the affine write into one loop fusion, and
// this kernel fuses them the same way, so no leaf-sized temporary exists.
//
// The bitwise specification is the plain torch version in ../kernel.py;
// this file follows it op for op under -fmad=false:
//
//  * bits: x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)) for the
//    flat index i (plus the caller's offset) — 20 rounds, 5 key injections;
//  * f32 gaussian: u = max(2(m 2^-23) + lo, lo), m = bits >> 9, then
//    erf_inv(u) as XLA:CPU expands it (log1p: a rational approximation for
//    |x| < sqrt(2) - 1, else Cephes logf(1 + x); Giles' polynomials), every
//    multiply that LLVM contracts into an add written as __fmaf_rn.  The
//    sqrt(2) and any z scale are folded into the host's scalars, as XLA's
//    algebraic simplifier folds them (kernel.f32_scalars);
//  * bf16 / f16 gaussian: a 256-entry (bits & 0xFF) or 1024-entry
//    ((bits & 0xFFFF) >> 6) table, built in shared memory by every block
//    from the same f32 erf_inv with u formed in the dtype;
//  * rademacher: +1 when bit 31 is clear, -1 otherwise;
//  * the affine write of the caller's form (kernel.FORMS): f32 with the
//    contracted FMAs, half dtypes with every op rounded to the dtype.
//
// A rows plan passes its bands (flat [start, start + len) ranges) as a
// start array and a prefix sum of lengths; element j of the launch is
// found by binary search in the prefix sum.  The counter is the flat index
// in the leaf, so a band draws the bits of that slice of the whole leaf.
//
// Design: a simple grid-stride loop, one element per thread step, no
// vectors, 64-bit indices; the form and the band route are template
// arguments.  The threefry hash (about 100 integer instructions per z)
// dominates, so the kernel is bound by instruction issue, not by bytes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum Form { FORM_Z = 0, FORM_AXPBZ = 1, FORM_XPBZ = 2, FORM_RESTORE = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// x0 ^ x1 of threefry2x32((k0, k1), (c0, c1))
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_R(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  TF_R(13) TF_R(15) TF_R(26) TF_R(6)  x0 += k1; x1 += k2 + 1u;
  TF_R(17) TF_R(29) TF_R(16) TF_R(24) x0 += k2; x1 += k0 + 2u;
  TF_R(13) TF_R(15) TF_R(26) TF_R(6)  x0 += k0; x1 += k1 + 3u;
  TF_R(17) TF_R(29) TF_R(16) TF_R(24) x0 += k1; x1 += k2 + 4u;
  TF_R(13) TF_R(15) TF_R(26) TF_R(6)  x0 += k2; x1 += k0 + 5u;
#undef TF_R
  return x0 ^ x1;
}

__device__ __forceinline__ float f_(uint32_t bits) {
  return __uint_as_float(bits);
}

// XLA:CPU's f32 log1p for x in (-1, 0]
__device__ __forceinline__ float xla_log1p(float x) {
  // large |x|: Cephes logf(1 + x)
  float y = __fadd_rn(x, 1.0f);
  y = y > f_(0x00800000u) ? y : f_(0x00800000u);
  const uint32_t bits = __float_as_uint(y);
  float e = __fadd_rn(__int2float_rn((int)(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & 0x007FFFFFu) | 0x3F000000u);
  const bool low = m < f_(0x3F3504F3u);
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  float pa = __fmaf_rn(t, f_(0x3D9021BBu), f_(0xBDEBD1B8u));
  float pb = __fmaf_rn(t, f_(0xBDFE5D4Fu), f_(0x3E11E9BFu));
  float pc = __fmaf_rn(t, f_(0x3E4CCEACu), f_(0xBE7FFFFCu));
  pa = __fmaf_rn(pa, t, f_(0x3DEF251Au));
  pb = __fmaf_rn(pb, t, f_(0xBE2AAE50u));
  pc = __fmaf_rn(pc, t, f_(0x3EAAAAAAu));
  float p = __fmaf_rn(__fmaf_rn(pa, t3, pb), t3, pc);
  p = __fmaf_rn(p, t3, __fmul_rn(e, f_(0xB95E8083u)));
  const float large =
      __fmaf_rn(e, f_(0x3F318000u),
                __fadd_rn(__fsub_rn(t, __fmul_rn(t2, 0.5f)), p));
  // small |x|: x - x^2/2 + x^3 num(x)/den(x)
  const float x2 = __fmul_rn(x, x);
  float den = 1.0f;
  den = __fmaf_rn(den, x, f_(0x417101ADu));
  den = __fmaf_rn(den, x, f_(0x42A6185Bu));
  den = __fmaf_rn(den, x, f_(0x435DC32Du));
  den = __fmaf_rn(den, x, f_(0x439A8CA3u));
  den = __fmaf_rn(den, x, f_(0x43586D8Au));
  den = __fmaf_rn(den, x, f_(0x42707982u));
  float num = f_(0x383DE04Bu);
  num = __fmaf_rn(num, x, f_(0x3EFF40C5u));
  num = __fmaf_rn(num, x, f_(0x40D284FAu));
  num = __fmaf_rn(num, x, f_(0x41EF4B9Cu));
  num = __fmaf_rn(num, x, f_(0x4273CC76u));
  num = __fmaf_rn(num, x, f_(0x426473ADu));
  num = __fmaf_rn(num, x, f_(0x41A05101u));
  const float small = __fadd_rn(
      x, __fmaf_rn(x2, -0.5f,
                   __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
  return fabsf(x) < f_(0x3ED413CDu) ? small : large;
}

__constant__ uint32_t ERFINV_LT[9] = {
    0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
    0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
__constant__ uint32_t ERFINV_GE[9] = {
    0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
    0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};

// XLA's f32 erf_inv (Giles) as XLA:CPU computes it
__device__ __forceinline__ float erf_inv_f32(float u) {
  const float lg = xla_log1p(__fmul_rn(u, -u));
  const bool lt = lg > -5.0f;
  const float ww = lt ? __fsub_rn(-2.5f, lg)
                      : __fsub_rn(__fsqrt_rn(fmaxf(-lg, 0.0f)), 3.0f);
  float p = f_(lt ? ERFINV_LT[0] : ERFINV_GE[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fmaf_rn(p, ww, f_(lt ? ERFINV_LT[i] : ERFINV_GE[i]));
  if (fabsf(u) == 1.0f) p = __uint_as_float(0x7F800000u);
  return __fmul_rn(u, p);
}

// erf_inv(u) of jax.random.normal's f32 uniform from 32 bits (the unit an
// f32 gaussian write multiplies; z = unit * sqrt(2))
__device__ __forceinline__ float unit_f32(uint32_t bits) {
  const float lo = f_(0xBF7FFFFFu);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return erf_inv_f32(fmaxf(__fadd_rn(__fmul_rn(f, 2.0f), lo), lo));
}

template <typename T> struct Half;
template <> struct Half<float> {
  static constexpr int TABLE = 0;
};
template <> struct Half<__nv_bfloat16> {
  static constexpr int TABLE = 256;
  static __device__ float rt(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ float one_plus(int i) {        // 1 + mantissa of i
    return __bfloat162float(
        __ushort_as_bfloat16((unsigned short)((i >> 1) | 0x3F80)));
  }
  static __device__ float lo() { return -0.99609375f; }   // nextafter(-1,0)
  static __device__ float sqrt2() { return 1.4140625f; }
  static __device__ uint32_t index(uint32_t bits) { return bits & 0xFFu; }
};
template <> struct Half<__half> {
  static constexpr int TABLE = 1024;
  static __device__ float rt(float v) { return __half2float(__float2half_rn(v)); }
  static __device__ float one_plus(int i) {
    return __half2float(__ushort_as_half((unsigned short)(i | 0x3C00)));
  }
  static __device__ float lo() { return -0.99951171875f; }
  static __device__ float sqrt2() { return 1.4140625f; }
  static __device__ uint32_t index(uint32_t bits) {
    return (bits & 0xFFFFu) >> 6;
  }
};

// gaussian z of table entry i of a half dtype: u formed in the dtype (each
// op rounded there), erf_inv in f32 rounded back, times sqrt(2) in it
template <typename T>
__device__ float table_entry(int i) {
  using H = Half<T>;
  const float lo = H::lo();
  const float span = H::rt(__fsub_rn(1.0f, lo));
  const float f = H::rt(__fsub_rn(H::one_plus(i), 1.0f));
  const float u = fmaxf(H::rt(__fadd_rn(H::rt(__fmul_rn(f, span)), lo)), lo);
  return H::rt(__fmul_rn(H::rt(erf_inv_f32(u)), H::sqrt2()));
}

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const __half* p, int64_t i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f(__half* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
}

struct Args {
  uint32_t k0, k1;
  uint64_t offset;
  float a, b, e, k;      // f32: k, b, e carry the folded sqrt(2) and z scale
  int zs_on;
  float zs;              // half dtypes: z <- rt(z * zs)
  const int64_t* starts;  // bands (nb > 0): flat starts
  const int64_t* cum;     // and the prefix sum of their lengths (nb + 1)
  int nb;
  int64_t total;          // elements written
};

// FORM and BANDS are template arguments so the loop holds only the write
// it runs (and its SASS count is the count per z)
template <typename T, int DIST, int FORM, bool BANDS>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(const T* x, T* y, Args g) {
  constexpr int TABLE = Half<T>::TABLE;
  __shared__ float table[TABLE > 0 ? TABLE : 1];
  if constexpr (TABLE > 0 && DIST == 0) {
    for (int i = threadIdx.x; i < TABLE; i += THREADS)
      table[i] = table_entry<T>(i);
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < g.total;
       j += stride) {
    int64_t flat = j;
    if constexpr (BANDS) {            // the band holding element j
      int lo = 0, hi = g.nb - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (g.cum[mid] <= j) lo = mid; else hi = mid - 1;
      }
      flat = g.starts[lo] + (j - g.cum[lo]);
    }
    const uint64_t idx = (uint64_t)flat + g.offset;
    const uint32_t bits = threefry_bits(g.k0, g.k1, (uint32_t)(idx >> 32),
                                        (uint32_t)idx);
    float u;
    if constexpr (DIST == 1) {
      u = (bits >> 31) ? -1.0f : 1.0f;
    } else if constexpr (TABLE == 0) {
      u = unit_f32(bits);
    } else {
      u = table[Half<T>::index(bits)];
    }
    float out;
    if constexpr (TABLE == 0) {               // f32: scalars pre-folded
      if constexpr (FORM == FORM_Z) {
        out = __fmul_rn(u, g.k);
      } else if constexpr (FORM == FORM_AXPBZ) {
        out = __fmaf_rn(g.a, load_f(x, flat), __fmul_rn(u, g.b));
      } else if constexpr (FORM == FORM_XPBZ) {
        out = __fmaf_rn(u, g.b, load_f(x, flat));
      } else {
        out = __fmaf_rn(g.a, __fmaf_rn(u, g.e, load_f(x, flat)),
                        __fmul_rn(u, g.b));
      }
    } else {                                   // every op rounded to T
      using H = Half<T>;
      const float z = g.zs_on ? H::rt(__fmul_rn(u, g.zs)) : u;
      if constexpr (FORM == FORM_Z) {
        out = z;
      } else if constexpr (FORM == FORM_AXPBZ) {
        out = __fadd_rn(H::rt(__fmul_rn(load_f(x, flat), g.a)),
                        H::rt(__fmul_rn(z, g.b)));
      } else if constexpr (FORM == FORM_XPBZ) {
        out = __fadd_rn(load_f(x, flat), H::rt(__fmul_rn(z, g.b)));
      } else {
        const float r =
            H::rt(__fadd_rn(load_f(x, flat), H::rt(__fmul_rn(z, g.e))));
        out = __fadd_rn(H::rt(__fmul_rn(r, g.a)), H::rt(__fmul_rn(z, g.b)));
      }
    }
    store_f(y, flat, out);
  }
}

int grid_for(int64_t total) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(want < cap ? want : cap);
}

template <typename T, int DIST, int FORM>
void launch_f(const void* x, void* y, const Args& g, cudaStream_t s) {
  const int grid = grid_for(g.total);
  if (g.nb > 0)
    threefry_kernel<T, DIST, FORM, true>
        <<<grid, THREADS, 0, s>>>((const T*)x, (T*)y, g);
  else
    threefry_kernel<T, DIST, FORM, false>
        <<<grid, THREADS, 0, s>>>((const T*)x, (T*)y, g);
}

template <typename T, int DIST>
void launch_d(const void* x, void* y, int form, const Args& g,
              cudaStream_t s) {
  switch (form) {
    case FORM_Z: launch_f<T, DIST, FORM_Z>(x, y, g, s); break;
    case FORM_AXPBZ: launch_f<T, DIST, FORM_AXPBZ>(x, y, g, s); break;
    case FORM_XPBZ: launch_f<T, DIST, FORM_XPBZ>(x, y, g, s); break;
    default: launch_f<T, DIST, FORM_RESTORE>(x, y, g, s);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int dist, int form,
                   const Args& g, cudaStream_t s) {
  if (dist == 0)
    launch_d<T, 0>(x, y, form, g, s);
  else
    launch_d<T, 1>(x, y, form, g, s);
  return cudaGetLastError();
}

__global__ void normal_f32_kernel(float* out, int64_t m0, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t bits = (uint32_t)(m0 + j) << 9;
  out[j] = __fmul_rn(unit_f32(bits), f_(0x3FB504F3u));
}

template <typename T>
__global__ void table_kernel(float* out) {
  for (int i = threadIdx.x; i < Half<T>::TABLE; i += blockDim.x)
    out[i] = table_entry<T>(i);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16; dist: 0 = gaussian, 1 = rademacher;
// form: enum Form.  x may be null for FORM_Z.  nb = 0: the whole leaf
// (total == n); else starts / cum (device int64) give the bands.
int zo_threefry(const void* x, void* y, int64_t n, int dtype, uint32_t k0,
                uint32_t k1, uint64_t offset, int dist, int form, float a,
                float b, float e, float k, int zs_on, float zs,
                const int64_t* starts, const int64_t* cum, int nb,
                int64_t total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || total <= 0) return 0;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 ||
      (x == nullptr && form != FORM_Z))
    return (int)cudaErrorInvalidValue;
  const Args g{k0, k1, offset, a, b, e, k, zs_on, zs, starts, cum, nb,
               total};
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, dist, form, g, s);
    case 1: return (int)launch<__nv_bfloat16>(x, y, dist, form, g, s);
    case 2: return (int)launch<__half>(x, y, dist, form, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[j] = the f32 gaussian z of bits (m0 + j) << 9, j < n: every uniform
// mantissa once for n = 2^23.
int zo_threefry_normal_f32(float* out, int64_t m0, int64_t n, void* stream) {
  if (n <= 0) return 0;
  normal_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(out, m0, n);
  return (int)cudaGetLastError();
}

// The kernel's gaussian table of a half dtype (1 = bf16: 256 entries,
// 2 = f16: 1024), as f32 values.
int zo_threefry_table(float* out, int dtype, void* stream) {
  if (dtype == 1)
    table_kernel<__nv_bfloat16><<<1, 256, 0, (cudaStream_t)stream>>>(out);
  else if (dtype == 2)
    table_kernel<__half><<<1, 256, 0, (cudaStream_t)stream>>>(out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
