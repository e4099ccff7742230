// K2 flash_attention: causal / sliding-window GQA forward attention with an
// online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:89, _flash_kernel).
//
// Semantics kept from the Pallas kernel: scores in f32 with q pre-scaled by
// hd^-0.5; keys at positions >= S masked; causal k <= q; a window w > 0 keeps
// k > q - w; head h reads kv-head h / (H / KV); out = acc / max(l, 1e-30).
//
// The TPU ran its grid in order and carried (m, l, acc) in VMEM across the
// KV-block axis.  Here the KV loop runs inside the CTA: one CTA per
// (q-block of BQ rows, head, batch), one thread per query row holding its
// scaled q row, its m, l and acc in registers; K and V tiles of BK rows are
// staged in shared memory as f32 and read by every thread at the same
// address (broadcast).  KV tiles wholly in the causal future or wholly
// outside the window are never visited; within a tile, keys are scored in
// groups of 16 so acc is rescaled once per group, not once per key.
//
// Bound on the H100: operations — 4*hd flops per unmasked (q, k) pair
// against the 989 TFLOP/s bf16 tensor-core rate; this first kernel issues
// them as scalar f32 FMAs on the CUDA cores (no mma/wgmma yet), so it runs
// far from that bound.  Inputs are read through arbitrary (b, s, h) strides
// (the model's (B, S, H, hd) layout), the output is written contiguous.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BQ = 128;   // query rows per CTA (one per thread)
constexpr int BK = 32;    // KV rows per shared-memory tile
constexpr int G16 = 16;   // keys scored per online-softmax update

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  int64_t b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
          Strides qs, Strides ks, Strides vs, float scale, int causal,
          int window) {
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qi = qb * BQ + threadIdx.x;
  const bool valid = qi < S;

  float qr[HD], acc[HD];
  if (valid) {
    const T* qp = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f(qp[d]) * scale;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = -1e30f, l = 0.0f;

  const int q_lo = qb * BQ;
  const int q_hi = min(S, q_lo + BQ) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;

  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * HD; e += BQ) {
      const int r = e / HD, d = e % HD, kp = kt + r;
      const bool in = kp < S;
      k_tile[r][d] = in ? to_f(kbase[(int64_t)kp * ks.s + d]) : 0.0f;
      v_tile[r][d] = in ? to_f(vbase[(int64_t)kp * vs.s + d]) : 0.0f;
    }
    __syncthreads();
    if (!valid) continue;
#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += G16) {
      float sc[G16];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < G16; ++jj) {
        const int kp = kt + j0 + jj;
        bool keep = kp < S;
        if (causal) keep = keep && kp <= qi;
        if (window > 0) keep = keep && kp > qi - window;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], k_tile[j0 + jj][d], s);
        sc[jj] = keep ? s : -INFINITY;
        cmax = fmaxf(cmax, sc[jj]);
      }
      if (cmax == -INFINITY) continue;
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < G16; ++jj) {
        const float p = expf(sc[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, v_tile[j0 + jj][d], acc[d]);
      }
      m = m_new;
    }
  }
  if (valid) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* op = o + (((int64_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) put(op + d, acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, Strides qs, Strides ks,
                   Strides vs, float scale, int causal, int window,
                   cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, BQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, qs, ks, vs,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int KV, Strides qs,
                     Strides ks, Strides vs, float scale, int causal,
                     int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B,S,H,hd), k/v (B,S,KV,hd) with unit stride on hd and the given
// (b, s, h) element strides; o (B,S,H,hd) contiguous.  dtype 0 = f32,
// 1 = bf16; hd in {16, 32, 64}.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int S, int H, int KV, int hd,
                    int64_t qsb, int64_t qss, int64_t qsh,
                    int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh,
                    float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
