// K2 flash_attention: causal / sliding-window GQA forward attention with an
// online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:89, _flash_kernel).
//
// Semantics kept from the Pallas kernel: scores in f32 scaled by hd^-0.5;
// keys at positions >= S masked; causal k <= q; a window w > 0 keeps
// k > q - w; head h reads kv-head h / (H / KV); out = acc / max(l, 1e-30).
// The TPU ran its grid in order and carried (m, l, acc) in VMEM across the
// KV-block axis.  Here the KV loop runs inside the CTA.  Tiles wholly in the
// causal future or wholly outside the window are never visited, and the
// mask is applied only on the tiles that cut the diagonal, the window edge
// or S.  No atomics: two launches agree bit for bit.
//
// Bound on the H100 at the training shape (16, 256, 14, 64) bf16: bytes —
// q, k, v read once and o written once, 17 MB at 3.35 TB/s = 0.005 ms; the
// 1.89 GFLOP of 4·hd flops per unmasked (q, k) pair take 0.002 ms at the
// 989 TFLOP/s bf16 tensor-core rate.  At that size the kernel is bound by
// latency long before either.  Measured by chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W (runs of 100 launches in one CUDA graph): 0.0224 ms
// at the training shape, 4.5× the bound; one cuDNN SDPA call 0.0161 ms;
// the scalar kernel this route replaced, 0.242 ms.
//
// bf16 route (flash_fwd_mma), a FlashAttention-2 forward on the tensor
// cores: one CTA of 4 warps per (64-row q tile, head, batch), each warp
// owning 16 query rows.  The Q tile comes in once by cp.async and stays in
// registers as mma A fragments (ldmatrix); 64-row K and V tiles stay bf16 in
// shared memory, double-buffered by 16-byte cp.async so the next tile loads
// while this one is multiplied, rows padded by 16 bytes so ldmatrix is free
// of bank conflicts.  S = Q·Kᵀ runs as mma.sync m16n8k16 bf16 → f32: a
// product of two bf16 values is exact in f32, so this equals JAX's f32
// product of the f32-cast inputs up to the order of summation; the scale is
// applied to the f32 scores (a power of two for hd 16 and 64, so equal to
// JAX's pre-scaled q).  The online softmax runs in registers, row max and
// row sum across the 4 lanes of a quad.  P·V cannot round P to one bf16:
// JAX multiplies the f32 P by the f32-cast V, and one bf16 rounding of P
// (relative error up to 2^-8) puts ~10 % of the bf16 outputs beyond one
// bf16 ulp of the f32 reference (tests/test_torch_flash_numerics.py).  So
// P is split
// in registers into P_hi = bf16(P) and P_lo = bf16(P - P_hi) (together
// within 2^-16 of P), both repacked as A fragments without a trip through
// shared memory, and two mma's per V fragment (ldmatrix.trans) add
// P_hi·V and P_lo·V into the same f32 accumulators: 1.5× the MMA work of
// the one-rounding design, negligible against the bound.  The epilogue
// scales by 1/max(l, 1e-30), rounds to bf16 and stages each warp's rows
// through shared memory for 16-byte coalesced stores.  Inputs are read
// through (b, s, h) strides that the wrapper has checked to be multiples of
// 8 elements on a 16-byte-aligned base.
//
// f32 route (flash_fwd, the first kernel of the port): no tensor-core
// format holds f32 to the 1e-5 absolute limit its checks keep, and no path
// of the port runs K2 in f32, so it stays scalar — one thread per query
// row, K and V tiles staged in shared memory as f32 and read at one address
// by every thread, scalar f32 FMAs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

struct Strides {
  int64_t b, s, h;
};

// ----------------------------------------------------------------------------
// f32 route: scalar online softmax
// ----------------------------------------------------------------------------
constexpr int BQ = 128;   // query rows per CTA (one per thread)
constexpr int BK = 32;    // KV rows per shared-memory tile
constexpr int G16 = 16;   // keys scored per online-softmax update

template <int HD>
__global__ void __launch_bounds__(BQ)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int H,
          int KV, Strides qs, Strides ks, Strides vs, float scale, int causal,
          int window) {
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qi = qb * BQ + threadIdx.x;
  const bool valid = qi < S;

  float qr[HD], acc[HD];
  if (valid) {
    const float* qp = q + b * qs.b + (int64_t)qi * qs.s + h * qs.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qp[d] * scale;
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

  const float* kbase = k + b * ks.b + kvh * ks.h;
  const float* vbase = v + b * vs.b + kvh * vs.h;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * HD; e += BQ) {
      const int r = e / HD, d = e % HD, kp = kt + r;
      const bool in = kp < S;
      k_tile[r][d] = in ? kbase[(int64_t)kp * ks.s + d] : 0.0f;
      v_tile[r][d] = in ? vbase[(int64_t)kp * vs.s + d] : 0.0f;
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
    float* op = o + (((int64_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] * inv;
  }
}

// ----------------------------------------------------------------------------
// bf16 route: mma.sync tiles
// ----------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;
constexpr int BM = 16 * MMA_WARPS;  // query rows per CTA
constexpr int BN = 64;              // keys per K/V tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b: m16n8k16, A row-major bf16, B column-major bf16, f32 sums;
// not volatile — a pure function of its registers that the compiler may
// interleave with independent work (ldmatrix stays volatile: it reads
// shared memory the compiler does not see)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> the bf16x2 words of P_hi = bf16(x) and P_lo = bf16(x - P_hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits_of(h);
  lo = bits_of(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 2^x, one MUFU.EX2 (max relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// rows [row0, row0 + 64) of a (S, HD) slab into a padded shared tile;
// rows at or beyond S are zero-filled (src-size 0: nothing is read)
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          int64_t row_stride, int row0, int S,
                                          int tid) {
  constexpr int LD = HD + 8, CH = HD / 8, ROWS = 64, T = 32 * MMA_WARPS;
  static_assert(ROWS * CH % T == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / T; ++it) {
    const int i = tid + it * T;
    const int r = i / CH, c = i % CH, pos = row0 + r;
    const bool in = pos < S;
    const __nv_bfloat16* src = in ? base + (int64_t)pos * row_stride + c * 8 : base;
    cp_async16(tile + r * LD + c * 8, src, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              int S, int H, int KV, Strides qs, Strides ks, Strides vs,
              float scale, int causal, int window) {
  constexpr int LD = HD + 8;      // padded smem row (elements): 16 B apart
  constexpr int KSTEPS = HD / 16; // k-steps of Q·Kᵀ
  constexpr int NT_S = BN / 8;    // 8-key n-tiles of the scores
  constexpr int NT_O = HD / 8;    // 8-column n-tiles of the output
  constexpr int CH = HD / 8;      // 16-byte chunks per row
  __shared__ __align__(128) __nv_bfloat16 sQ[BM * LD];
  __shared__ __align__(128) __nv_bfloat16 sK[2][BN * LD];
  __shared__ __align__(128) __nv_bfloat16 sV[2][BN * LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the causal q tiles at the end of the sequence carry the most key tiles:
  // hand them out first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_lo = qb * BM;
  const int q_last = min(S, q_lo + BM) - 1;
  const int k_stop = causal ? q_last + 1 : S;
  const int k_first = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = k_first / BN, t_end = (k_stop + BN - 1) / BN;

  const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kbase = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + kvh * vs.h;

  load_tile<HD>(sQ, qbase, qs.s, q_lo, S, tid);
  load_tile<HD>(sK[0], kbase, ks.s, t_begin * BN, S, tid);
  load_tile<HD>(sV[0], vbase, vs.s, t_begin * BN, S, tid);
  cp_async_commit();

  // this thread's two rows in the warp's 16: g and g + 8
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q_lo + warp * 16 + g;
  uint32_t qa[KSTEPS][4];
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<HD>(sK[buf ^ 1], kbase, ks.s, (t + 1) * BN, S, tid);
      load_tile<HD>(sV[buf ^ 1], vbase, vs.s, (t + 1) * BN, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int mi = lane >> 3;
        ldmatrix_x4(qa[kk], sQ + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                                kk * 16 + (mi >> 1) * 8);
      }
    }
    const __nv_bfloat16* tk = sK[buf];
    const __nv_bfloat16* tv = sV[buf];
    const int k0 = t * BN;

    // S = Q · Kᵀ for this warp's 16 rows and the tile's 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        const int mi = lane >> 3;
        uint32_t kb[4];
        ldmatrix_x4(kb, tk + (jp * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                            kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale; mask only where the tile cuts S, the diagonal or the window
    const bool masked = k0 + BN > S || (causal && k0 + BN - 1 > q_lo) ||
                        (window > 0 && k0 <= q_lo + BM - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int key = k0 + j * 8 + qd * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          bool keep = key < S;
          if (causal) keep = keep && key <= row;
          if (window > 0) keep = keep && key > row - window;
          x = keep ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_approx((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // e^(x - m) as 2^(x·log2 e - m·log2 e): one FFMA and one MUFU.EX2
    const float ml2e[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -ml2e[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // acc += P_hi · V + P_lo · V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      uint32_t vb[NT_O / 2][4];
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vb[np], tv + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                           LD + np * 16 + (mi >> 1) * 8);
      }
      // all P_hi products, then all P_lo ones: consecutive mma's write
      // different accumulators
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        mma_bf16(acc[2 * np], ph, vb[np][0], vb[np][1]);
        mma_bf16(acc[2 * np + 1], ph, vb[np][2], vb[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        mma_bf16(acc[2 * np], pl, vb[np][0], vb[np][1]);
        mma_bf16(acc[2 * np + 1], pl, vb[np][2], vb[np][3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  // epilogue: full row sums, scale, round to bf16, stage the warp's rows in
  // its own 16 rows of sQ (read only by this warp), 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[r] = 1.0f / fmaxf(lt, 1e-30f);
  }
  __nv_bfloat16* so = sQ + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = j * 8 + qd * 2;
    *reinterpret_cast<__nv_bfloat162*>(so + g * LD + col) =
        __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, pos = q_lo + warp * 16 + r;
    if (pos < S)
      *reinterpret_cast<uint4*>(o + (((int64_t)b * S + pos) * H + h) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
  }
}

// ----------------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------------
template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, Strides qs, Strides ks,
                       Strides vs, float scale, int causal, int window,
                       cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<HD><<<grid, BQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KV,
      qs, ks, vs, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, Strides qs, Strides ks,
                        Strides vs, float scale, int causal, int window,
                        cudaStream_t stream) {
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_fwd_mma<HD><<<grid, 32 * MMA_WARPS, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, H, KV, qs, ks, vs, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B,S,H,hd), k/v (B,S,KV,hd) with unit stride on hd and the given
// (b, s, h) element strides; o (B,S,H,hd) contiguous.  dtype 0 = f32 (the
// scalar kernel), 1 = bf16 (the mma.sync kernel: base pointers 16-byte
// aligned and strides multiples of 8 elements, checked by the wrapper);
// hd in {16, 32, 64}.
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
#define K2_ARGS q, k, v, o, B, S, H, KV, qs, ks, vs, scale, causal, window, st
  if (dtype == 0) {
    switch (hd) {
      case 16: return (int)launch_f32<16>(K2_ARGS);
      case 32: return (int)launch_f32<32>(K2_ARGS);
      case 64: return (int)launch_f32<64>(K2_ARGS);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return (int)launch_bf16<16>(K2_ARGS);
      case 32: return (int)launch_bf16<32>(K2_ARGS);
      case 64: return (int)launch_bf16<64>(K2_ARGS);
    }
  }
#undef K2_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
