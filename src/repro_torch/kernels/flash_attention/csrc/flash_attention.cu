// K2 flash_attention: causal / sliding-window GQA forward attention with an
// online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:89, _flash_kernel).
//
// Semantics kept from the Pallas kernel: scores in f32 scaled by hd^-0.5;
// keys at positions >= S masked; causal k <= q; a window w > 0 keeps
// k > q - w; head h reads kv-head h / (H / KV); out = acc / max(l, 1e-30).
// Like JAX's (its BlockSpec spans the whole hd), the kernel takes any head
// dim and f32, bf16 or f16.  The TPU ran its grid in order and carried
// (m, l, acc) in VMEM across the KV-block axis.  Here the KV loop runs inside
// the CTA.  Tiles wholly in the causal future or wholly outside the window
// are never visited, and the mask is applied only on the tiles that cut the
// diagonal, the window edge or S.  No atomics: two launches agree bit for
// bit.
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
// bf16 / f16 route (flash_fwd_mma, head dims up to 256), a FlashAttention-2
// forward on the tensor cores: one CTA of 4 warps per (64-row q tile, head,
// batch), each warp owning 16 query rows.  It is instantiated for HD in
// {16, 32, 64, 96, 128, 192, 256}; a head dim between two instances runs the
// next one up with the columns past hd zero-filled in shared memory — exact
// in Q·Kᵀ (a zero adds nothing) and never stored.  Each instance has an
// exact form (hd equal to it: no column checks, the store's extent known at
// compile time — the padded form's checks cost the hd-64 kernel a register
// and 7 % of its time) and a padded one.  The Q tile comes in once
// by cp.async; up to HD 192 it stays in registers as mma A fragments
// (ldmatrix), at HD 256 it is read from shared memory at each k-step (the
// registers would spill).  The K and V tiles (BN keys: 64, 32 from HD 192
// on) stay in shared memory,
// double-buffered by 16-byte cp.async so the next tile loads while this one
// is multiplied, rows padded by 16 bytes so ldmatrix is free of bank
// conflicts; past 48 KB the buffers are dynamic shared memory.  S = Q·Kᵀ
// runs as mma.sync m16n8k16 → f32 (bf16 or f16 inputs): a product of two
// such values is exact in f32, so this equals JAX's f32 product of the
// f32-cast inputs up to the order of summation; the scale is applied to the
// f32 scores.  The online softmax runs in registers, row max and row sum
// across the 4 lanes of a quad.  P·V cannot round P to one bf16: JAX
// multiplies the f32 P by the f32-cast V, and one bf16 rounding of P
// (relative error up to 2^-8) puts ~10 % of the bf16 outputs beyond one
// bf16 ulp of the f32 reference (tests/test_torch_flash_numerics.py).  So
// P is split in registers into P_hi = T(P) and P_lo = T(P - P_hi) (together
// within 2^-16 of P in bf16, 2^-22 in f16), both repacked as A fragments
// without a trip through shared memory, and two mma's per V fragment
// (ldmatrix.trans) add P_hi·V and P_lo·V into the same f32 accumulators:
// 1.5× the MMA work of the one-rounding design, negligible against the
// bound.  The epilogue scales by 1/max(l, 1e-30), rounds to T and stages
// each warp's rows through shared memory for 16-byte coalesced stores.
// Inputs are read through (b, s, h) strides that the wrapper has checked to
// be multiples of 8 elements on a 16-byte-aligned base with a head dim that
// is a multiple of 8 (it copies inputs that are not so first).
//
// Scalar route (flash_fwd_sliced): f32 at every head dim — no tensor-core
// format holds f32 to the 1e-5 absolute limit its checks keep, and no path
// of the port runs K2 in f32 — and bf16 / f16 past 256.  One thread per
// query row; the head dim is walked in slices of DS columns: the scores sum
// over all slices (K staged in shared memory one slice at a time), and each
// output slice runs its own online softmax over the keys, so registers hold
// one slice of q and of the accumulator whatever hd is.  Scalar f32 FMAs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <math.h>

namespace {

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// ----------------------------------------------------------------------------
// scalar route: online softmax, hd in slices of DS columns
// ----------------------------------------------------------------------------
constexpr int BQ = 128;   // query rows per CTA (one per thread)
constexpr int BK = 32;    // KV rows per shared-memory tile
constexpr int G16 = 16;   // keys scored per online-softmax update

template <typename T, int DS>
__global__ void __launch_bounds__(BQ)
flash_fwd_sliced(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int hd, Strides qs, Strides ks, Strides vs,
                 float scale, int causal, int window) {
  __shared__ float k_tile[BK][DS];
  __shared__ float v_tile[BK][DS];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qi = qb * BQ + threadIdx.x;
  const bool valid = qi < S;

  const int q_lo = qb * BQ;
  const int q_hi = min(S, q_lo + BQ) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;

  const T* qp = q + b * qs.b + (int64_t)min(qi, S - 1) * qs.s + h * qs.h;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  T* op = o + (((int64_t)b * S + qi) * H + h) * hd;

  for (int o0 = 0; o0 < hd; o0 += DS) {
    float acc[DS];
#pragma unroll
    for (int d = 0; d < DS; ++d) acc[d] = 0.0f;
    float m = -1e30f, l = 0.0f;
    for (int kt = k_begin; kt < k_end; kt += BK) {
      float sc[BK];
#pragma unroll
      for (int j = 0; j < BK; ++j) sc[j] = 0.0f;
      for (int d0 = 0; d0 < hd; d0 += DS) {
        __syncthreads();
        for (int e = threadIdx.x; e < BK * DS; e += BQ) {
          const int r = e / DS, d = e % DS, kp = kt + r;
          k_tile[r][d] = kp < S && d0 + d < hd
                             ? to_f32(kbase[(int64_t)kp * ks.s + d0 + d])
                             : 0.0f;
        }
        __syncthreads();
        if (!valid) continue;
        float qr[DS];
#pragma unroll
        for (int d = 0; d < DS; ++d)
          qr[d] = d0 + d < hd ? to_f32(qp[d0 + d]) * scale : 0.0f;
#pragma unroll
        for (int j = 0; j < BK; ++j)
#pragma unroll
          for (int d = 0; d < DS; ++d)
            sc[j] = fmaf(qr[d], k_tile[j][d], sc[j]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < BK * DS; e += BQ) {
        const int r = e / DS, d = e % DS, kp = kt + r;
        v_tile[r][d] = kp < S && o0 + d < hd
                           ? to_f32(vbase[(int64_t)kp * vs.s + o0 + d])
                           : 0.0f;
      }
      __syncthreads();
      if (!valid) continue;
#pragma unroll
      for (int j0 = 0; j0 < BK; j0 += G16) {
        float cmax = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < G16; ++jj) {
          const int kp = kt + j0 + jj;
          bool keep = kp < S;
          if (causal) keep = keep && kp <= qi;
          if (window > 0) keep = keep && kp > qi - window;
          sc[j0 + jj] = keep ? sc[j0 + jj] : -INFINITY;
          cmax = fmaxf(cmax, sc[j0 + jj]);
        }
        if (cmax == -INFINITY) continue;
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int d = 0; d < DS; ++d) acc[d] *= corr;
#pragma unroll
        for (int jj = 0; jj < G16; ++jj) {
          const float p = expf(sc[j0 + jj] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < DS; ++d)
            acc[d] = fmaf(p, v_tile[j0 + jj][d], acc[d]);
        }
        m = m_new;
      }
    }
    if (valid) {
      const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int d = 0; d < DS; ++d)
        if (o0 + d < hd) op[o0 + d] = from_f32<T>(acc[d] * inv);
    }
  }
}

// ----------------------------------------------------------------------------
// bf16 / f16 route: mma.sync tiles
// ----------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;
constexpr int BM = 16 * MMA_WARPS;  // query rows per CTA

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

// d += a · b: m16n8k16, A row-major, B column-major, f32 sums; not volatile
// — a pure function of its registers that the compiler may interleave with
// independent work (ldmatrix stays volatile: it reads shared memory the
// compiler does not see)
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> the T×2 words of P_hi = T(x) and P_lo = T(x - P_hi)
__device__ __forceinline__ void split_pair(__nv_bfloat16*, float x0, float x1,
                                           uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}
__device__ __forceinline__ void split_pair(__half*, float x0, float x1,
                                           uint32_t& hi, uint32_t& lo) {
  __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x, one MUFU.EX2 (max relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// rows [row0, row0 + ROWS) of a (S, hd) slab into a padded shared tile of
// HD columns; chunks at or past hd (a multiple of 8; hd == HD when EXACT)
// and rows at or past S are zero-filled (src-size 0: nothing is read)
template <typename T, int HD, int ROWS, bool EXACT>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          int64_t row_stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int LD = HD + 8, CH = HD / 8, NT = 32 * MMA_WARPS;
  static_assert(ROWS * CH % NT == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CH, c = i % CH, pos = row0 + r;
    const bool in = pos < S && (EXACT || c * 8 < hd);
    const T* src = in ? base + (int64_t)pos * row_stride + c * 8 : base;
    cp_async16(tile + r * LD + c * 8, src, in ? 16 : 0);
  }
}

template <typename T, int HD, int BN>
constexpr int mma_smem_bytes() {
  return (BM + 4 * BN) * (HD + 8) * (int)sizeof(T);
}

// the key tile and where Q lives, per instance: past HD 128 the registers
// of Q's fragments, the accumulators and the scores spill, so the key tile
// shrinks to 32 or Q stays in shared memory, whichever -Xptxas -v showed
// spilling less when all were built (nvcc 12.8 for sm_90a, bytes of spill
// stores, bf16 / f16): HD 192 — 32-key tile 8 / 8, Q in shared memory 48 /
// 80; HD 256 — 32-key tile 248 / 248, Q in shared memory 280 / 284, both
// 100 / 100, so HD 256 takes both.
template <int HD>
struct MmaShape {
  static constexpr int BN = 64;
  static constexpr bool QREG = true;
};
template <>
struct MmaShape<192> {
  static constexpr int BN = 32;
  static constexpr bool QREG = true;
};
template <>
struct MmaShape<256> {
  static constexpr int BN = 32;
  static constexpr bool QREG = false;
};

template <typename T, int HD, int BN, bool QREG, bool EXACT>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int KV, int hd, int hd_o, Strides qs, Strides ks, Strides vs,
              float scale, int causal, int window) {
  constexpr int LD = HD + 8;      // padded smem row (elements): 16 B apart
  constexpr int KSTEPS = HD / 16; // k-steps of Q·Kᵀ
  constexpr int NT_S = BN / 8;    // 8-key n-tiles of the scores
  constexpr int NT_O = HD / 8;    // 8-column n-tiles of the output
  // V fragments loaded at a time: the largest of 4, 3, 2, 1 that divides
  // the NT_O / 2 fragment pairs
  constexpr int NPG = (NT_O / 2) % 4 == 0 ? 4 : (NT_O / 2) % 3 == 0 ? 3
                      : (NT_O / 2) % 2 == 0 ? 2 : 1;
  static_assert((NT_O / 2) % NPG == 0, "whole groups of V fragments");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK0 = sQ + BM * LD;
  T* sV0 = sK0 + 2 * BN * LD;

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

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;

  load_tile<T, HD, BM, EXACT>(sQ, qbase, qs.s, q_lo, S, hd, tid);
  load_tile<T, HD, BN, EXACT>(sK0, kbase, ks.s, t_begin * BN, S, hd, tid);
  load_tile<T, HD, BN, EXACT>(sV0, vbase, vs.s, t_begin * BN, S, hd, tid);
  cp_async_commit();

  // this thread's two rows in the warp's 16: g and g + 8
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q_lo + warp * 16 + g;
  uint32_t qa[QREG ? KSTEPS : 1][4];
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
      load_tile<T, HD, BN, EXACT>(sK0 + (buf ^ 1) * BN * LD, kbase, ks.s,
                           (t + 1) * BN, S, hd, tid);
      load_tile<T, HD, BN, EXACT>(sV0 + (buf ^ 1) * BN * LD, vbase, vs.s,
                           (t + 1) * BN, S, hd, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (QREG) {
      if (t == t_begin) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int mi = lane >> 3;
          ldmatrix_x4(qa[kk], sQ + (warp * 16 + (mi & 1) * 8 + (lane & 7)) *
                                       LD + kk * 16 + (mi >> 1) * 8);
        }
      }
    }
    const T* tk = sK0 + buf * BN * LD;
    const T* tv = sV0 + buf * BN * LD;
    const int k0 = t * BN;

    // S = Q · Kᵀ for this warp's 16 rows and the tile's BN keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qk[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qa[kk][e];
      } else {
        const int mi = lane >> 3;
        ldmatrix_x4(qk, sQ + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                            kk * 16 + (mi >> 1) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        const int mi = lane >> 3;
        uint32_t kb[4];
        ldmatrix_x4(kb, tk + (jp * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                            kk * 16 + (mi & 1) * 8);
        mma<T>(s[2 * jp], qk, kb[0], kb[1]);
        mma<T>(s[2 * jp + 1], qk, kb[2], kb[3]);
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
      split_pair((T*)nullptr, s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair((T*)nullptr, s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair((T*)nullptr, s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2],
                 pl[2]);
      split_pair((T*)nullptr, s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3],
                 pl[3]);
#pragma unroll
      for (int g0 = 0; g0 < NT_O / 2; g0 += NPG) {
        uint32_t vb[NPG][4];
#pragma unroll
        for (int np = 0; np < NPG; ++np) {
          const int mi = lane >> 3;
          ldmatrix_x4_trans(vb[np], tv + (kk * 16 + (mi & 1) * 8 +
                                          (lane & 7)) * LD +
                                        (g0 + np) * 16 + (mi >> 1) * 8);
        }
        // all P_hi products, then all P_lo ones: consecutive mma's write
        // different accumulators
#pragma unroll
        for (int np = 0; np < NPG; ++np) {
          mma<T>(acc[2 * (g0 + np)], ph, vb[np][0], vb[np][1]);
          mma<T>(acc[2 * (g0 + np) + 1], ph, vb[np][2], vb[np][3]);
        }
#pragma unroll
        for (int np = 0; np < NPG; ++np) {
          mma<T>(acc[2 * (g0 + np)], pl, vb[np][0], vb[np][1]);
          mma<T>(acc[2 * (g0 + np) + 1], pl, vb[np][2], vb[np][3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  // epilogue: full row sums, scale, round to T, stage the warp's rows in
  // its own 16 rows of sQ (read only by this warp), coalesced stores of the
  // hd_o columns that exist
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[r] = 1.0f / fmaxf(lt, 1e-30f);
  }
  T* so = sQ + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = j * 8 + qd * 2;
    *reinterpret_cast<uint32_t*>(so + g * LD + col) =
        pack2((T*)nullptr, acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + col) =
        pack2((T*)nullptr, acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  if constexpr (EXACT) {
    constexpr int CH = HD / 8;
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH, pos = q_lo + warp * 16 + r;
      if (pos < S)
        *reinterpret_cast<uint4*>(o + (((int64_t)b * S + pos) * H + h) * HD +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
    }
  } else if (hd_o % 8 == 0) {
    const int ch = hd_o / 8;
    for (int i = lane; i < 16 * ch; i += 32) {
      const int r = i / ch, c = i % ch, pos = q_lo + warp * 16 + r;
      if (pos < S)
        *reinterpret_cast<uint4*>(o + (((int64_t)b * S + pos) * H + h) * hd_o +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
    }
  } else {
    for (int i = lane; i < 16 * hd_o; i += 32) {
      const int r = i / hd_o, c = i % hd_o, pos = q_lo + warp * 16 + r;
      if (pos < S)
        o[(((int64_t)b * S + pos) * H + h) * hd_o + c] = so[r * LD + c];
    }
  }
}

// ----------------------------------------------------------------------------
// launch
// ----------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, H, KV, hd, hd_o;
  Strides qs, ks, vs;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int DS>
cudaError_t launch_sliced(const Args& a) {
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_sliced<T, DS><<<grid, BQ, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.S, a.H, a.KV,
      a.hd, a.qs, a.ks, a.vs, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sliced(const Args& a) {
  if (a.hd <= 16) return launch_sliced<T, 16>(a);
  if (a.hd <= 32) return launch_sliced<T, 32>(a);
  return launch_sliced<T, 64>(a);
}

template <typename T, int HD, int BN, bool QREG, bool EXACT>
cudaError_t launch_mma(const Args& a) {
  constexpr int bytes = mma_smem_bytes<T, HD, BN>();
  auto kernel = flash_fwd_mma<T, HD, BN, QREG, EXACT>;
  static bool attr_set = false;
  if (bytes > 48 * 1024 && !attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  kernel<<<grid, 32 * MMA_WARPS, bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.S, a.H, a.KV,
      a.hd, a.hd_o, a.qs, a.ks, a.vs, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// the instances, HD = the next one at or above hd
// the instance's exact form (hd == hd_o == HD: no column checks, the
// epilogue's extent known at compile time) or its padded one
template <typename T, int HD>
cudaError_t launch_instance(const Args& a) {
  constexpr int BN = MmaShape<HD>::BN;
  constexpr bool QREG = MmaShape<HD>::QREG;
  return a.hd == HD && a.hd_o == HD ? launch_mma<T, HD, BN, QREG, true>(a)
                                    : launch_mma<T, HD, BN, QREG, false>(a);
}

template <typename T>
cudaError_t dispatch_mma(const Args& a) {
  if (a.hd <= 16) return launch_instance<T, 16>(a);
  if (a.hd <= 32) return launch_instance<T, 32>(a);
  if (a.hd <= 64) return launch_instance<T, 64>(a);
  if (a.hd <= 96) return launch_instance<T, 96>(a);
  if (a.hd <= 128) return launch_instance<T, 128>(a);
  if (a.hd <= 192) return launch_instance<T, 192>(a);
  if (a.hd <= 256) return launch_instance<T, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B,S,H,·), k/v (B,S,KV,·) with unit stride on the head dim and the
// given (b, s, h) element strides, of which the kernel reads hd columns;
// o (B,S,H,hd_o) contiguous.  dtype 0 = f32, 1 = bf16, 2 = f16.  route 0 =
// the mma.sync kernel (bf16 / f16, hd_o <= hd <= 256, hd a multiple of 8,
// base pointers 16-byte aligned and strides multiples of 8 elements — the
// columns in [hd_o, hd) are zeros the wrapper padded on), 1 = the scalar
// kernel (any dtype, hd_o == hd, any hd).  The wrapper checks all of it.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int route, int B, int S, int H, int KV, int hd,
                    int hd_o, int64_t qsb, int64_t qss, int64_t qsh,
                    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                    int64_t vss, int64_t vsh, float scale, int causal,
                    int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd_o <= 0 || hd_o > hd)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, S, H, KV, hd, hd_o, Strides{qsb, qss, qsh},
               Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, scale, causal,
               window, (cudaStream_t)stream};
  if (route == 1) {
    if (hd_o != hd) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case 0: return (int)dispatch_sliced<float>(a);
      case 1: return (int)dispatch_sliced<__nv_bfloat16>(a);
      case 2: return (int)dispatch_sliced<__half>(a);
    }
  } else if (route == 0 && hd % 8 == 0) {
    switch (dtype) {
      case 1: return (int)dispatch_mma<__nv_bfloat16>(a);
      case 2: return (int)dispatch_mma<__half>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
