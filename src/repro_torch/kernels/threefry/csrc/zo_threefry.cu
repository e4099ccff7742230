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
//    multiply that LLVM contracts into an add written as __fmaf_rn;
//  * bf16 gaussian: a 256-entry table (bits & 0xFF) of z, built by every
//    block from the same f32 erf_inv with u formed in bf16; f16 gaussian: a
//    1024-entry table ((bits & 0xFFFF) >> 6) of erf_inv(u) rounded to f16;
//  * rademacher: +1 when bit 31 is clear, -1 otherwise;
//  * the affine write of the caller's form (kernel.FORMS).  f32 and f16:
//    on the unit (f32 / f16 gaussian: erf_inv(u)) with z's sqrt(2) and any
//    z scale folded into the host's scalars, as XLA's algebraic simplifier
//    folds them (kernel.folded_scalars), and one multiply contracted into
//    each add — __fmaf_rn in f32, __hfma2 in f16 (XLA:CPU's native half
//    FMAs); bf16: on z, every op rounded to bf16, the z-side products
//    (rt(b*z), rt(e*z), the z scale) read from the block's table.
//
// What bounds X1 on the H100.  Each element is read and written once (4
// bytes in bf16): 0.75 ms per qwen2-0.5b pass.  The 20 threefry rounds are
// an add, a rotate and a xor each.  The ALU pipe (LOP3, SHF, IADD3, and
// F2FP) takes 16 lanes per SM partition, half the issue rate; IMAD and
// VIADD run on the FMA pipe's integer side, also at 16 lanes, beside it
// (the pipe probes below; chip_smoke.py prints their rates).  ptxas issues
// most round adds as IMAD by itself, so what stays on the ALU pipe is the
// rotates (SHF) and the xors (LOP3): X1 is bound by that pipe — its first
// design issued 66 ALU instructions per z, 2.5 ms of ALU time per qwen2
// pass at 1 980 MHz.  The design takes every other instruction off it:
//
//  * the counter's high word is a per-launch constant: the host splits a
//    call at counters that are multiples of 2^31, so no launch crosses
//    2^32, and round 1's x0 = hi + k0 is one constant (x1 = lo + k1 + i, a
//    32-bit index inside the launch); the key schedule's sums (k2 + r) are
//    launch constants read from the parameter bank;
//  * the last key injection is an IMAD that also scales the bits into a
//    table's byte offset, and one LOP3 xors and masks them;
//  * K1's 16-byte vectors: 8 bf16 / f16 or 4 f32 elements per thread step,
//    one load and one store, their 4-8 z independent chains; a scalar head
//    and tail take the elements off the 16-byte grid, and x and y that lie
//    differently against 16 bytes run all scalar (kernel.whole_launches
//    computes the split; its routes are counted apart);
//  * bf16: a*x is one HMUL2 per pair, a store packs two elements per F2FP,
//    and the z-side products come from the table, built per block (256
//    entries against ~600 000 z per block on a qwen2 pass).
//
// What is left on the ALU pipe is about 46 instructions per z: 20 SHF, 21
// LOP3, the injections' IADD3.  Rotates as IMAD + IMAD.HI (IMAD.HI takes
// two slots of the FMA pipe), as IMAD.WIDE, or the injections forced onto
// IMAD each made the bf16 pass slower on the card, so the rounds stay as
// written.
//
// A rows plan passes its bands (flat [start, start + len) ranges) as a
// start array and a prefix sum of lengths (the `bands` route: one element
// per thread step, binary search for the band, the general 64-bit
// counter); the counter is the flat index in the leaf, so a band draws the
// bits of that slice of the whole leaf.
//
// The original layout (jax_threefry_partitionable off) has its own route,
// `pairs`: element e of an n-element draw reads bits of word e / (32 / bw)
// of the m = ceil(bw n / 32) words, and one hash gives the words p ("site
// 1") and p + h ("site 2", h = ceil(m / 2)) — half a hash per f32 element,
// an eighth per bf16 one.  So the hash is cheap and the accesses set the
// pace: its first design wrote each element alone (a 2-byte load and store,
// a 64-bit index and a window test each) and reached 39.5 % of its byte
// bound.  This design gives a thread R consecutive pairs whose site-1 words
// fill one 16-byte vector of y (R = 2 for bf16 gaussian, 8 bytes a word; 4
// for f16 gaussian and f32; 8 for half rademacher), one uint4 load of x and
// one store of y, with 32-bit indices inside a launch (the host cuts a
// block's pairs into launches of at most 2^31 elements a site).  Site 2's
// words lie d = h mod R words off the 16-byte grid, a launch constant.  They
// are funnelled across lanes: each lane rotates its R site-2 words by d and
// writes the aligned vector that ends d words into its own span, its first
// d words shuffled up from the lane below (lane 0: carried from lane 31 of
// the warp's previous 32 runs, since a warp walks a chunk of 64 consecutive
// runs).  Shuffles keep the 32-bit words in registers — the element's
// bits, z and the affine write happen where the word lands — with no shared
// memory, no barrier and no bank conflicts, where staging in shared memory
// would add a store, a load at R-way conflicts and a barrier per run.  The
// vector at each chunk's edge (a "junction", its R pairs hashed again: one
// vector in 64 runs) is written apart, still 16 bytes at a time.  Pairs off
// the zone (a window's ends, an odd m's last pair, x and y that lie
// differently against 16 bytes) take a scalar loop.  kernel.original_split
// computes the split; tests/test_torch_x1_original_vector.py walks it on the
// CPU.  x's loads are issued before the hashes, so they fly while the pairs
// are hashed.  The affine write, erf_inv and the f16 FMA rule are the
// partitionable route's.
//
// zo_threefry_pipe_probe times chains of the instructions X1 is made of,
// one kind per probe, for chip_smoke.py's reading of each pipe's rate.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

enum Form { FORM_Z = 0, FORM_AXPBZ = 1, FORM_XPBZ = 2, FORM_RESTORE = 3 };

// threefry2x32's launch constants (the kernel's parameter bank)
struct Key {
  uint32_t inj0[4];       // key injections after rounds 4, 8, 12, 16
  uint32_t inj1[4];
  uint32_t mul;           // 2^s: the final injection scales the bits by it
  uint32_t fin0, fin1;    // (k2 << s), ((k0 + 5) << s)
  uint32_t k0, k1;        // for the general (64-bit counter) route
};

// round r's rotation: 13, 15, 26, 6, 17, 29, 16, 24, repeating
__host__ __device__ constexpr int rot_of(int r) {
  return (r % 8 == 0) ? 13 : (r % 8 == 1) ? 15 : (r % 8 == 2) ? 26
       : (r % 8 == 3) ? 6 : (r % 8 == 4) ? 17 : (r % 8 == 5) ? 29
       : (r % 8 == 6) ? 16 : 24;
}

Key make_key(uint32_t k0, uint32_t k1, int shift) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  Key k{};
  for (int i = 0; i < 4; ++i) {
    k.inj0[i] = ks[(i + 1) % 3];
    k.inj1[i] = ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  k.mul = 1u << shift;
  k.fin0 = k2 << shift;
  k.fin1 = (k0 + 5u) << shift;
  k.k0 = k0;
  k.k1 = k1;
  return k;
}

// round R of threefry2x32 (0-based), with the key injection that follows
// rounds 4, 8, 12 and 16; ptxas issues most of the adds as IMAD on the FMA
// pipe by itself, the rotate is one SHF and the xor one LOP3 (ALU pipe)
template <int R>
__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1,
                                         const Key& k) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, rot_of(R)) ^ x0;
  if constexpr (R % 4 == 3 && R < 19) {
    x0 += k.inj0[R / 4];
    x1 += k.inj1[R / 4];
  }
}

template <int R = 0>
__device__ __forceinline__ void tf_rounds(uint32_t& x0, uint32_t& x1,
                                          const Key& k) {
  if constexpr (R < 20) {
    tf_round<R>(x0, x1, k);
    tf_rounds<R + 1>(x0, x1, k);
  }
}

// (x0 + k2) << s and (x1 + k0 + 5) << s of threefry2x32 with round 1's
// (c0 + k0, c1 + k1) given: the bits, scaled, are A ^ B
struct Pre {
  uint32_t A, B;
};
__device__ __forceinline__ Pre threefry(uint32_t x0, uint32_t x1,
                                        const Key& k) {
  tf_rounds(x0, x1, k);
  return Pre{x0 * k.mul + k.fin0, x1 * k.mul + k.fin1};
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

__device__ __forceinline__ float rt_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rt_f16(float v) {
  return __half2float(__float2half_rn(v));
}

// gaussian table entry i of a half dtype, as f32: u formed in the dtype
// (each op rounded there), erf_inv in f32 rounded back — bf16: z, times
// sqrt(2) in bf16; f16: the unit erf_inv(u) (its sqrt(2) is folded)
template <typename T>
__device__ float table_entry(int i);
template <>
__device__ float table_entry<__nv_bfloat16>(int i) {
  const float lo = -0.99609375f;                    // nextafter(-1, 0)
  const float one_plus = __bfloat162float(
      __ushort_as_bfloat16((unsigned short)((i >> 1) | 0x3F80)));
  const float span = rt_bf16(__fsub_rn(1.0f, lo));
  const float f = rt_bf16(__fsub_rn(one_plus, 1.0f));
  const float u = fmaxf(rt_bf16(__fadd_rn(rt_bf16(__fmul_rn(f, span)), lo)),
                        lo);
  return rt_bf16(__fmul_rn(rt_bf16(erf_inv_f32(u)), 1.4140625f));
}
template <>
__device__ float table_entry<__half>(int i) {
  const float lo = -0.99951171875f;
  const float one_plus =
      __half2float(__ushort_as_half((unsigned short)(i | 0x3C00)));
  const float span = rt_f16(__fsub_rn(1.0f, lo));
  const float f = rt_f16(__fsub_rn(one_plus, 1.0f));
  const float u = fmaxf(rt_f16(__fadd_rn(rt_f16(__fmul_rn(f, span)), lo)),
                        lo);
  return rt_f16(erf_inv_f32(u));
}

// the write's scalars: f32 / f16 carry the folded sqrt(2) and z scale in
// k, b, e (kernel.folded_scalars); bf16 takes the z scale zs
struct Scal {
  float a, b, e, k;
  int zs_on;
  float zs;
};

// ---------------------------------------------------------------------------
// The per-block table of a half dtype, and the bits -> unit lookups
// ---------------------------------------------------------------------------
// bf16: entry of z (or its sign, rademacher) -> what the write reads: z for
// the z form, else rt(b*z) — and for restore the pair (rt(b*z), rt(e*z)),
// z first scaled as rt(z*zs).  f16: the unit as __half (rademacher: none).
template <typename T, int DIST, int FORM>
struct Table {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // bf16: 256 entries (gaussian) or 2 (rademacher); f16 gaussian: 1024
  static constexpr int ENTRIES =
      BF16 ? (DIST == 0 ? 256 : 2)
           : (std::is_same<T, __half>::value && DIST == 0 ? 1024 : 0);
  static constexpr bool PAIR = BF16 && FORM == FORM_RESTORE;
  static constexpr int SHIFT = BF16 ? (PAIR ? 3 : 2) : 0;   // log2 bytes
  static constexpr int BYTES =
      BF16 ? ENTRIES << SHIFT : (ENTRIES > 0 ? ENTRIES * 2 : 16);
};

template <typename T, int DIST, int FORM>
__device__ __forceinline__ void build_table(char* tab, const Scal& s) {
  using TB = Table<T, DIST, FORM>;
  if constexpr (TB::BF16) {
    for (int i = threadIdx.x; i < TB::ENTRIES; i += THREADS) {
      float z = DIST == 1 ? (i ? -1.0f : 1.0f) : table_entry<T>(i);
      if (s.zs_on) z = rt_bf16(__fmul_rn(z, s.zs));
      float* p = reinterpret_cast<float*>(tab + (i << TB::SHIFT));
      p[0] = FORM == FORM_Z ? z : rt_bf16(__fmul_rn(z, s.b));
      if constexpr (TB::PAIR) p[1] = rt_bf16(__fmul_rn(z, s.e));
    }
  } else if constexpr (TB::ENTRIES > 0) {
    for (int i = threadIdx.x; i < TB::ENTRIES; i += THREADS)
      reinterpret_cast<__half*>(tab)[i] =
          __float2half_rn(table_entry<T>(i));
  }
}

// bf16: the byte offset of the entry for bits A ^ B (scaled by 2^SHIFT)
template <typename T, int DIST, int FORM>
__device__ __forceinline__ uint32_t bf16_offset(const Pre& p) {
  using TB = Table<T, DIST, FORM>;
  if constexpr (DIST == 1)
    return ((p.A ^ p.B) >> 31) << TB::SHIFT;
  else
    return (p.A ^ p.B) & (0xFFu << TB::SHIFT);
}

// f16: the unit for bits A ^ B
template <int DIST>
__device__ __forceinline__ __half f16_unit(const Pre& p, const char* tab) {
  const uint32_t bits = p.A ^ p.B;
  if constexpr (DIST == 1)
    return __ushort_as_half((unsigned short)(0x3C00u | ((bits >> 16) &
                                                        0x8000u)));
  else
    return reinterpret_cast<const __half*>(tab)[(bits & 0xFFFFu) >> 6];
}

// ---------------------------------------------------------------------------
// The writes: f32 one element, bf16 / f16 a pair (lo = the lower address)
// ---------------------------------------------------------------------------
template <int DIST, int FORM>
__device__ __forceinline__ float write_f32(float x, const Pre& p,
                                           const Scal& s) {
  const uint32_t bits = p.A ^ p.B;
  const float u = DIST == 1 ? ((bits >> 31) ? -1.0f : 1.0f) : unit_f32(bits);
  if constexpr (FORM == FORM_Z) return __fmul_rn(u, s.k);
  if constexpr (FORM == FORM_AXPBZ)
    return __fmaf_rn(s.a, x, __fmul_rn(u, s.b));
  if constexpr (FORM == FORM_XPBZ) return __fmaf_rn(u, s.b, x);
  return __fmaf_rn(s.a, __fmaf_rn(u, s.e, x), __fmul_rn(u, s.b));
}

__device__ __forceinline__ float2 widen_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ uint32_t narrow_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t hmul_bf16(uint32_t a2, uint32_t w) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a2),
              *reinterpret_cast<const __nv_bfloat162*>(&w));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16: rt(rt(a*x) + rt(b*z)) and the other forms, the sums in f32 and
// rounded once to bf16 as XLA:CPU writes them (a2 = (a, a) as bf16x2)
template <int FORM>
__device__ __forceinline__ uint32_t write_bf16(uint32_t w, uint32_t a2,
                                               const char* tab,
                                               uint32_t off0,
                                               uint32_t off1) {
  const float* t0 = reinterpret_cast<const float*>(tab + off0);
  const float* t1 = reinterpret_cast<const float*>(tab + off1);
  if constexpr (FORM == FORM_Z) return narrow_bf16(t0[0], t1[0]);
  if constexpr (FORM == FORM_AXPBZ) {
    const float2 ax = widen_bf16(hmul_bf16(a2, w));
    return narrow_bf16(__fadd_rn(ax.x, t0[0]), __fadd_rn(ax.y, t1[0]));
  }
  const float2 xf = widen_bf16(w);
  if constexpr (FORM == FORM_XPBZ)
    return narrow_bf16(__fadd_rn(xf.x, t0[0]), __fadd_rn(xf.y, t1[0]));
  const uint32_t r = narrow_bf16(__fadd_rn(xf.x, t0[1]),
                                 __fadd_rn(xf.y, t1[1]));
  const float2 ar = widen_bf16(hmul_bf16(a2, r));
  return narrow_bf16(__fadd_rn(ar.x, t0[0]), __fadd_rn(ar.y, t1[0]));
}

// f16: the folded form with native half FMAs (a2, b2, e2, k2 = (v, v))
template <int FORM>
__device__ __forceinline__ uint32_t write_f16(uint32_t w, __half2 u,
                                              __half2 a2, __half2 b2,
                                              __half2 e2, __half2 k2) {
  const __half2 x = *reinterpret_cast<const __half2*>(&w);
  __half2 r;
  if constexpr (FORM == FORM_Z) r = __hmul2_rn(u, k2);
  if constexpr (FORM == FORM_AXPBZ) r = __hfma2(a2, x, __hmul2_rn(u, b2));
  if constexpr (FORM == FORM_XPBZ) r = __hfma2(u, b2, x);
  if constexpr (FORM == FORM_RESTORE)
    r = __hfma2(a2, __hfma2(u, e2, x), __hmul2_rn(u, b2));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// What a launch of one dtype, dist and form needs beside the key: the
// scalars packed in the dtype, and the block's table
template <typename T, int DIST, int FORM>
struct Writer {
  const char* tab;
  uint32_t a2;                        // bf16: (a, a)
  __half2 ha, hb, he, hk;             // f16

  __device__ __forceinline__ Writer(const char* t, const Scal& s) : tab(t) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      a2 = narrow_bf16(s.a, s.a);
    } else if constexpr (std::is_same<T, __half>::value) {
      ha = __float2half2_rn(s.a);
      hb = __float2half2_rn(s.b);
      he = __float2half2_rn(s.e);
      hk = __float2half2_rn(s.k);
    }
  }

  // a pair of half elements (w: their bits) at bits p0, p1
  __device__ __forceinline__ uint32_t pair(uint32_t w, const Pre& p0,
                                           const Pre& p1) const {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return write_bf16<FORM>(w, a2, tab, bf16_offset<T, DIST, FORM>(p0),
                              bf16_offset<T, DIST, FORM>(p1));
    } else {
      return write_f16<FORM>(
          w, __halves2half2(f16_unit<DIST>(p0, tab), f16_unit<DIST>(p1, tab)),
          ha, hb, he, hk);
    }
  }

  // one 16-byte vector of x's bits xv (zero for FORM_Z) written at its
  // N = 16 / sizeof(T) elements' bits p
  template <int N>
  __device__ __forceinline__ uint4 vec(const uint4& xv, const Pre (&p)[N],
                                       const Scal& s) const {
    uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (sizeof(T) == 4)
        w[q] = __float_as_uint(
            write_f32<DIST, FORM>(__uint_as_float(w[q]), p[q], s));
      else
        w[q] = pair(w[q], p[2 * q], p[2 * q + 1]);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // one element at index i of x / y
  __device__ __forceinline__ void one(const T* x, T* y, uint32_t i,
                                      const Pre& p, const Scal& s) const {
    if constexpr (sizeof(T) == 4) {
      y[i] = write_f32<DIST, FORM>(FORM == FORM_Z ? 0.0f : x[i], p, s);
    } else {
      const uint32_t w =
          FORM == FORM_Z ? 0u
                         : (uint32_t)reinterpret_cast<const uint16_t*>(x)[i];
      reinterpret_cast<uint16_t*>(y)[i] = (uint16_t)pair(w, p, p);
    }
  }
};

// ---------------------------------------------------------------------------
// The whole route: a leaf (or a chunk of it) whose counters share their
// high word, in 16-byte vectors with a scalar head and tail
// ---------------------------------------------------------------------------
struct Whole {
  uint32_t n, head, nvec;   // elements; scalar head; whole 16-byte vectors
  uint32_t x0c, x1c;        // round 1's hi + k0 and lo + k1
};

template <typename T, int DIST, int FORM>
__global__ void __launch_bounds__(THREADS)
whole_kernel(const T* x, T* y, Whole g, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  constexpr int N = 16 / sizeof(T);
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < g.nvec; v += nthreads) {
    const uint32_t i0 = g.head + v * N;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (FORM != FORM_Z)
      xv = *reinterpret_cast<const uint4*>(x + i0);
    const uint32_t c = g.x1c + i0;
    Pre p[N];
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = threefry(g.x0c, c + (uint32_t)j, k);
    *reinterpret_cast<uint4*>(y + i0) = wr.vec(xv, p, s);
  }
  const uint32_t body_end = g.head + g.nvec * N;
  for (uint32_t r = tid; r < g.n - g.nvec * N; r += nthreads) {
    const uint32_t i = r < g.head ? r : body_end + (r - g.head);
    wr.one(x, y, i, threefry(g.x0c, g.x1c + i, k), s);
  }
}

// ---------------------------------------------------------------------------
// The bands route: rows plans, one element per thread step, 64-bit counter
// ---------------------------------------------------------------------------
struct Bands {
  uint64_t offset;
  const int64_t* starts;  // flat starts
  const int64_t* cum;     // and the prefix sum of their lengths (nb + 1)
  int nb;
  int64_t total;          // elements written
};

template <typename T, int DIST, int FORM>
__global__ void __launch_bounds__(THREADS)
bands_kernel(const T* x, T* y, Bands g, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < g.total;
       j += stride) {
    int lo = 0, hi = g.nb - 1;                 // the band holding element j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (g.cum[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int64_t flat = g.starts[lo] + (j - g.cum[lo]);
    const uint64_t idx = (uint64_t)flat + g.offset;
    const Pre p = threefry((uint32_t)(idx >> 32) + k.k0,
                           (uint32_t)idx + k.k1, k);
    // flat < 2^31 elements per band launch is not assumed: index by pointer
    wr.one(x == nullptr ? nullptr : x + flat, y + flat, 0u, p, s);
  }
}

// Blocks of THREADS for a grid-stride kernel with `work` steps to take: at
// most its occupancy times the SM count (read once per kernel)
template <auto Kernel>
int resident_grid(uint64_t work) {
  static int sms = 0, per_sm = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, THREADS,
                                                  0);
    if (per_sm < 1) per_sm = 1;
  }
  const uint64_t want = (work + THREADS - 1) / THREADS;
  const uint64_t cap = (uint64_t)sms * per_sm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// the table's entry size as the shift the final injection scales by
template <typename T, int DIST, int FORM>
__host__ __device__ constexpr int key_shift() {
  return Table<T, DIST, FORM>::BF16 && DIST == 0
             ? Table<T, DIST, FORM>::SHIFT : 0;
}

// dispatch dtype x dist x form onto a launcher L<T, DIST, FORM>::run
template <template <typename, int, int> class L, typename... A>
cudaError_t dispatch(int dtype, int dist, int form, A&&... args) {
  auto by_form = [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int D = decltype(d)::value;
    switch (form) {
      case FORM_Z: L<T, D, FORM_Z>::run(args...); break;
      case FORM_AXPBZ: L<T, D, FORM_AXPBZ>::run(args...); break;
      case FORM_XPBZ: L<T, D, FORM_XPBZ>::run(args...); break;
      default: L<T, D, FORM_RESTORE>::run(args...);
    }
  };
  auto by_dist = [&](auto t) {
    if (dist == 0) by_form(t, std::integral_constant<int, 0>{});
    else by_form(t, std::integral_constant<int, 1>{});
  };
  switch (dtype) {
    case 0: by_dist(float{}); break;
    case 1: by_dist(__nv_bfloat16{}); break;
    case 2: by_dist(__half{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int DIST, int FORM>
struct WholeL {
  static void run(const void* x, void* y, const Whole& g, uint32_t k0,
                  uint32_t k1, const Scal& s, cudaStream_t st) {
    constexpr int N = 16 / sizeof(T);
    const uint32_t rest = g.n - g.nvec * N;
    const int grid = resident_grid<whole_kernel<T, DIST, FORM>>(
        g.nvec > rest ? g.nvec : rest);
    whole_kernel<T, DIST, FORM><<<grid, THREADS, 0, st>>>(
        (const T*)x, (T*)y, g, make_key(k0, k1, key_shift<T, DIST, FORM>()),
        s);
  }
};
template <typename T, int DIST, int FORM>
struct BandsL {
  static void run(const void* x, void* y, const Bands& g, uint32_t k0,
                  uint32_t k1, const Scal& s, cudaStream_t st) {
    const int grid =
        resident_grid<bands_kernel<T, DIST, FORM>>((uint64_t)g.total);
    bands_kernel<T, DIST, FORM><<<grid, THREADS, 0, st>>>(
        (const T*)x, (T*)y, g, make_key(k0, k1, key_shift<T, DIST, FORM>()),
        s);
  }
};

// ---------------------------------------------------------------------------
// The original layout (jax_threefry_partitionable off): a draw of m words
// (bw bits per element, 32 / bw elements per word) hashes iota(m) in two
// halves of h = ceil(m / 2) words: threefry2x32(key, (p, p + h)) gives word
// p (output 0, "site 1") and word p + h (output 1, "site 2"); for odd m the
// last pair's second count is the pad 0 and its output 1 is dropped.  A
// draw past 2^32 - 1 words takes one key per block of that many words (the
// host splits the launch at blocks and passes each block's key, word base
// and m).
// ---------------------------------------------------------------------------
// elements a word, as log2: JAX draws 8 bits for bf16, 16 for f16, and 32
// for f32 and for rademacher in every dtype
template <typename T, int DIST>
__host__ __device__ constexpr int orig_lg() {
  return (DIST == 1 || sizeof(T) == 4) ? 0
         : std::is_same<T, __nv_bfloat16>::value ? 2 : 1;
}

struct Orig {           // the bands route
  uint64_t wbase;       // the block's first word in the draw
  uint32_t m, h;        // the block's words and its half
  uint64_t off;         // the draw index of y[0] (and x[0])
  int lg;               // log2(32 / bw): elements per word
};

// the element's bits within its word, as the writers read them (scaled
// into a bf16 table's byte offset like threefry()'s A ^ B)
template <typename T, int DIST, int FORM>
__device__ __forceinline__ Pre orig_pre(uint32_t word, int j, int lg) {
  const int bw = 32 >> lg;
  const uint32_t v =
      bw == 32 ? word : (word >> (bw * j)) & ((1u << bw) - 1u);
  return Pre{v << key_shift<T, DIST, FORM>(), 0u};
}

// runs of R pairs a warp walks in one chunk, 32 at a time; the chunks are
// grid-strided over the warps, so the warps' concurrent accesses stay near
// each other in memory (one long chunk a warp spreads them a chunk apart),
// and a junction vector joins two chunks
constexpr uint32_t ORIG_CHUNK = 64;

// One launch of the pairs route (kernel.original_split computes the same
// split).  Each site's elements are indexed in 32 bits from its base, the
// first element of pair p0's word there (y1 / y2 in the kernel), so pair
// p0 + q's words start at element q << lg at both sites.
struct OrigV {
  uint32_t p0, np, m, h;        // pairs [p0, p0 + np) of a block of m words
  uint32_t lo1, hi1, lo2, hi2;  // each site's elements inside the window
  uint32_t qz, nrun;            // the zone: nrun runs of R pairs from qz
  uint32_t d;                   // site 2's words off the 16-byte grid
  uint32_t ch, nchunks;         // runs a chunk (ORIG_CHUNK), chunks
};

// the hash of block-local pair c0: A = word c0, B = word c0 + h
__device__ __forceinline__ Pre orig_hash(uint32_t c0, const OrigV& g,
                                         const Key& k) {
  const uint32_t c1 = c0 + g.h;
  return threefry(c0 + k.k0, (c1 < g.m ? c1 : 0u) + k.k1, k);
}

// the 16-byte vector of x at element e (zeros for the z form, which reads
// no x)
template <typename T, int FORM>
__device__ __forceinline__ uint4 orig_load(const T* x, uint32_t e) {
  if constexpr (FORM == FORM_Z) return make_uint4(0u, 0u, 0u, 0u);
  else return *reinterpret_cast<const uint4*>(x + e);
}

// the 16-byte vector of y at element e from x's vector xv there and the R
// words w (word r's elements first at r << lg)
template <typename T, int DIST, int FORM, int R>
__device__ __forceinline__ void orig_vector(T* y, uint32_t e, uint4 xv,
                                            const uint32_t (&w)[R],
                                            const Writer<T, DIST, FORM>& wr,
                                            const Scal& s) {
  constexpr int LG = orig_lg<T, DIST>();
  constexpr int EPW = 1 << LG;
  uint32_t o[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 4) {
      o[q] = __float_as_uint(write_f32<DIST, FORM>(
          __uint_as_float(o[q]), orig_pre<T, DIST, FORM>(w[q], 0, 0), s));
    } else {
      o[q] = wr.pair(
          o[q],
          orig_pre<T, DIST, FORM>(w[(2 * q) >> LG], (2 * q) & (EPW - 1), LG),
          orig_pre<T, DIST, FORM>(w[(2 * q + 1) >> LG],
                                  (2 * q + 1) & (EPW - 1), LG));
    }
  }
  *reinterpret_cast<uint4*>(y + e) = make_uint4(o[0], o[1], o[2], o[3]);
}

// the elements of word w (its first at element e) that lie in [lo, hi)
template <typename T, int DIST, int FORM>
__device__ __forceinline__ void orig_scalar(const T* x, T* y, uint32_t e,
                                            uint32_t w, uint32_t lo,
                                            uint32_t hi,
                                            const Writer<T, DIST, FORM>& wr,
                                            const Scal& s) {
  constexpr int LG = orig_lg<T, DIST>();
#pragma unroll
  for (int j = 0; j < (1 << LG); ++j) {
    const uint32_t i = e + (uint32_t)j;
    if (i >= lo && i < hi)
      wr.one(x, y, i, orig_pre<T, DIST, FORM>(w, j, LG), s);
  }
}

// Whole leaves and windows: one hash per pair of words, both written.
//  1. The zone, in 16-byte vectors: a warp walks a chunk of g.ch runs, 32
//     at a time (the chunks grid-strided over the warps), a lane taking R pairs whose site-1 words fill one vector
//     of y.  Their site-2 words lie d words off the grid; the lane rotates
//     them by d and writes the aligned vector that ends d words into its
//     own, taking its first d words from the lane below (__shfl_up_sync)
//     and, at lane 0, from lane 31 of the warp's previous 32 runs (the
//     carry).  Lane 0 of a chunk's first 32 runs has no carry.
//  2. The junctions: the site-2 vector at each chunk's edge (the zone's
//     two ends in part), one thread each, its R pairs hashed again.
//  3. The scalar loop: the pairs before and after the zone, element by
//     element inside the window.
template <typename T, int DIST, int FORM>
__global__ void __launch_bounds__(THREADS)
orig_kernel(const T* x1, T* y1, const T* x2, T* y2, OrigV g, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  constexpr int LG = orig_lg<T, DIST>();
  constexpr int R = 16 / ((1 << LG) * (int)sizeof(T));
  constexpr uint32_t FULL = 0xFFFFFFFFu;
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  const uint32_t lane = threadIdx.x & 31u;
  const bool has1 = g.hi1 > g.lo1, has2 = g.hi2 > g.lo2;
  for (uint32_t c = tid >> 5; c < g.nchunks; c += nthreads >> 5) {
    const uint32_t j0 = c * g.ch;
    const uint32_t j1 = min(j0 + g.ch, g.nrun);
    uint32_t carry[R];
#pragma unroll
    for (int r = 0; r < R; ++r) carry[r] = 0u;
    for (uint32_t jb = j0; jb < j1; jb += 32) {
      const uint32_t j = jb + lane;
      const bool active = j < j1;
      const uint32_t q = g.qz + j * R;      // this lane's first pair
      const uint32_t e = q << LG;           // its words' first element
      const uint32_t e2 = e - (g.d << LG);  // its site-2 vector's
      const bool on1 = has1 && active;
      const bool on2 = has2 && active && (g.d == 0 || lane > 0 || jb > j0);
      // x's vectors first: their loads fly while the pairs are hashed
      uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
      if (on1) xa = orig_load<T, FORM>(x1, e);
      if (on2) xb = orig_load<T, FORM>(x2, e2);
      uint32_t w1[R], w2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Pre p = orig_hash(g.p0 + q + (uint32_t)r, g, k);
        w1[r] = p.A;
        w2[r] = p.B;
      }
      if (on1) orig_vector<T, DIST, FORM, R>(y1, e, xa, w1, wr, s);
      if (has2) {
        // rot[r] = w2[(r - d) mod R], a barrel shift by the bits of d
#pragma unroll
        for (int b = 1; b < R; b <<= 1) {
          if (g.d & b) {
            uint32_t t[R];
#pragma unroll
            for (int r = 0; r < R; ++r) t[r] = w2[(r + R - b) % R];
#pragma unroll
            for (int r = 0; r < R; ++r) w2[r] = t[r];
          }
        }
        uint32_t v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r] = w2[r];
          if ((uint32_t)r < g.d) {
            const uint32_t below = __shfl_up_sync(FULL, w2[r], 1);
            v[r] = lane ? below : carry[r];
            carry[r] = __shfl_sync(FULL, w2[r], 31);
          }
        }
        if (on2) orig_vector<T, DIST, FORM, R>(y2, e2, xb, v, wr, s);
      }
    }
  }
  if (has2 && g.d != 0 && g.nrun != 0) {
    for (uint32_t t = tid; t <= g.nchunks; t += nthreads) {
      const uint32_t b = min(t * g.ch, g.nrun);
      const uint32_t q = g.qz + b * R - g.d;  // the vector's first pair
      uint32_t v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = orig_hash(g.p0 + q + (uint32_t)r, g, k).B;
      if (b > 0 && b < g.nrun) {
        orig_vector<T, DIST, FORM, R>(y2, q << LG,
                                      orig_load<T, FORM>(x2, q << LG), v, wr,
                                      s);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t p = q + (uint32_t)r;  // in the zone only
          if (p - g.qz < g.nrun * R)
            orig_scalar<T, DIST, FORM>(x2, y2, p << LG, v[r], g.lo2, g.hi2,
                                       wr, s);
        }
      }
    }
  }
  const uint32_t tail = g.qz + g.nrun * R;
  const uint32_t nscal = g.qz + (g.np - tail);
  for (uint32_t t = tid; t < nscal; t += nthreads) {
    const uint32_t q = t < g.qz ? t : tail + (t - g.qz);
    const Pre p = orig_hash(g.p0 + q, g, k);
    orig_scalar<T, DIST, FORM>(x1, y1, q << LG, p.A, g.lo1, g.hi1, wr, s);
    orig_scalar<T, DIST, FORM>(x2, y2, q << LG, p.B, g.lo2, g.hi2, wr, s);
  }
}

// rows plans: one element per thread step, its word's hash kept for it
template <typename T, int DIST, int FORM>
__global__ void __launch_bounds__(THREADS)
orig_bands_kernel(const T* x, T* y, Orig g, Bands b, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < b.total;
       j += stride) {
    int lo = 0, hi = b.nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (b.cum[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int64_t flat = b.starts[lo] + (j - b.cum[lo]);
    const uint64_t e = (uint64_t)flat + g.off;
    const uint32_t w = (uint32_t)((e >> g.lg) - g.wbase);
    const bool first = w < g.h;
    const uint32_t c0 = first ? w : w - g.h;
    const uint32_t c1 = first ? (w + g.h < g.m ? w + g.h : 0u) : w;
    const Pre r = threefry(c0 + k.k0, c1 + k.k1, k);
    wr.one(x == nullptr ? nullptr : x + flat, y + flat, 0u,
           orig_pre<T, DIST, FORM>(first ? r.A : r.B,
                                   (int)(e & ((1u << g.lg) - 1u)), g.lg),
           s);
  }
}

// The arguments of zo_threefry_original: pairs [p0, p0 + np) of a block of
// m words (its first word wbase of the draw, half h), writing the draw's
// elements in [e_lo, e_hi) of y, whose element 0 is draw element off.
struct OrigCall {
  uint64_t wbase;
  uint32_t m, h, p0, np;
  uint64_t e_lo, e_hi, off;
};

// the launch's split, as kernel.original_split computes it; the site
// bases y1 / y2 (x1 / x2) are 64-bit pointers into y at the first element
// of pair p0's word at each site (outside y where the window starts later;
// the kernel reads and writes only inside the window)
template <typename T, int DIST, int FORM>
struct OrigL {
  static void run(const void* x, void* y, const OrigCall& a, uint32_t k0,
                  uint32_t k1, const Scal& s, cudaStream_t st) {
    constexpr int LG = orig_lg<T, DIST>();
    constexpr int64_t EPW = 1 << LG;
    constexpr int64_t BPW = EPW * (int64_t)sizeof(T);   // y's bytes a word
    constexpr uint32_t R = (uint32_t)(16 / BPW);
    const int64_t e1 = (int64_t)(a.wbase + a.p0) * EPW;
    const int64_t e2 = e1 + (int64_t)a.h * EPW;
    const int64_t span1 = (int64_t)a.np * EPW;
    const int64_t end2 = (int64_t)a.p0 + a.np + a.h < (int64_t)a.m
                             ? (int64_t)a.p0 + a.np + a.h : (int64_t)a.m;
    const int64_t span2 =
        end2 > (int64_t)a.p0 + a.h ? (end2 - a.p0 - a.h) * EPW : 0;
    auto clip = [](int64_t v, int64_t span) {
      return (uint32_t)(v < 0 ? 0 : v > span ? span : v);
    };
    OrigV g{};
    g.p0 = a.p0;
    g.np = a.np;
    g.m = a.m;
    g.h = a.h;
    g.lo1 = clip((int64_t)a.e_lo - e1, span1);
    g.hi1 = clip((int64_t)a.e_hi - e1, span1);
    g.lo2 = clip((int64_t)a.e_lo - e2, span2);
    g.hi2 = clip((int64_t)a.e_hi - e2, span2);
    const int64_t d1 = e1 - (int64_t)a.off, d2 = e2 - (int64_t)a.off;
    const T* xt = (const T*)x;
    T* yt = (T*)y;
    const uintptr_t ay = (uintptr_t)y;
    const uintptr_t a1 = ay + (uintptr_t)(d1 * (int64_t)sizeof(T));
    const bool vector = (x == nullptr || ((uintptr_t)x - ay) % 16 == 0) &&
                        ay % sizeof(T) == 0 && a1 % BPW == 0;
    g.qz = a.np;
    if (vector) {
      const uint32_t qa = (uint32_t)((16 - a1 % 16) % 16 / BPW);
      uint32_t first = 0, end = a.np;     // whole words inside each window
      auto take = [&](uint32_t lo, uint32_t hi) {
        if (hi <= lo) return;
        const uint32_t f = (uint32_t)((lo + EPW - 1) >> LG);
        first = f > first ? f : first;
        end = (hi >> LG) < end ? (hi >> LG) : end;
      };
      take(g.lo1, g.hi1);
      take(g.lo2, g.hi2);
      const uint32_t qz = first + (qa + R - first % R) % R;
      if (end > qz && (end - qz) / R > 0) {
        g.qz = qz;
        g.nrun = (end - qz) / R;
        g.d = g.hi2 > g.lo2 ? a.h % R : 0u;
      }
    }
    g.ch = ORIG_CHUNK;
    g.nchunks = (g.nrun + ORIG_CHUNK - 1) / ORIG_CHUNK;
    const uint32_t nscal = g.qz + (g.np - (g.qz + g.nrun * R));
    const uint64_t work = (uint64_t)g.nchunks * 32;       // a warp a chunk
    const int grid = resident_grid<orig_kernel<T, DIST, FORM>>(
        work > nscal ? work : nscal);
    orig_kernel<T, DIST, FORM><<<grid, THREADS, 0, st>>>(
        x == nullptr ? nullptr : xt + d1, yt + d1,
        x == nullptr ? nullptr : xt + d2, yt + d2, g, make_key(k0, k1, 0),
        s);
  }
};
template <typename T, int DIST, int FORM>
struct OrigBandsL {
  static void run(const void* x, void* y, const Orig& g, const Bands& b,
                  uint32_t k0, uint32_t k1, const Scal& s, cudaStream_t st) {
    const int grid =
        resident_grid<orig_bands_kernel<T, DIST, FORM>>((uint64_t)b.total);
    orig_bands_kernel<T, DIST, FORM><<<grid, THREADS, 0, st>>>(
        (const T*)x, (T*)y, g, b, make_key(k0, k1, 0), s);
  }
};

// ---------------------------------------------------------------------------
// The shard route: a rank's shard of a leaf under tensor parallelism.
// Local element j of a launch is draw element e = base + (j / R) * G + j % R
// (kernels/_build.py ShardMap) and takes e's bits in either layout: the
// partitionable hash of e, or (ORIG) its own word of its pair under the
// draw's one key (m words, half h) — a shard need not hold the pair's other
// site — so the write is bitwise the slice of the whole leaf's.  The
// partitionable layout walks 16-byte vectors where R and n are multiples
// of a vector's elements and x, y lie on 16 bytes (shard_vec_kernel: no
// vector crosses a row, one 32-bit divide a vector); the original layout
// and any other shard walk one element a thread step (shard_kernel).
// ---------------------------------------------------------------------------
struct ShardV {
  uint32_t n, R;        // local elements in the launch; a row's
  uint64_t G, base;     // draw elements between rows; the first row's start
  uint32_t m, h;        // ORIG: the draw's words and their half
  int lg;               // ORIG: log2(elements a word)
};

template <typename T, int DIST, int FORM, bool ORIG>
__global__ void __launch_bounds__(THREADS)
shard_kernel(const T* x, T* y, ShardV g, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t j = tid; j < g.n; j += nthreads) {
    const uint32_t row = j / g.R;
    const uint64_t e = g.base + (uint64_t)row * g.G + (j - row * g.R);
    Pre p;
    if constexpr (ORIG) {
      const uint32_t w = (uint32_t)(e >> g.lg);
      const bool first = w < g.h;
      const uint32_t c0 = first ? w : w - g.h;
      const uint32_t c1 = first ? (w + g.h < g.m ? w + g.h : 0u) : w;
      const Pre r = threefry(c0 + k.k0, c1 + k.k1, k);
      p = orig_pre<T, DIST, FORM>(first ? r.A : r.B,
                                  (int)(e & ((1u << g.lg) - 1u)), g.lg);
    } else {
      p = threefry((uint32_t)(e >> 32) + k.k0, (uint32_t)e + k.k1, k);
    }
    wr.one(x, y, j, p, s);
  }
}

template <typename T, int DIST, int FORM>
__global__ void __launch_bounds__(THREADS)
shard_vec_kernel(const T* x, T* y, ShardV g, Key k, Scal s) {
  using TB = Table<T, DIST, FORM>;
  __shared__ __align__(16) char tab[TB::BYTES];
  build_table<T, DIST, FORM>(tab, s);
  if constexpr (TB::ENTRIES > 0) __syncthreads();
  const Writer<T, DIST, FORM> wr(tab, s);
  constexpr int N = 16 / sizeof(T);
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  for (uint32_t v = tid; v < g.n / N; v += nthreads) {
    const uint32_t j0 = v * N;
    const uint32_t row = j0 / g.R;
    const uint64_t e0 = g.base + (uint64_t)row * g.G + (j0 - row * g.R);
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (FORM != FORM_Z)
      xv = *reinterpret_cast<const uint4*>(x + j0);
    Pre p[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t e = e0 + (uint64_t)j;
      p[j] = threefry((uint32_t)(e >> 32) + k.k0, (uint32_t)e + k.k1, k);
    }
    *reinterpret_cast<uint4*>(y + j0) = wr.vec(xv, p, s);
  }
}

template <typename T, int DIST, int FORM>
struct ShardL {
  static void run(const void* x, void* y, const ShardV& g, int orig,
                  uint32_t k0, uint32_t k1, const Scal& s, cudaStream_t st) {
    constexpr uint32_t N = 16 / sizeof(T);
    const bool vec = !orig && g.R % N == 0 && g.n % N == 0 &&
                     (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
    if (vec) {
      const int grid =
          resident_grid<shard_vec_kernel<T, DIST, FORM>>((uint64_t)g.n / N);
      shard_vec_kernel<T, DIST, FORM><<<grid, THREADS, 0, st>>>(
          (const T*)x, (T*)y, g,
          make_key(k0, k1, key_shift<T, DIST, FORM>()), s);
    } else if (orig) {
      const int grid =
          resident_grid<shard_kernel<T, DIST, FORM, true>>((uint64_t)g.n);
      shard_kernel<T, DIST, FORM, true><<<grid, THREADS, 0, st>>>(
          (const T*)x, (T*)y, g, make_key(k0, k1, 0), s);
    } else {
      const int grid =
          resident_grid<shard_kernel<T, DIST, FORM, false>>((uint64_t)g.n);
      shard_kernel<T, DIST, FORM, false><<<grid, THREADS, 0, st>>>(
          (const T*)x, (T*)y, g,
          make_key(k0, k1, key_shift<T, DIST, FORM>()), s);
    }
  }
};

__global__ void normal_f32_kernel(float* out, int64_t m0, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t bits = (uint32_t)(m0 + j) << 9;
  out[j] = __fmul_rn(unit_f32(bits), f_(0x3FB504F3u));
}

template <typename T>
__global__ void table_kernel(float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = table_entry<T>(i);
}

// ---------------------------------------------------------------------------
// Pipe probes: PROBE_CHAINS independent chains of one instruction kind per
// thread, `iters` loop trips, the result stored so nothing is dead
// ---------------------------------------------------------------------------
enum Probe {
  PROBE_LOP3,       // a ^= b & c; b ^= a | c            (LOP3)
  PROBE_SHF,        // funnel shifts                     (SHF)
  PROBE_IADD3,      // a = a + b + c                     (IADD3)
  PROBE_F2FP,       // bf16x2 packs                      (F2FP)
  PROBE_IMAD,       // a = a * one + b                   (IMAD)
  PROBE_VIADD,      // a = a + immediate                 (VIADD)
  PROBE_MULHI,      // a = hi(a * c)                     (IMAD.HI)
  PROBE_FFMA,       // f = f * p + q                     (FFMA)
  PROBE_LOP3_F2FP,  // two kinds interleaved: one pipe, or two
  PROBE_LOP3_VIADD,
  PROBE_IMAD_VIADD,
  PROBE_ROUND,      // X1's round: add, rotate, xor
  N_PROBES
};
constexpr int PROBE_CHAINS = 8;

template <int P>
__global__ void __launch_bounds__(THREADS)
probe_kernel(uint32_t* out, int iters, uint32_t one, uint32_t c) {
  uint32_t a[PROBE_CHAINS], b[PROBE_CHAINS];
  float f[PROBE_CHAINS], g[PROBE_CHAINS];
  const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
#pragma unroll
  for (int j = 0; j < PROBE_CHAINS; ++j) {
    a[j] = t * 0x9E3779B9u + j;
    b[j] = t ^ (0x85EBCA6Bu * (j + 1));
    f[j] = __uint_as_float(0x3F800000u | (a[j] >> 9));
    g[j] = __uint_as_float(0x3F000000u | (b[j] >> 9));
  }
  const float fp = __uint_as_float(0x3F7FFFF0u | (c & 7u));
  const float fq = __uint_as_float(0x33800000u | (c >> 9));
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < PROBE_CHAINS; ++j) {
      if constexpr (P == PROBE_LOP3) {
        a[j] ^= b[j] & c;
        b[j] ^= a[j] | c;
      } else if constexpr (P == PROBE_SHF) {
        a[j] = __funnelshift_l(a[j], b[j], 13);
        b[j] = __funnelshift_l(b[j], a[j], 7);
      } else if constexpr (P == PROBE_IADD3) {
        a[j] = a[j] + b[j] + c;
        b[j] = b[j] + a[j] + one;
      } else if constexpr (P == PROBE_F2FP) {
        f[j] = __uint_as_float(narrow_bf16(f[j], g[j]));
        g[j] = __uint_as_float(narrow_bf16(g[j], f[j]));
      } else if constexpr (P == PROBE_IMAD) {
        a[j] = a[j] * one + b[j];
        b[j] = b[j] * one + a[j];
      } else if constexpr (P == PROBE_VIADD) {
        a[j] = a[j] + 0x3C6EF372u;
        b[j] = b[j] + 0x5A827999u;
      } else if constexpr (P == PROBE_MULHI) {
        a[j] = __umulhi(a[j], c);
        b[j] = __umulhi(b[j], c);
      } else if constexpr (P == PROBE_FFMA) {
        f[j] = __fmaf_rn(f[j], fp, fq);
        g[j] = __fmaf_rn(g[j], fp, fq);
      } else if constexpr (P == PROBE_LOP3_F2FP) {
        a[j] ^= b[j] & c;
        f[j] = __uint_as_float(narrow_bf16(f[j], g[j]));
      } else if constexpr (P == PROBE_LOP3_VIADD) {
        a[j] ^= b[j] & c;
        b[j] = b[j] + 0x5A827999u;
      } else if constexpr (P == PROBE_IMAD_VIADD) {
        a[j] = a[j] * one + b[j];
        b[j] = b[j] + 0x5A827999u;
      } else {
        a[j] = a[j] + b[j];
        b[j] = __funnelshift_l(b[j], b[j], 13) ^ a[j];
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < PROBE_CHAINS; ++j)
    acc ^= a[j] ^ b[j] ^ __float_as_uint(f[j]) ^ __float_as_uint(g[j]);
  out[t] = acc;
}

template <int P = 0>
cudaError_t launch_probe(int probe, uint32_t* out, int blocks, int iters,
                         cudaStream_t s) {
  if constexpr (P < N_PROBES) {
    if (probe == P) {
      probe_kernel<P><<<blocks, THREADS, 0, s>>>(out, iters, 1u, 0x2545F491u);
      return cudaGetLastError();
    }
    return launch_probe<P + 1>(probe, out, blocks, iters, s);
  }
  return cudaErrorInvalidValue;
}

// The bits JAX draws per element: 32 for f32 and for rademacher, 8 for
// bf16 and 16 for f16 (kernel.bit_width); -1 for an unknown dtype
int orig_bw(int dtype, int dist) {
  return (dist == 1 || dtype == 0) ? 32 : dtype == 1 ? 8 : dtype == 2 ? 16
                                                                     : -1;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = f32, 1 = bf16, 2 = f16; dist: 0 = gaussian, 1 = rademacher;
// form: enum Form.  x may be null for FORM_Z.
//
// zo_threefry_whole: one launch of the whole route over n elements
// (n <= 2^31: every index the kernel forms is a uint32 below n) at x, y
// whose counters are (hi, lo + i) with lo + n <= 2^32;
// the first `head` elements and those past head + nvec 16-byte vectors
// take the scalar loop (kernel.whole_launches computes the split).
int zo_threefry_whole(const void* x, void* y, uint32_t n, uint32_t head,
                      uint32_t nvec, int dtype, uint32_t k0, uint32_t k1,
                      uint32_t hi, uint32_t lo, int dist, int form, float a,
                      float b, float e, float k, int zs_on, float zs,
                      void* stream) {
  if (n == 0) return 0;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 ||
      (x == nullptr && form != FORM_Z) || n > (1u << 31) ||
      (uint64_t)lo + n > (1ull << 32) || head > n ||
      (uint64_t)nvec * (16 / (dtype == 0 ? 4 : 2)) > n - head)
    return (int)cudaErrorInvalidValue;
  const Whole g{n, head, nvec, hi + k0, lo + k1};
  const Scal s{a, b, e, k, zs_on, zs};
  return (int)dispatch<WholeL>(dtype, dist, form, x, y, g, k0, k1, s,
                               (cudaStream_t)stream);
}

// zo_threefry_bands: the elements of the flat bands [starts[i], starts[i] +
// len_i) of a leaf, counters offset + flat index; starts / cum (device
// int64) hold the starts and the prefix sum of the lengths (nb + 1).
int zo_threefry_bands(const void* x, void* y, int dtype, uint32_t k0,
                      uint32_t k1, uint64_t offset, int dist, int form,
                      float a, float b, float e, float k, int zs_on,
                      float zs, const int64_t* starts, const int64_t* cum,
                      int nb, int64_t total, void* stream) {
  if (total <= 0) return 0;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 || nb <= 0 ||
      (x == nullptr && form != FORM_Z))
    return (int)cudaErrorInvalidValue;
  const Bands g{offset, starts, cum, nb, total};
  const Scal s{a, b, e, k, zs_on, zs};
  return (int)dispatch<BandsL>(dtype, dist, form, x, y, g, k0, k1, s,
                               (cudaStream_t)stream);
}

// zo_threefry_original: one launch of the original layout over the pairs
// [p0, p0 + np) of a block of m words (its first word wbase of the draw,
// its key (k0, k1), h = ceil(m / 2)), writing the draw's elements in
// [e_lo, e_hi); y[0] (and x[0]) is draw element `off`; bw bits per element
// (kernel.bit_width's), np at most 2^31 elements a site
// (kernel.ORIG_LAUNCH_PAIRS).  The launch's split into the vector zone,
// its junctions and the scalar head and tail is kernel.original_split's.
int zo_threefry_original(const void* x, void* y, int dtype, uint32_t k0,
                         uint32_t k1, uint64_t wbase, uint32_t m, uint32_t h,
                         uint32_t p0, uint32_t np, uint64_t e_lo,
                         uint64_t e_hi, uint64_t off, int bw, int dist,
                         int form, float a, float b, float e, float k,
                         int zs_on, float zs, void* stream) {
  if (np == 0 || e_hi <= e_lo) return 0;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 ||
      bw != orig_bw(dtype, dist) || (x == nullptr && form != FORM_Z) ||
      h != m - m / 2 || (uint64_t)p0 + np > h || e_lo < off ||
      (uint64_t)np * (32 / bw) > (1ull << 31))
    return (int)cudaErrorInvalidValue;
  const OrigCall g{wbase, m, h, p0, np, e_lo, e_hi, off};
  const Scal s{a, b, e, k, zs_on, zs};
  return (int)dispatch<OrigL>(dtype, dist, form, x, y, g, k0, k1, s,
                              (cudaStream_t)stream);
}

// zo_threefry_original_bands: the original layout on the elements of the
// flat bands of y (as zo_threefry_bands), every band inside one block of m
// words at word wbase; y[0] is draw element `off`.
int zo_threefry_original_bands(const void* x, void* y, int dtype, uint32_t k0,
                               uint32_t k1, uint64_t wbase, uint32_t m,
                               uint32_t h, uint64_t off, int bw, int dist,
                               int form, float a, float b, float e, float k,
                               int zs_on, float zs, const int64_t* starts,
                               const int64_t* cum, int nb, int64_t total,
                               void* stream) {
  if (total <= 0) return 0;
  const int lg = bw == 32 ? 0 : bw == 16 ? 1 : bw == 8 ? 2 : -1;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 || nb <= 0 ||
      lg < 0 || (dist == 1 && bw != 32) || (dtype == 0 && bw != 32) ||
      (x == nullptr && form != FORM_Z) || h != m - m / 2)
    return (int)cudaErrorInvalidValue;
  const Orig g{wbase, m, h, off, lg};
  const Bands bd{off, starts, cum, nb, total};
  const Scal s{a, b, e, k, zs_on, zs};
  return (int)dispatch<OrigBandsL>(dtype, dist, form, x, y, g, bd, k0, k1, s,
                                   (cudaStream_t)stream);
}

// zo_threefry_shard: one launch of the shard route over n < 2^31 local
// elements of a rank's shard of a draw of `total` elements: local element j
// at draw element base + (j / R) * G + j % R; orig selects the original
// layout (bw bits an element, the draw below 2^32 - 1 words: one key).
int zo_threefry_shard(const void* x, void* y, uint32_t n, int dtype,
                      uint32_t k0, uint32_t k1, uint32_t R, uint64_t G,
                      uint64_t base, uint64_t total, int orig, int bw,
                      int dist, int form, float a, float b, float e, float k,
                      int zs_on, float zs, void* stream) {
  if (n == 0) return 0;
  const int lg = bw == 32 ? 0 : bw == 16 ? 1 : bw == 8 ? 2 : -1;
  const uint64_t m = (total * (uint64_t)bw + 31) / 32;
  if ((dist != 0 && dist != 1) || form < 0 || form > 3 || R == 0 ||
      n > (1u << 31) || (x == nullptr && form != FORM_Z) ||
      (orig && (lg < 0 || bw != orig_bw(dtype, dist) ||
                m >= 0xFFFFFFFFull)))
    return (int)cudaErrorInvalidValue;
  const ShardV g{n, R, G, base, (uint32_t)m, (uint32_t)(m - m / 2),
                 lg < 0 ? 0 : lg};
  const Scal s{a, b, e, k, zs_on, zs};
  return (int)dispatch<ShardL>(dtype, dist, form, x, y, g, orig, k0, k1, s,
                               (cudaStream_t)stream);
}

// out[j] = the f32 gaussian z of bits (m0 + j) << 9, j < n: every uniform
// mantissa once for n = 2^23.
int zo_threefry_normal_f32(float* out, int64_t m0, int64_t n, void* stream) {
  if (n <= 0) return 0;
  normal_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(out, m0, n);
  return (int)cudaGetLastError();
}

// The kernel's gaussian table of a half dtype as f32 values (1 = bf16:
// z, 256 entries; 2 = f16: the unit, 1024).
int zo_threefry_table(float* out, int dtype, void* stream) {
  if (dtype == 1)
    table_kernel<__nv_bfloat16><<<1, 256, 0, (cudaStream_t)stream>>>(out,
                                                                     256);
  else if (dtype == 2)
    table_kernel<__half><<<1, 256, 0, (cudaStream_t)stream>>>(out, 1024);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The number of pipe probes (enum Probe) and one run of probe `probe`:
// `blocks` blocks of 256 threads, `iters` trips of PROBE_CHAINS chains
// each; out holds blocks * 256 uint32.
int zo_threefry_probes() { return N_PROBES; }
int zo_threefry_pipe_probe(int probe, uint32_t* out, int blocks, int iters,
                           void* stream) {
  return (int)launch_probe(probe, out, blocks, iters, (cudaStream_t)stream);
}

}  // extern "C"
