// K11 wkv6_chunked: the chunked WKV6 ("Finch") recurrence, forward.
//
// Replaces the Pallas TPU kernel wkv6_chunked
// (src/repro/kernels/rwkv6/kernel.py:68, pallas_call at :77, body
// _wkv_kernel at :27).
//
// Per (b, h), with chunks of C tokens (1 <= C <= 16) and, per chunk,
// lc = inclusive cumsum of the log decays lw over the chunk:
//   r~ = r * exp(max(lc - lw, -50))     k~ = k * exp(min(-lc, 50))
//   k^ = k * exp(max(lc_last - lc, -50))
//   A  = (r~ k~^T) on the strict lower triangle      bonus_t = sum_i r u k
//   y  = A v + bonus * v + r~ S
//   S  = exp(lc_last)^T * S + k^^T v                  (carried to the next chunk)
// and the final S is written out.  The same clip and factors as the Pallas
// kernel and models.rwkv6.time_mix, so the function is the same; only the
// rounding order differs.
//
// Two routes (kernel.plan in Python picks, and counts each): at hd 64 with
// rows on 16 bytes - rwkv6-3b's heads, every launch of the model - the
// tiled kernel (namespace tile, below the scalar one; its design is noted
// there), one CTA per (b, h); any other head dim or layout the scalar
// kernel, which follows.
//
// The TPU ran the grid (BH, n_chunks) in order and carried S in VMEM across
// grid steps.  A GPU runs its grid in parallel, so the chunk loop runs inside
// the CTA and S lives in shared memory in f32.  Every column j of the value
// dimension is independent (y[:, j] and S[:, j] read no other column), so the
// grid is (ceil(hd / 16) column slices, H, B): each CTA owns 16 columns of S
// (hd x 16 f32) and recomputes the C x C matrix A and the factors, which are
// shared by its columns.  At the training shape (B 16, H 40, hd 64) that is
// 2 560 CTAs; a single-request prefill still has 4 x H CTAs.
//
// Like JAX's kernel it takes any head dim.  The key channels (the rows of S)
// are walked in slices of HD, an instance in {16, 32, 64, 128, 256}: a head
// dim up to 256 is one slice of the next instance up, the channels past hd
// zero (r = k = log w = u = 0 adds exactly nothing to A, the bonus, r~ S or
// the update), the value columns past hd neither loaded nor stored; a larger
// one runs ceil(hd / 256) slices of 256, A, the bonus and r~ S summed across
// them in the same order as one long sum.  The factor arrays take one slice,
// S all hd rows of the CTA's 16 columns, in dynamic shared memory — or,
// past what a block's shared memory holds (hd above ~1 800), S and u stay
// in global memory, S updated in place in s_out.
//
// Bound on the H100: bytes at the model's shapes — r, k, v, lw and y are
// f32 (B, S, H, hd), s0 and s_final (B, H, hd, hd); the operations (~2 C hd
// flops per element for A, r~ S and k^^T v) are fewer than the 67 TFLOP/s
// f32 rate allows in the time the bytes take.  This first kernel does
// everything in scalar f32 FMAs from shared memory with expf (not __expf),
// no atomics, so runs repeat bit for bit; mma.sync / wgmma tiles and bf16
// inputs are later work.  Inputs are read through arbitrary (b, s, h)
// element strides with unit stride on hd (the model's (B, S, H, hd) layout,
// or (BH, S, hd) as H = 1), so the caller pays no transposes.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int CMAX = 16;   // the envelope: exponents stay <= 43.5 at C <= 16
constexpr int JW = 16;     // value columns per CTA
constexpr int NT = 256;    // threads per CTA: one per (t, s) and (t, j) pair
constexpr float CLIP = 50.0f;
static_assert(CMAX * CMAX <= NT && CMAX * JW <= NT, "one pair per thread");

struct Strides {
  int64_t b, s, h;
};

// f32 words of shared memory for slice width HD and ns slices: u and the
// state slice there too unless GS (they then stay in global memory)
template <int HD, bool GS>
constexpr int smem_words(int ns) {
  return 6 * CMAX * (HD + 1) + CMAX * JW + CMAX * (CMAX + 1) + CMAX + HD +
         (GS ? 0 : ns * HD * (1 + JW));
}

// at least 4 blocks per SM, so up to 64 registers: left to itself ptxas
// picks 48 and spills 24 bytes a thread, at 64 it spills 4
template <int HD, bool GS>
__global__ void __launch_bounds__(NT, 4)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ lw,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int S, int C,
         int hd, int ns, Strides rs, Strides ks, Strides vs, Strides ws,
         Strides ys, int64_t u_b, int64_t u_h, int64_t s0_b, int64_t s0_h,
         int64_t so_b, int64_t so_h) {
  // +1 on the inner extent: rows read by neighbouring threads at one i fall
  // in different banks
  extern __shared__ float smem[];
  float(*sr)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem);   // r, raw
  float(*sk)[HD + 1] = sr + CMAX;       // k, raw
  float(*slc)[HD + 1] = sk + CMAX;      // lw, then the inclusive cumsum lc
  float(*srt)[HD + 1] = slc + CMAX;     // r~
  float(*skt)[HD + 1] = srt + CMAX;     // k~
  float(*skh)[HD + 1] = skt + CMAX;     // k^
  float(*sv)[JW] = reinterpret_cast<float(*)[JW]>(skh + CMAX);
  float(*sA)[CMAX + 1] = reinterpret_cast<float(*)[CMAX + 1]>(sv + CMAX);
  float* sbonus = reinterpret_cast<float*>(sA + CMAX);
  float* sdec = sbonus + CMAX;          // exp(lc_last) of the slice
  float* su = sdec + HD;                // u, all ns * HD channels (!GS)

  const int j0 = blockIdx.x * JW, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  // the state slice, ns * HD rows of the CTA's JW columns: in shared
  // memory, or (GS: past what shared memory holds) in place in s_out, whose
  // rows and columns past hd do not exist
  float* sS = GS ? s_out + b * so_b + h * so_h + j0 : su + ns * HD;
  // its row stride (64-bit only where the rows are s_out's)
  using Idx = typename std::conditional<GS, int64_t, int>::type;
  const Idx s_ld = GS ? (Idx)hd : (Idx)JW;
  const int hdp = ns * HD;
  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h + j0;
  const float* wb = lw + b * ws.b + h * ws.h;
  float* yb = y + b * ys.b + h * ys.h + j0;

  const float* ub = u + b * u_b + h * u_h;
  if (!GS)
    for (int i = tid; i < hdp; i += NT) su[i] = i < hd ? ub[i] : 0.0f;
  const float* s0b = s0 + b * s0_b + h * s0_h + j0;
  for (int e = tid; e < hdp * JW; e += NT) {
    const int i = e / JW, j = e % JW;
    const bool in = i < hd && j0 + j < hd;
    if (!GS || in)
      sS[(Idx)i * s_ld + j] = in ? s0b[(int64_t)i * hd + j] : 0.0f;
  }

  // this thread's (t, s) of A, t of the bonus and (t, j) of y
  const int at = tid / CMAX, as = tid % CMAX;
  const int yt = tid / JW, yj = tid % JW;
  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();   // the previous chunk's S update and y reads are done
    for (int e = tid; e < C * JW; e += NT) {
      const int t = e / JW, j = e % JW;
      sv[t][j] = j0 + j < hd ? vb[(int64_t)(t0 + t) * vs.s + j] : 0.0f;
    }
    float a_acc = 0.0f, b_acc = 0.0f, c_acc = 0.0f;
    for (int sl = 0; sl < ns; ++sl) {
      const int i0 = sl * HD;
      __syncthreads();   // the previous slice's factors are read
      for (int e = tid; e < C * HD; e += NT) {
        const int t = e / HD, i = e % HD;
        const int64_t tt = t0 + t;
        const bool in = i0 + i < hd;
        sr[t][i] = in ? rb[tt * rs.s + i0 + i] : 0.0f;
        sk[t][i] = in ? kb[tt * ks.s + i0 + i] : 0.0f;
        slc[t][i] = in ? wb[tt * ws.s + i0 + i] : 0.0f;
      }
      __syncthreads();
      // the cumsum per channel, in token order, and the three factors
      for (int i = tid; i < HD; i += NT) {
        float lc = 0.0f;
        for (int t = 0; t < C; ++t) {
          const float w = slc[t][i];
          lc += w;
          srt[t][i] = sr[t][i] * expf(fmaxf(lc - w, -CLIP));
          skt[t][i] = sk[t][i] * expf(fminf(-lc, CLIP));
          slc[t][i] = lc;
        }
        for (int t = 0; t < C; ++t)
          skh[t][i] = sk[t][i] * expf(fmaxf(lc - slc[t][i], -CLIP));
        sdec[i] = expf(lc);
      }
      __syncthreads();
      // A on the strict lower triangle, the bonus on the diagonal, and
      // r~ S_in, each summed over this slice's channels
      if (at < C && as < at) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i)
          a_acc = fmaf(srt[at][i], skt[as][i], a_acc);
      }
      if (tid < C) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i) {
          const float ui =
              GS ? (i0 + i < hd ? ub[i0 + i] : 0.0f) : su[i0 + i];
          b_acc = fmaf(sr[tid][i] * ui, sk[tid][i], b_acc);
        }
      }
      if (yt < C) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i) {
          const float si = !GS || (i0 + i < hd && j0 + yj < hd)
                               ? sS[(Idx)(i0 + i) * s_ld + yj] : 0.0f;
          c_acc = fmaf(srt[yt][i], si, c_acc);
        }
      }
      __syncthreads();   // every read of this slice's S_in is done
      // S = exp(lc_last)^T * S + k^^T v on this slice's rows
      for (int e = tid; e < HD * JW; e += NT) {
        const int i = e / JW, j = e % JW;
        if (GS && (i0 + i >= hd || j0 + j >= hd)) continue;
        float acc = 0.0f;
        for (int t = 0; t < C; ++t) acc = fmaf(skh[t][i], sv[t][j], acc);
        float& sij = sS[(Idx)(i0 + i) * s_ld + j];
        sij = fmaf(sdec[i], sij, acc);
      }
    }
    if (at < C) sA[at][as] = a_acc;
    if (tid < C) sbonus[tid] = b_acc;
    __syncthreads();
    // y = A v + bonus v + r~ S_in
    if (yt < C) {
      float a = 0.0f;
      for (int s = 0; s < yt; ++s) a = fmaf(sA[yt][s], sv[s][yj], a);
      a = fmaf(sbonus[yt], sv[yt][yj], a);
      if (j0 + yj < hd) yb[(int64_t)(t0 + yt) * ys.s + yj] = a + c_acc;
    }
  }
  if (GS) return;   // the state was updated in place in s_out
  __syncthreads();
  float* sob = s_out + b * so_b + h * so_h + j0;
  for (int e = tid; e < hd * JW; e += NT) {
    const int i = e / JW, j = e % JW;
    if (j0 + j < hd) sob[(int64_t)i * hd + j] = sS[i * JW + j];
  }
}

struct Args {
  const float *r, *k, *v, *lw, *u, *s0;
  float *y, *s_out;
  int B, H, S, hd, C;
  Strides rs, ks, vs, ws, ys;
  int64_t u_b, u_h, s0_b, s0_h, so_b, so_h;
  cudaStream_t st;
};

template <int HD, bool GS>
cudaError_t launch_with(const Args& a, int ns) {
  const int bytes = 4 * smem_words<HD, GS>(ns);
  static int attr_bytes = 48 * 1024;
  if (bytes > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_fwd<HD, GS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes = bytes;
  }
  dim3 grid((a.hd + JW - 1) / JW, a.H, a.B);
  wkv6_fwd<HD, GS><<<grid, NT, bytes, a.st>>>(
      a.r, a.k, a.v, a.lw, a.u, a.s0, a.y, a.s_out, a.S, a.C, a.hd, ns, a.rs,
      a.ks, a.vs, a.ws, a.ys, a.u_b, a.u_h, a.s0_b, a.s0_h, a.so_b, a.so_h);
  return cudaGetLastError();
}

// past what one block's shared memory holds (hd above ~1 800 on an H100)
// the state slice stays in global memory, in s_out
template <int HD>
cudaError_t launch(const Args& a) {
  const int ns = (a.hd + HD - 1) / HD;
  if constexpr (HD == 256) {
    static int optin = 0;
    if (optin == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
    }
    if (4 * smem_words<HD, false>(ns) > optin)
      return launch_with<HD, true>(a, ns);
  }
  return launch_with<HD, false>(a, ns);
}


// ---------------------------------------------------------------------------
// The tiled route (hd 64, the head width of rwkv6-3b, the rwkv6 arch of the
// registry): one CTA of 256 threads owns all 64 columns of a (b, h), so the
// factors, A and the bonus are computed once per (b, h) and chunk.
//
// The scalar kernel above gives each of ceil(hd / 16) CTAs 16 columns; each
// recomputes the chunk's factors on 64 of its 256 threads, token after token
// (four expf each), then A on 120 threads and the bonus on 16, in phases
// that overlap nothing with the next chunk's loads.  Here, per chunk:
//
//   1. cp.async (16 bytes, L2 only) has brought the chunk's r, k, v, lw into
//      one of two shared buffers while the previous chunk computed; the next
//      chunk's copies are issued at once (tokens past C zero-filled: r = k =
//      v = log w = 0 adds exactly nothing);
//   2. factors: thread (t, c) takes channels 4c .. 4c + 3 of token t: the
//      inclusive cumsum of log w in token order (the scalar kernel's
//      sequential order), then r~, k~, k^ and exp(lc_last) with expf, and its
//      share of the bonus sum r u k, reduced over the token's 16 lanes by
//      shuffles into A's diagonal;
//   3. A = r~ k~^T on the strict lower triangle, one entry a thread, stored
//      transposed (at[s][t]);
//   4. y and the state: thread (q, p) holds rows 8q .. 8q + 7 of columns 2p,
//      2p + 1 of S in registers (16 f32).  Its partials of y[t][j] = sum_i
//      r~[t][i] S[i][j] + sum_s A[t][s] v[s][j] cover its rows and s = q,
//      q + 8, four tokens (8 outputs) at a time; the 8 partials of an output
//      sit in lanes q = 0 .. 7 and are reduced by three halving shuffles, so
//      each lane stores one output.  Then S[i][j] = exp(lc_last[i]) S[i][j] +
//      sum_t k^[t][i] v[t][j] in its registers.  Each 16-byte read of r~ or
//      k^ feeds 8 FMAs.
//
// Three barriers per chunk, no atomics: a run repeats bit for bit.  The
// factor arrays are padded (4 floats after every 32 channels, rows of 76) so
// the eight 16-byte reads a warp makes at one step, and A's sixteen rows,
// fall in distinct banks; the chunk buffers' rows are 72 floats, so v's
// eight rows at one step take two wavefronts, not eight.  53 KB of dynamic
// shared memory and __launch_bounds__(256, 3): 80 registers, no spills (at
// 4 CTAs an SM ptxas caps a thread at 64 registers and spills; of 2, 3 and
// 4 CTAs an SM, 3 ran fastest on the card).
// ---------------------------------------------------------------------------
namespace tile {

constexpr int HD = 64;       // the head dim this route takes
constexpr int NT = 256;      // threads per CTA
constexpr int TC = CMAX;     // tokens per chunk buffer (C <= 16, padded)
constexpr int IS = 72;       // padded row of a chunk buffer
constexpr int FS = 76;       // padded row of a factor array
constexpr int AS = 20;       // row of the transposed A
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(TC * HD / 4 == NT && TC * TC == NT, "one quad / entry each");

__host__ __device__ constexpr int pad(int i) { return i + 4 * (i / 32); }

struct Smem {
  float in[2][4][TC][IS];            // r, k, v, lw of a chunk, two buffers
  float rt[TC][FS], kt[TC][FS], kh[TC][FS];   // r~, k~, k^ (padded)
  float at[TC][AS];                  // at[s][t] = A[t][s]; diagonal: bonus
  float dec[HD];                     // exp(lc_last)
};

struct Src {
  const float* p[4];                 // r, k, v, lw
  Strides st[4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// tokens [t0, t0 + C) of r, k, v, lw at (b, h) into buffer `buf`: one
// 16-byte copy per thread and tensor
__device__ __forceinline__ void load_chunk(Smem& sm, int buf, const Src& src,
                                           int64_t b, int64_t h, int64_t t0,
                                           int C, int tid) {
  const int row = tid / (HD / 4), c4 = tid % (HD / 4);
  const bool in = row < C;
#pragma unroll
  for (int tn = 0; tn < 4; ++tn) {
    const float* base = src.p[tn] + b * src.st[tn].b + h * src.st[tn].h;
    cp_async16(&sm.in[buf][tn][row][4 * c4],
               in ? base + (t0 + row) * src.st[tn].s + 4 * c4 : base,
               in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(NT, 3)
wkv6_tile(const __grid_constant__ Src src, const float* __restrict__ u,
          const float* __restrict__ s0, float* __restrict__ y,
          float* __restrict__ s_out, int S, int C, Strides ys, int64_t u_b,
          int64_t u_h, int64_t s0_b, int64_t s0_h, int64_t so_b,
          int64_t so_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // factors: token ft, channels 4 fc ..; A: entry (ta, sa)
  const int ft = tid / 16, fc = tid % 16;
  const int ta = tid / TC, sa = tid % TC;
  // y and the state: rows 8 q .. 8 q + 7 of columns 2 p, 2 p + 1
  const int q = tid % 8, p = tid / 8;

  const int nc = S / C;
  if (nc > 0) load_chunk(sm, 0, src, b, h, 0, C, tid);
  const float* ub = u + b * u_b + h * u_h;
  const float u0 = ub[4 * fc], u1 = ub[4 * fc + 1], u2 = ub[4 * fc + 2],
              u3 = ub[4 * fc + 3];
  float st[8][2];
  const float* s0b = s0 + b * s0_b + h * s0_h + 8 * q * HD + 2 * p;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    st[ii][0] = s0b[ii * HD];
    st[ii][1] = s0b[ii * HD + 1];
  }
  float* yb = y + b * ys.b + h * ys.h;

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // chunk c landed; chunk c-1 is done with everything
    if (c + 1 < nc)
      load_chunk(sm, buf ^ 1, src, b, h, (int64_t)(c + 1) * C, C, tid);
    const float(*in_v)[IS] = sm.in[buf][2];

    // ---- 2. the factors of token ft, channels 4 fc .. 4 fc + 3 ----
    {
      const float(*in_w)[IS] = sm.in[buf][3];
      float4 lc = make_float4(0.0f, 0.0f, 0.0f, 0.0f), w, mw, mlc;
      for (int t = 0; t < ft; ++t) {
        w = lds4(&in_w[t][4 * fc]);
        lc.x += w.x; lc.y += w.y; lc.z += w.z; lc.w += w.w;
      }
      mw = lds4(&in_w[ft][4 * fc]);
      lc.x += mw.x; lc.y += mw.y; lc.z += mw.z; lc.w += mw.w;
      mlc = lc;
      for (int t = ft + 1; t < TC; ++t) {
        w = lds4(&in_w[t][4 * fc]);
        lc.x += w.x; lc.y += w.y; lc.z += w.z; lc.w += w.w;
      }
      const float4 r = lds4(&sm.in[buf][0][ft][4 * fc]);
      const float4 k = lds4(&sm.in[buf][1][ft][4 * fc]);
      float4 rt, kt, kh;
      rt.x = r.x * expf(fmaxf(mlc.x - mw.x, -CLIP));
      rt.y = r.y * expf(fmaxf(mlc.y - mw.y, -CLIP));
      rt.z = r.z * expf(fmaxf(mlc.z - mw.z, -CLIP));
      rt.w = r.w * expf(fmaxf(mlc.w - mw.w, -CLIP));
      kt.x = k.x * expf(fminf(-mlc.x, CLIP));
      kt.y = k.y * expf(fminf(-mlc.y, CLIP));
      kt.z = k.z * expf(fminf(-mlc.z, CLIP));
      kt.w = k.w * expf(fminf(-mlc.w, CLIP));
      kh.x = k.x * expf(fmaxf(lc.x - mlc.x, -CLIP));
      kh.y = k.y * expf(fmaxf(lc.y - mlc.y, -CLIP));
      kh.z = k.z * expf(fmaxf(lc.z - mlc.z, -CLIP));
      kh.w = k.w * expf(fmaxf(lc.w - mlc.w, -CLIP));
      *reinterpret_cast<float4*>(&sm.rt[ft][pad(4 * fc)]) = rt;
      *reinterpret_cast<float4*>(&sm.kt[ft][pad(4 * fc)]) = kt;
      *reinterpret_cast<float4*>(&sm.kh[ft][pad(4 * fc)]) = kh;
      if (ft == 0)
        *reinterpret_cast<float4*>(&sm.dec[4 * fc]) =
            make_float4(expf(lc.x), expf(lc.y), expf(lc.z), expf(lc.w));
      float bp = fmaf(r.x * u0, k.x, 0.0f);
      bp = fmaf(r.y * u1, k.y, bp);
      bp = fmaf(r.z * u2, k.z, bp);
      bp = fmaf(r.w * u3, k.w, bp);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) bp += __shfl_xor_sync(FULL, bp, o);
      if (fc == 0) sm.at[ft][ft] = bp;
    }
    __syncthreads();

    // ---- 3. A on the strict lower triangle (zero above the diagonal) ----
    if (sa != ta) {
      float a = 0.0f;
      if (sa < ta) {
#pragma unroll
        for (int i = 0; i < HD; i += 4) {
          const float4 x = lds4(&sm.rt[ta][pad(i)]);
          const float4 z = lds4(&sm.kt[sa][pad(i)]);
          a = fmaf(x.x, z.x, a);
          a = fmaf(x.y, z.y, a);
          a = fmaf(x.z, z.z, a);
          a = fmaf(x.w, z.w, a);
        }
      }
      sm.at[sa][ta] = a;
    }
    __syncthreads();

    // ---- 4. y = A v + r~ S_in, then S = exp(lc_last) S + k^^T v ----
    const int64_t t0 = (int64_t)c * C;
#pragma unroll
    for (int g = 0; g < TC / 4; ++g) {
      float acc[8] = {};   // acc[2 tt + cc]: y[4 g + tt][2 p + cc]
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int r4 = 0; r4 < 8; r4 += 4) {
          const float4 x = lds4(&sm.rt[4 * g + tt][pad(8 * q + r4)]);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[2 * tt] = fmaf(xs[e], st[r4 + e][0], acc[2 * tt]);
            acc[2 * tt + 1] = fmaf(xs[e], st[r4 + e][1], acc[2 * tt + 1]);
          }
        }
      }
#pragma unroll
      for (int ss = 0; ss < TC / 8; ++ss) {
        const int s = q + 8 * ss;
        const float2 vs = *reinterpret_cast<const float2*>(&in_v[s][2 * p]);
        const float4 a = lds4(&sm.at[s][4 * g]);
        const float as[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          acc[2 * tt] = fmaf(as[tt], vs.x, acc[2 * tt]);
          acc[2 * tt + 1] = fmaf(as[tt], vs.y, acc[2 * tt + 1]);
        }
      }
      // halve the 8 outputs across lanes q, q ^ 1, q ^ 2, q ^ 4: lane q
      // keeps output q (tt = q / 2, cc = q % 2) summed over all 8 lanes
#pragma unroll
      for (int m = 1, n = 8; m < 8; m <<= 1, n >>= 1) {
        const bool hi = q & m;
#pragma unroll
        for (int e = 0; e < n / 2; ++e) {
          const float keep = hi ? acc[2 * e + 1] : acc[2 * e];
          const float give = hi ? acc[2 * e] : acc[2 * e + 1];
          acc[e] = keep + __shfl_xor_sync(FULL, give, m);
        }
      }
      const int t = 4 * g + q / 2;
      if (t < C) yb[(t0 + t) * ys.s + 2 * p + q % 2] = acc[0];
    }
#pragma unroll
    for (int r4 = 0; r4 < 8; r4 += 4) {
      const float4 d = lds4(&sm.dec[8 * q + r4]);
      const float ds[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[r4 + e][0] *= ds[e];
        st[r4 + e][1] *= ds[e];
      }
    }
#pragma unroll 4
    for (int t = 0; t < TC; ++t) {
      const float2 vt = *reinterpret_cast<const float2*>(&in_v[t][2 * p]);
#pragma unroll
      for (int r4 = 0; r4 < 8; r4 += 4) {
        const float4 x = lds4(&sm.kh[t][pad(8 * q + r4)]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[r4 + e][0] = fmaf(xs[e], vt.x, st[r4 + e][0]);
          st[r4 + e][1] = fmaf(xs[e], vt.y, st[r4 + e][1]);
        }
      }
    }
  }
  float* sob = s_out + b * so_b + h * so_h + 8 * q * HD + 2 * p;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    sob[ii * HD] = st[ii][0];
    sob[ii * HD + 1] = st[ii][1];
  }
}

inline cudaError_t launch(const Args& a) {
  constexpr int bytes = (int)sizeof(Smem);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const Src src{{a.r, a.k, a.v, a.lw}, {a.rs, a.ks, a.vs, a.ws}};
  wkv6_tile<<<dim3(a.H, a.B), NT, bytes, a.st>>>(
      src, a.u, a.s0, a.y, a.s_out, a.S, a.C, a.ys, a.u_b, a.u_h, a.s0_b,
      a.s0_h, a.so_b, a.so_h);
  return cudaGetLastError();
}

// cp.async moves 16 bytes: every row of r, k, v, lw must start on 16 bytes
inline bool aligned16(const Args& a) {
  const void* p[4] = {a.r, a.k, a.v, a.lw};
  const Strides s[4] = {a.rs, a.ks, a.vs, a.ws};
  for (int i = 0; i < 4; ++i)
    if ((uintptr_t)p[i] % 16 || s[i].b % 4 || s[i].s % 4 || s[i].h % 4)
      return false;
  return true;
}

}  // namespace tile

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Bytes of dynamic shared memory a CTA of the tiled route takes.
int wkv6_tile_smem_bytes() { return (int)sizeof(tile::Smem); }

// r, k, v, lw, y: f32 (B, S, H, hd) at the given (b, s, h) element strides
// with unit stride on hd; u: f32 hd-vectors at (u_b, u_h); s0, s_out: f32
// hd x hd row-major matrices at (b, h) strides, not aliasing s0.  Any
// hd >= 1; 1 <= C <= 16 and S a multiple of C.  tiled: 0 runs the scalar
// kernel (any hd), 1 the tiled one (hd 64, rows of r, k, v, lw on 16
// bytes).
int wkv6_chunked(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int H, int S, int hd, int C, int64_t rsb, int64_t rss,
                 int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
                 int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
                 int64_t ysh, int64_t u_b, int64_t u_h, int64_t s0_b,
                 int64_t s0_h, int64_t so_b, int64_t so_h, int tiled,
                 void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (hd < 1 || C < 1 || C > CMAX || S < 0 || S % C != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)r, (const float*)k, (const float*)v,
               (const float*)lw, (const float*)u, (const float*)s0,
               (float*)y, (float*)s_out, B, H, S, hd, C,
               Strides{rsb, rss, rsh}, Strides{ksb, kss, ksh},
               Strides{vsb, vss, vsh}, Strides{wsb, wss, wsh},
               Strides{ysb, yss, ysh}, u_b, u_h, s0_b, s0_h, so_b, so_h,
               (cudaStream_t)stream};
  if (tiled) {
    if (hd != tile::HD || !tile::aligned16(a))
      return (int)cudaErrorInvalidValue;
    return (int)tile::launch(a);
  }
  if (hd <= 16) return (int)launch<16>(a);
  if (hd <= 32) return (int)launch<32>(a);
  if (hd <= 64) return (int)launch<64>(a);
  if (hd <= 128) return (int)launch<128>(a);
  return (int)launch<256>(a);
}

}  // extern "C"
