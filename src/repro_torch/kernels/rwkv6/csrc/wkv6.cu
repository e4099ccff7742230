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

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// r, k, v, lw, y: f32 (B, S, H, hd) at the given (b, s, h) element strides
// with unit stride on hd; u: f32 hd-vectors at (u_b, u_h); s0, s_out: f32
// hd x hd row-major matrices at (b, h) strides, not aliasing s0.  Any
// hd >= 1; 1 <= C <= 16 and S a multiple of C.
int wkv6_chunked(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int H, int S, int hd, int C, int64_t rsb, int64_t rss,
                 int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
                 int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
                 int64_t ysh, int64_t u_b, int64_t u_h, int64_t s0_b,
                 int64_t s0_h, int64_t so_b, int64_t so_h, void* stream) {
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
  if (hd <= 16) return (int)launch<16>(a);
  if (hd <= 32) return (int)launch<32>(a);
  if (hd <= 64) return (int)launch<64>(a);
  if (hd <= 128) return (int)launch<128>(a);
  return (int)launch<256>(a);
}

}  // extern "C"
