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
// grid is (hd / 16 column slices, H, B): each CTA owns 16 columns of S
// (hd x 16 f32) and recomputes the C x C matrix A and the factors, which are
// shared by its columns.  At the training shape (B 16, H 40, hd 64) that is
// 2 560 CTAs; a single-request prefill still has 4 x H CTAs.
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

namespace {

constexpr int CMAX = 16;   // the envelope: exponents stay <= 43.5 at C <= 16
constexpr int JW = 16;     // value columns per CTA
constexpr int NT = 256;    // threads per CTA
constexpr float CLIP = 50.0f;

struct Strides {
  int64_t b, s, h;
};

template <int HD>
__global__ void __launch_bounds__(NT)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ lw,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int S, int C,
         Strides rs, Strides ks, Strides vs, Strides ws, Strides ys,
         int64_t u_b, int64_t u_h, int64_t s0_b, int64_t s0_h, int64_t so_b,
         int64_t so_h) {
  // +1 on the inner extent: rows read by neighbouring threads at one i fall
  // in different banks
  __shared__ float sr[CMAX][HD + 1];    // r, raw (for the bonus)
  __shared__ float sk[CMAX][HD + 1];    // k, raw
  __shared__ float slc[CMAX][HD + 1];   // lw, then the inclusive cumsum lc
  __shared__ float srt[CMAX][HD + 1];   // r~
  __shared__ float skt[CMAX][HD + 1];   // k~
  __shared__ float skh[CMAX][HD + 1];   // k^
  __shared__ float sv[CMAX][JW];
  __shared__ float sA[CMAX][CMAX + 1];
  __shared__ float sbonus[CMAX];
  __shared__ float sdec[HD];            // exp(lc_last)
  __shared__ float su[HD];
  __shared__ float sS[HD][JW];

  const int j0 = blockIdx.x * JW, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h + j0;
  const float* wb = lw + b * ws.b + h * ws.h;
  float* yb = y + b * ys.b + h * ys.h + j0;

  for (int i = tid; i < HD; i += NT) su[i] = u[b * u_b + h * u_h + i];
  const float* s0b = s0 + b * s0_b + h * s0_h + j0;
  for (int e = tid; e < HD * JW; e += NT) {
    const int i = e / JW, j = e % JW;
    sS[i][j] = s0b[(int64_t)i * HD + j];
  }

  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();   // the previous chunk's S update is done
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      const int64_t tt = t0 + t;
      sr[t][i] = rb[tt * rs.s + i];
      sk[t][i] = kb[tt * ks.s + i];
      slc[t][i] = wb[tt * ws.s + i];
    }
    for (int e = tid; e < C * JW; e += NT) {
      const int t = e / JW, j = e % JW;
      sv[t][j] = vb[(int64_t)(t0 + t) * vs.s + j];
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
    // A on the strict lower triangle; the bonus on the diagonal
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      float acc = 0.0f;
      if (s < t) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i) acc = fmaf(srt[t][i], skt[s][i], acc);
      }
      sA[t][s] = acc;
    }
    for (int t = tid; t < C; t += NT) {
      float acc = 0.0f;
#pragma unroll 16
      for (int i = 0; i < HD; ++i) acc = fmaf(sr[t][i] * su[i], sk[t][i], acc);
      sbonus[t] = acc;
    }
    __syncthreads();
    // y = A v + bonus v + r~ S_in
    for (int e = tid; e < C * JW; e += NT) {
      const int t = e / JW, j = e % JW;
      float a = 0.0f;
      for (int s = 0; s < t; ++s) a = fmaf(sA[t][s], sv[s][j], a);
      a = fmaf(sbonus[t], sv[t][j], a);
      float c = 0.0f;
#pragma unroll 16
      for (int i = 0; i < HD; ++i) c = fmaf(srt[t][i], sS[i][j], c);
      yb[(int64_t)(t0 + t) * ys.s + j] = a + c;
    }
    __syncthreads();   // every read of S_in is done
    // S = exp(lc_last)^T * S + k^^T v
    for (int e = tid; e < HD * JW; e += NT) {
      const int i = e / JW, j = e % JW;
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) acc = fmaf(skh[t][i], sv[t][j], acc);
      sS[i][j] = fmaf(sdec[i], sS[i][j], acc);
    }
  }
  __syncthreads();
  float* sob = s_out + b * so_b + h * so_h + j0;
  for (int e = tid; e < HD * JW; e += NT) {
    const int i = e / JW, j = e % JW;
    sob[(int64_t)i * HD + j] = sS[i][j];
  }
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* s0, float* y,
                   float* s_out, int B, int H, int S, int C, Strides rs,
                   Strides ks, Strides vs, Strides ws, Strides ys, int64_t u_b,
                   int64_t u_h, int64_t s0_b, int64_t s0_h, int64_t so_b,
                   int64_t so_h, cudaStream_t st) {
  dim3 grid(HD / JW, H, B);
  wkv6_fwd<HD><<<grid, NT, 0, st>>>(r, k, v, lw, u, s0, y, s_out, S, C, rs,
                                    ks, vs, ws, ys, u_b, u_h, s0_b, s0_h,
                                    so_b, so_h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// r, k, v, lw, y: f32 (B, S, H, hd) at the given (b, s, h) element strides
// with unit stride on hd; u: f32 hd-vectors at (u_b, u_h); s0, s_out: f32
// hd x hd row-major matrices at (b, h) strides.  hd in {16, 32, 64};
// 1 <= C <= 16 and S a multiple of C.
int wkv6_chunked(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int H, int S, int hd, int C, int64_t rsb, int64_t rss,
                 int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb,
                 int64_t wss, int64_t wsh, int64_t ysb, int64_t yss,
                 int64_t ysh, int64_t u_b, int64_t u_h, int64_t s0_b,
                 int64_t s0_h, int64_t so_b, int64_t so_h, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (C < 1 || C > CMAX || S < 0 || S % C != 0) return (int)cudaErrorInvalidValue;
  Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ws{wsb, wss, wsh}, ys{ysb, yss, ysh};
  cudaStream_t st = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)k,
              *fv = (const float*)v, *fw = (const float*)lw,
              *fu = (const float*)u, *fs = (const float*)s0;
  float *fy = (float*)y, *fo = (float*)s_out;
  switch (hd) {
    case 16: return (int)launch<16>(fr, fk, fv, fw, fu, fs, fy, fo, B, H, S, C, rs, ks, vs, ws, ys, u_b, u_h, s0_b, s0_h, so_b, so_h, st);
    case 32: return (int)launch<32>(fr, fk, fv, fw, fu, fs, fy, fo, B, H, S, C, rs, ks, vs, ws, ys, u_b, u_h, s0_b, s0_h, so_b, so_h, st);
    case 64: return (int)launch<64>(fr, fk, fv, fw, fu, fs, fy, fo, B, H, S, C, rs, ks, vs, ws, ys, u_b, u_h, s0_b, s0_h, so_b, so_h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
