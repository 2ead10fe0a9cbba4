// AEC3 subtractor pair kernel for sm_90a: the subtractor loop of one 10 ms
// frame's 2 or 3 capture blocks (Subtractor::Process, subtractor.cc:188-321,
// with adaptive_fir_filter.cc, refined_filter_update_gain.cc:80-150 and
// coarse_filter_update_gain.cc:30-78), for every stream and capture channel.
// Per block k, for stream b and capture channel c:
//
//   reset both filters and gains on an echo-path change, then the
//   initial-state exit on a transition;
//   X      = chain rows [off_k, off_k + P)   (the render FFT window)
//   X2     = sum over p < size, r of the rows' spectra (per filter)
//   S      = sum over p < size, r of X[p, r] H[p, r]   (refined, coarse)
//   s      = irfft(S)[64:128],  e = y - s
//   the misadjustment estimator and its rescale of the refined filter;
//   E      = rfft([0 x 64, hann * e])
//   the refined gain, size update, adapt of every active partition,
//   constrain of one (h = irfft(H[pc])[0:64], H[pc] = rfft([h, 0])), the
//   impulse-response row pc and the frequency response; the coarse filter's
//   poor-filter counter, reset from the refined filter, gain, adapt and
//   constrain.
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_subtractor.py
// (make_pair_kernel, its inner kernel launched at :830). Design: one block of
// 256 threads per (stream, capture channel). The channel's refined and
// coarse filters, its render window, frequency and impulse responses live in
// shared memory for the whole frame, so each state plane is read once and
// written once per launch (the kernel is bound by those bytes). Filter sweeps
// run one thread per (render channel, bin) lane and sum over render channels
// through shared memory; the 128-point transforms are direct sums over a
// 128-entry twiddle table. The per-stream scalars (filter sizes, gain
// configurations, counters) depend on no channel's data: every block
// computes them in registers, and the block of channel 0 writes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 65;
constexpr int kBlock = 64;
constexpr int kFft = 128;
constexpr int kOutScalars = 7;
constexpr int kMaxSharedBytes = 232448;
constexpr double kPi = 3.141592653589793;

// Scalar slots of the packed state (ops/cuda_subtractor.py, the slot order of
// pallas_subtractor.py:62-105): the shared float and int slots, then per
// capture channel c the slot base + c.
constexpr int F_RG_CUR = 0, F_RG_TGT = 5, F_RG_OLD = 10;
constexpr int F_CG_CUR = 15, F_CG_TGT = 17, F_CG_OLD = 19, NF_SHARED = 21;
constexpr int I_R_CUR = 0, I_R_TGT = 1, I_R_OLD = 2, I_R_CTR = 3, I_R_PC = 4;
constexpr int I_C_CUR = 5, I_C_TGT = 6, I_C_OLD = 7, I_C_CTR = 8, I_C_PC = 9;
constexpr int I_RG_CTR = 10, I_CG_CTR = 11, I_RG_POOR = 12, I_RG_CALL = 13;
constexpr int I_CG_POOR = 14, I_CG_CALL = 15, NI_SHARED = 16;

constexpr float kHErrorInitial = 10000.0f;
constexpr int kPoorExcitationInitial = 1000;

struct Config {
  float refined[5];  // leakage converged/diverged, error floor/ceil, gate
  float coarse[2];   // rate, noise gate
  float refined_initial[5];
  float coarse_initial[2];
  int duration;          // config_change_duration_blocks
  int size_r0, size_c0;  // initial sizes, capped at P and Pc
  int size_r, size_c;    // converged sizes, capped at P and Pc
  int hangover;          // coarse_reset_hangover_blocks
};

struct Args {
  const float2* H;      // (B, C, P, R, 65) complex
  const float2* Hc;     // (B, C, Pc, R, 65) complex
  const float* herr;    // (B, C, 65)
  const float* freq;    // (B, C, P, 65)
  const float* imp;     // (B, C, P * 64)
  const float* fs;      // (B, NF)
  const int* iv;        // (B, NI)
  const float* chain;   // (B, W2, F): [fft re | fft im | spectrum | 0]
  const int* offs;      // (B, nb)
  const float* y;       // (B, nb, C, 64)
  const uint8_t* mask;  // (B, nb, 65)
  const uint8_t* ev;    // (B, nb, 3): poor excitation, delay change, transition
  const uint8_t* sat;   // (B,)
  float2* H_o;
  float2* Hc_o;
  float* herr_o;
  float* freq_o;
  float* imp_o;
  float* fs_o;
  int* iv_o;
  float* e_ref;  // (B, nb, C, 64)
  float* e_coa;
  float* scal;   // (B, nb, C, 7)
  float* ofreq;  // (B, nb, C, P, 65)
  float* oimp;   // (B, nb, C, P * 64)
  int* osize;    // (B, nb)
  int C, P, Pc, R, W2, F, nb;
};

// The Python twin evaluates these op by op; the _rn intrinsics keep nvcc
// from contracting them into fused multiply-adds, so that the filter sizes
// truncated from them agree exactly.
__device__ __forceinline__ float lerp_rn(float old, float tgt, float f) {
  return __fadd_rn(__fmul_rn(old, f), __fmul_rn(tgt, __fsub_rn(1.0f, f)));
}

__device__ __forceinline__ float ratio_rn(int counter, int duration) {
  return __fdiv_rn((float)counter, (float)duration);
}

// AdaptiveFirFilter::UpdateSize on the int slots (cur, tgt, old, ctr, pc at
// base .. base + 4): returns the new size, advances old and ctr, clamps pc.
__device__ __forceinline__ int update_size(int (&iv)[NI_SHARED], int base,
                                           int duration) {
  const int ctr = iv[base + 3];
  const int ctr2 = max(ctr - 1, 0);
  const bool in_trans = ctr > 0;
  const int size =
      in_trans ? (int)lerp_rn((float)iv[base + 2], (float)iv[base + 1],
                              ratio_rn(ctr2, duration))
               : iv[base + 1];
  if (!in_trans) iv[base + 2] = iv[base + 1];
  iv[base + 3] = ctr2;
  iv[base] = size;
  iv[base + 4] = min(iv[base + 4], size - 1);
  return size;
}

// GainConfig interpolation (RefinedFilterUpdateGain::UpdateCurrentConfig).
template <int K>
__device__ __forceinline__ void update_config(float (&fs)[NF_SHARED],
                                              int (&iv)[NI_SHARED], int cur,
                                              int tgt, int old, int ctr_slot,
                                              int duration) {
  const int ctr = iv[ctr_slot];
  const int ctr2 = max(ctr - 1, 0);
  const bool in_trans = ctr > 0;
  const bool still = ctr2 > 0;
  const float f = ratio_rn(ctr2, duration);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (in_trans) {
      fs[cur + j] = still ? lerp_rn(fs[old + j], fs[tgt + j], f) : fs[tgt + j];
      if (!still) fs[old + j] = fs[tgt + j];
    }
  }
  iv[ctr_slot] = ctr2;
}

// irfft of 65 bins, sample m of 128: the imaginary parts of bins 0 and 64
// are ignored, as a real inverse transform does.
__device__ __forceinline__ float irfft_at(const float2* X, int m,
                                          const float* cos_t,
                                          const float* sin_t) {
  float acc = 0.0f;
  for (int k = 1; k < kBins - 1; ++k) {
    const int j = (k * m) & (kFft - 1);
    acc += X[k].x * cos_t[j] - X[k].y * sin_t[j];
  }
  const float edge = X[0].x + ((m & 1) ? -X[kBins - 1].x : X[kBins - 1].x);
  return (edge + 2.0f * acc) * (1.0f / kFft);
}

// Bin k of the 128-point rfft of 64 samples x placed at [shift, shift + 64),
// zeros elsewhere.
__device__ __forceinline__ float2 rfft_at(const float* x, int k, int shift,
                                          const float* cos_t,
                                          const float* sin_t) {
  float re = 0.0f, im = 0.0f;
  for (int n = 0; n < kBlock; ++n) {
    const int j = (k * (n + shift)) & (kFft - 1);
    re += x[n] * cos_t[j];
    im -= x[n] * sin_t[j];
  }
  return make_float2(re, im);
}

// H[p, l] += conj(X[p, l]) G[k(l)] for p < size (AdaptPartitions).
__device__ __forceinline__ void adapt(float2* H, const float2* X,
                                      const float2* G, int size, int L) {
  for (int i = threadIdx.x; i < size * L; i += kThreads) {
    const float2 x = X[i];
    const float2 g = G[(i % L) % kBins];
    float2 h = H[i];
    h.x += x.x * g.x + x.y * g.y;
    h.y += x.x * g.y - x.y * g.x;
    H[i] = h;
  }
}

// Constrain partition pc of H (per render channel): hh (R, 64) receives the
// causal head irfft(H[pc])[0:64], and H[pc] its rfft. Ends synchronised.
__device__ void constrain(float2* H, int pc, int R, float* hh,
                          const float* cos_t, const float* sin_t) {
  const int L = R * kBins;
  float2* Hp = H + pc * L;
  for (int t = threadIdx.x; t < R * kBlock; t += kThreads) {
    const int r = t / kBlock;
    hh[t] = irfft_at(Hp + r * kBins, t - r * kBlock, cos_t, sin_t);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += kThreads) {
    const int r = t / kBins;
    Hp[t] = rfft_at(hh + r * kBlock, t - r * kBins, 0, cos_t, sin_t);
  }
  __syncthreads();
}

__host__ __device__ inline size_t shared_floats(int P, int Pc, int R) {
  const size_t L = (size_t)R * kBins;
  // float2: Hs, Hcs, Xs, part (2 L), S, E (2 x 65 each), G (65).
  const size_t complex = (size_t)P * L * 2 + (size_t)Pc * L + 2 * L +
                         4 * kBins + kBins;
  // float: fr, ir, cos, sin, hann, y, s (2 x 64), e (2 x 64), x2, E2
  // (2 x 65 each), herr, hh (R x 64), the reduction scratch (16).
  return 2 * complex + (size_t)P * kBins + (size_t)P * kBlock + 2 * kFft +
         kBlock + kBlock + 4 * kBlock + 4 * kBins + kBins +
         (size_t)R * kBlock + 16;
}

__global__ void __launch_bounds__(kThreads)
    pair_kernel(Args a, Config cfg) {
  extern __shared__ float smem[];
  const int C = a.C, P = a.P, Pc = a.Pc, R = a.R, nb = a.nb;
  const int L = R * kBins;
  const int NF = NF_SHARED + 3 * C;
  const int NI = NI_SHARED + 4 * C;
  const int b = blockIdx.x / C;
  const int c = blockIdx.x - b * C;
  const int tid = threadIdx.x;
  const size_t bc = (size_t)b * C + c;

  float2* Hs = reinterpret_cast<float2*>(smem);  // (P, L)
  float2* Hcs = Hs + P * L;                      // (Pc, L)
  float2* Xs = Hcs + Pc * L;                     // (P, L)
  float2* part = Xs + P * L;                     // (2, L)
  float2* S = part + 2 * L;                      // (2, 65)
  float2* E = S + 2 * kBins;                     // (2, 65)
  float2* G = E + 2 * kBins;                     // (65,)
  float* fr = reinterpret_cast<float*>(G + kBins);  // (P, 65)
  float* ir = fr + P * kBins;                       // (P, 64)
  float* cos_t = ir + P * kBlock;
  float* sin_t = cos_t + kFft;
  float* hann = sin_t + kFft;
  float* ys = hann + kBlock;
  float* sv = ys + kBlock;          // (2, 64): s refined, coarse
  float* evl = sv + 2 * kBlock;     // (2, 64): e refined, coarse
  float* x2 = evl + 2 * kBlock;     // (2, 65)
  float* E2 = x2 + 2 * kBins;       // (2, 65)
  float* herr = E2 + 2 * kBins;     // (65,)
  float* hh = herr + kBins;         // (R, 64)
  float* red = hh + R * kBlock;     // (2, 8)

  for (int j = tid; j < kFft; j += kThreads) {
    double s, co;
    sincospi(j / 64.0, &s, &co);
    cos_t[j] = (float)co;
    sin_t[j] = (float)s;
  }
  for (int n = tid; n < kBlock; n += kThreads) {
    const double w = sin(kPi * n / 63.0);  // kHanning64, aec3_fft.cc:40-54
    hann[n] = (float)(w * w);
  }
  for (int i = tid; i < P * L; i += kThreads) Hs[i] = a.H[bc * P * L + i];
  for (int i = tid; i < Pc * L; i += kThreads) Hcs[i] = a.Hc[bc * Pc * L + i];
  for (int i = tid; i < P * kBins; i += kThreads)
    fr[i] = a.freq[bc * P * kBins + i];
  for (int i = tid; i < P * kBlock; i += kThreads)
    ir[i] = a.imp[bc * P * kBlock + i];
  for (int k = tid; k < kBins; k += kThreads) herr[k] = a.herr[bc * kBins + k];

  const float* fsb = a.fs + (size_t)b * NF;
  const int* ivb = a.iv + (size_t)b * NI;
  float fs[NF_SHARED];
  int iv[NI_SHARED];
#pragma unroll
  for (int i = 0; i < NF_SHARED; ++i) fs[i] = fsb[i];
#pragma unroll
  for (int i = 0; i < NI_SHARED; ++i) iv[i] = ivb[i];
  float mis_e2 = fsb[NF_SHARED + c];
  float mis_y2 = fsb[NF_SHARED + C + c];
  float mis_inv = fsb[NF_SHARED + 2 * C + c];
  int mis_blocks = ivb[NI_SHARED + c];
  int mis_over = ivb[NI_SHARED + C + c];
  int poor_coarse = ivb[NI_SHARED + 2 * C + c];
  int hang = ivb[NI_SHARED + 3 * C + c];
  const bool sat = a.sat[b] != 0;
  const float* rows0 = a.chain + (size_t)b * a.W2 * a.F;
  __syncthreads();

  for (int kb = 0; kb < nb; ++kb) {
    const size_t bk = (size_t)b * nb + kb;
    const size_t o = bk * C + c;  // (b, kb, c)
    const bool poor_exc = a.ev[bk * 3] != 0;
    const bool delay_change = a.ev[bk * 3 + 1] != 0;
    const bool transition = a.ev[bk * 3 + 2] != 0;
    const uint8_t* mask = a.mask + bk * kBins;
    for (int n = tid; n < kBlock; n += kThreads) ys[n] = a.y[o * kBlock + n];

    // HandleEchoPathChange (subtractor.cc:146-174): both filters and gains
    // back to their initial state.
    if (delay_change) {
      for (int i = tid; i < P * L; i += kThreads) Hs[i] = make_float2(0, 0);
      for (int i = tid; i < Pc * L; i += kThreads) Hcs[i] = make_float2(0, 0);
      for (int k = tid; k < kBins; k += kThreads) herr[k] = kHErrorInitial;
      iv[I_R_CUR] = iv[I_R_TGT] = iv[I_R_OLD] = cfg.size_r0;
      iv[I_C_CUR] = iv[I_C_TGT] = iv[I_C_OLD] = cfg.size_c0;
      iv[I_R_CTR] = iv[I_C_CTR] = iv[I_RG_CTR] = iv[I_CG_CTR] = 0;
      iv[I_R_PC] = min(iv[I_R_PC], cfg.size_r0 - 1);
      iv[I_C_PC] = min(iv[I_C_PC], cfg.size_c0 - 1);
      iv[I_RG_POOR] = kPoorExcitationInitial;
      iv[I_RG_CALL] = iv[I_CG_POOR] = iv[I_CG_CALL] = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        fs[F_RG_CUR + j] = fs[F_RG_TGT + j] = fs[F_RG_OLD + j] =
            cfg.refined_initial[j];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        fs[F_CG_CUR + j] = fs[F_CG_TGT + j] = fs[F_CG_OLD + j] =
            cfg.coarse_initial[j];
      }
    }
    // ExitInitialState (subtractor.cc:176-186): converged targets, reached
    // over config_change_duration_blocks.
    if (transition) {
#pragma unroll
      for (int j = 0; j < 5; ++j) fs[F_RG_TGT + j] = cfg.refined[j];
#pragma unroll
      for (int j = 0; j < 2; ++j) fs[F_CG_TGT + j] = cfg.coarse[j];
      iv[I_RG_CTR] = iv[I_CG_CTR] = cfg.duration;
      iv[I_R_TGT] = cfg.size_r;
      iv[I_C_TGT] = cfg.size_c;
      iv[I_R_CTR] = iv[I_C_CTR] = cfg.duration;
    }
    const int size_r = iv[I_R_CUR];
    const int size_c = iv[I_C_CUR];

    // The render window and its spectral sums over the active partitions;
    // the start is clamped into the chain, where every valid window lies.
    const int off = min(max(a.offs[bk], 0), a.W2 - P);
    const float* rows = rows0 + (size_t)off * a.F;
    for (int i = tid; i < P * L; i += kThreads) {
      const int p = i / L;
      const float* row = rows + (size_t)p * a.F;
      const int l = i - p * L;
      Xs[i] = make_float2(row[l], row[L + l]);
    }
    for (int k = tid; k < kBins; k += kThreads) {
      float sr = 0.0f, sc = 0.0f;
      for (int p = 0; p < P; ++p) {
        const float* spec = rows + (size_t)p * a.F + 2 * L;
        float v = 0.0f;
        for (int r = 0; r < R; ++r) v += spec[r * kBins + k];
        if (p < size_r) sr += v;
        if (p < size_c) sc += v;
      }
      x2[k] = sr;
      x2[kBins + k] = sc;
    }
    __syncthreads();

    // Apply both filters with the same arithmetic, so that filters equal on
    // the active partitions give equal outputs (the refined/coarse ties).
    for (int l = tid; l < L; l += kThreads) {
      float2 ar = make_float2(0, 0), ac = make_float2(0, 0);
      for (int p = 0; p < P; ++p) {
        const float2 x = Xs[p * L + l];
        if (p < size_r) {
          const float2 h = Hs[p * L + l];
          ar.x += x.x * h.x - x.y * h.y;
          ar.y += x.x * h.y + x.y * h.x;
        }
        if (p < size_c) {
          const float2 h = Hcs[p * L + l];
          ac.x += x.x * h.x - x.y * h.y;
          ac.y += x.x * h.y + x.y * h.x;
        }
      }
      part[l] = ar;
      part[L + l] = ac;
    }
    __syncthreads();
    for (int t = tid; t < 2 * kBins; t += kThreads) {
      const int w = t / kBins;
      const float2* pw = part + w * L + (t - w * kBins);
      float2 s = pw[0];
      for (int r = 1; r < R; ++r) {
        s.x += pw[r * kBins].x;
        s.y += pw[r * kBins].y;
      }
      S[t] = s;
    }
    __syncthreads();

    // Prediction errors (subtractor.cc:41-57).
    for (int t = tid; t < 2 * kBlock; t += kThreads) {
      const int w = t / kBlock;
      const int n = t - w * kBlock;
      const float s = irfft_at(S + w * kBins, kBlock + n, cos_t, sin_t);
      sv[t] = s;
      evl[t] = ys[n] - s;
    }
    __syncthreads();

    // y2, e2 and s2 of both filters and the peaks of |s|, before the
    // rescale: two warps, then one pass through shared memory.
    if (tid < kBlock) {
      const float yv = ys[tid], er = evl[tid], ec = evl[kBlock + tid];
      const float sr = sv[tid], sc = sv[kBlock + tid];
      float q[kOutScalars] = {yv * yv, er * er, ec * ec, sr * sr, sc * sc,
                              fabsf(sr), fabsf(sc)};
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
        for (int i = 0; i < 5; ++i) q[i] += __shfl_down_sync(~0u, q[i], d);
        q[5] = fmaxf(q[5], __shfl_down_sync(~0u, q[5], d));
        q[6] = fmaxf(q[6], __shfl_down_sync(~0u, q[6], d));
      }
      if ((tid & 31) == 0) {
#pragma unroll
        for (int i = 0; i < kOutScalars; ++i) red[(tid >> 5) * 8 + i] = q[i];
      }
    }
    __syncthreads();
    const float y2 = red[0] + red[8];
    const float e2r = red[1] + red[9];
    const float e2c = red[2] + red[10];
    const float s2r = red[3] + red[11];
    const float s2c = red[4] + red[12];
    const float smax_r = fmaxf(red[5], red[13]);
    const float smax_c = fmaxf(red[6], red[14]);

    // FilterMisadjustmentEstimator (subtractor.cc:324-357) and the rescale
    // of an overestimating refined filter (:258-268).
    float e2a = mis_e2 + e2r;
    float y2a = mis_y2 + y2;
    int nblk = mis_blocks + 1;
    const bool window_done = nblk == 4;
    const bool done_active = window_done && y2a > 4.0f * 200.0f * 200.0f * 64;
    const float update = e2a / fmaxf(y2a, 1e-30f);
    mis_over = (done_active && e2a > 4.0f * 7500.0f * 7500.0f * 64)
                   ? 4
                   : max(mis_over - (done_active ? 1 : 0), 0);
    if (done_active && (update < mis_inv || mis_over > 0)) {
      mis_inv = __fadd_rn(mis_inv, __fmul_rn(0.1f, __fsub_rn(update, mis_inv)));
    }
    if (window_done) {
      e2a = 0.0f;
      y2a = 0.0f;
      nblk = 0;
    }
    const bool adjust = mis_inv > 10.0f;
    if (adjust) {
      const float scale = 2.0f / sqrtf(fmaxf(mis_inv, 1e-10f));
      for (int i = tid; i < P * L; i += kThreads) {
        Hs[i].x *= scale;
        Hs[i].y *= scale;
      }
      for (int i = tid; i < P * kBlock; i += kThreads) ir[i] *= scale;
      for (int n = tid; n < kBlock; n += kThreads) {
        sv[n] *= scale;
        evl[n] = ys[n] - sv[n];
      }
      mis_inv = 0.0f;
      mis_over = 0;
      e2a = 0.0f;
      y2a = 0.0f;
      nblk = 0;
    }
    mis_e2 = e2a;
    mis_y2 = y2a;
    mis_blocks = nblk;
    __syncthreads();

    // Hanning-windowed error FFTs of both filters (the windowed errors take
    // the place of s, which is not read again).
    for (int t = tid; t < 2 * kBlock; t += kThreads) {
      sv[t] = evl[t] * hann[t & (kBlock - 1)];
    }
    __syncthreads();
    for (int t = tid; t < 2 * kBins; t += kThreads) {
      const int w = t / kBins;
      const float2 X =
          rfft_at(sv + w * kBlock, t - w * kBins, kBlock, cos_t, sin_t);
      E[t] = X;
      E2[t] = X.x * X.x + X.y * X.y;
    }
    __syncthreads();

    // RefinedFilterUpdateGain::Compute (refined_filter_update_gain.cc:
    // 80-150); the size is the one before this block's update.
    update_config<5>(fs, iv, F_RG_CUR, F_RG_TGT, F_RG_OLD, I_RG_CTR,
                     cfg.duration);
    const int call_r = iv[I_RG_CALL] + 1;
    const int poor_r = (poor_exc ? 0 : iv[I_RG_POOR]) + 1;
    iv[I_RG_CALL] = call_r;
    iv[I_RG_POOR] = poor_r;
    const bool no_update_r = poor_r < size_r || sat || call_r <= size_r;
    const bool disallow_diverged = hang > 0;
    for (int k = tid; k < kBins; k += kThreads) {
      const float X2 = x2[k];
      const float he = herr[k];
      float mu = X2 >= fs[F_RG_CUR + 4]
                     ? he / (0.5f * he * X2 + (float)size_r * E2[k])
                     : 0.0f;
      if (mask[k] || no_update_r) mu = 0.0f;
      float h = he - 0.5f * mu * X2 * he;
      G[k] = (no_update_r || adjust) ? make_float2(0, 0)
                                     : make_float2(mu * E[k].x, mu * E[k].y);
      float erl = 0.0f;
      for (int p = 0; p < P; ++p) erl += fr[p * kBins + k];
      const float leak = (E2[k] <= E2[kBins + k] || disallow_diverged)
                             ? fs[F_RG_CUR]
                             : fs[F_RG_CUR + 1];
      h = h + leak * erl;
      herr[k] = fminf(fmaxf(h, fs[F_RG_CUR + 2]), fs[F_RG_CUR + 3]);
    }

    // The refined filter's size update, adapt and constrain, then its
    // impulse-response row and frequency response.
    const int old_r = iv[I_R_CUR];
    const int new_r = update_size(iv, I_R_CUR, cfg.duration);
    const int pc = iv[I_R_PC];
    for (int i = old_r * L + tid; i < new_r * L; i += kThreads) {
      Hs[i] = make_float2(0, 0);
    }
    __syncthreads();
    adapt(Hs, Xs, G, new_r, L);
    __syncthreads();
    constrain(Hs, pc, R, hh, cos_t, sin_t);
    for (int n = tid; n < kBlock; n += kThreads) {
      float s = hh[n];
      for (int r = 1; r < R; ++r) {
        const float cand = hh[r * kBlock + n];
        if (fabsf(s) < fabsf(cand)) s = cand;
      }
      ir[pc * kBlock + n] = s;
    }
    for (int i = tid; i < P * kBins; i += kThreads) {
      const int p = i / kBins;
      const int k = i - p * kBins;
      float m = 0.0f;
      if (p < new_r) {
        for (int r = 0; r < R; ++r) {
          const float2 h = Hs[p * L + r * kBins + k];
          const float v = h.x * h.x + h.y * h.y;
          m = r == 0 ? v : fmaxf(m, v);
        }
      }
      fr[i] = m;
    }
    iv[I_R_PC] = pc < new_r - 1 ? pc + 1 : 0;

    // The coarse filter (subtractor.cc:282-311): poor-filter counter, size
    // update, reset from the refined filter, gain, adapt and constrain.
    poor_coarse = e2r < e2c ? poor_coarse + 1 : 0;
    const bool reset = poor_coarse >= 5;
    if (reset) poor_coarse = 0;
    hang = reset ? cfg.hangover : max(hang - 1, 0);
    const int old_c = iv[I_C_CUR];
    const int new_c = update_size(iv, I_C_CUR, cfg.duration);
    const int cpc = iv[I_C_PC];
    __syncthreads();
    if (reset) {
      for (int i = tid; i < Pc * L; i += kThreads) Hcs[i] = Hs[i];
    } else {
      for (int i = old_c * L + tid; i < new_c * L; i += kThreads) {
        Hcs[i] = make_float2(0, 0);
      }
    }
    update_config<2>(fs, iv, F_CG_CUR, F_CG_TGT, F_CG_OLD, I_CG_CTR,
                     cfg.duration);
    const int call_c = iv[I_CG_CALL] + 1;
    const int poor_c = (poor_exc ? 0 : iv[I_CG_POOR]) + 1;
    iv[I_CG_CALL] = call_c;
    iv[I_CG_POOR] = poor_c;
    const bool no_update_c = poor_c < new_c || sat || call_c <= new_c;
    for (int k = tid; k < kBins; k += kThreads) {
      const float X2 = x2[kBins + k];
      float mu = X2 > fs[F_CG_CUR + 1] ? fs[F_CG_CUR] / fmaxf(X2, 1e-30f)
                                       : 0.0f;
      if (mask[k]) mu = 0.0f;
      const float2 e = reset ? E[k] : E[kBins + k];
      G[k] = no_update_c ? make_float2(0, 0)
                         : make_float2(mu * e.x, mu * e.y);
    }
    __syncthreads();
    adapt(Hcs, Xs, G, new_c, L);
    __syncthreads();
    constrain(Hcs, cpc, R, hh, cos_t, sin_t);
    iv[I_C_PC] = cpc < new_c - 1 ? cpc + 1 : 0;

    // This block's outputs.
    for (int n = tid; n < kBlock; n += kThreads) {
      a.e_ref[o * kBlock + n] = evl[n];
      a.e_coa[o * kBlock + n] = evl[kBlock + n];
    }
    if (tid == 0) {
      float* sc = a.scal + o * kOutScalars;
      sc[0] = y2;
      sc[1] = e2r;
      sc[2] = e2c;
      sc[3] = s2r;
      sc[4] = s2c;
      sc[5] = smax_r;
      sc[6] = smax_c;
      if (c == 0) a.osize[bk] = new_r;
    }
    for (int i = tid; i < P * kBins; i += kThreads) {
      a.ofreq[o * P * kBins + i] = fr[i];
    }
    for (int i = tid; i < P * kBlock; i += kThreads) {
      a.oimp[o * P * kBlock + i] = ir[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < P * L; i += kThreads) a.H_o[bc * P * L + i] = Hs[i];
  for (int i = tid; i < Pc * L; i += kThreads) {
    a.Hc_o[bc * Pc * L + i] = Hcs[i];
  }
  for (int i = tid; i < P * kBins; i += kThreads) {
    a.freq_o[bc * P * kBins + i] = fr[i];
  }
  for (int i = tid; i < P * kBlock; i += kThreads) {
    a.imp_o[bc * P * kBlock + i] = ir[i];
  }
  for (int k = tid; k < kBins; k += kThreads) {
    a.herr_o[bc * kBins + k] = herr[k];
  }
  if (tid == 0) {
    float* fso = a.fs_o + (size_t)b * NF;
    int* ivo = a.iv_o + (size_t)b * NI;
    fso[NF_SHARED + c] = mis_e2;
    fso[NF_SHARED + C + c] = mis_y2;
    fso[NF_SHARED + 2 * C + c] = mis_inv;
    ivo[NI_SHARED + c] = mis_blocks;
    ivo[NI_SHARED + C + c] = mis_over;
    ivo[NI_SHARED + 2 * C + c] = poor_coarse;
    ivo[NI_SHARED + 3 * C + c] = hang;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NF_SHARED; ++i) fso[i] = fs[i];
#pragma unroll
      for (int i = 0; i < NI_SHARED; ++i) ivo[i] = iv[i];
    }
  }
}

}  // namespace

// The bytes of shared memory one block needs, or 0 when the geometry does
// not fit in a block's 227 KB.
extern "C" long long subtractor_pair_shared_bytes(int P, int Pc, int R) {
  const size_t bytes = shared_floats(P, Pc, R) * sizeof(float);
  return bytes <= (size_t)kMaxSharedBytes ? (long long)bytes : 0;
}

// State planes H (B, C, P, R, 65) and Hc (B, C, Pc, R, 65) as interleaved
// complex float32, herr (B, C, 65), freq (B, C, P, 65), imp (B, C, P * 64),
// fs (B, 21 + 3 C) float32, iv (B, 16 + 4 C) int32; the sf chain (B, W2, F),
// offs (B, nb) int32, y (B, nb, C, 64), mask (B, nb, 65) uint8, events (B,
// nb, 3) uint8, sat (B,) uint8 -> the new state planes and scalars (same
// shapes) and the per-block outputs e_ref and e_coa (B, nb, C, 64), scal
// (B, nb, C, 7), ofreq (B, nb, C, P, 65), oimp (B, nb, C, P * 64), osize
// (B, nb) int32. fcfg: 14 floats on the host (refined, coarse, refined
// initial, coarse initial gain configs); icfg: 6 ints on the host (duration,
// initial refined and coarse sizes, converged refined and coarse sizes,
// coarse reset hangover). All tensors contiguous on the device. Returns
// cudaGetLastError().
extern "C" int subtractor_pair_f32(
    const void* H, const void* Hc, const void* herr, const void* freq,
    const void* imp, const void* fs, const void* iv, const void* chain,
    const void* offs, const void* y, const void* mask, const void* events,
    const void* sat, void* H_o, void* Hc_o, void* herr_o, void* freq_o,
    void* imp_o, void* fs_o, void* iv_o, void* e_ref, void* e_coa,
    void* scal, void* ofreq, void* oimp, void* osize, int B, int C, int P,
    int Pc, int R, int W2, int F, int nb, const float* fcfg, const int* icfg,
    void* stream) {
  const long long bytes = subtractor_pair_shared_bytes(P, Pc, R);
  if (B < 0 || C < 1 || P < 1 || Pc < 1 || Pc > P || R < 1 || nb < 1 ||
      W2 < P || F < 3 * R * kBins || bytes == 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  Config cfg;
  for (int j = 0; j < 5; ++j) {
    cfg.refined[j] = fcfg[j];
    cfg.refined_initial[j] = fcfg[7 + j];
  }
  for (int j = 0; j < 2; ++j) {
    cfg.coarse[j] = fcfg[5 + j];
    cfg.coarse_initial[j] = fcfg[12 + j];
  }
  cfg.duration = icfg[0];
  cfg.size_r0 = icfg[1];
  cfg.size_c0 = icfg[2];
  cfg.size_r = icfg[3];
  cfg.size_c = icfg[4];
  cfg.hangover = icfg[5];
  Args a;
  a.H = static_cast<const float2*>(H);
  a.Hc = static_cast<const float2*>(Hc);
  a.herr = static_cast<const float*>(herr);
  a.freq = static_cast<const float*>(freq);
  a.imp = static_cast<const float*>(imp);
  a.fs = static_cast<const float*>(fs);
  a.iv = static_cast<const int*>(iv);
  a.chain = static_cast<const float*>(chain);
  a.offs = static_cast<const int*>(offs);
  a.y = static_cast<const float*>(y);
  a.mask = static_cast<const uint8_t*>(mask);
  a.ev = static_cast<const uint8_t*>(events);
  a.sat = static_cast<const uint8_t*>(sat);
  a.H_o = static_cast<float2*>(H_o);
  a.Hc_o = static_cast<float2*>(Hc_o);
  a.herr_o = static_cast<float*>(herr_o);
  a.freq_o = static_cast<float*>(freq_o);
  a.imp_o = static_cast<float*>(imp_o);
  a.fs_o = static_cast<float*>(fs_o);
  a.iv_o = static_cast<int*>(iv_o);
  a.e_ref = static_cast<float*>(e_ref);
  a.e_coa = static_cast<float*>(e_coa);
  a.scal = static_cast<float*>(scal);
  a.ofreq = static_cast<float*>(ofreq);
  a.oimp = static_cast<float*>(oimp);
  a.osize = static_cast<int*>(osize);
  a.C = C;
  a.P = P;
  a.Pc = Pc;
  a.R = R;
  a.W2 = W2;
  a.F = F;
  a.nb = nb;
  pair_kernel<<<B * C, kThreads, (size_t)bytes,
                static_cast<cudaStream_t>(stream)>>>(a, cfg);
  return (int)cudaGetLastError();
}
