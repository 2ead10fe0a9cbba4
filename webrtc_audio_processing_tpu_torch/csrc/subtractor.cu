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
// (make_pair_kernel, its inner kernel launched at :830).
//
// What bounds it. Its least time is set by bytes (each state plane read and
// written once, the window rows, the per-block outputs: 0.12 ms at 48 kHz
// stereo, B = 2048). What it takes is set by latency: each (stream,
// capture channel) runs a chain of dependent steps per block, so the time is
// the chain's length under the SM's sharing, times the waves of blocks the
// card runs. The design keeps the chain short and wide:
// - one block of threads per (stream, capture channel), 256 threads (128
//   with one render channel), its filters, window, responses, y, masks,
//   events and scalars in shared memory for the whole frame, the large
//   planes filled by cp.async without passing through registers;
// - the 128-point transforms are FFTs: a 64-point complex FFT on one warp
//   (lane j holds points j and j + 32, butterflies across lanes by
//   shuffles) and the real split or merge, pruned by the known zeros (the
//   error and constrain inputs are half zero, each inverse is read in one
//   half only); twiddles and the Hann window come from a table built at
//   compile time; the refined and coarse transforms, and the render
//   channels' constrains, run on separate warps side by side;
// - the per-stream scalars live in shared memory, updated by one thread
//   each for the refined and the coarse filter while the two filters'
//   warps compute their errors (no per-thread copies: three blocks of 256
//   threads fit an SM, ~63 KB of shared memory each, or five of 128);
// - consecutive window starts (block k at start_0 - k, the chain's
//   trajectory) stage their union of P + nb - 1 rows once per frame; other
//   starts (a jump to the second chain, a clamped start) load each block's
//   rows; the clamp and the result do not depend on which;
// - six barriers a block: the products over all threads; the two filters'
//   prediction, error and error spectrum on two warps while the others sum
//   the render spectra and the ERL; the gains; the constrains on half the
//   warps while the other half adapts the other partitions; the responses
//   and outputs.
// Transforms and sums run in another order than the twin's torch.fft and
// einsums: float leaves agree to rounding, integer leaves exactly. The
// per-stream scalars (filter sizes, gain configurations, counters) depend
// on no channel's data: every block computes them, and the block of
// channel 0 writes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 65;
constexpr int kBlock = 64;
constexpr int kOutScalars = 7;
constexpr int kMaxSharedBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------------------------ tables, built at compile
// time in double and rounded to float once.

constexpr double kPi = 3.141592653589793;

constexpr double taylor_sin(double x) {  // |x| <= pi / 4
  double term = x, sum = x;
  for (int n = 1; n < 14; ++n) {
    term *= -x * x / ((2.0 * n) * (2.0 * n + 1.0));
    sum += term;
  }
  return sum;
}

constexpr double taylor_cos(double x) {  // |x| <= pi / 4
  double term = 1.0, sum = 1.0;
  for (int n = 1; n < 14; ++n) {
    term *= -x * x / ((2.0 * n - 1.0) * (2.0 * n));
    sum += term;
  }
  return sum;
}

// sin(pi num / den) for 0 <= num <= den, reduced to [0, pi / 4], so that
// multiples of pi / 2 come out exact.
constexpr double sin_pi_frac(int num, int den) {
  if (2 * num > den) num = den - num;
  if (4 * num > den) return taylor_cos(kPi * (den - 2 * num) / (2.0 * den));
  return taylor_sin(kPi * num / den);
}

struct Tables {
  float2 w[128];     // (cos, sin) of 2 pi m / 128
  float2 st[5][32];  // st[s][j]: lane j's twiddle at butterfly distance
                     // d = 2^s, w[2 (j mod d) 32 / d] (W64 to that power)
  float hann[64];    // kHanning64 (aec3_fft.cc:40-54): sin^2(pi n / 63)
};

constexpr Tables make_tables() {
  Tables t{};
  for (int m = 0; m < 128; ++m) {
    const int q = m / 32, r = m % 32;
    const double s = sin_pi_frac(r, 64), c = sin_pi_frac(32 - r, 64);
    const double cs[4][2] = {{c, s}, {-s, c}, {-c, -s}, {s, -c}};
    t.w[m].x = static_cast<float>(cs[q][0]);
    t.w[m].y = static_cast<float>(cs[q][1]);
  }
  for (int s = 0; s < 5; ++s) {
    const int d = 1 << s;
    for (int j = 0; j < 32; ++j) t.st[s][j] = t.w[2 * (j & (d - 1)) * (32 / d)];
  }
  for (int n = 0; n < 64; ++n) {
    const double v = sin_pi_frac(n, 63);
    t.hann[n] = static_cast<float>(v * v);
  }
  return t;
}

__device__ const Tables kTables = make_tables();

// ------------------------------------------------ 128-point real transforms
//
// One warp computes one transform: a 64-point complex FFT of the even and
// odd samples as (re, im) pairs, lane j holding points j and j + 32, with the
// butterflies across lanes by shuffles, and the real split (forward) or merge
// (inverse) step around it. Every multiply-add is written out (the _rn
// intrinsics), so that the order is the one tests/test_torch_kernel_
// contracts.py models.

__device__ __forceinline__ int rev5(int j) { return __brev(j) >> 27; }

__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src));
}

__device__ __forceinline__ float2 shfl_xor(float2 v, int d) {
  return make_float2(__shfl_xor_sync(kFull, v.x, d),
                     __shfl_xor_sync(kFull, v.y, d));
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// v (c - i s): the forward transform's twiddle.
__device__ __forceinline__ float2 cmul_fwd(float2 v, float2 w) {
  return make_float2(__fmaf_rn(v.x, w.x, __fmul_rn(v.y, w.y)),
                     __fmaf_rn(v.y, w.x, -__fmul_rn(v.x, w.y)));
}

// v (c + i s): the inverse transform's twiddle.
__device__ __forceinline__ float2 cmul_inv(float2 v, float2 w) {
  return make_float2(__fmaf_rn(v.x, w.x, -__fmul_rn(v.y, w.y)),
                     __fmaf_rn(v.y, w.x, __fmul_rn(v.x, w.y)));
}

// Forward 64-point FFT by decimation in frequency: z0, z1 are points lane
// and lane + 32 on entry; on return point n holds Z[rev6(n)], so lane j
// holds Z[2 rev5(j)] in z0 and Z[2 rev5(j) + 1] in z1.
__device__ __forceinline__ void fft64_forward(float2& z0, float2& z1,
                                              const Tables& tb, int lane) {
  const float2 a = z0;
  z0 = add2(a, z1);
  z1 = cmul_fwd(sub2(a, z1), tb.w[2 * lane]);
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {  // FFT stages
    const float2 w = tb.st[31 - __clz(d)][lane];
    const bool upper = (lane & d) != 0;
    const float2 p0 = shfl_xor(z0, d), p1 = shfl_xor(z1, d);
    z0 = upper ? cmul_fwd(sub2(p0, z0), w) : add2(z0, p0);
    z1 = upper ? cmul_fwd(sub2(p1, z1), w) : add2(z1, p1);
  }
}

// Bin k of the rfft from A = Z[k] and Bz = Z[(64 - k) mod 64], w = w[k].
__device__ __forceinline__ float2 split_bin(float2 A, float2 Bz, float2 w) {
  const float sx = __fadd_rn(A.x, Bz.x), sy = __fsub_rn(A.y, Bz.y);
  const float dx = __fsub_rn(A.x, Bz.x), dy = __fadd_rn(A.y, Bz.y);
  const float re = __fmaf_rn(w.x, dy, __fmaf_rn(-w.y, dx, sx));
  const float im = __fmaf_rn(-w.x, dx, __fmaf_rn(-w.y, dy, sy));
  return make_float2(__fmul_rn(0.5f, re), __fmul_rn(0.5f, im));
}

// The rfft of the 128 real samples whose even and odd samples are (z0.x,
// z0.y) at 2 lane, 2 lane + 1 and (z1.x, z1.y) at 64 + 2 lane, 65 + 2 lane:
// lane j returns bins k0 = 2 rev5(j) in X0 and k0 + 1 in X1, and lane 0 bin
// 64 in X64.
__device__ __forceinline__ void rfft128(float2 z0, float2 z1,
                                        const Tables& tb, int lane,
                                        float2& X0, float2& X1, float2& X64) {
  fft64_forward(z0, z1, tb, lane);
  const int m = rev5(lane);
  const float2 b0 = shfl(z0, rev5((32 - m) & 31));
  const float2 b1 = shfl(z1, rev5(31 - m));
  X0 = split_bin(z0, b0, tb.w[2 * m]);
  X1 = split_bin(z1, b1, tb.w[2 * m + 1]);
  X64 = split_bin(z0, z0, tb.w[64]);
}

// Z[k] of the inverse from A = X[k] and Bz = X[64 - k], w = w[k].
__device__ __forceinline__ float2 merge_bin(float2 A, float2 Bz, float2 w) {
  const float ex = __fadd_rn(A.x, Bz.x), ey = __fsub_rn(A.y, Bz.y);
  const float dx = __fsub_rn(A.x, Bz.x), dy = __fadd_rn(A.y, Bz.y);
  return make_float2(__fmaf_rn(-dy, w.x, __fmaf_rn(-dx, w.y, ex)),
                     __fmaf_rn(dx, w.x, __fmaf_rn(-dy, w.y, ey)));
}

// irfft to 128 samples of the 65 bins get(k) (the imaginary parts of bins
// 0 and 64 ignored): inverse 64-point FFT by decimation in time. Lane j
// returns samples 2 j, 2 j + 1 in lo and 64 + 2 j, 65 + 2 j in hi; a caller
// that needs one half leaves the other unused.
template <class Get>
__device__ __forceinline__ void irfft128(const Get& get, const Tables& tb,
                                         int lane, float2& lo, float2& hi) {
  const int k0 = 2 * rev5(lane);
  float2 A0 = get(k0), B0 = get(64 - k0);
  const float2 A1 = get(k0 + 1), B1 = get(63 - k0);
  if (k0 == 0) {
    A0.y = 0.0f;
    B0.y = 0.0f;
  }
  float2 z0 = merge_bin(A0, B0, tb.w[k0]);
  float2 z1 = merge_bin(A1, B1, tb.w[k0 + 1]);
#pragma unroll
  for (int d = 1; d <= 16; d <<= 1) {  // FFT stages
    const float2 w = tb.st[31 - __clz(d)][lane];
    const bool upper = (lane & d) != 0;
    const float2 t0 = cmul_inv(z0, w), t1 = cmul_inv(z1, w);
    const float2 p0 = shfl_xor(upper ? t0 : z0, d);
    const float2 p1 = shfl_xor(upper ? t1 : z1, d);
    z0 = upper ? sub2(p0, t0) : add2(z0, p0);
    z1 = upper ? sub2(p1, t1) : add2(z1, p1);
  }
  const float2 t = cmul_inv(z1, tb.w[2 * lane]);
  constexpr float kScale = 1.0f / 128.0f;
  const float2 a = add2(z0, t), b = sub2(z0, t);
  lo = make_float2(__fmul_rn(a.x, kScale), __fmul_rn(a.y, kScale));
  hi = make_float2(__fmul_rn(b.x, kScale), __fmul_rn(b.y, kScale));
}

// ------------------------------------------------ the subtractor's state

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

// The per-stream scalars and this block's decisions, in shared memory: one
// thread writes them between barriers, every thread reads them.
struct Scalars {
  float fs[NF_SHARED];
  int iv[NI_SHARED];
  float mis_e2, mis_y2, mis_inv;  // this channel's misadjustment estimator
  int mis_blocks, mis_over, poor_coarse, hang;
  int size_r, size_c;    // the sizes both filters apply with
  int old_r, new_r, pc;  // the refined size update, partition constrained
  int old_c, new_c, cpc;
  int adjust, reset, no_update_r, no_update_c, disallow;
  float scale;
  float out[kOutScalars];  // y2, e2 and s2 of both filters, max |s| of both
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
__device__ int update_size(int* iv, int base, int duration) {
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
__device__ void update_config(float* fs, int* iv, int K, int cur, int tgt,
                              int old, int ctr_slot, int duration) {
  const int ctr = iv[ctr_slot];
  const int ctr2 = max(ctr - 1, 0);
  const bool still = ctr2 > 0;
  if (ctr > 0) {
    const float f = ratio_rn(ctr2, duration);
    for (int j = 0; j < K; ++j) {
      fs[cur + j] = still ? lerp_rn(fs[old + j], fs[tgt + j], f) : fs[tgt + j];
      if (!still) fs[old + j] = fs[tgt + j];
    }
  }
  iv[ctr_slot] = ctr2;
}

// Before block k's filters run: HandleEchoPathChange (subtractor.cc:146-174)
// and ExitInitialState (:176-186) on the scalars; the sizes to apply with.
__device__ void block_start(Scalars& sc, const Config& cfg, bool delay_change,
                            bool transition) {
  float* fs = sc.fs;
  int* iv = sc.iv;
  if (delay_change) {
    iv[I_R_CUR] = iv[I_R_TGT] = iv[I_R_OLD] = cfg.size_r0;
    iv[I_C_CUR] = iv[I_C_TGT] = iv[I_C_OLD] = cfg.size_c0;
    iv[I_R_CTR] = iv[I_C_CTR] = iv[I_RG_CTR] = iv[I_CG_CTR] = 0;
    iv[I_R_PC] = min(iv[I_R_PC], cfg.size_r0 - 1);
    iv[I_C_PC] = min(iv[I_C_PC], cfg.size_c0 - 1);
    iv[I_RG_POOR] = kPoorExcitationInitial;
    iv[I_RG_CALL] = iv[I_CG_POOR] = iv[I_CG_CALL] = 0;
    for (int j = 0; j < 5; ++j) {
      fs[F_RG_CUR + j] = fs[F_RG_TGT + j] = fs[F_RG_OLD + j] =
          cfg.refined_initial[j];
    }
    for (int j = 0; j < 2; ++j) {
      fs[F_CG_CUR + j] = fs[F_CG_TGT + j] = fs[F_CG_OLD + j] =
          cfg.coarse_initial[j];
    }
  }
  if (transition) {
    for (int j = 0; j < 5; ++j) fs[F_RG_TGT + j] = cfg.refined[j];
    for (int j = 0; j < 2; ++j) fs[F_CG_TGT + j] = cfg.coarse[j];
    iv[I_RG_CTR] = iv[I_CG_CTR] = cfg.duration;
    iv[I_R_TGT] = cfg.size_r;
    iv[I_C_TGT] = cfg.size_c;
    iv[I_R_CTR] = iv[I_C_CTR] = cfg.duration;
  }
  sc.size_r = iv[I_R_CUR];
  sc.size_c = iv[I_C_CUR];
}

// The decisions that need no error energy, taken while the two filters'
// errors are computed, the refined filter's on one thread and the coarse
// filter's on another (their slots are apart): the refined gain's
// configuration and counters (refined_filter_update_gain.cc:80-150; the size
// is the one before this block's update), the refined size update; the
// coarse filter's size update and gain configuration (coarse_filter_update_
// gain.cc:30-78); each filter's partition the next block constrains.
__device__ void block_decide(Scalars& sc, const Config& cfg, bool coarse,
                             bool poor_exc, bool sat) {
  float* fs = sc.fs;
  int* iv = sc.iv;
  if (coarse) {
    sc.old_c = iv[I_C_CUR];
    const int new_c = update_size(iv, I_C_CUR, cfg.duration);
    const int cpc = iv[I_C_PC];
    sc.new_c = new_c;
    sc.cpc = cpc;
    update_config(fs, iv, 2, F_CG_CUR, F_CG_TGT, F_CG_OLD, I_CG_CTR,
                  cfg.duration);
    const int call_c = iv[I_CG_CALL] + 1;
    const int poor_c = (poor_exc ? 0 : iv[I_CG_POOR]) + 1;
    iv[I_CG_CALL] = call_c;
    iv[I_CG_POOR] = poor_c;
    sc.no_update_c = poor_c < new_c || sat || call_c <= new_c;
    iv[I_C_PC] = cpc < new_c - 1 ? cpc + 1 : 0;
    return;
  }
  update_config(fs, iv, 5, F_RG_CUR, F_RG_TGT, F_RG_OLD, I_RG_CTR,
                cfg.duration);
  const int call_r = iv[I_RG_CALL] + 1;
  const int poor_r = (poor_exc ? 0 : iv[I_RG_POOR]) + 1;
  iv[I_RG_CALL] = call_r;
  iv[I_RG_POOR] = poor_r;
  sc.no_update_r = poor_r < sc.size_r || sat || call_r <= sc.size_r;
  sc.disallow = sc.hang > 0;
  sc.old_r = iv[I_R_CUR];
  const int new_r = update_size(iv, I_R_CUR, cfg.duration);
  const int pc = iv[I_R_PC];
  sc.new_r = new_r;
  sc.pc = pc;
  iv[I_R_PC] = pc < new_r - 1 ? pc + 1 : 0;
}

// The coarse filter's poor-filter counter after this block; at 5 the coarse
// filter resets from the refined one (subtractor.cc:282-301).
__device__ __forceinline__ int poor_coarse_next(const Scalars& sc) {
  return sc.out[1] < sc.out[2] ? sc.poor_coarse + 1 : 0;
}

// ------------------------------------------------ shared memory

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int NT>
__device__ __forceinline__ void copy8(float2* dst, const float2* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) cp_async8(dst + i, src + i);
}

template <int NT>
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) cp_async4(dst + i, src + i);
}

// Rows [first, first + n) of a stream's chain into (n, L) planes of the re,
// im and spectrum parts (asynchronous: the caller waits).
template <int NT>
__device__ __forceinline__ void load_window(float* xre, const float* rows,
                                            int first, int n, int L, int F,
                                            int plane) {
  for (int q = 0; q < 3 * n; ++q) {
    const int p = q / 3, part = q - 3 * p;
    copy4<NT>(xre + part * plane + p * L, rows + (size_t)(first + p) * F +
                                              part * L, L);
  }
}

inline size_t shared_bytes(int P, int Pc, int R, int nb) {
  const size_t L = (size_t)R * kBins, rows = (size_t)P + nb - 1;
  // float2: H, Hc, the partial products (2, L), E and G (2, 65 each).
  const size_t complex = (P + Pc + 2) * L + 4 * kBins;
  // float: the window's re, im and spectrum planes (rows, L), fr (P, 65),
  // ir (P, 64), the constrained heads (R, 64), the blocks' y (nb, 64), x2
  // and E2 (2, 65 each), H_error and erl (65 each); bytes: the blocks'
  // narrow-band masks (nb, 65) and events (nb, 3).
  const size_t real = 3 * rows * L + (size_t)P * (kBins + kBlock) +
                      (size_t)(R + nb) * kBlock + 6 * kBins;
  return 8 * complex + sizeof(Tables) + 4 * real + sizeof(Scalars) +
         (size_t)nb * (kBins + 3);
}

// H[k] + conj(X[k]) G[k], the adapt of one bin (AdaptPartitions).
__device__ __forceinline__ float2 adapt_bin(float2 h, float xr, float xi,
                                            float2 g) {
  return add2(h, make_float2(__fmaf_rn(xr, g.x, __fmul_rn(xi, g.y)),
                             __fmaf_rn(xr, g.y, -__fmul_rn(xi, g.x))));
}

__device__ __forceinline__ float power(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// The block's shared memory, carved from one dynamic allocation.
struct Shared {
  float2 *H, *Hc, *part, *E, *G;
  Tables* tb;
  float *xre, *xim, *xsp, *fr, *ir, *hh, *ys, *x2, *E2, *herr, *erl;
  Scalars* sc;
  uint8_t *mask, *ev;
};

__device__ __forceinline__ Shared carve(unsigned char* base, int P, int Pc,
                                        int L, int R, int nb) {
  const int rows = P + nb - 1;
  Shared s;
  s.H = reinterpret_cast<float2*>(base);
  s.Hc = s.H + P * L;
  s.part = s.Hc + Pc * L;  // (2, L): refined, coarse per (render ch, bin)
  s.E = s.part + 2 * L;    // (2, 65)
  s.G = s.E + 2 * kBins;   // (2, 65)
  s.tb = reinterpret_cast<Tables*>(s.G + 2 * kBins);
  // The planes read as float pairs first, at even offsets.
  s.ys = reinterpret_cast<float*>(s.tb + 1);  // (nb, 64)
  s.hh = s.ys + nb * kBlock;  // (R, 64)
  s.x2 = s.hh + R * kBlock;  // (2, 65)
  s.E2 = s.x2 + 2 * kBins;   // (2, 65)
  s.herr = s.E2 + 2 * kBins;
  s.erl = s.herr + kBins;
  s.xre = s.erl + kBins;  // (rows, L)
  s.xim = s.xre + rows * L;
  s.xsp = s.xim + rows * L;
  s.fr = s.xsp + rows * L;  // (P, 65)
  s.ir = s.fr + P * kBins;  // (P, 64)
  s.sc = reinterpret_cast<Scalars*>(s.ir + P * kBlock);
  s.mask = reinterpret_cast<uint8_t*>(s.sc + 1);  // (nb, 65)
  s.ev = s.mask + nb * kBins;                      // (nb, 3)
  return s;
}

// Adapt every active partition of the filters in `which` (bit 0 refined,
// bit 1 coarse) and constrain the one due: the lower half of the block's
// warps run the 2 R constrain transforms (one warp each: the head
// irfft(H[pc] + conj(X) G)[0:64], then H[pc] = rfft([head, 0])), the upper
// half adapts the other partitions, so the two never touch the same bins.
template <int NT>
__device__ void adapt_and_constrain(const Shared& s, int which, int L, int R,
                                    int xb) {
  constexpr int NW = NT / 32;
  const Scalars& sc = *s.sc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < NW / 2) {
    for (int t = warp; t < 2 * R; t += NW / 2) {
      const int w = t / R, r = t - w * R;
      if (!((which >> w) & 1)) continue;
      const int p = w ? sc.cpc : sc.pc;
      float2* Hp = (w ? s.Hc : s.H) + p * L + r * kBins;
      const float* xr = s.xre + (xb + p) * L + r * kBins;
      const float* xi = s.xim + (xb + p) * L + r * kBins;
      const float2* g = s.G + w * kBins;
      float2 head, tail;
      irfft128([&](int k) { return adapt_bin(Hp[k], xr[k], xi[k], g[k]); },
               *s.tb, lane, head, tail);
      if (w == 0) reinterpret_cast<float2*>(s.hh + r * kBlock)[lane] = head;
      float2 X0, X1, X64;
      rfft128(head, make_float2(0.0f, 0.0f), *s.tb, lane, X0, X1, X64);
      __syncwarp();
      const int m = rev5(lane);
      Hp[2 * m] = X0;
      Hp[2 * m + 1] = X1;
      if (lane == 0) Hp[kBins - 1] = X64;
    }
  } else {
    constexpr int kStride = NT / 2;
    for (int w = 0; w < 2; ++w) {
      if (!((which >> w) & 1)) continue;
      float2* H = w ? s.Hc : s.H;
      const float2* g = s.G + w * kBins;
      const int n = (w ? sc.new_c : sc.new_r) * L;
      const int skip = (w ? sc.cpc : sc.pc) * L;  // the constrained rows
      const float* xr = s.xre + xb * L;
      const float* xi = s.xim + xb * L;
      // Bin i of the filter is row i of the window; its gain is G[i mod
      // 65], since a partition's L = 65 R bins are R spectra. (Unrolled,
      // the loop measures slower: tools/torch_k6_variants.py.)
#pragma unroll 1
      for (int i = tid - kStride; i < n; i += kStride) {
        if (i >= skip && i < skip + L) continue;
        H[i] = adapt_bin(H[i], xr[i], xi[i], g[i % kBins]);
      }
    }
  }
}

template <int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    pair_kernel(Args a, Config cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, P = a.P, Pc = a.Pc, R = a.R, nb = a.nb;
  const int L = R * kBins;
  const int rows = P + nb - 1;
  const int plane = rows * L;
  const int NF = NF_SHARED + 3 * C;
  const int NI = NI_SHARED + 4 * C;
  const int b = blockIdx.x / C;
  const int c = blockIdx.x - b * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bc = (size_t)b * C + c;
  const Shared s = carve(smem, P, Pc, L, R, nb);
  Scalars& sc = *s.sc;
  const Tables& tb = *s.tb;

  // The windows' starts, clamped into the chain, where every valid window
  // lies. Consecutive starts (block k at start_0 - k, as a chain's
  // trajectory runs) share one staged span of P + nb - 1 rows; otherwise
  // each block loads its own P rows.
  const int* offs = a.offs + (size_t)b * nb;
  const int hi = a.W2 - P;
  const int o0 = min(max(offs[0], 0), hi);
  bool staged = true;
  for (int k = 1; k < nb; ++k) {
    staged = staged && min(max(offs[k], 0), hi) == o0 - k;
  }
  const float* rows0 = a.chain + (size_t)b * a.W2 * a.F;

  copy8<NT>(s.H, a.H + bc * P * L, P * L);
  copy8<NT>(s.Hc, a.Hc + bc * Pc * L, Pc * L);
  copy4<NT>(s.fr, a.freq + bc * P * kBins, P * kBins);
  copy4<NT>(s.ir, a.imp + bc * P * kBlock, P * kBlock);
  copy4<NT>(s.herr, a.herr + bc * kBins, kBins);
  copy8<NT>(reinterpret_cast<float2*>(s.tb),
            reinterpret_cast<const float2*>(&kTables),
            (int)(sizeof(Tables) / sizeof(float2)));
  if (staged) load_window<NT>(s.xre, rows0, o0 - (nb - 1), rows, L, a.F, plane);
  if (tid == 0) {
    const float* fsb = a.fs + (size_t)b * NF;
    const int* ivb = a.iv + (size_t)b * NI;
    for (int i = 0; i < NF_SHARED; ++i) sc.fs[i] = fsb[i];
    for (int i = 0; i < NI_SHARED; ++i) sc.iv[i] = ivb[i];
    sc.mis_e2 = fsb[NF_SHARED + c];
    sc.mis_y2 = fsb[NF_SHARED + C + c];
    sc.mis_inv = fsb[NF_SHARED + 2 * C + c];
    sc.mis_blocks = ivb[NI_SHARED + c];
    sc.mis_over = ivb[NI_SHARED + C + c];
    sc.poor_coarse = ivb[NI_SHARED + 2 * C + c];
    sc.hang = ivb[NI_SHARED + 3 * C + c];
  }
  // Every block's capture, mask and events, so that no block waits on
  // device memory for them.
  for (int i = tid; i < nb * kBlock; i += NT) {
    const int kb = i >> 6;
    s.ys[i] = a.y[(((size_t)b * nb + kb) * C + c) * kBlock + (i & 63)];
  }
  for (int i = tid; i < nb * kBins; i += NT) {
    s.mask[i] = a.mask[(size_t)b * nb * kBins + i];
  }
  for (int i = tid; i < nb * 3; i += NT) s.ev[i] = a.ev[(size_t)b * nb * 3 + i];
  const bool sat = a.sat[b] != 0;
  cp_async_wait_all();
  __syncthreads();

  for (int kb = 0; kb < nb; ++kb) {
    const size_t bk = (size_t)b * nb + kb;
    const size_t o = bk * C + c;  // (b, kb, c)
    const uint8_t* ev = s.ev + kb * 3;
    const float* ys = s.ys + kb * kBlock;
    const bool delay_change = ev[1] != 0;

    // A. Events and the window.
    int xb = nb - 1 - kb;
    if (!staged) {
      xb = 0;
      load_window<NT>(s.xre, rows0, min(max(offs[kb], 0), hi), P, L, a.F,
                      plane);
    }
    if (tid == 0) block_start(sc, cfg, delay_change, ev[2] != 0);
    if (delay_change) {
      for (int i = tid; i < P * L; i += NT) s.H[i] = make_float2(0, 0);
      for (int i = tid; i < Pc * L; i += NT) s.Hc[i] = make_float2(0, 0);
      for (int k = tid; k < kBins; k += NT) s.herr[k] = kHErrorInitial;
    }
    if (!staged) cp_async_wait_all();
    __syncthreads();

    // B. Both filters' products summed over their active partitions per
    // (render channel, bin), with the same arithmetic, so that filters
    // equal on the active partitions give equal outputs (the refined /
    // coarse ties).
    const int size_r = sc.size_r, size_c = sc.size_c;
    {
      for (int i = tid; i < 2 * L; i += NT) {
        const int w = i >= L;
        const int l = i - w * L;
        const float2* H = w ? s.Hc : s.H;
        const int size = w ? size_c : size_r;
        float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 4
        for (int p = 0; p < size; ++p) {
          const int x = (xb + p) * L + l;
          const float xr = s.xre[x], xi = s.xim[x];
          const float2 h = H[p * L + l];
          acc.x = __fmaf_rn(xr, h.x, __fmaf_rn(-xi, h.y, acc.x));
          acc.y = __fmaf_rn(xr, h.y, __fmaf_rn(xi, h.x, acc.y));
        }
        s.part[i] = acc;
      }
    }
    __syncthreads();

    // C. One warp per filter: the prediction s = irfft(S)[64:128] and the
    // error e = y - s (subtractor.cc:41-57), their energies; on the refined
    // filter's warp the misadjustment estimator (subtractor.cc:324-357) and
    // the rescale of an overestimating filter (:258-268); the windowed error
    // spectrum E = rfft([0 x 64, hann e]) and its power. Meanwhile the other
    // warps sum the render spectra over the filters' active partitions and
    // the frequency responses into the ERL, and their last thread takes the
    // decisions that need no error energy.
    if (warp >= 2) {
      for (int i = tid - 64; i < 3 * kBins; i += NT - 64) {
        if (i < 2 * kBins) {
          const int w = i >= kBins;
          const int k = i - w * kBins;
          const int size = w ? size_c : size_r;
          float sum = 0.0f;
#pragma unroll 4
          for (int p = 0; p < size; ++p) {
            const float* spec = s.xsp + (xb + p) * L + k;
            float v = 0.0f;
            for (int r = 0; r < R; ++r) v += spec[r * kBins];
            sum += v;
          }
          s.x2[i] = sum;
        } else {
          const int k = i - 2 * kBins;
          float erl = 0.0f;
#pragma unroll 4
          for (int p = 0; p < P; ++p) erl += s.fr[p * kBins + k];
          s.erl[k] = erl;
        }
      }
      if (tid == NT - 1 || tid == NT - 33) {
        block_decide(sc, cfg, tid == NT - 33, ev[0] != 0, sat);
      }
    } else {
      const int w = warp;
      const float2* pw = s.part + w * L;
      float2 head, sv;
      irfft128(
          [&](int k) {
            float2 v = pw[k];
            for (int r = 1; r < R; ++r) v = add2(v, pw[r * kBins + k]);
            return v;
          },
          tb, lane, head, sv);
      const float2 y = reinterpret_cast<const float2*>(ys)[lane];
      float2 e = sub2(y, sv);
      float q_y = __fmaf_rn(y.y, y.y, __fmul_rn(y.x, y.x));
      float q_e = __fmaf_rn(e.y, e.y, __fmul_rn(e.x, e.x));
      float q_s = __fmaf_rn(sv.y, sv.y, __fmul_rn(sv.x, sv.x));
      float q_m = fmaxf(fabsf(sv.x), fabsf(sv.y));
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        q_y += __shfl_xor_sync(kFull, q_y, d);
        q_e += __shfl_xor_sync(kFull, q_e, d);
        q_s += __shfl_xor_sync(kFull, q_s, d);
        q_m = fmaxf(q_m, __shfl_xor_sync(kFull, q_m, d));
      }
      if (lane == 0) {
        if (w == 0) sc.out[0] = q_y;
        sc.out[1 + w] = q_e;
        sc.out[3 + w] = q_s;
        sc.out[5 + w] = q_m;
      }
      if (w == 0) {
        float e2a = sc.mis_e2 + q_e;
        float y2a = sc.mis_y2 + q_y;
        int nblk = sc.mis_blocks + 1;
        float inv = sc.mis_inv;
        int over = sc.mis_over;
        const bool window_done = nblk == 4;
        const bool done_active =
            window_done && y2a > 4.0f * 200.0f * 200.0f * 64;
        const float update = e2a / fmaxf(y2a, 1e-30f);
        over = (done_active && e2a > 4.0f * 7500.0f * 7500.0f * 64)
                   ? 4
                   : max(over - (done_active ? 1 : 0), 0);
        if (done_active && (update < inv || over > 0)) {
          inv = __fadd_rn(inv, __fmul_rn(0.1f, __fsub_rn(update, inv)));
        }
        if (window_done) {
          e2a = 0.0f;
          y2a = 0.0f;
          nblk = 0;
        }
        const bool adjust = inv > 10.0f;
        const float scale = 2.0f / sqrtf(fmaxf(inv, 1e-10f));
        if (adjust) {
          sv = make_float2(__fmul_rn(sv.x, scale), __fmul_rn(sv.y, scale));
          e = sub2(y, sv);
          inv = 0.0f;
          over = 0;
          e2a = 0.0f;
          y2a = 0.0f;
          nblk = 0;
        }
        __syncwarp();
        if (lane == 0) {
          sc.mis_e2 = e2a;
          sc.mis_y2 = y2a;
          sc.mis_blocks = nblk;
          sc.mis_inv = inv;
          sc.mis_over = over;
          sc.adjust = adjust;
          sc.scale = scale;
        }
      }
      reinterpret_cast<float2*>((w ? a.e_coa : a.e_ref) + o * kBlock)[lane] =
          e;
      const float2 hw = reinterpret_cast<const float2*>(tb.hann)[lane];
      float2 X0, X1, X64;
      rfft128(make_float2(0.0f, 0.0f),
              make_float2(__fmul_rn(e.x, hw.x), __fmul_rn(e.y, hw.y)), tb,
              lane, X0, X1, X64);
      const int m = rev5(lane);
      float2* E = s.E + w * kBins;
      float* E2 = s.E2 + w * kBins;
      E[2 * m] = X0;
      E[2 * m + 1] = X1;
      E2[2 * m] = power(X0);
      E2[2 * m + 1] = power(X1);
      if (lane == 0) {
        E[kBins - 1] = X64;
        E2[kBins - 1] = power(X64);
      }
    }
    __syncthreads();

    // D. Per bin: the refined gain and H_error (refined_filter_update_gain.
    // cc:80-150), the coarse gain (coarse_filter_update_gain.cc:30-78); the
    // rescale of the refined filter and its impulse responses; partitions
    // that join a filter start at zero (UpdateSize).
    {
      const uint8_t* mask = s.mask + kb * kBins;
      const float* cur = sc.fs;
      const bool adjust = sc.adjust != 0;
      const bool reset = poor_coarse_next(sc) >= 5;
      if (tid == 0) sc.reset = reset;
      for (int i = tid; i < 2 * kBins; i += NT) {
        if (i < kBins) {
          const int k = i;
          const float X2 = s.x2[k], he = s.herr[k], E2r = s.E2[k];
          const bool no_update = sc.no_update_r != 0;
          float mu = 0.0f;
          if (X2 >= cur[F_RG_CUR + 4]) {
            mu = __fdiv_rn(he, __fadd_rn(
                                   __fmul_rn(__fmul_rn(0.5f, he), X2),
                                   __fmul_rn((float)sc.size_r, E2r)));
          }
          if (mask[k] || no_update) mu = 0.0f;
          float h = __fsub_rn(
              he, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, mu), X2), he));
          const float2 Ek = s.E[k];
          s.G[k] = (no_update || adjust)
                       ? make_float2(0.0f, 0.0f)
                       : make_float2(__fmul_rn(mu, Ek.x), __fmul_rn(mu, Ek.y));
          const float leak = (E2r <= s.E2[kBins + k] || sc.disallow)
                                 ? cur[F_RG_CUR]
                                 : cur[F_RG_CUR + 1];
          h = __fadd_rn(h, __fmul_rn(leak, s.erl[k]));
          s.herr[k] = fminf(fmaxf(h, cur[F_RG_CUR + 2]), cur[F_RG_CUR + 3]);
        } else {
          const int k = i - kBins;
          const float X2 = s.x2[kBins + k];
          float mu = X2 > cur[F_CG_CUR + 1]
                         ? __fdiv_rn(cur[F_CG_CUR], fmaxf(X2, 1e-30f))
                         : 0.0f;
          if (mask[k]) mu = 0.0f;
          const float2 e = reset ? s.E[k] : s.E[kBins + k];
          s.G[kBins + k] = sc.no_update_c
                               ? make_float2(0.0f, 0.0f)
                               : make_float2(__fmul_rn(mu, e.x),
                                             __fmul_rn(mu, e.y));
        }
      }
      const int old_r = sc.old_r, new_r = sc.new_r;
      if (adjust) {
        const float scale = sc.scale;
        for (int i = tid; i < P * L; i += NT) {
          const int p = i / L;
          s.H[i] = (p >= old_r && p < new_r)
                       ? make_float2(0.0f, 0.0f)
                       : make_float2(__fmul_rn(s.H[i].x, scale),
                                     __fmul_rn(s.H[i].y, scale));
        }
        for (int i = tid; i < P * kBlock; i += NT) {
          s.ir[i] = __fmul_rn(s.ir[i], scale);
        }
      } else {
        for (int i = old_r * L + tid; i < new_r * L; i += NT) {
          s.H[i] = make_float2(0.0f, 0.0f);
        }
      }
      if (!reset) {
        for (int i = sc.old_c * L + tid; i < sc.new_c * L; i += NT) {
          s.Hc[i] = make_float2(0.0f, 0.0f);
        }
      }
    }
    __syncthreads();

    // E. Adapt and constrain both filters; after a coarse reset the coarse
    // filter restarts from the refined one as adapted and constrained.
    if (!sc.reset) {
      adapt_and_constrain<NT>(s, 3, L, R, xb);
    } else {
      adapt_and_constrain<NT>(s, 1, L, R, xb);
      __syncthreads();
      for (int i = tid; i < Pc * L; i += NT) s.Hc[i] = s.H[i];
      __syncthreads();
      adapt_and_constrain<NT>(s, 2, L, R, xb);
    }
    __syncthreads();

    // F. The refined filter's impulse-response row pc (the largest of the
    // render channels' heads) and frequency response (the largest |H|^2
    // over render channels, zero beyond the size); this block's outputs.
    {
      const int pc = sc.pc, new_r = sc.new_r;
      float* oimp = a.oimp + o * P * kBlock;
      for (int i = tid; i < P * kBlock; i += NT) {
        float v;
        if ((i >> 6) == pc) {
          const int n = i & (kBlock - 1);
          v = s.hh[n];
          for (int r = 1; r < R; ++r) {
            const float cand = s.hh[r * kBlock + n];
            if (fabsf(v) < fabsf(cand)) v = cand;
          }
          s.ir[i] = v;
        } else {
          v = s.ir[i];
        }
        oimp[i] = v;
      }
      float* ofreq = a.ofreq + o * P * kBins;
      for (int i = tid; i < P * kBins; i += NT) {
        const int p = i / kBins;
        const int k = i - p * kBins;
        float m = 0.0f;
        if (p < new_r) {
          for (int r = 0; r < R; ++r) {
            const float v = power(s.H[p * L + r * kBins + k]);
            m = r == 0 ? v : fmaxf(m, v);
          }
        }
        s.fr[i] = m;
        ofreq[i] = m;
      }
      if (tid == 0) {
        for (int j = 0; j < kOutScalars; ++j) {
          a.scal[o * kOutScalars + j] = sc.out[j];
        }
        if (c == 0) a.osize[bk] = new_r;
        const int poor = poor_coarse_next(sc);
        sc.poor_coarse = poor >= 5 ? 0 : poor;
        sc.hang = poor >= 5 ? cfg.hangover : max(sc.hang - 1, 0);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < P * L; i += NT) a.H_o[bc * P * L + i] = s.H[i];
  for (int i = tid; i < Pc * L; i += NT) a.Hc_o[bc * Pc * L + i] = s.Hc[i];
  for (int i = tid; i < P * kBins; i += NT) {
    a.freq_o[bc * P * kBins + i] = s.fr[i];
  }
  for (int i = tid; i < P * kBlock; i += NT) {
    a.imp_o[bc * P * kBlock + i] = s.ir[i];
  }
  for (int k = tid; k < kBins; k += NT) a.herr_o[bc * kBins + k] = s.herr[k];
  if (tid == 0) {
    float* fso = a.fs_o + (size_t)b * NF;
    int* ivo = a.iv_o + (size_t)b * NI;
    fso[NF_SHARED + c] = sc.mis_e2;
    fso[NF_SHARED + C + c] = sc.mis_y2;
    fso[NF_SHARED + 2 * C + c] = sc.mis_inv;
    ivo[NI_SHARED + c] = sc.mis_blocks;
    ivo[NI_SHARED + C + c] = sc.mis_over;
    ivo[NI_SHARED + 2 * C + c] = sc.poor_coarse;
    ivo[NI_SHARED + 3 * C + c] = sc.hang;
    if (c == 0) {
      for (int i = 0; i < NF_SHARED; ++i) fso[i] = sc.fs[i];
      for (int i = 0; i < NI_SHARED; ++i) ivo[i] = sc.iv[i];
    }
  }
}

template <int NT, int MIN_BLOCKS>
int launch(const Args& a, const Config& cfg, int B, long long bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_kernel<NT, MIN_BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  pair_kernel<NT, MIN_BLOCKS><<<B * a.C, NT, (size_t)bytes, stream>>>(a, cfg);
  return (int)cudaGetLastError();
}

}  // namespace

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
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take (one that needs more than a block's 227 KB).
extern "C" int subtractor_pair_f32(
    const void* H, const void* Hc, const void* herr, const void* freq,
    const void* imp, const void* fs, const void* iv, const void* chain,
    const void* offs, const void* y, const void* mask, const void* events,
    const void* sat, void* H_o, void* Hc_o, void* herr_o, void* freq_o,
    void* imp_o, void* fs_o, void* iv_o, void* e_ref, void* e_coa,
    void* scal, void* ofreq, void* oimp, void* osize, int B, int C, int P,
    int Pc, int R, int W2, int F, int nb, const float* fcfg, const int* icfg,
    void* stream) {
  if (B < 0 || C < 1 || P < 1 || Pc < 1 || Pc > P || R < 1 || nb < 1 ||
      W2 < P || F < 3 * R * kBins) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = shared_bytes(P, Pc, R, nb);
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
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
  const auto s = static_cast<cudaStream_t>(stream);
  // One render channel: 128 threads (the 65-bin sweeps fill them), five
  // blocks an SM; more: 256 threads, three blocks an SM (~63 KB each at
  // P = 13, Pc = 11, R = 2).
  return R == 1 ? launch<128, 5>(a, cfg, B, (long long)bytes, s)
                : launch<256, 3>(a, cfg, B, (long long)bytes, s);
}
