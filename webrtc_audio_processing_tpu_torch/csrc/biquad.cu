// Batched cascaded direct-form-1 biquad filter for sm_90a.
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_biquad.py
// (_biquad_kernel). The recurrence is sequential in time, so the parallel
// axis is the lane m (stream x channel): one thread per lane walks the T
// samples with every section's (x1, x2, y1, y2) and coefficients in
// registers. Data is time-major (T, M), so a warp's 32 reads of sample t
// are one 128-byte line.
//
// Rounding. The kernel's oracle is the JAX package's scan
// (pallas_biquad.make_cascade.scan_impl) as XLA:CPU compiles it:
//     y = b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2
// with x*1.0 folded away and every remaining multiply-add contracted into a
// fused multiply-add, so each section evaluates
//     acc = b0 == 1 ? fma(b1, x1, x) : fma(b0, x, b1*x1)
//     acc = b2 == 1 ? x2 + acc       : fma(b2, x2, acc)
//     acc = fma(-a1, y1, acc)
//     acc = fma(-a2, y2, acc)
// A caller whose rows are first-order all-pass sections [a, 1, 0, a, 0]
// (the two-band QMF's branches, ops/qmf.py) asks for the all-pass form,
// evaluated in the order XLA:CPU gives the JAX package's all-pass scan
// (ops/qmf.py, y = x1 + a * (x - y1)):
//     acc = fma(a, x - y1, x1)
// It is a separate kernel instantiation, chosen on the host, so the biquad
// form's code is untouched by it.
// Each fma is one float32 FFMA (__fmaf_rn), the single rounding XLA:CPU
// does. The PyTorch twin rounds the double sum of the exact product and c
// to float, which equals it on every multiply-add of the port's tables
// (tests/test_torch_kernel_contracts.py holds the twin to an exact fma).
// Every operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing on its own.
//
// What bounds it on an H100: one read and one write of the (T, M) frame
// and the state (16.1 MB at the HPF's T = 480, M = 4096: 0.0048 ms at
// 3.35 TB/s). The recurrence itself is short: y_t depends on y_{t-1} only
// through the last two multiply-adds, so its chain is about 2T + 4K
// dependent FFMAs (0.002 ms). The design follows from that:
// - Sections run skewed: in iteration i, section k filters sample i - k,
//   taking what section k - 1 produced in iteration i - 1. The K updates of
//   one iteration are independent, so the warp issues them back to back
//   and each sample waits only on the 2 feedback FFMAs. Each section sees
//   the same operands in the same order as in the plain loop: only the
//   interleaving across sections changes, and the results are bit for bit
//   those of the unskewed cascade. K - 1 guarded iterations fill the
//   cascade at the start and drain it at the end.
// - One-warp blocks of 32 lanes: M / 32 blocks, 128 at the HPF's and
//   PostFilter's M = 4096 (of 132 SMs), 64 at the decimators' M = 2048. A
//   block's time is its warp's issue of T * K section updates; a half-warp
//   block would issue the same instructions for half the lanes, so no
//   block would finish sooner, and at M = 2048 every warp already has an
//   SM to itself.
// - The input is staged through shared memory in chunks of 32 samples with
//   cp.async, double-buffered: chunk c + 1 is in flight while chunk c is
//   filtered. Each lane copies its own column (the warp's 32 copies of a
//   sample are one line) and reads back only what it copied, so no barrier
//   is needed. Outputs are stored directly, one coalesced line per sample.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 5;
constexpr int kLanes = 32;  // one warp per block
constexpr int kChunk = 32;  // samples per staged chunk

// Which sections have b0 == 1 (bit 2k) and b2 == 1 (bit 2k + 1). The port's
// tables have unit sections after a general first one: the HPFs (K = 3)
// and the factor-4 decimators' (K = 4, last section general) 0x3C, the
// PostFilter's 0xFC; the factor-8 decimators' five band-pass sections
// have none (K = 5, mask 0). A kernel specialised on its table's mask
// carries no select per operation, as XLA folds x * 1.0 away at compile
// time; kRuntime decides per section at run time, for any other table.
// kAllpass: the caller's rows are first-order all-pass sections.
constexpr int kRuntime = -1;
constexpr int kAllpass = -2;
constexpr int kUnit123 = 0xFC;
constexpr int kUnit12 = 0x3C;
constexpr int kUnitNone = 0;

struct Section {
  float b0, b1, b2, na1, na2;  // coefficients, a1 and a2 negated
  float x1, x2, y1, y2;        // state
};

// Section k on one sample, in the oracle's contracted order. After the
// caller's loop over k is unrolled, k is a constant and a mask other than
// kRuntime folds the choices away.
template <int kUnits>
__device__ __forceinline__ float section_step(Section& s, float in, int k) {
  const bool b0_one =
      kUnits == kRuntime ? s.b0 == 1.0f
                         : kUnits >= 0 && ((kUnits >> (2 * k)) & 1) != 0;
  const bool b2_one =
      kUnits == kRuntime ? s.b2 == 1.0f
                         : kUnits >= 0 && ((kUnits >> (2 * k + 1)) & 1) != 0;
  float acc;
  if (kUnits == kAllpass) {
    acc = __fmaf_rn(s.b0, __fsub_rn(in, s.y1), s.x1);
  } else {
    acc = b0_one ? __fmaf_rn(s.b1, s.x1, in)
                 : __fmaf_rn(s.b0, in, __fmul_rn(s.b1, s.x1));
    acc = b2_one ? __fadd_rn(s.x2, acc) : __fmaf_rn(s.b2, s.x2, acc);
    acc = __fmaf_rn(s.na1, s.y1, acc);
    acc = __fmaf_rn(s.na2, s.y2, acc);
  }
  s.x2 = s.x1;
  s.x1 = in;
  s.y2 = s.y1;
  s.y1 = acc;
  return acc;
}

// Iteration i of the skewed cascade: section k filters sample i - k. pipe[k]
// (k >= 1) holds section k - 1's output of iteration i - 1; sections run
// from the last down, so each reads its pipe slot before it is refilled.
// kGuarded skips the sections with no sample in [0, T) (fill and drain).
// The last section's output goes to *out, which then moves one row on.
template <int K, int kUnits, bool kGuarded>
__device__ __forceinline__ void iteration(Section (&sec)[K],
                                          float (&pipe)[K], float x, int i,
                                          int T, float*& out, int M) {
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (kGuarded && (i - k < 0 || i - k >= T)) continue;
    const float y = section_step<kUnits>(sec[k], k == 0 ? x : pipe[k], k);
    if (k + 1 < K) {
      pipe[k + 1] = y;
    } else {
      *out = y;
      out += M;
    }
  }
}

// Issue the copies of chunk c (samples [c * kChunk, c * kChunk + kChunk)
// of this lane's column) into its stage, as one cp.async group.
__device__ __forceinline__ void stage_chunk(float (*stage)[kChunk][kLanes],
                                            const float* __restrict__ x,
                                            int c, int T, int M, int m,
                                            int lane) {
  const int t0 = c * kChunk;
  const int n = min(kChunk, T - t0);
  float* dst = &stage[c & 1][0][lane];
  const float* src = x + (size_t)t0 * M + m;
  for (int j = 0; j < n; ++j, src += M) {
    __pipeline_memcpy_async(dst + j * kLanes, src, sizeof(float));
  }
  __pipeline_commit();
}

// The whole time loop of one lane, for one coefficient mask.
template <int K, int kUnits>
__device__ __forceinline__ void filter_lane(
    Section (&sec)[K], float (*stage)[kChunk][kLanes],
    const float* __restrict__ x, float* __restrict__ y, int T, int M, int m,
    int lane) {
  float pipe[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pipe[k] = 0.0f;
  float* out = y + m;
  const int chunks = (T + kChunk - 1) / kChunk;
  if (chunks > 0) stage_chunk(stage, x, 0, T, M, m, lane);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk(stage, x, c + 1, T, M, m, lane);
    } else {
      __pipeline_commit();  // an empty group keeps one group per chunk
    }
    __pipeline_wait_prior(1);  // chunk c has landed
    const float* xs = &stage[c & 1][0][lane];
    const int t0 = c * kChunk;
    const int n = min(kChunk, T - t0);
    int j = 0;
    if (c == 0) {
      for (; j < n && j < K - 1; ++j) {
        iteration<K, kUnits, true>(sec, pipe, xs[j * kLanes], j, T, out, M);
      }
    }
#pragma unroll 4
    for (; j < n; ++j) {
      iteration<K, kUnits, false>(sec, pipe, xs[j * kLanes], t0 + j, T, out,
                                  M);
    }
  }
  // Drain: sections 1..K-1 filter the samples still in the pipe.
  for (int i = T; i < T + K - 1; ++i) {
    iteration<K, kUnits, true>(sec, pipe, 0.0f, i, T, out, M);
  }
}

// Lanes past M (in the last block only) filter lane M - 1's column again
// and store the same values to the same addresses, so no load or store
// needs a predicate and the loop body stays one block of straight code.
template <int K, bool kAllpassRows>
__global__ void __launch_bounds__(kLanes)
    biquad_cascade_kernel(const float* __restrict__ x, float* __restrict__ y,
                          const float* __restrict__ state_in,
                          float* __restrict__ state_out,
                          const float* __restrict__ coeffs, int T, int M) {
  __shared__ float stage[2][kChunk][kLanes];
  const int lane = threadIdx.x;
  const int m = min((int)blockIdx.x * kLanes + lane, M - 1);

  Section sec[K];
  int units = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sec[k].b0 = coeffs[5 * k + 0];
    sec[k].b1 = coeffs[5 * k + 1];
    sec[k].b2 = coeffs[5 * k + 2];
    sec[k].na1 = -coeffs[5 * k + 3];
    sec[k].na2 = -coeffs[5 * k + 4];
    sec[k].x1 = state_in[(size_t)(4 * k + 0) * M + m];
    sec[k].x2 = state_in[(size_t)(4 * k + 1) * M + m];
    sec[k].y1 = state_in[(size_t)(4 * k + 2) * M + m];
    sec[k].y2 = state_in[(size_t)(4 * k + 3) * M + m];
    units |= (sec[k].b0 == 1.0f ? 1 : 0) << (2 * k);
    units |= (sec[k].b2 == 1.0f ? 1 : 0) << (2 * k + 1);
  }

  if (kAllpassRows) {
    filter_lane<K, kAllpass>(sec, stage, x, y, T, M, m, lane);
  } else if (K == 3 && units == kUnit12) {
    filter_lane<K, kUnit12>(sec, stage, x, y, T, M, m, lane);
  } else if (K == 4 && units == kUnit12) {
    filter_lane<K, kUnit12>(sec, stage, x, y, T, M, m, lane);
  } else if (K == 4 && units == kUnit123) {
    filter_lane<K, kUnit123>(sec, stage, x, y, T, M, m, lane);
  } else if (K == 5 && units == kUnitNone) {
    filter_lane<K, kUnitNone>(sec, stage, x, y, T, M, m, lane);
  } else {
    filter_lane<K, kRuntime>(sec, stage, x, y, T, M, m, lane);
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    state_out[(size_t)(4 * k + 0) * M + m] = sec[k].x1;
    state_out[(size_t)(4 * k + 1) * M + m] = sec[k].x2;
    state_out[(size_t)(4 * k + 2) * M + m] = sec[k].y1;
    state_out[(size_t)(4 * k + 3) * M + m] = sec[k].y2;
  }
}

template <int K>
void launch(const float* x, float* y, const float* st_in, float* st_out,
            const float* coeffs, int T, int M, bool allpass,
            cudaStream_t stream) {
  const int blocks = (M + kLanes - 1) / kLanes;
  if (allpass) {
    biquad_cascade_kernel<K, true><<<blocks, kLanes, 0, stream>>>(
        x, y, st_in, st_out, coeffs, T, M);
  } else {
    biquad_cascade_kernel<K, false><<<blocks, kLanes, 0, stream>>>(
        x, y, st_in, st_out, coeffs, T, M);
  }
}

}  // namespace

// x, y: (T, M) float32, time-major. state_in, state_out: (4K, M) float32,
// rows [x1, x2, y1, y2] per section. coeffs: (K, 5) float32 rows
// [b0, b1, b2, a1, a2] on the device; allpass != 0 takes each row as the
// first-order all-pass [a, 1, 0, a, 0]. Returns cudaGetLastError().
extern "C" int biquad_cascade_f32(const void* x, void* y, const void* state_in,
                                  void* state_out, const void* coeffs, int K,
                                  int T, int M, int allpass, void* stream) {
  if (K < 1 || K > kMaxSections || T < 0 || M < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  const float* cf = static_cast<const float*>(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(xf, yf, si, so, cf, T, M, allpass != 0, s); break;
    case 2: launch<2>(xf, yf, si, so, cf, T, M, allpass != 0, s); break;
    case 3: launch<3>(xf, yf, si, so, cf, T, M, allpass != 0, s); break;
    case 4: launch<4>(xf, yf, si, so, cf, T, M, allpass != 0, s); break;
    case 5: launch<5>(xf, yf, si, so, cf, T, M, allpass != 0, s); break;
  }
  return (int)cudaGetLastError();
}
