// AEC3 matched-filter pre-echo errors for sm_90a (the accumulated-error
// statistics of MatchedFilter::Update, matched_filter.cc:792-812), for the
// winning filter of each stream:
//
//   x_i[t]  = seg[sub - 1 - i + t]
//   p_i[t]  = (h0[t] + wex_i[t]) * x_i[t],  wex_i = sum_{j<i} a_j x_j
//   part_i  = inclusive prefix sums over chunks of acc_rate taps of p_i
//   out[c]  = sum_i (y_i - part_i[c])^2
//
// Replaces the TPU kernels webrtc_audio_processing_tpu/ops/pallas_pre_echo.py
// (_kernel and its streams-on-lanes form _t_kernel).
//
// What bounds it: the bytes, about 4.8 KB per stream (10 MB at B = 2048,
// 2.9 us at 3.35 TB/s); the 16 steps are independent but for the wex
// chain of one FMA per tap and step. Design: one warp per stream and no
// block barrier; four streams per block share nothing. Lane l owns the
// TPL = taps / 32 consecutive taps TPL * l + k, i.e. TPL / acc_rate whole
// chunks, and holds its h0, wex and the TPL + sub - 1 segment values its
// taps touch in registers, so each window is a compile-time register
// index. Each step: the lane's chunk sums (an FMA chain over each chunk)
// and their running prefix in the lane, one 5-level __shfl_up_sync scan of
// the lane totals and one shuffle for the exclusive prefix, then
// d = y_i - (prefix + part) and acc += d^2 per chunk, and wex += a_i x_i.
// The segment and h0 are read coalesced, all at once, and come in through
// padded shared-memory slices per warp (one pad word per 32: a lane's
// consecutive slice falls on distinct banks); the lane's errors go out as
// one float4. Specialised for
// taps 512, acc_rate 4, sub 16; the rest of the domain runs a general form
// with the same summation order and its state in a padded shared slice.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunks = 1024;
constexpr int kMaxRate = 8;
constexpr int kMaxSub = 16;
constexpr int kStreamsPerBlock = 4;

// One pad word after every 32.
__host__ __device__ constexpr int padded(int j) { return j + (j >> 5); }

// Inclusive prefix over the lanes, then the exclusive one of this lane.
__device__ __forceinline__ float lanes_before(float run, int lane) {
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0f : excl;
}

template <int RATE, int CPL, int SUB>
__global__ void __launch_bounds__(32 * kStreamsPerBlock)
pre_echo_kernel(const float* __restrict__ seg_in,
                const float* __restrict__ h0,
                const float* __restrict__ alphas,
                const float* __restrict__ y, float* __restrict__ out,
                int B) {
  constexpr int TPL = RATE * CPL;
  constexpr int taps = 32 * TPL;
  constexpr int seg_len = SUB - 1 + taps;
  constexpr int kSegWords = padded(seg_len - 1) + 1;
  constexpr int kSegIters = (seg_len + 31) / 32;
  static_assert(CPL == 4, "the errors go out as one float4 per lane");
  __shared__ float slices[kStreamsPerBlock][kSegWords + padded(taps - 1) + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kStreamsPerBlock + warp;
  if (b >= B) return;
  float* sh_seg = slices[warp];
  float* sh_h = sh_seg + kSegWords;

  // All global reads at once, coalesced, then into the warp's slices.
  const float* sb = seg_in + (size_t)b * seg_len;
  const float* hb = h0 + (size_t)b * taps;
  float v[kSegIters], w[TPL];
#pragma unroll
  for (int q = 0; q < kSegIters; ++q) {
    const int j = lane + 32 * q;
    v[q] = j < seg_len ? sb[j] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < TPL; ++q) w[q] = hb[lane + 32 * q];
#pragma unroll
  for (int q = 0; q < kSegIters; ++q) {
    const int j = lane + 32 * q;
    if (j < seg_len) sh_seg[padded(j)] = v[q];
  }
#pragma unroll
  for (int q = 0; q < TPL; ++q) sh_h[padded(lane + 32 * q)] = w[q];
  __syncwarp();
  float xs[TPL + SUB - 1];  // x_i[TPL * lane + t] = xs[SUB - 1 - i + t]
#pragma unroll
  for (int j = 0; j < TPL + SUB - 1; ++j) {
    xs[j] = sh_seg[padded(TPL * lane + j)];
  }
  float h[TPL], wex[TPL], acc[CPL];
#pragma unroll
  for (int t = 0; t < TPL; ++t) {
    h[t] = sh_h[padded(TPL * lane + t)];
    wex[t] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < CPL; ++m) acc[m] = 0.0f;
  const float* ab = alphas + (size_t)b * SUB;
  const float* yb = y + (size_t)b * SUB;

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    float part[CPL];
    float run = 0.0f;
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      float c = 0.0f;
#pragma unroll
      for (int k = 0; k < RATE; ++k) {
        const int t = m * RATE + k;
        c = fmaf(h[t] + wex[t], xs[SUB - 1 - i + t], c);
      }
      run += c;
      part[m] = run;
    }
    const float before = lanes_before(run, lane);
    const float yi = yb[i];
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const float d = yi - (before + part[m]);
      acc[m] = fmaf(d, d, acc[m]);
    }
    const float a = ab[i];
#pragma unroll
    for (int t = 0; t < TPL; ++t) {
      wex[t] = fmaf(a, xs[SUB - 1 - i + t], wex[t]);
    }
  }
  reinterpret_cast<float4*>(out + (size_t)b * (32 * CPL))[lane] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The rest of the domain: the same lanes, chunks and summation order, with
// h0, wex, the segment and the per-chunk values in a padded shared slice
// (one warp per block, dynamic shared memory).
__global__ void __launch_bounds__(32)
pre_echo_general_kernel(const float* __restrict__ seg_in,
                        const float* __restrict__ h0,
                        const float* __restrict__ alphas,
                        const float* __restrict__ y,
                        float* __restrict__ out, int sub, int taps,
                        int rate) {
  extern __shared__ float smem[];
  const int chunks = taps / rate;
  const int cpl = chunks / 32;
  const int tpl = taps / 32;
  const int seg_len = sub - 1 + taps;
  float* seg = smem;
  float* hs = seg + padded(seg_len - 1) + 1;
  float* wex = hs + padded(taps - 1) + 1;
  float* part = wex + padded(taps - 1) + 1;  // [cpl][32]
  float* acc = part + chunks;                // [cpl][32]
  const int b = blockIdx.x;
  const int lane = threadIdx.x;

  const float* sb = seg_in + (size_t)b * seg_len;
  for (int j = lane; j < seg_len; j += 32) seg[padded(j)] = sb[j];
  const float* hb = h0 + (size_t)b * taps;
  for (int j = lane; j < taps; j += 32) {
    hs[padded(j)] = hb[j];
    wex[padded(j)] = 0.0f;
  }
  for (int m = 0; m < cpl; ++m) acc[m * 32 + lane] = 0.0f;
  __syncwarp();
  const float* ab = alphas + (size_t)b * sub;
  const float* yb = y + (size_t)b * sub;
  const int t0 = tpl * lane;

  for (int i = 0; i < sub; ++i) {
    const int xo = sub - 1 - i;
    float run = 0.0f;
    for (int m = 0; m < cpl; ++m) {
      float c = 0.0f;
      for (int k = 0; k < rate; ++k) {
        const int t = t0 + m * rate + k;
        c = fmaf(hs[padded(t)] + wex[padded(t)], seg[padded(xo + t)], c);
      }
      run += c;
      part[m * 32 + lane] = run;
    }
    const float before = lanes_before(run, lane);
    const float yi = yb[i];
    for (int m = 0; m < cpl; ++m) {
      const float d = yi - (before + part[m * 32 + lane]);
      acc[m * 32 + lane] = fmaf(d, d, acc[m * 32 + lane]);
    }
    const float a = ab[i];
    for (int t = t0; t < t0 + tpl; ++t) {
      wex[padded(t)] = fmaf(a, seg[padded(xo + t)], wex[padded(t)]);
    }
  }
  float* ob = out + (size_t)b * chunks + cpl * lane;
  for (int m = 0; m < cpl; ++m) ob[m] = acc[m * 32 + lane];
}

}  // namespace

// seg (B, sub - 1 + taps), h0 (B, taps), alphas (B, sub), y (B, sub) ->
// out (B, taps / acc_rate); float32, contiguous on the device. taps /
// acc_rate must be a multiple of 32 and at most 1024, acc_rate at most 8
// and sub at most 16. Returns cudaGetLastError().
extern "C" int pre_echo_inst_f32(const void* seg, const void* h0,
                                 const void* alphas, const void* y, void* out,
                                 int B, int sub, int taps, int acc_rate,
                                 void* stream) {
  if (B < 0 || sub < 1 || sub > kMaxSub || acc_rate < 1 ||
      acc_rate > kMaxRate || taps % acc_rate != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = taps / acc_rate;
  if (chunks % 32 != 0 || chunks > kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* seg_f = static_cast<const float*>(seg);
  const auto* h0_f = static_cast<const float*>(h0);
  const auto* a_f = static_cast<const float*>(alphas);
  const auto* y_f = static_cast<const float*>(y);
  auto* out_f = static_cast<float*>(out);
  if (taps == 512 && acc_rate == 4 && sub == 16) {
    const int blocks = (B + kStreamsPerBlock - 1) / kStreamsPerBlock;
    pre_echo_kernel<4, 4, 16><<<blocks, 32 * kStreamsPerBlock, 0, s>>>(
        seg_f, h0_f, a_f, y_f, out_f, B);
    return (int)cudaGetLastError();
  }
  const size_t words = padded(sub - 1 + taps - 1) + 1 +
                       2 * ((size_t)padded(taps - 1) + 1) + 2 * chunks;
  const size_t smem = words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pre_echo_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  pre_echo_general_kernel<<<B, 32, smem, s>>>(seg_f, h0_f, a_f, y_f, out_f,
                                               sub, taps, acc_rate);
  return (int)cudaGetLastError();
}
