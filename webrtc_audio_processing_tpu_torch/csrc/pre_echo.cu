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
// (_kernel and its streams-on-lanes form _t_kernel). Design: one block per
// stream with one thread per chunk (128 at taps 512, acc_rate 4); each
// thread keeps its chunk of h0 and wex in registers, the segment sits in
// shared memory, and each step runs one block-wide inclusive scan of the
// chunk sums (warp shuffles, then one shared-memory pass over the warp
// totals). About 5 KB of reads per stream: the launch, not the card's
// bandwidth, bounds it at the main path's batch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunks = 1024;
constexpr int kMaxRate = 8;
constexpr int kMaxSub = 16;

__global__ void pre_echo_kernel(const float* __restrict__ seg_in,
                                const float* __restrict__ h0,
                                const float* __restrict__ alphas,
                                const float* __restrict__ y,
                                float* __restrict__ out, int sub, int taps,
                                int rate) {
  extern __shared__ float smem[];
  const int chunks = taps / rate;
  const int seg_len = sub - 1 + taps;
  float* seg = smem;
  float* warp_tot = smem + seg_len;
  const int b = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;

  const float* sb = seg_in + (size_t)b * seg_len;
  for (int j = c; j < seg_len; j += chunks) seg[j] = sb[j];
  float h[kMaxRate], wex[kMaxRate];
  const float* hb = h0 + (size_t)b * taps + c * rate;
#pragma unroll
  for (int k = 0; k < kMaxRate; ++k) {
    h[k] = k < rate ? hb[k] : 0.0f;
    wex[k] = 0.0f;
  }
  const float* ab = alphas + (size_t)b * sub;
  const float* yb = y + (size_t)b * sub;
  float acc = 0.0f;
  __syncthreads();

  for (int i = 0; i < sub; ++i) {
    const float* x = seg + (sub - 1 - i) + c * rate;
    float chunk = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxRate; ++k) {
      if (k < rate) chunk += (h[k] + wex[k]) * x[k];
    }
    // Inclusive scan over the chunks: within the warp, then warp totals.
    float part = chunk;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, part, off);
      if (lane >= off) part += v;
    }
    if (lane == 31) warp_tot[warp] = part;
    __syncthreads();
    for (int w = 0; w < warp; ++w) part += warp_tot[w];
    __syncthreads();  // warp_tot is rewritten by the next step
    const float d = yb[i] - part;
    acc += d * d;
    const float a = ab[i];
#pragma unroll
    for (int k = 0; k < kMaxRate; ++k) {
      if (k < rate) wex[k] += a * x[k];
    }
  }
  out[(size_t)b * chunks + c] = acc;
}

}  // namespace

// seg (B, sub - 1 + taps), h0 (B, taps), alphas (B, sub), y (B, sub) ->
// out (B, taps / acc_rate); float32, contiguous on the device. taps /
// acc_rate must be a multiple of 32 and at most 1024. Returns
// cudaGetLastError().
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
  const size_t smem = (size_t)(sub - 1 + taps + chunks / 32) * sizeof(float);
  pre_echo_kernel<<<B, chunks, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seg), static_cast<const float*>(h0),
      static_cast<const float*>(alphas), static_cast<const float*>(y),
      static_cast<float*>(out), sub, taps, acc_rate);
  return (int)cudaGetLastError();
}
