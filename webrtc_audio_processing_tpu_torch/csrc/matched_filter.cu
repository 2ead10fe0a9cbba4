// AEC3 matched-filter NLMS bank for sm_90a (MatchedFilter::Update,
// matched_filter.cc:693-812): for each stream b and filter n, a 16-step
// NLMS of the filter h (taps long) against sliding windows of the
// low-rate render ring, one step per decimated capture sample:
//
//   seg      = ring[(lr_read + n * shift) mod DS + j], j < sub - 1 + taps
//   x_i[t]   = seg[sub - 1 - i + t]
//   s_i      = h . x_i,  e_i = y_i - s_i,  x2_i = x_i . x_i
//   a_i      = gate_i ? smoothing * e_i / max(x2_i, 1e-30) : 0
//   h       += a_i * x_i
//
// with gate_i = x2_i > threshold and |y_i| < 32000. Outputs h, the steps
// a_i, the error sum of e_i^2, whether any step was gated open, and the
// segments (the pre-echo kernel reads the winner's segment).
//
// Replaces the TPU kernels webrtc_audio_processing_tpu/ops/pallas_mf.py
// (_mf_kernel and its streams-on-lanes form _mf_t_kernel), which differ
// only in TPU layout. Design: one block of 128 threads per (stream,
// filter); each thread keeps taps/128 filter taps in registers, the
// segment sits in shared memory, and each step reduces the two dot
// products (h . x_i, x_i . x_i) together with warp shuffles and one
// shared-memory pass. The filters are read and written once; the step
// chain is serial, 16 dependent block reductions per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTapsPerThread = 4;
constexpr int kMaxSub = 16;
constexpr int kMaxSeg = kMaxSub - 1 + kThreads * kMaxTapsPerThread;

__global__ void nlms_kernel(const float* __restrict__ lowrate,
                            const int* __restrict__ lr_read,
                            const float* __restrict__ h0,
                            const float* __restrict__ y,
                            const float* __restrict__ smoothing,
                            float* __restrict__ h_out,
                            float* __restrict__ alphas,
                            float* __restrict__ err_out,
                            uint8_t* __restrict__ updated,
                            float* __restrict__ segs, int N, int shift,
                            int ds_size, float threshold, int sub,
                            int taps) {
  __shared__ float seg[kMaxSeg];
  __shared__ float red[2][kWarps];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tpt = taps / kThreads;
  const int seg_len = sub - 1 + taps;
  const size_t bn = (size_t)b * N + n;

  int start = (lr_read[b] + n * shift) % ds_size;
  if (start < 0) start += ds_size;
  const float* ring = lowrate + (size_t)b * ds_size;
  float* seg_out = segs + bn * seg_len;
  for (int j = tid; j < seg_len; j += kThreads) {
    int k = start + j;
    if (k >= ds_size) k -= ds_size;
    const float v = ring[k];
    seg[j] = v;
    seg_out[j] = v;
  }

  float h[kMaxTapsPerThread];
  const float* h_in = h0 + bn * taps;
#pragma unroll
  for (int k = 0; k < kMaxTapsPerThread; ++k) {
    h[k] = k < tpt ? h_in[tid + k * kThreads] : 0.0f;
  }
  const float mu = smoothing[b];
  const float* yb = y + (size_t)b * sub;
  float err = 0.0f;
  bool any_gate = false;
  __syncthreads();

  for (int i = 0; i < sub; ++i) {
    const float* x = seg + (sub - 1 - i);
    float hx = 0.0f, xx = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxTapsPerThread; ++k) {
      if (k < tpt) {
        const float v = x[tid + k * kThreads];
        hx += h[k] * v;
        xx += v * v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hx += __shfl_xor_sync(0xffffffffu, hx, off);
      xx += __shfl_xor_sync(0xffffffffu, xx, off);
    }
    if (lane == 0) {
      red[0][warp] = hx;
      red[1][warp] = xx;
    }
    __syncthreads();
    float s = 0.0f, x2 = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += red[0][w];
      x2 += red[1][w];
    }
    __syncthreads();  // red is rewritten by the next step
    const float yi = yb[i];
    const bool sat = yi >= 32000.0f || yi <= -32000.0f;
    const bool gate = x2 > threshold && !sat;
    const float e = yi - s;
    const float a = gate ? mu * e / fmaxf(x2, 1e-30f) : 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxTapsPerThread; ++k) {
      if (k < tpt) h[k] += a * x[tid + k * kThreads];
    }
    err += e * e;
    any_gate = any_gate || gate;
    if (tid == 0) alphas[bn * sub + i] = a;
  }

  float* h_o = h_out + bn * taps;
#pragma unroll
  for (int k = 0; k < kMaxTapsPerThread; ++k) {
    if (k < tpt) h_o[tid + k * kThreads] = h[k];
  }
  if (tid == 0) {
    err_out[bn] = err;
    updated[bn] = any_gate ? 1 : 0;
  }
}

}  // namespace

// lowrate (B, DS), lr_read (B,) int32, h0 (B, N, taps), y (B, sub),
// smoothing (B,) -> h (B, N, taps), alphas (B, N, sub), err (B, N),
// updated (B, N) uint8, segs (B, N, sub - 1 + taps); float32 unless noted,
// all contiguous on the device. taps must be 128, 256, 384 or 512 and sub at
// most 16. Returns cudaGetLastError().
extern "C" int matched_filter_nlms_f32(
    const void* lowrate, const void* lr_read, const void* h0, const void* y,
    const void* smoothing, void* h, void* alphas, void* err, void* updated,
    void* segs, int B, int N, int shift, int ds_size, float threshold,
    int sub, int taps, void* stream) {
  if (B < 0 || N < 0 || sub < 1 || sub > kMaxSub || taps % kThreads != 0 ||
      taps < kThreads || taps > kThreads * kMaxTapsPerThread ||
      ds_size < sub - 1 + taps) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid(N, B);
  nlms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lowrate), static_cast<const int*>(lr_read),
      static_cast<const float*>(h0), static_cast<const float*>(y),
      static_cast<const float*>(smoothing), static_cast<float*>(h),
      static_cast<float*>(alphas), static_cast<float*>(err),
      static_cast<uint8_t*>(updated), static_cast<float*>(segs), N, shift,
      ds_size, threshold, sub, taps);
  return (int)cudaGetLastError();
}
