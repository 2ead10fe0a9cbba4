// Per-stream contiguous row-span read from a mirrored ring, for sm_90a:
//     out[b, :, :] = ring[b, start_b : start_b + W, :]
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_span.py
// (_span_kernel), through which AEC3 reads every render-ring window. The
// ring keeps rows [L, L + pad) as a copy of rows [0, pad), so a span never
// wraps and the W rows of a stream are one contiguous run of W * F floats.
// It only moves data: one block per stream copies that run, with 16-byte
// vector loads and stores when F is a multiple of 4 (every row then starts
// on a 16-byte boundary). Starts follow lax.dynamic_slice: a negative start
// counts from the end, then every start is clamped to [0, LP - W].

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_start(int s, int LP, int W) {
  if (s < 0) s += LP;
  return s < 0 ? 0 : (s > LP - W ? LP - W : s);
}

__global__ void span_gather_vec4(const float4* __restrict__ ring,
                                 const int* __restrict__ start,
                                 float4* __restrict__ out, int LP, int F4,
                                 int W) {
  const int b = blockIdx.x;
  const int s = clamp_start(start[b], LP, W);
  const float4* src = ring + ((size_t)b * LP + s) * F4;
  float4* dst = out + (size_t)b * W * F4;
  const int n = W * F4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void span_gather_scalar(const float* __restrict__ ring,
                                   const int* __restrict__ start,
                                   float* __restrict__ out, int LP, int F,
                                   int W) {
  const int b = blockIdx.x;
  const int s = clamp_start(start[b], LP, W);
  const float* src = ring + ((size_t)b * LP + s) * F;
  float* dst = out + (size_t)b * W * F;
  const int n = W * F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// ring: (B, LP, F) float32; start: (B,) int32; out: (B, W, F) float32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int span_gather_f32(const void* ring, const void* start, void* out,
                               int B, int LP, int F, int W, void* stream) {
  if (B < 0 || F < 0 || W < 0 || W > LP) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0 || F == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0) {
    span_gather_vec4<<<B, kThreads, 0, st>>>(
        static_cast<const float4*>(ring), static_cast<const int*>(start),
        static_cast<float4*>(out), LP, F / 4, W);
  } else {
    span_gather_scalar<<<B, kThreads, 0, st>>>(
        static_cast<const float*>(ring), static_cast<const int*>(start),
        static_cast<float*>(out), LP, F, W);
  }
  return (int)cudaGetLastError();
}
