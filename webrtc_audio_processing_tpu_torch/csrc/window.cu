// Per-stream contiguous window read for sm_90a:
//     out[b, :] = buf[b, start_b : start_b + W]
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_window.py
// (_window_kernel), which the RNN-VAD uses for its pitch-lagged frame read.
// It only moves data: one block per stream copies the W floats with
// consecutive threads on consecutive addresses. Starts follow
// lax.dynamic_slice: a negative start counts from the end of the row, then
// every start is clamped to [0, L - W], so a read never leaves its row.

#include <cuda_runtime.h>

namespace {

__global__ void take_windows_kernel(const float* __restrict__ buf,
                                    const int* __restrict__ start,
                                    float* __restrict__ out, int L, int W) {
  const int b = blockIdx.x;
  int s = start[b];
  if (s < 0) s += L;
  s = s < 0 ? 0 : (s > L - W ? L - W : s);
  const float* src = buf + (size_t)b * L + s;
  float* dst = out + (size_t)b * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    dst[i] = src[i];
  }
}

}  // namespace

// buf: (B, L) float32; start: (B,) int32; out: (B, W) float32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int take_windows_f32(const void* buf, const void* start, void* out,
                                int B, int L, int W, void* stream) {
  if (B < 0 || W < 0 || W > L) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return (int)cudaSuccess;
  constexpr int kThreads = 128;
  take_windows_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const int*>(start),
      static_cast<float*>(out), L, W);
  return (int)cudaGetLastError();
}
