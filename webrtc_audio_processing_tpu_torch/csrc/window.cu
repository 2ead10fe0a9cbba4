// Per-stream contiguous window read for sm_90a:
//     out[b, :] = buf[b, start_b : start_b + W]
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_window.py
// (_window_kernel), which the RNN-VAD uses for its pitch-lagged frame read.
// Starts follow lax.dynamic_slice: a negative start counts from the end of
// the row, then every start is clamped to [0, L - W], so a read never
// leaves its row. They are read as the caller made them, int32 or int64.
//
// It only moves data, B * W * 4 bytes each way (3.9 MB at B = 2048,
// W = 480: 0.0023 ms at 3.35 TB/s). One warp copies one row, 8 rows per
// 256-thread block. Each output row starts 16-byte aligned, so every lane
// stores float4s. The source window starts at any float s: the warp reads
// the aligned float4s that cover [s - s % 4, s + W), and each lane builds
// its output float4 from its own and its right neighbour's
// (__shfl_down_sync), shifted by s % 4 in registers. Rows whose length,
// width or base are not multiples of 4 floats take a plain per-float copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename Index>
__device__ __forceinline__ int clamped_start(const Index* start, int b, int L,
                                             int W) {
  long long s = static_cast<long long>(start[b]);
  if (s < 0) s += L;
  return static_cast<int>(s < 0 ? 0 : (s > L - W ? L - W : s));
}

// L % 4 == 0, W % 4 == 0, buf and out 16-byte aligned.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    take_windows_vec4(const float* __restrict__ buf,
                      const Index* __restrict__ start,
                      float* __restrict__ out, int B, int L, int W) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: b is the warp's row
  const int s = clamped_start(start, b, L, W);
  const int r = s & 3;
  const float4* src =
      reinterpret_cast<const float4*>(buf + (size_t)b * L + (s - r));
  float4* dst = reinterpret_cast<float4*>(out + (size_t)b * W);
  const int n_out = W >> 2;
  const int n_src = (r + W + 3) >> 2;  // ends at or before the row's end
  for (int j0 = 0; j0 < n_out; j0 += 32) {
    const int j = j0 + lane;
    const float4 v =
        j < n_src ? __ldg(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 n;
    n.x = __shfl_down_sync(0xffffffffu, v.x, 1);
    n.y = __shfl_down_sync(0xffffffffu, v.y, 1);
    n.z = __shfl_down_sync(0xffffffffu, v.z, 1);
    if (lane == 31 && r != 0 && j + 1 < n_src) {
      const float4 t = __ldg(src + j + 1);
      n.x = t.x;
      n.y = t.y;
      n.z = t.z;
    }
    if (j < n_out) {
      float4 o;
      switch (r) {
        case 0: o = v; break;
        case 1: o = make_float4(v.y, v.z, v.w, n.x); break;
        case 2: o = make_float4(v.z, v.w, n.x, n.y); break;
        default: o = make_float4(v.w, n.x, n.y, n.z); break;
      }
      dst[j] = o;
    }
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    take_windows_scalar(const float* __restrict__ buf,
                        const Index* __restrict__ start,
                        float* __restrict__ out, int B, int L, int W) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* src = buf + (size_t)b * L + clamped_start(start, b, L, W);
  float* dst = out + (size_t)b * W;
  for (int i = lane; i < W; i += 32) dst[i] = __ldg(src + i);
}

template <typename Index>
void launch(const float* buf, const void* start, float* out, int B, int L,
            int W, cudaStream_t stream) {
  const Index* st = static_cast<const Index*>(start);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const bool vec = L % 4 == 0 && W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    take_windows_vec4<Index><<<blocks, kThreads, 0, stream>>>(buf, st, out, B,
                                                             L, W);
  } else {
    take_windows_scalar<Index><<<blocks, kThreads, 0, stream>>>(buf, st, out,
                                                               B, L, W);
  }
}

}  // namespace

// buf: (B, L) float32; start: (B,) int32 (start_bytes 4) or int64
// (start_bytes 8); out: (B, W) float32, all contiguous on the device.
// Returns cudaGetLastError().
extern "C" int take_windows_f32(const void* buf, const void* start,
                                int start_bytes, void* out, int B, int L,
                                int W, void* stream) {
  if (B < 0 || W < 0 || W > L || (start_bytes != 4 && start_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || W == 0) return (int)cudaSuccess;
  const float* b = static_cast<const float*>(buf);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (start_bytes == 8) {
    launch<long long>(b, start, o, B, L, W, s);
  } else {
    launch<int>(b, start, o, B, L, W, s);
  }
  return (int)cudaGetLastError();
}
