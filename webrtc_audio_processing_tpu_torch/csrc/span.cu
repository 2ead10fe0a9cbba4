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
//
// A bfloat16 ring (AEC3's rings in their bf16 storage) has its own entry,
// span_gather_bf16: it reads the bf16 rows and writes them as float32, the
// JAX package's read (render_buffer._span: the gather in the ring's dtype,
// then astype(float32)). bf16 -> float32 is exact (the 16 bits become the
// high half of the float), so fusing the upcast changes no bit and halves
// the bytes read. Each thread moves 8 values a step with a 16-byte load
// and two 16-byte stores when F is a multiple of 8; a scalar form takes
// the rest.

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

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);  // element 2i: the low half, little end
}

__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

// F8 = F / 8: a row is F8 16-byte words of eight bf16 values.
__global__ void span_gather_bf16_vec8(const uint4* __restrict__ ring,
                                      const int* __restrict__ start,
                                      float4* __restrict__ out, int LP,
                                      int F8, int W) {
  const int b = blockIdx.x;
  const int s = clamp_start(start[b], LP, W);
  const uint4* src = ring + ((size_t)b * LP + s) * F8;
  float4* dst = out + (size_t)b * W * F8 * 2;
  const int n = W * F8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint4 v = src[i];
    dst[2 * i] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                             bf16_hi(v.y));
    dst[2 * i + 1] = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w),
                                 bf16_hi(v.w));
  }
}

__global__ void span_gather_bf16_scalar(const unsigned short* __restrict__ ring,
                                        const int* __restrict__ start,
                                        float* __restrict__ out, int LP,
                                        int F, int W) {
  const int b = blockIdx.x;
  const int s = clamp_start(start[b], LP, W);
  const unsigned short* src = ring + ((size_t)b * LP + s) * F;
  float* dst = out + (size_t)b * W * F;
  const int n = W * F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = __uint_as_float((unsigned int)src[i] << 16);
  }
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

// ring: (B, LP, F) bfloat16; start: (B,) int32; out: (B, W, F) float32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int span_gather_bf16(const void* ring, const void* start,
                                void* out, int B, int LP, int F, int W,
                                void* stream) {
  if (B < 0 || F < 0 || W < 0 || W > LP) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0 || F == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F % 8 == 0) {
    span_gather_bf16_vec8<<<B, kThreads, 0, st>>>(
        static_cast<const uint4*>(ring), static_cast<const int*>(start),
        static_cast<float4*>(out), LP, F / 8, W);
  } else {
    span_gather_bf16_scalar<<<B, kThreads, 0, st>>>(
        static_cast<const unsigned short*>(ring),
        static_cast<const int*>(start), static_cast<float*>(out), LP, F, W);
  }
  return (int)cudaGetLastError();
}
