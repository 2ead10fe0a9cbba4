// Batched cascaded direct-form-1 biquad filter for sm_90a.
//
// Replaces the TPU kernel webrtc_audio_processing_tpu/ops/pallas_biquad.py
// (_biquad_kernel). The recurrence is sequential in time, so the parallel
// axis is the lane m (stream x channel): one thread per lane walks the T
// samples and keeps every section's (x1, x2, y1, y2) and coefficients in
// registers. Data is time-major (T, M), so a warp's 32 loads of sample t
// read 32 neighbouring floats.
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
// The fused multiply-add is computed as the float rounding of the exact
// product plus c in double (the product of two floats is exact in double),
// the same expression the PyTorch twin evaluates, so kernel and twin agree
// bit for bit. Every operation uses an explicit round-to-nearest intrinsic,
// so nvcc contracts nothing on its own.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 4;

__device__ __forceinline__ float fused(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

template <int K>
__global__ void biquad_cascade_kernel(const float* __restrict__ x,
                                      float* __restrict__ y,
                                      const float* __restrict__ state_in,
                                      float* __restrict__ state_out,
                                      const float* __restrict__ coeffs,
                                      int T, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;

  float b0[K], b1[K], b2[K], na1[K], na2[K];
  float x1[K], x2[K], y1[K], y2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b0[k] = coeffs[5 * k + 0];
    b1[k] = coeffs[5 * k + 1];
    b2[k] = coeffs[5 * k + 2];
    na1[k] = -coeffs[5 * k + 3];
    na2[k] = -coeffs[5 * k + 4];
    x1[k] = state_in[(size_t)(4 * k + 0) * M + m];
    x2[k] = state_in[(size_t)(4 * k + 1) * M + m];
    y1[k] = state_in[(size_t)(4 * k + 2) * M + m];
    y2[k] = state_in[(size_t)(4 * k + 3) * M + m];
  }

#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    float sig = x[(size_t)t * M + m];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = b0[k] == 1.0f
                      ? fused(b1[k], x1[k], sig)
                      : fused(b0[k], sig, __fmul_rn(b1[k], x1[k]));
      acc = b2[k] == 1.0f ? __fadd_rn(x2[k], acc) : fused(b2[k], x2[k], acc);
      acc = fused(na1[k], y1[k], acc);
      acc = fused(na2[k], y2[k], acc);
      x2[k] = x1[k];
      x1[k] = sig;
      y2[k] = y1[k];
      y1[k] = acc;
      sig = acc;
    }
    y[(size_t)t * M + m] = sig;
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    state_out[(size_t)(4 * k + 0) * M + m] = x1[k];
    state_out[(size_t)(4 * k + 1) * M + m] = x2[k];
    state_out[(size_t)(4 * k + 2) * M + m] = y1[k];
    state_out[(size_t)(4 * k + 3) * M + m] = y2[k];
  }
}

template <int K>
void launch(const float* x, float* y, const float* st_in, float* st_out,
            const float* coeffs, int T, int M, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int blocks = (M + kThreads - 1) / kThreads;
  biquad_cascade_kernel<K><<<blocks, kThreads, 0, stream>>>(
      x, y, st_in, st_out, coeffs, T, M);
}

}  // namespace

// x, y: (T, M) float32, time-major. state_in, state_out: (4K, M) float32,
// rows [x1, x2, y1, y2] per section. coeffs: (K, 5) float32 rows
// [b0, b1, b2, a1, a2] on the device. Returns cudaGetLastError().
extern "C" int biquad_cascade_f32(const void* x, void* y, const void* state_in,
                                  void* state_out, const void* coeffs, int K,
                                  int T, int M, void* stream) {
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
    case 1: launch<1>(xf, yf, si, so, cf, T, M, s); break;
    case 2: launch<2>(xf, yf, si, so, cf, T, M, s); break;
    case 3: launch<3>(xf, yf, si, so, cf, T, M, s); break;
    case 4: launch<4>(xf, yf, si, so, cf, T, M, s); break;
  }
  return (int)cudaGetLastError();
}
