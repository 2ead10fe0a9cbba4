// AGC1's overload limiter for sm_90a (WebRtcAgc_ComputeDigitalGains,
// digital_agc.cc:439-483), the loop of the JAX package's
// models/agc1/digital.py:397-427:
//
//   for each subframe k = 1..10 of a row:
//     while env[k-1] * gain[k]^2 exceeds full scale (the reference's
//           fixed-point test): gain[k] -= 0.1 dB (x 253 / 256);
//   then, backwards, gain[k] = min(gain[k], gain[k+1]) for k = 9..1
//   (the gain reductions take effect 1 ms earlier).
//
// A port-only kernel: the JAX package runs the loop as lax.while_loop
// under vmap, outside Pallas. Plain PyTorch has no form of it that a CUDA
// graph can capture (a `while mask.any()` reads the device each pass), so
// the loop runs here, one thread per (row, subframe), and stops where the
// reference stops.
//
// Integer semantics are the JAX package's, which are the C code's on
// int32: products wrap (computed in uint32), >> is arithmetic, and the
// (g // 256) * 253 step floors. 16 lanes serve a row, 2 rows a warp; lanes
// 10..15 idle. The backward minimum is a suffix minimum over the row's 10
// lanes by warp shuffles. The thread of subframe k also copies gain[0].

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLanesPerRow = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// WebRtcSpl_NormW32 as the JAX package computes it (ops/spl.py).
__device__ __forceinline__ int norm_w32(int x) {
  if (x == 0) return 0;
  const unsigned ax = static_cast<unsigned>(x < 0 ? ~x : x);
  const int clz = ax == 0 ? 31 : __clz(ax);  // 31 for 0: spl.norm_u32
  return clz - 1;
}

// AGC_MUL32(A, B) = (B >> 13) * A + ((0x1FFF & B) * A >> 13).
__device__ __forceinline__ int agc_mul32(int a, int b) {
  return wadd(wmul(b >> 13, a), wmul(b & 0x1FFF, a) >> 13);
}

__device__ __forceinline__ bool overloaded(int g, int e) {
  const int zeros = g > 47452159 ? 16 - norm_w32(g) : 10;
  int gain32 = wadd(g >> zeros, 1);
  gain32 = wmul(gain32, gain32);
  const int lhs = agc_mul32(wadd(e >> 12, 1), gain32);
  const int shift = 2 * (1 - zeros + 10);
  const int rhs = shift >= 0 ? wmul(32767, 1 << shift) : 32767 >> (-shift);
  return lhs > rhs;
}

__global__ void __launch_bounds__(kThreads)
    agc1_limiter(const int* __restrict__ gains_in,
                 const int* __restrict__ env, int* __restrict__ gains_out,
                 int N) {
  const int lane = threadIdx.x & (kLanesPerRow - 1);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const bool live = row < N && lane < 10;
  int g = INT_MAX;
  if (live) {
    g = gains_in[(size_t)row * 11 + 1 + lane];
    const int e = env[(size_t)row * 10 + lane];
    while (overloaded(g, e)) {
      g = g > 8388607 ? wmul(floordiv(g, 256), 253)
                      : floordiv(wmul(g, 253), 256);
    }
  }
  // Suffix minimum over the row's lanes 0..9 (subframes 1..10).
#pragma unroll
  for (int d = 1; d < kLanesPerRow; d <<= 1) {
    const int other = __shfl_down_sync(0xffffffffu, g, d, kLanesPerRow);
    if (lane + d < kLanesPerRow) g = min(g, other);
  }
  if (live) {
    gains_out[(size_t)row * 11 + 1 + lane] = g;
    if (lane == 0) gains_out[(size_t)row * 11] = gains_in[(size_t)row * 11];
  }
}

}  // namespace

// gains_in, gains_out: (N, 11) int32; env: (N, 10) int32, contiguous on
// the device (gains_out may not alias gains_in). Returns cudaGetLastError().
extern "C" int agc1_limiter_i32(const void* gains_in, const void* env,
                                void* gains_out, int N, void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  agc1_limiter<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gains_in), static_cast<const int*>(env),
      static_cast<int*>(gains_out), N);
  return (int)cudaGetLastError();
}
