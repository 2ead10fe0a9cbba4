// K3, the matched-filter NLMS bank (csrc/matched_filter.cu), in a form
// that stages each stream's ring span once per block: the block's warps
// (one per filter) load the (warps - 1) * shift + seg_len ring entries
// their segments touch (2063 floats at shift 384, taps 512, sub 16, where
// five separate segments would be 2635) into padded shared memory,
// coalesced and with the ring's wrap, meet at one __syncthreads, and each
// cuts its window from there. The step loop is the kept kernel's, so the
// outputs are bit for bit the same. Not built into the package: it was
// measured slower than the kept per-warp load (PERF.md, section 6), and
// tools/torch_k3_variants.py builds it beside the kept source to repeat
// that comparison. Same C entry point and domain as the kept source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSub = 16;
constexpr int kMaxWarps = 8;  // filters (warps) per block
constexpr int kStageBatch = 16;  // ring loads in flight per thread
// The most ring words a block stages; a block holds fewer filters when
// their span would be longer (shift is the caller's).
constexpr int kMaxSpan = 7168;

// One pad word after every 32.
__host__ __device__ constexpr int padded(int j) { return j + (j >> 5); }

// TPL taps per lane; SUB the capture samples per call, or 0 for a runtime
// `sub` (the window registers are then indexed as if sub were 16, offset
// by 16 - sub, so every index stays a compile-time constant).
template <int TPL, int SUB>
__global__ void __launch_bounds__(32 * kMaxWarps)
nlms_kernel(const float* __restrict__ lowrate,
            const int* __restrict__ lr_read, const float* __restrict__ h0,
            const float* __restrict__ y, const float* __restrict__ smoothing,
            float* __restrict__ h_out, float* __restrict__ alphas,
            float* __restrict__ err_out, uint8_t* __restrict__ updated,
            float* __restrict__ segs, int N, int groups, int shift,
            int ds_size, float threshold, int sub_rt) {
  extern __shared__ float smem[];
  constexpr int taps = 32 * TPL;
  constexpr int kX = TPL + kMaxSub - 1;
  constexpr int kHWords = padded(taps - 1) + 1;
  const int sub = SUB > 0 ? SUB : sub_rt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x / groups;
  const int n0 = (blockIdx.x - b * groups) * warps;
  const int nw = N - n0 < warps ? N - n0 : warps;
  const int n = n0 + warp;
  const bool active = warp < nw;
  const size_t bn = (size_t)b * N + n;
  const int seg_len = sub - 1 + taps;
  const int span = (nw - 1) * shift + seg_len;
  float* sh_h = smem + warp * kHWords;
  float* sh_span = smem + warps * kHWords;

  // All global reads at once: the warp's filter into registers, and the
  // block's span of the ring (its filters' segments, with the ring's wrap)
  // staged once into shared memory, coalesced.
  float w[TPL];
  if (active) {
    const float* h_in = h0 + bn * taps;
#pragma unroll
    for (int q = 0; q < TPL; ++q) w[q] = h_in[lane + 32 * q];
  }
  int start = (lr_read[b] + n0 * shift) % ds_size;
  if (start < 0) start += ds_size;
  const float* ring = lowrate + (size_t)b * ds_size;
  for (int base = 0; base < span; base += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int j = base + threadIdx.x + q * blockDim.x;
      v[q] = j < span ? ring[(start + j) % ds_size] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int j = base + threadIdx.x + q * blockDim.x;
      if (j < span) sh_span[padded(j)] = v[q];
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < TPL; ++q) sh_h[padded(lane + 32 * q)] = w[q];
  }
  __syncthreads();
  if (!active) return;

  // The warp's segment starts at warp * shift in the span.
  const int seg0 = warp * shift;
  float* seg_o = segs + bn * seg_len;
  for (int j = lane; j < seg_len; j += 32) {
    seg_o[j] = sh_span[padded(seg0 + j)];
  }
  // xs[j] = seg[TPL * lane + j - (16 - sub)]; x_i[TPL * lane + k] is then
  // xs[15 - i + k].
  float xs[kX], h[TPL];
  const int off = TPL * lane - (kMaxSub - sub);
#pragma unroll
  for (int j = 0; j < kX; ++j) {
    const int s = off + j;
    xs[j] = (SUB == kMaxSub || s >= 0) ? sh_span[padded(seg0 + s)] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < TPL; ++k) h[k] = sh_h[padded(TPL * lane + k)];

  const float mu = smoothing[b];
  const float* yb = y + (size_t)b * sub;
  const bool keep_s = lane < 16;
  float err = 0.0f, my_a = 0.0f;
  bool any_gate = false;
#pragma unroll
  for (int i = 0; i < kMaxSub; ++i) {
    if (SUB == 0 && i >= sub) break;
    float hx = 0.0f, xx = 0.0f;
#pragma unroll
    for (int k = 0; k < TPL; ++k) {
      const float x = xs[kMaxSub - 1 - i + k];
      hx = fmaf(h[k], x, hx);
      xx = fmaf(x, x, xx);
    }
    // Lanes 0-15 keep h . x, lanes 16-31 x . x: one exchange across the
    // halves, four levels within them, one exchange back. Additions
    // commute, so every lane ends with the same two sums.
    float mine = keep_s ? hx : xx;
    mine += __shfl_xor_sync(kFull, keep_s ? xx : hx, 16);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
    const float theirs = __shfl_xor_sync(kFull, mine, 16);
    const float s = keep_s ? mine : theirs;
    const float x2 = keep_s ? theirs : mine;
    const float yi = yb[i];
    const bool sat = yi >= 32000.0f || yi <= -32000.0f;
    const bool gate = x2 > threshold && !sat;
    const float e = yi - s;
    const float a = gate ? mu * e / fmaxf(x2, 1e-30f) : 0.0f;
#pragma unroll
    for (int k = 0; k < TPL; ++k) {
      h[k] = fmaf(a, xs[kMaxSub - 1 - i + k], h[k]);
    }
    err = fmaf(e, e, err);
    any_gate = any_gate || gate;
    if (lane == i) my_a = a;
  }

  __syncwarp();
#pragma unroll
  for (int k = 0; k < TPL; ++k) sh_h[padded(TPL * lane + k)] = h[k];
  __syncwarp();
  float* h_o = h_out + bn * taps;
#pragma unroll
  for (int q = 0; q < TPL; ++q) {
    h_o[lane + 32 * q] = sh_h[padded(lane + 32 * q)];
  }
  if (lane < sub) alphas[bn * sub + lane] = my_a;
  if (lane == 0) {
    err_out[bn] = err;
    updated[bn] = any_gate ? 1 : 0;
  }
}

template <int TPL, int SUB>
int launch(const void* lowrate, const void* lr_read, const void* h0,
           const void* y, const void* smoothing, void* h, void* alphas,
           void* err, void* updated, void* segs, int B, int N, int shift,
           int ds_size, float threshold, int sub, cudaStream_t stream) {
  const int seg_len = sub - 1 + 32 * TPL;
  int warps = N < kMaxWarps ? N : kMaxWarps;
  while (warps > 1 &&
         (shift < 0 || (long long)(warps - 1) * shift + seg_len > kMaxSpan)) {
    --warps;
  }
  const int groups = (N + warps - 1) / warps;
  const int span = (warps - 1) * shift + seg_len;
  const size_t smem =
      ((size_t)warps * (padded(32 * TPL - 1) + 1) + padded(span - 1) + 1) *
      sizeof(float);
  nlms_kernel<TPL, SUB><<<B * groups, 32 * warps, smem, stream>>>(
      static_cast<const float*>(lowrate), static_cast<const int*>(lr_read),
      static_cast<const float*>(h0), static_cast<const float*>(y),
      static_cast<const float*>(smoothing), static_cast<float*>(h),
      static_cast<float*>(alphas), static_cast<float*>(err),
      static_cast<uint8_t*>(updated), static_cast<float*>(segs), N, groups,
      shift, ds_size, threshold, sub);
  return (int)cudaGetLastError();
}

}  // namespace

// lowrate (B, DS), lr_read (B,) int32, h0 (B, N, taps), y (B, sub),
// smoothing (B,) -> h (B, N, taps), alphas (B, N, sub), err (B, N),
// updated (B, N) uint8, segs (B, N, sub - 1 + taps); float32 unless noted,
// all contiguous on the device. taps must be 128, 256, 384 or 512 and sub at
// most 16. Specialised for taps 512, sub 16 (the port's geometries);
// every other shape runs the form with a runtime sub. Returns
// cudaGetLastError().
extern "C" int matched_filter_nlms_f32(
    const void* lowrate, const void* lr_read, const void* h0, const void* y,
    const void* smoothing, void* h, void* alphas, void* err, void* updated,
    void* segs, int B, int N, int shift, int ds_size, float threshold,
    int sub, int taps, void* stream) {
  if (B < 0 || N < 0 || sub < 1 || sub > kMaxSub || taps % 128 != 0 ||
      taps < 128 || taps > 512 || ds_size < sub - 1 + taps) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
#define WAP_NLMS(TPL, SUB)                                                  \
  launch<TPL, SUB>(lowrate, lr_read, h0, y, smoothing, h, alphas, err,     \
                   updated, segs, B, N, shift, ds_size, threshold, sub, s)
  if (taps == 512 && sub == 16) return WAP_NLMS(16, 16);
  switch (taps / 32) {
    case 4: return WAP_NLMS(4, 0);
    case 8: return WAP_NLMS(8, 0);
    case 12: return WAP_NLMS(12, 0);
    default: return WAP_NLMS(16, 0);
  }
#undef WAP_NLMS
}
