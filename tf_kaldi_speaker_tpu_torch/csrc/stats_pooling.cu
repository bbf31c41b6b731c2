// Masked statistics pooling (mean || floored stddev over time) for Hopper.
//
// Replaces: tf_kaldi_speaker_tpu/ops/pooling_pallas.py:_kernel, the Pallas
// TPU kernel launched by _stats_pallas inside masked_stats_pooling (grid
// (B, D/DT) over VMEM tiles, one pass of sum and sum of squares).
//
// x [B, L, D] (float32 or bfloat16), mask [B, L] float32 -> out [B, 2D] in
// x's type: out[b, :D] = masked mean, out[b, D:] = sqrt(var) with var
// clamped at 0 and floored to 1e-12, n = max(sum(mask), 1).
//
// What bounds it on the H100: device memory. It reads x once (B*L*D
// elements) and writes 2*B*D; the arithmetic is three FMAs per element.
// Design: grid (B, ceil(D/32)), block (32, 8). threadIdx.x walks 32
// adjacent columns, so each warp reads one contiguous 64- or 128-byte row
// segment per frame; threadIdx.y strides over the frames, and the eight
// partial sums of each column meet in shared memory. There is no cross-block
// reduction: a block owns its columns for all L frames, so nothing carries
// between blocks (the TPU grid's in-order carry has no counterpart here).
// At [32, ~390, 1500] that is 1,504 blocks of 256 threads for 132 SMs.
//
// Numerics: sums are in float32 whatever x's type. A one-pass
// E[x^2] - E[x]^2 cancels when the mean is large against the spread, which
// post-ReLU activations over long utterances are. Each column is therefore
// shifted by its value at the row's first valid frame before it is summed;
// in exact arithmetic the result is unchanged. The mask multiplies every
// frame: padded frames after the convolutions hold non-zero values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // threadIdx.x: adjacent columns
constexpr int kRows = 8;   // threadIdx.y: frame stride
constexpr float kVarFloor = 1e-12f;  // VAR2STD_EPSILON

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
    stats_pooling_kernel(const T* __restrict__ x,
                         const float* __restrict__ mask,
                         T* __restrict__ out, int L, int D) {
  const int b = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int d = blockIdx.y * kCols + tx;
  const float* m_row = mask + (size_t)b * L;
  const T* x_b = x + (size_t)b * L * D;

  __shared__ int first_valid;
  __shared__ float s_w[kRows][kCols];
  __shared__ float s_a[kRows][kCols];
  __shared__ float s_q[kRows][kCols];

  // The row's first valid frame supplies the shift.
  const int tid = ty * kCols + tx;
  if (tid == 0) first_valid = L;
  __syncthreads();
  for (int l = tid; l < L; l += kCols * kRows) {
    if (m_row[l] != 0.0f) {
      atomicMin(&first_valid, l);
      break;
    }
  }
  __syncthreads();

  float w = 0.0f, a = 0.0f, q = 0.0f, shift = 0.0f;
  if (d < D) {
    if (first_valid < L) shift = to_f32(x_b[(size_t)first_valid * D + d]);
    for (int l = ty; l < L; l += kRows) {
      const float m = m_row[l];
      const float v = to_f32(x_b[(size_t)l * D + d]) - shift;
      w += m;
      a += m * v;
      q += m * v * v;
    }
  }
  s_w[ty][tx] = w;
  s_a[ty][tx] = a;
  s_q[ty][tx] = q;
  __syncthreads();
  if (ty != 0 || d >= D) return;
  for (int r = 1; r < kRows; ++r) {
    w += s_w[r][tx];
    a += s_a[r][tx];
    q += s_q[r][tx];
  }
  // With W = sum(m), n = max(W, 1), r = W / n and dm = a / n:
  //   mean = shift * r + dm
  //   var  = q / n - dm^2 + (1 - r) * (2 * shift * dm + shift^2 * r)
  // which is the TPU kernel's s2/n - mean^2; the last term vanishes for
  // 0/1 masks with at least one valid frame.
  const float n = fmaxf(w, 1.0f);
  const float r = w / n;
  const float dm = a / n;
  const float mean = shift * r + dm;
  float var = q / n - dm * dm + (1.0f - r) * (2.0f * shift * dm + shift * shift * r);
  var = fmaxf(var, 0.0f);
  const float sd = sqrtf(var <= kVarFloor ? kVarFloor : var);
  out[(size_t)b * 2 * D + d] = from_f32<T>(mean);
  out[(size_t)b * 2 * D + D + d] = from_f32<T>(sd);
}

template <typename T>
int launch(const void* x, const void* mask, void* out, int B, int L, int D,
           void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  const dim3 grid(B, (D + kCols - 1) / kCols);
  const dim3 block(kCols, kRows);
  stats_pooling_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)mask, (T*)out, L, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int tfks_stats_pooling_f32(const void* x, const void* mask,
                                      void* out, int B, int L, int D,
                                      void* stream) {
  return launch<float>(x, mask, out, B, L, D, stream);
}

extern "C" int tfks_stats_pooling_bf16(const void* x, const void* mask,
                                       void* out, int B, int L, int D,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, mask, out, B, L, D, stream);
}
