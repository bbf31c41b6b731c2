// Backward of the masked statistics pooling (mean || floored stddev) for
// Hopper.
//
// Replaces: tf_kaldi_speaker_tpu/ops/pooling_pallas.py:_bwd, the custom VJP
// of masked_stats_pooling. It is jnp there, which XLA fuses into about one
// pass on the TPU; run eagerly on the card it is some eight elementwise
// launches, each over the whole [B, L, D] tensor.
//
// x [B, L, D] (float32 or bfloat16), mask [B, L] float32, out [B, 2D] and
// g [B, 2D] in x's type -> gx [B, L, D] in x's type:
//   gx = m/n * g_mean + m/n * (x - mean)/std * g_std * (1 - floored)
// with mean = out[:, :D], std = out[:, D:], n = max(sum(mask), 1) and
// floored = std^2 <= 1e-12 * (1 + 1e-6) (the forward floored that variance,
// so no gradient flows through it). All arithmetic is float32; gx is
// rounded to x's type once.
//
// What bounds it on the H100: device memory. It reads x once and writes gx
// once (at the train step's [64, 286, 1500] bf16, 55 MB each); mask, out
// and g are a few KB. Design:
// - One pass. A block owns 128 columns of one row and a range of 128
//   frames; it sums the row's mask once (n), and each thread computes its 4
//   columns' factors a = g_mean/n and c = g_std (1 - floored)/(n std) once,
//   so a frame costs one fused multiply-add and two multiplies per element:
//   gx = m * (a + c * (x - mean)).
// - The forward's loads (vec4.cuh): 4 adjacent columns per thread, one 8-B
//   (bf16) or 16-B (f32) streaming load and store each, a warp covering 128
//   columns; the scalar path where D % 4 != 0 or x or gx is not aligned to
//   4 elements. Each thread issues the loads of 8 (bf16) or 4 (f32) frames,
//   64 bytes, before it uses any.
// - Enough blocks: a [64, 286, 1500] call is a grid of 12 x 3 x 64 = 2304
//   blocks of 256 threads, about 17 per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec4.cuh"

namespace {

using tfks::F4;
using tfks::kVec;
using tfks::load4;
using tfks::store4;
using tfks::to_f32;

constexpr int kTx = 32;                  // threadIdx.x: column groups
constexpr int kTy = 8;                   // threadIdx.y: frame stride
constexpr int kThreads = kTx * kTy;
constexpr int kCols = kTx * kVec;        // columns per block
constexpr int kFramesPerBlock = 128;     // frames per block
template <typename T>
constexpr int kUnroll = 16 / sizeof(T);  // frames whose loads a thread issues at once
constexpr float kFloor = 1e-12f * (1.0f + 1e-6f);  // VAR2STD_EPSILON * (1 + 1e-6)

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    stats_pooling_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                             const T* __restrict__ out, const T* __restrict__ g,
                             T* __restrict__ gx, int L, int D) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTx + tx;
  const int b = blockIdx.z;
  const int d0 = blockIdx.x * kCols + tx * kVec;  // this thread's first column
  const int ncols = min(kVec, D - d0);            // its columns in range (<= 0: none)
  const float* m_row = mask + (size_t)b * L;

  // n = max(sum of the row's mask, 1): per-thread sums, then the warps',
  // then the block's, in a fixed order.
  __shared__ float s_w[kThreads / 32];
  __shared__ float s_n;
  float w = 0.0f;
  for (int i = tid; i < L; i += kThreads) w += m_row[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(0xffffffffu, w, off);
  if ((tid & 31) == 0) s_w[tid >> 5] = w;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) s += s_w[k];
    s_n = fmaxf(s, 1.0f);
  }
  __syncthreads();
  if (ncols <= 0) return;
  const float inv_n = 1.0f / s_n;

  // The thread's columns: mean, and the factors of g_mean and of (x - mean).
  const T* o = out + (size_t)b * 2 * D + d0;
  const T* gr = g + (size_t)b * 2 * D + d0;
  F4 mean, a, c;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mean.v[j] = a.v[j] = c.v[j] = 0.0f;
    if (j < ncols) {
      const float std = to_f32(o[D + j]);
      mean.v[j] = to_f32(o[j]);
      a.v[j] = to_f32(gr[j]) * inv_n;
      c.v[j] = std * std <= kFloor ? 0.0f : to_f32(gr[D + j]) * inv_n / std;
    }
  }

  const int l_begin = blockIdx.y * kFramesPerBlock;
  const int l_end = min(L, l_begin + kFramesPerBlock);
  const T* xb = x + (size_t)b * L * D + d0;
  T* gb = gx + (size_t)b * L * D + d0;
  constexpr int U = kUnroll<T>;
  for (int l = l_begin + ty; l < l_end; l += U * kTy) {
    F4 v[U];
    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = l + u * kTy;
      if (f < l_end) {
        v[u] = load4<kWide>(xb + (size_t)f * D, ncols);
        m[u] = m_row[f];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = l + u * kTy;
      if (f < l_end) {
        F4 r;
#pragma unroll
        for (int j = 0; j < kVec; ++j) r.v[j] = m[u] * fmaf(c.v[j], v[u].v[j] - mean.v[j], a.v[j]);
        store4<kWide>(gb + (size_t)f * D, r, ncols);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* mask, const void* out, const void* g, void* gx,
           int B, int L, int D, void* stream) {
  if (B == 0 || L == 0 || D == 0) return (int)cudaSuccess;
  if (B > 65535 || L > 65535 * kFramesPerBlock) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + kCols - 1) / kCols, (L + kFramesPerBlock - 1) / kFramesPerBlock, B);
  const dim3 block(kTx, kTy, 1);
  const uintptr_t align = kVec * sizeof(T);
  const bool wide = D % kVec == 0 && (uintptr_t)x % align == 0 && (uintptr_t)gx % align == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    stats_pooling_bwd_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)x, (const float*)mask, (const T*)out, (const T*)g, (T*)gx, L, D);
  else
    stats_pooling_bwd_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)x, (const float*)mask, (const T*)out, (const T*)g, (T*)gx, L, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's CUDA error (0 on success).
extern "C" int tfks_stats_pooling_bwd_f32(const void* x, const void* mask, const void* out,
                                          const void* g, void* gx, int B, int L, int D,
                                          void* stream) {
  return launch<float>(x, mask, out, g, gx, B, L, D, stream);
}

extern "C" int tfks_stats_pooling_bwd_bf16(const void* x, const void* mask, const void* out,
                                           const void* g, void* gx, int B, int L, int D,
                                           void* stream) {
  return launch<__nv_bfloat16>(x, mask, out, g, gx, B, L, D, stream);
}
