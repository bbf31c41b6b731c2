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
// elements) and writes 2*B*D; the arithmetic is three FMAs per element. At
// the extraction path's shapes (B of 1-32 rows, L of 200-1450 frames,
// D = 1500) the read is 0.4-37 MB, a few microseconds at 3.35 TB/s, so the
// kernel has to keep enough bytes in flight from the first wave on.
// Design:
// - Wide loads. A thread owns 4 adjacent columns and reads them with one
//   16-B (f32) or 8-B (bf16) load per frame; a warp covers 128 columns, 512
//   or 256 contiguous bytes. Where D % 4 != 0 or x is not aligned to 4
//   elements, the same layout loads the 4 columns one by one.
// - Loads in flight. Block (32, 8): threadIdx.y strides over frames, and
//   each thread issues the loads of 4 (f32) or 8 (bf16) frames, 64 bytes,
//   before it uses any of them. The wide loads are streaming loads
//   (ld.global.cs): x is read once, so its lines are allocated evict-first
//   in L2 and a miss replaces them before lines that other kernels hold,
//   dirty ones included, which would otherwise be written back while the
//   kernel reads.
// - Fill the card at small B. The grid is (ceil(D/128), splits, B): the
//   frame axis is cut into `splits` ranges (about 2.5 blocks per SM, each
//   range whole unrolled steps of frames, none empty), and the blocks of
//   one row's column range form a thread-block cluster of `splits` blocks.
//   Each block leaves its partial sums in its shared memory; block 0 of the
//   cluster reads the others' through distributed shared memory, in rank
//   order, and writes the result. One launch, no atomics, the same sums in the same order on
//   every run. With one split (32 rows fill the card alone) the launch is
//   a plain one, without the cluster launch's and barriers' cost.
// - One mask pass per block. The mask of the block's frame range is staged
//   in shared memory in tiles of 2048 frames; the first valid frame of the
//   row comes from one scan that stops at the first block of frames holding
//   one. The first tile and the scan's first block are loaded before the
//   thread's first frames and the frame-0 shift, so that the barrier they
//   meet at does not wait on the frame loads of the whole grid.
//
// Numerics: sums are in float32 whatever x's type. A one-pass
// E[x^2] - E[x]^2 cancels when the mean is large against the spread, which
// post-ReLU activations over long utterances are. Each column is therefore
// shifted by its value at the row's first valid frame before it is summed;
// in exact arithmetic the result is unchanged, and every split of a row uses
// the same shift, so the partial sums add. The mask multiplies every frame:
// padded frames after the convolutions hold non-zero values.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "vec4.cuh"

namespace cg = cooperative_groups;

namespace {

using tfks::F4;
using tfks::from_f32;
using tfks::kVec;
using tfks::load4;

constexpr int kTx = 32;             // threadIdx.x: column groups
constexpr int kTy = 8;              // threadIdx.y: frame stride
constexpr int kThreads = kTx * kTy;
constexpr int kCols = kTx * kVec;   // columns per block
constexpr int kMaskTile = 2048;     // mask frames staged per pass
// Frames whose loads a thread issues at once: 64 bytes in flight per thread.
template <typename T>
constexpr int kUnroll = 16 / sizeof(T);
constexpr int kMaxSplits = 8;       // the portable cluster size
// Blocks the frame splits aim for on each SM: the kernel holds about three
// per SM, and a grid past one wave of them pays for a second.
constexpr float kBlocksPerSm = 2.5f;
constexpr float kVarFloor = 1e-12f;  // VAR2STD_EPSILON

struct Sums {
  float w = 0.0f;
  float a[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  float q[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
};

__device__ __forceinline__ void accumulate(Sums& s, float m, const F4& x, const F4& shift) {
  s.w += m;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float v = x.v[j] - shift.v[j];
    s.a[j] += m * v;
    s.q[j] += m * v * v;
  }
}

// kSplit: launched as clusters of gridDim.y blocks that each sum a range of
// the frames; else gridDim.y == 1 and a block sums all frames of its row.
template <typename T, bool kWide, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    stats_pooling_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                         T* __restrict__ out, int L, int D, int frames_per_split) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTx + tx;
  const int b = blockIdx.z;
  const int d0 = blockIdx.x * kCols + tx * kVec;  // this thread's first column
  const int ncols = min(kVec, D - d0);            // its columns in range (<= 0: none)
  const float* m_row = mask + (size_t)b * L;
  const T* x_b = x + (size_t)b * L * D;

  __shared__ float s_mask[kMaskTile];
  __shared__ __align__(16) float s_a[kTy][kCols];
  __shared__ __align__(16) float s_q[kTy][kCols];
  __shared__ float s_w[kTy][kTx];
  __shared__ int s_first;

  // Everything the block needs first is requested before its first
  // barrier: the row's first block of mask frames and the first mask tile
  // of the block's frame range (first, so that they do not queue behind
  // the whole grid's frame loads), then this thread's first U frames and
  // its columns at frame 0 (the shift whenever frame 0 is valid, as it is
  // on every row that does not start with padding).
  const int l_begin = blockIdx.y * frames_per_split;
  const int l_end = min(L, l_begin + frames_per_split);
  int tile = l_begin;
  int n = min(kMaskTile, l_end - tile);
  float m_scan = tid < L ? m_row[tid] : 0.0f;
  float m_tile[kMaskTile / kThreads];
#pragma unroll
  for (int k = 0; k < kMaskTile / kThreads; ++k) {
    const int i = tid + k * kThreads;
    m_tile[k] = i < n ? m_row[tile + i] : 0.0f;
  }
  constexpr int U = kUnroll<T>;
  const size_t stride = (size_t)kTy * D;
  const F4 zero = {{0.0f, 0.0f, 0.0f, 0.0f}};
  F4 v[U];
  bool prefetched = ncols > 0 && ty + (U - 1) * kTy < n;
  if (prefetched) {
    const T* p = x_b + (size_t)(tile + ty) * D + d0;
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load4<kWide>(p + u * stride, ncols);
  }
  const F4 shift0 = ncols > 0 && L > 0 ? load4<kWide>(x_b + d0, ncols) : zero;
#pragma unroll
  for (int k = 0; k < kMaskTile / kThreads; ++k) s_mask[tid + k * kThreads] = m_tile[k];
  if (tid == 0) s_first = L;
  __syncthreads();
  // The row's first valid frame supplies the shift.
  for (int base = 0; base < L; base += kThreads) {
    if (base > 0) m_scan = base + tid < L ? m_row[base + tid] : 0.0f;
    const bool hit = m_scan != 0.0f;
    if (hit) atomicMin(&s_first, base + tid);
    if (__syncthreads_or(hit)) break;
  }
  const int first = s_first;
  F4 shift = first == 0 ? shift0 : zero;
  if (first > 0 && first < L && ncols > 0)
    shift = load4<kWide>(x_b + (size_t)first * D + d0, ncols);

  Sums s;
  while (n > 0) {
    if (ncols > 0) {
      const T* p = x_b + (size_t)(tile + ty) * D + d0;
      int i = ty;
      if (prefetched) {
#pragma unroll
        for (int u = 0; u < U; ++u) accumulate(s, s_mask[i + u * kTy], v[u], shift);
        i += U * kTy;
        p += U * stride;
        prefetched = false;
      }
      for (; i + (U - 1) * kTy < n; i += U * kTy, p += U * stride) {
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = load4<kWide>(p + u * stride, ncols);
#pragma unroll
        for (int u = 0; u < U; ++u) accumulate(s, s_mask[i + u * kTy], v[u], shift);
      }
      for (; i < n; i += kTy, p += stride) accumulate(s, s_mask[i], load4<kWide>(p, ncols), shift);
    }
    tile += kMaskTile;
    n = min(kMaskTile, l_end - tile);
    if (n <= 0) break;
    __syncthreads();  // every thread is done with this tile's mask
    for (int i = tid; i < n; i += kThreads) s_mask[i] = m_row[tile + i];
    __syncthreads();
  }

  // The block's sums: the kTy frame lanes meet in shared memory, in order.
  float4* a4 = reinterpret_cast<float4*>(&s_a[0][0]);
  float4* q4 = reinterpret_cast<float4*>(&s_q[0][0]);
  a4[ty * kTx + tx] = make_float4(s.a[0], s.a[1], s.a[2], s.a[3]);
  q4[ty * kTx + tx] = make_float4(s.q[0], s.q[1], s.q[2], s.q[3]);
  s_w[ty][tx] = s.w;
  __syncthreads();
  if (ty == 0) {
    for (int r = 1; r < kTy; ++r) {
      const float4 a = a4[r * kTx + tx], q = q4[r * kTx + tx];
      s.a[0] += a.x, s.a[1] += a.y, s.a[2] += a.z, s.a[3] += a.w;
      s.q[0] += q.x, s.q[1] += q.y, s.q[2] += q.z, s.q[3] += q.w;
      s.w += s_w[r][tx];
    }
    if (kSplit) {
      a4[tx] = make_float4(s.a[0], s.a[1], s.a[2], s.a[3]);
      q4[tx] = make_float4(s.q[0], s.q[1], s.q[2], s.q[3]);
      s_w[0][tx] = s.w;
    }
  }

  // The row's sums: block 0 of the cluster adds the other blocks' in rank
  // order, then every block waits until it has read them.
  bool finalize = ty == 0 && ncols > 0;
  if (kSplit) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    finalize = finalize && cluster.block_rank() == 0;
    for (unsigned int r = 1; finalize && r < cluster.num_blocks(); ++r) {
      const float4 a = cluster.map_shared_rank(a4, r)[tx];
      const float4 q = cluster.map_shared_rank(q4, r)[tx];
      s.a[0] += a.x, s.a[1] += a.y, s.a[2] += a.z, s.a[3] += a.w;
      s.q[0] += q.x, s.q[1] += q.y, s.q[2] += q.z, s.q[3] += q.w;
      s.w += cluster.map_shared_rank(&s_w[0][0], r)[tx];
    }
  }
  if (finalize) {
    // With W = sum(m), n = max(W, 1), r = W / n and dm = a / n:
    //   mean = shift * r + dm
    //   var  = q / n - dm^2 + (1 - r) * (2 * shift * dm + shift^2 * r)
    // which is the TPU kernel's s2/n - mean^2; the last term vanishes for
    // 0/1 masks with at least one valid frame.
    const float n = fmaxf(s.w, 1.0f);
    const float r = s.w / n;
    T* o = out + (size_t)b * 2 * D + d0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j >= ncols) break;
      const float sh = shift.v[j];
      const float dm = s.a[j] / n;
      const float mean = sh * r + dm;
      float var = s.q[j] / n - dm * dm + (1.0f - r) * (2.0f * sh * dm + sh * sh * r);
      var = fmaxf(var, 0.0f);
      o[j] = from_f32<T>(mean);
      o[D + j] = from_f32<T>(sqrtf(var <= kVarFloor ? kVarFloor : var));
    }
  }
  if (kSplit) cg::this_cluster().sync();
}

template <typename T, bool kWide>
cudaError_t launch_kernel(const cudaLaunchConfig_t& cfg, const void* x, const void* mask,
                          void* out, int L, int D, int frames_per_split) {
  if (cfg.numAttrs == 0)
    return cudaLaunchKernelEx(&cfg, stats_pooling_kernel<T, kWide, false>, (const T*)x,
                              (const float*)mask, (T*)out, L, D, frames_per_split);
  return cudaLaunchKernelEx(&cfg, stats_pooling_kernel<T, kWide, true>, (const T*)x,
                            (const float*)mask, (T*)out, L, D, frames_per_split);
}

// splits: frame ranges per row, 1-8, or 0 for the count nearest
// kBlocksPerSm blocks on each SM of the current device. Either is cut so
// that each range is a whole number of the block's unrolled steps
// (kTy * kUnroll frames) and none is empty.
template <typename T>
int launch(const void* x, const void* mask, void* out, int B, int L, int D,
           int splits, void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (splits < 0 || splits > kMaxSplits || B > 65535) return (int)cudaErrorInvalidValue;
  if (splits == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int blocks = B * ((D + kCols - 1) / kCols);
    splits = std::max(1, std::min(kMaxSplits, (int)(kBlocksPerSm * sms / blocks + 0.5f)));
  }
  constexpr int kStep = kTy * kUnroll<T>;
  const int frames_per_split = std::max(1, ((L + splits - 1) / splits + kStep - 1) / kStep) * kStep;
  splits = std::max(1, (L + frames_per_split - 1) / frames_per_split);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kCols - 1) / kCols, splits, B);
  cfg.blockDim = dim3(kTx, kTy, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a plain launch
  const bool wide = D % kVec == 0 && (uintptr_t)x % (kVec * sizeof(T)) == 0;
  const cudaError_t err =
      wide ? launch_kernel<T, true>(cfg, x, mask, out, L, D, frames_per_split)
           : launch_kernel<T, false>(cfg, x, mask, out, L, D, frames_per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's CUDA error (0 on success).
extern "C" int tfks_stats_pooling_f32(const void* x, const void* mask,
                                      void* out, int B, int L, int D,
                                      void* stream) {
  return launch<float>(x, mask, out, B, L, D, 0, stream);
}

extern "C" int tfks_stats_pooling_bf16(const void* x, const void* mask,
                                       void* out, int B, int L, int D,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, mask, out, B, L, D, 0, stream);
}

// For tests: the same launch with `splits` frame ranges per row (1-8,
// before the cut above) instead of the count picked for the device.
extern "C" int tfks_stats_pooling_splits(int bf16, const void* x, const void* mask,
                                         void* out, int B, int L, int D,
                                         int splits, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(x, mask, out, B, L, D, splits, stream)
              : launch<float>(x, mask, out, B, L, D, splits, stream);
}
