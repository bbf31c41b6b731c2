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
// and g are a few KB. So every SM must have bytes of x in flight from its
// first cycle to its last. The first version of this kernel (one block
// per 128 columns x 128 frames of a row) did not: each block summed
// its row's mask and loaded its factors before its first load of x, which
// in bf16 lasted about as long as its 2 iterations of streaming, and the
// grid ran 2.18 waves at [64, 286, 1500]. Design:
// - A persistent grid. The wrapper (ops/pooling.py, backward_plan) cuts
//   the work into items, each (row, 128-column tile, frame range), and
//   launches as many blocks as are resident on the card at once; block i
//   walks items i, i + gridDim.x, ... A row's frames are split into ranges
//   of three ring stages of every warp only where rows x tiles give under
//   two items a block (small B, short L). The item order puts the tiles
//   of one frame range next to each other, so that neighbouring blocks
//   read whole frames. The launcher checks the plan and refuses one that
//   does not cover the work exactly once or has more blocks than are
//   resident.
// - A ring of asynchronous copies. A block is 32 x 8 threads; a thread owns
//   4 adjacent columns of the item's tile and every 8th frame of its range.
//   A stage of the ring is kU of the thread's frames (4 in bf16, 2 in
//   float32: 1 KB a warp), copied by cp.async (8 B bf16, 16 B f32) into the
//   thread's own slots of shared memory, with the warp's mask values of
//   those frames beside them (lane u copies frame u's). kStages = 4 stages:
//   while a thread computes one, the next three (96 B in bf16, 96 B in
//   float32) are in flight, about 120 KB a SM at 5 blocks a SM. The stream
//   runs across items: the next item's first stages are in flight while
//   the current item's last are computed, and stay in flight while the new
//   item's n and factors are loaded. The ring needs no barrier of the
//   block: a thread waits for its own copies (cp.async.wait_group), and a
//   __syncwarp before a stage is read, and again before its slot is
//   refilled, orders the mask values that one lane copies for its warp.
// - Per item, not per frame: each thread's factors (mean, std and the
//   gradients of its 4 columns, requested first) and n, summed by each warp
//   on its own (lane i adds frames i, i + 32, ... in order with 8 loads in
//   flight, then a butterfly of shuffles, which leaves the same bits in
//   every lane and every warp), skipped when the item's row is the
//   previous item's; then a = g_mean/n and c = g_std (1 - floored)/(n std).
//   A frame costs a subtract, a fused multiply-add and a multiply per
//   element: gx = m * (a + c * (x - mean)).
// - gx is written once, with vec4.cuh's streaming stores. No atomics, and
//   the same sums in the same order on every run: two launches on the same
//   inputs give the same bits.
// - One copy engine for both types: a TMA tensor map needs global strides
//   that are multiples of 16 bytes, which the flagship's bf16 rows (1500 x
//   2 = 3000 bytes) are not; cp.async needs only x aligned to 4 elements.
// - The scalar path, for D % 4 != 0 or x or gx not aligned to 4 elements,
//   loads x from device memory at the frame itself (the mask still comes
//   through the ring). It is there for correctness, not speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "vec4.cuh"

namespace {

using tfks::F4;
using tfks::kVec;
using tfks::load4;
using tfks::store4;
using tfks::to_f32;

constexpr int kTx = 32;            // threadIdx.x: column groups, a warp
constexpr int kTy = 8;             // threadIdx.y: frame rows, one a warp
constexpr int kThreads = kTx * kTy;
constexpr int kCols = kTx * kVec;  // columns of an item's tile
constexpr float kFloor = 1e-12f * (1.0f + 1e-6f);  // VAR2STD_EPSILON * (1 + 1e-6)
constexpr int kMaxDevices = 64;    // devices whose capacity is cached

// The ring: a stage is kU frames a thread (frames f, f + kTy, ...), one
// cp.async group; kStages stages. Raw: a thread's 4 columns of one frame
// as they lie in memory.
template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kU = 2, kStages = 4;
  using Raw = float4;
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int kU = 4, kStages = 4;
  using Raw = uint2;
};

__device__ __forceinline__ F4 unpack(const float4& u) { return {{u.x, u.y, u.z, u.w}}; }

// bf16 -> f32 is the bf16 bits in the high half of the f32 word, as
// vec4.cuh's load4 converts them.
__device__ __forceinline__ F4 unpack(const uint2& u) {
  return {{__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
           __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u)}};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy_async(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async(uint2* dst, const uint2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's groups are pending.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The work: items (row, tile, frame range), tile fastest, then range.
struct Plan {
  int L, D, tiles, splits, frames, items;
};

// A thread's place in its stream: the item, its row, the thread's first
// column, the first frame of its stage and the item's last frame + 1.
struct Cursor {
  int k, b, d0, f, f_end;
};

// Move c to item c.k, or to the first later item of the block that holds a
// frame of this thread's frame row; c.k >= p.items when there is none.
__device__ __forceinline__ void enter(Cursor& c, const Plan& p) {
  for (; c.k < p.items; c.k += gridDim.x) {
    const int r = c.k / p.tiles;
    const int f0 = (r % p.splits) * p.frames;
    c.b = r / p.splits;
    c.d0 = (c.k % p.tiles) * kCols + threadIdx.x * kVec;
    c.f = f0 + threadIdx.y;
    c.f_end = min(p.L, f0 + p.frames);
    if (c.f < c.f_end) return;
  }
}

template <int kU>
__device__ __forceinline__ void advance(Cursor& c, const Plan& p) {
  c.f += kU * kTy;
  if (c.f >= c.f_end) {
    c.k += gridDim.x;
    enter(c, p);
  }
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    stats_pooling_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                             const T* __restrict__ out, const T* __restrict__ g,
                             T* __restrict__ gx, const Plan p) {
  constexpr int kU = Ring<T>::kU, kStages = Ring<T>::kStages;
  using R = typename Ring<T>::Raw;
  __shared__ __align__(16) R s_x[kStages][kU][kThreads];
  __shared__ float s_m[kStages][kTy][kU];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTx + tx;
  const size_t step = (size_t)kTy * p.D;  // elements from a frame to the thread's next

  // The producer: the copies of the thread's next stage into a slot (lane
  // u < kU copies its warp's mask value of frame u), one group a stage, an
  // empty group once the stream has ended.
  Cursor pc{(int)blockIdx.x};
  enter(pc, p);
  auto issue = [&](int slot) {
    if (pc.k < p.items) {
      const size_t frame = (size_t)pc.b * p.L + pc.f;
      if (tx < kU && pc.f + tx * kTy < pc.f_end)
        copy_async(&s_m[slot][ty][tx], mask + frame + tx * kTy);
      if (kWide && pc.d0 < p.D) {
        const R* src = reinterpret_cast<const R*>(x + frame * p.D + pc.d0);
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (pc.f + u * kTy < pc.f_end)
            copy_async(&s_x[slot][u][tid], src + u * step / kVec);
      }
      advance<kU>(pc, p);
    }
    commit_group();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);

  // The consumer walks the same stream kStages stages behind.
  Cursor c{(int)blockIdx.x};
  enter(c, p);
  int item = -1, row = -1;
  float inv_n = 0.0f;
  F4 mean, a, cf;
  for (int q = 0; c.k < p.items; ++q) {
    const int ncols = min(kVec, p.D - c.d0);  // <= 0: the thread is past D
    if (c.k != item) {
      item = c.k;
      // the columns' mean, std and gradients, requested before the mask
      // sum so that their loads overlap its own
      const T* o = out + (size_t)c.b * 2 * p.D + c.d0;
      const T* gr = g + (size_t)c.b * 2 * p.D + c.d0;
      float std[kVec], g_mean[kVec], g_std[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool in = j < ncols;
        mean.v[j] = in ? to_f32(o[j]) : 0.0f;
        std[j] = in ? to_f32(o[p.D + j]) : 0.0f;
        g_mean[j] = in ? to_f32(gr[j]) : 0.0f;
        g_std[j] = in ? to_f32(gr[p.D + j]) : 0.0f;
      }
      if (c.b != row) {
        // n = max(sum of the row's mask, 1): lane i adds frames i, i + 32,
        // ... in order (8 loads in flight), then a butterfly of shuffles
        row = c.b;
        const float* m_row = mask + (size_t)row * p.L;
        float w = 0.0f;
        int i = tx;
        for (; i + 7 * kTx < p.L; i += 8 * kTx) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = m_row[i + j * kTx];
#pragma unroll
          for (int j = 0; j < 8; ++j) w += v[j];
        }
        for (; i < p.L; i += kTx) w += m_row[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) w += __shfl_xor_sync(0xffffffffu, w, off);
        inv_n = 1.0f / fmaxf(w, 1.0f);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        a.v[j] = g_mean[j] * inv_n;
        cf.v[j] = std[j] * std[j] <= kFloor ? 0.0f : g_std[j] * inv_n / std[j];
      }
    }
    const int slot = q % kStages;
    wait_groups<kStages - 1>();
    __syncwarp();  // the lanes' mask copies are visible to the whole warp
    if (ncols > 0) {
      const size_t at = ((size_t)c.b * p.L + c.f) * p.D + c.d0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (c.f + u * kTy < c.f_end) {
          const float m = s_m[slot][ty][u];
          const F4 v = kWide ? unpack(s_x[slot][u][tid]) : load4<false>(x + at + u * step, ncols);
          F4 r;
#pragma unroll
          for (int j = 0; j < kVec; ++j) r.v[j] = m * fmaf(cf.v[j], v.v[j] - mean.v[j], a.v[j]);
          store4<kWide>(gx + at + u * step, r, ncols);
        }
      }
    }
    // every lane has read the slot (its values are stored) before any
    // lane copies the stage kStages ahead into it
    __syncwarp();
    issue(slot);
    advance<kU>(c, p);
  }
}

// SMs and resident blocks a SM (the lower of the two paths' occupancies)
// of the current device, cached per device.
template <typename T>
int capacity(int* sms, int* per_sm) {
  static std::atomic<int> cached_sms[kMaxDevices], cached_per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && (*per_sm = cached_per_sm[dev].load(std::memory_order_acquire)) > 0) {
    *sms = cached_sms[dev].load(std::memory_order_relaxed);
    return 0;
  }
  int wide = 0, scalar = 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &wide, stats_pooling_bwd_kernel<T, true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &scalar, stats_pooling_bwd_kernel<T, false>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *per_sm = wide < scalar ? wide : scalar;
  if (dev < kMaxDevices) {
    cached_sms[dev].store(*sms, std::memory_order_relaxed);
    cached_per_sm[dev].store(*per_sm, std::memory_order_release);
  }
  return 0;
}

// What the plan is made from: columns of a tile, frames of a ring stage
// (every warp's), SMs and resident blocks a SM.
template <typename T>
int geometry(int* geo) {
  geo[0] = kCols;
  geo[1] = Ring<T>::kU * kTy;
  return capacity<T>(geo + 2, geo + 3);
}

template <typename T>
int launch(const void* x, const void* mask, const void* out, const void* g, void* gx, int B,
           int L, int D, int blocks, int items, int frames, void* stream) {
  if (B < 0 || L < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || D == 0)
    return blocks == 0 && items == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  // The plan must cover the work exactly once with resident blocks.
  if (frames < 1 || frames > L) return (int)cudaErrorInvalidValue;
  const long long tiles = (D + kCols - 1) / kCols, splits = (L + frames - 1) / frames;
  if ((long long)B * tiles * splits != (long long)items || items < 1 || items > INT_MAX / 2 ||
      blocks < 1 || blocks > items)
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  const int err = capacity<T>(&sms, &per_sm);
  if (err != 0) return err;
  if (blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  const Plan p{L, D, (int)tiles, (int)splits, frames, items};
  const uintptr_t align = kVec * sizeof(T);
  const bool wide = D % kVec == 0 && (uintptr_t)x % align == 0 && (uintptr_t)gx % align == 0;
  const dim3 block(kTx, kTy, 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    stats_pooling_bwd_kernel<T, true><<<blocks, block, 0, s>>>(
        (const T*)x, (const float*)mask, (const T*)out, (const T*)g, (T*)gx, p);
  else
    stats_pooling_bwd_kernel<T, false><<<blocks, block, 0, s>>>(
        (const T*)x, (const float*)mask, (const T*)out, (const T*)g, (T*)gx, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's CUDA error (0 on success). The plan (blocks,
// items, frames per item) comes from ops/pooling.py's backward_plan; a
// plan that does not cover [B, L, D] exactly once, or that asks for more
// blocks than are resident, is refused with cudaErrorInvalidValue.
extern "C" int tfks_stats_pooling_bwd_f32(const void* x, const void* mask, const void* out,
                                          const void* g, void* gx, int B, int L, int D,
                                          int blocks, int items, int frames, void* stream) {
  return launch<float>(x, mask, out, g, gx, B, L, D, blocks, items, frames, stream);
}

extern "C" int tfks_stats_pooling_bwd_bf16(const void* x, const void* mask, const void* out,
                                           const void* g, void* gx, int B, int L, int D,
                                           int blocks, int items, int frames, void* stream) {
  return launch<__nv_bfloat16>(x, mask, out, g, gx, B, L, D, blocks, items, frames, stream);
}

// The backward's geometry on the current device, from which
// ops/pooling.py's backward_plan makes the plan: geo[0] columns of a tile,
// geo[1] frames of a ring stage, geo[2] SMs, geo[3] resident blocks a SM
// (the lower of its two paths'); returns the CUDA error.
extern "C" int tfks_stats_pooling_bwd_geometry(int bf16, int* geo) {
  return bf16 ? geometry<__nv_bfloat16>(geo) : geometry<float>(geo);
}
