// Train-mode BatchNorm over the last axis of x, for Hopper: the batch
// statistics, the normalize pass, and the analytic backward.
//
// Replaces no TPU kernel. The JAX package's BatchNorm is flax's
// nn.BatchNorm, plain jnp that XLA fuses into the neighbouring ops on the
// TPU; in PyTorch the same arithmetic is some twenty element-wise and
// reduction launches a direction, each reading and writing float32 copies
// of the activations. Six kernels do it here (a seventh over a data
// group), with the arithmetic of models/layers.py's BatchNorm (flax's):
//   forward  bn_train_stats_kernel        each block's sums of x and x^2
//            bn_train_finish_kernel       per channel: the blocks' sums in
//                                         order, mean, var = max(E[x^2] -
//                                         mean^2, 0), inv = rsqrt(var +
//                                         eps), mul = inv * scale, and the
//                                         running statistics
//            bn_train_normalize_kernel    y = (x - mean) * mul + bias
//   backward bn_train_grad_stats_kernel   each block's sums of g and
//                                         g * (x - mean)
//            bn_train_grad_finish_kernel  per channel: dscale, dbias and the
//                                         coefficients
//            bn_train_grad_kernel         dx = mul * g + k2 * (x - mean) + k3
// with k2 = -mul * inv^2 * sum(g (x - mean)) / n (0 where the clamp held the
// variance: no gradient flows through it there, as under autograd) and
// k3 = -mul * sum(g) / n, n the rows a channel has.
//
// Over a data group (BatchNorm's `group`, the batch split over ranks) the
// sums are all-reduced between the passes: bn_train_totals_kernel adds the
// blocks' sums into one [2, C] vector a rank, the wrapper all-reduces it
// with the row count, and the finish kernels run on the group's totals
// (one split) with n read from the device. dscale and dbias stay the
// rank's own sums, as under autograd of the plain grouped forward.
//
// What bounds it on the H100: device memory. The statistics need every x
// before the first y, so the forward reads x twice and writes y (3 element
// sizes an element), the backward reads x and g twice and writes dx (5);
// the arithmetic is a few operations an element, and the finish kernels
// read a few hundred KB of block sums. Everything is computed in float32
// whatever x's type, and y and dx are rounded to x's type once.
// Design:
// - Two layouts, read through the tensor's strides, no copy. "Rows": x is
//   contiguous, rows x C (dense layers, ResNet34's channels-last maps).
//   "Channels-first": x is the [B, ..., C] view of a contiguous
//   [B, C, ...] (the TDNN's and ECAPA's convolutions), so a channel's
//   values are B runs of R contiguous elements. y and dx are written with
//   x's strides, so the convolution after a channels-first layer still gets
//   a contiguous [B, C, L].
// - Long contiguous reads. Rows: a block is `tile` vector columns (up to
//   128, a whole row where C allows) by 512 / tile rows, each thread kVe
//   adjacent channels, whose sums or coefficients stay in registers over
//   every row it takes. Channels-first: a warp takes one channel and a
//   block 16 adjacent ones, so a block reads the 16 runs of one batch row
//   that lie next to each other in memory; the warp's lanes take the
//   16-byte-aligned chunks of its runs in turn, a chunk that straddles a
//   run's end masked element by element (its store too).
// - Wide accesses: kVe adjacent elements at once, 16 bytes where the
//   addresses and the layout allow it, else 8, else one element (the
//   wrapper picks kVe).
// - Bytes in flight. The forward statistics copy their rows or chunks
//   with cp.async into a ring of shared memory a block (32 KB for rows,
//   16 KB for channels-first, each the faster on the card), each thread
//   into slots of its own, and keep all but one slot in flight while they
//   add up the oldest: no registers held, no drain between rounds (a
//   2-byte access, which cp.async does not take, loads into registers).
//   The other passes issue the loads of up to 8 rows or chunks (64 bytes a
//   thread for the backward's sums, 32 for the element-wise passes) before
//   they use them. The grid is about two 512-thread blocks an SM.
// - Deterministic sums in a second stage. The rows (runs) are cut into
//   `splits` ranges, one block of each tile (channel group) each; every
//   block writes its sums to a float32 workspace [splits, 2, C], reduced in
//   a fixed order; the finish kernel adds each channel's splits in a fixed
//   order too (32 lanes, then the lanes in order). The same bits on every
//   run, no atomics.
// - Rounding as the plain path's: the finish and the element-wise passes
//   use the __f*_rn intrinsics, which are never contracted into FMA, and
//   rsqrtf as torch.rsqrt does, so with equal sums the statistics, the
//   running statistics and y are bit-equal to models/layers.py's plain
//   chain on the card; only the order of the sums differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
// Bytes a thread's register loads keep in flight before it uses them: the
// backward's sums' and the element-wise passes' (the card measured both
// halves and doubles as slower or no faster: more registers, fewer
// resident blocks).
constexpr int kSumBytes = 64, kPassBytes = 32;
constexpr int kWarps = kThreads / 32;  // channels-first: channels of a block
constexpr int kMaxTile = 128;          // rows: vector columns of a tile, a power of 2
constexpr int kFinishLanes = 32;       // finish: lanes a channel's splits are dealt to
constexpr int kFinishChannels = kThreads / kFinishLanes;

// The unsigned type of an access of kBytes.
template <int kBytes> struct Carrier;
template <> struct Carrier<16> { using type = uint4; };
template <> struct Carrier<8> { using type = uint2; };
template <> struct Carrier<4> { using type = unsigned int; };
template <> struct Carrier<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// kLast: the last read of the data (ld.global.cs), else a plain load that
// may leave the lines in L2 for the second pass.
template <typename T, int kVe, bool kLast>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[kVe]) {
  using C = typename Carrier<kVe * sizeof(T)>::type;
  const C c = kLast ? __ldcs(reinterpret_cast<const C*>(p)) : *reinterpret_cast<const C*>(p);
  T e[kVe];
  memcpy(e, &c, sizeof(C));
#pragma unroll
  for (int j = 0; j < kVe; ++j) v[j] = to_f32(e[j]);
}

template <typename T, int kVe>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[kVe]) {
  using C = typename Carrier<kVe * sizeof(T)>::type;
  T e[kVe];
#pragma unroll
  for (int j = 0; j < kVe; ++j) e[j] = from_f32<T>(v[j]);
  C c;
  memcpy(&c, e, sizeof(C));
  *reinterpret_cast<C*>(p) = c;
}

__device__ __forceinline__ float param(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void set_param(void* p, int bf16, int c, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[c] = v;
}

// The forward statistics' ring: each thread copies its own rows or chunks
// with cp.async into its own slots of shared memory, kRingBytes a block,
// and reads back only what it copied, so the ring needs no barrier; a
// slot is 4, 8 or 16 bytes (a 2-byte access keeps the loads in registers).
// Channels-first takes kRunsRingBytes: at bf16 [256, 286, 512] 16 KB read
// 62.4-62.7% of the bytes bound against 32 KB's 58.3-58.8% over eight
// alternating rounds on an H100 (float32 [32, 198, 512] alike).
constexpr int kRingBytes = 32 * 1024, kRunsRingBytes = 16 * 1024;

template <int kSlot, int kBytes = kRingBytes>
__host__ __device__ constexpr int ring_stages() {
  static_assert(kBytes / (kThreads * kSlot) >= 2, "a ring needs two slots");
  return kBytes / (kThreads * kSlot);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int kSlot>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if (kSlot == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(kSlot)
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

// Rows or chunks a thread loads before it uses any: kBytes of its streams
// in all, 1 to 8.
template <typename T, int kVe, int kStreams, int kBytes>
__host__ __device__ constexpr int unroll() {
  return kBytes / kStreams / (kVe * (int)sizeof(T)) < 1 ? 1
         : kBytes / kStreams / (kVe * (int)sizeof(T)) > 8 ? 8
         : kBytes / kStreams / (kVe * (int)sizeof(T));
}

// outer: rows (rows layout) or B (channels-first); inner: 1 or the run
// length R; per_split: the rows or runs of one split (blockIdx.y).
struct Geo {
  long long outer;
  int inner;
  int C;
  int per_split;
};

// stat [4, C] float32: mean, inv = rsqrt(var + eps), mul = inv * scale, and
// 1 where E[x^2] - mean^2 >= 0 (the clamp let the gradient through), else 0.
struct Fwd {
  const void* scale;
  int param_bf16;
  float* run_mean;
  float* run_var;
  float* stat;
  float factor;  // 1 / n, as torch.mean scales its sum
  float eps;
  float m;       // momentum
  float om;      // 1 - momentum
  const float* count;  // the group's n on the device (then s / n, as the
                       // plain grouped forward divides), or null: factor
};

// coef [2, C] float32: k2 and k3.
struct Bwd {
  const float* stat;
  float* coef;
  void* dscale;
  void* dbias;
  int param_bf16;
  float factor;
  const float* count;  // as Fwd's
  const float* local;  // the rank's own sums for dscale and dbias, or null
};

// The sums into [2, C] vectors: `out`, and `copy` where it is not null.
struct Tot {
  float* out;
  float* copy;
};

__device__ __forceinline__ float per_row(float s, float factor, const float* count) {
  return count ? __fdiv_rn(s, *count) : __fmul_rn(s, factor);
}

__device__ __forceinline__ void finish(const Fwd& f, int C, int c, float s1, float s2) {
  const float mean = per_row(s1, f.factor, f.count);
  const float raw = __fsub_rn(per_row(s2, f.factor, f.count), __fmul_rn(mean, mean));
  const float var = raw < 0.0f ? 0.0f : raw;  // clamp_min: a NaN stays NaN
  const float inv = rsqrtf(__fadd_rn(var, f.eps));
  const float mul = __fmul_rn(inv, param(f.scale, f.param_bf16, c));
  f.run_mean[c] = __fadd_rn(__fmul_rn(f.m, f.run_mean[c]), __fmul_rn(f.om, mean));
  f.run_var[c] = __fadd_rn(__fmul_rn(f.m, f.run_var[c]), __fmul_rn(f.om, var));
  f.stat[c] = mean;
  f.stat[C + c] = inv;
  f.stat[2 * C + c] = mul;
  f.stat[3 * C + c] = raw >= 0.0f ? 1.0f : 0.0f;
}

__device__ __forceinline__ void finish(const Bwd& b, int C, int c, float sg, float sgx) {
  const float inv = b.stat[C + c], mul = b.stat[2 * C + c];
  set_param(b.dscale, b.param_bf16, c, __fmul_rn(b.local ? b.local[C + c] : sgx, inv));
  set_param(b.dbias, b.param_bf16, c, b.local ? b.local[c] : sg);
  const float k2 = -__fmul_rn(__fmul_rn(__fmul_rn(mul, inv), inv), per_row(sgx, b.factor, b.count));
  b.coef[c] = b.stat[3 * C + c] != 0.0f ? k2 : 0.0f;
  b.coef[C + c] = -__fmul_rn(mul, per_row(sg, b.factor, b.count));
}

__device__ __forceinline__ void finish(const Tot& t, int C, int c, float s1, float s2) {
  t.out[c] = s1;
  t.out[C + c] = s2;
  if (t.copy) t.copy[c] = s1, t.copy[C + c] = s2;
}

// ---------------------------------------------------------------------------
// Rows layout: block (tile, split) is blockDim.x = `tile` vector columns by
// blockDim.y rows; thread (tx, ty) takes channels c0 = (tile index * tile +
// tx) * kVe ... + kVe - 1 and rows r0 + ty, r0 + ty + blockDim.y, ... of
// the split's range [r0, r1).

// The thread's sums of x and x^2 over its rows, through the ring: row k of
// the thread goes through slot k % S of its own.
template <typename T, int kVe>
__device__ __forceinline__ void rows_sums_ring(const T* __restrict__ x, const Geo& geo, int c0,
                                               long long r0, long long r1,
                                               unsigned char* smem, float (&a)[kVe],
                                               float (&b)[kVe]) {
  constexpr int kSlot = kVe * (int)sizeof(T), S = ring_stages<kSlot>();
  const int th = blockDim.y;
  unsigned char* ring = smem + (size_t)(threadIdx.y * blockDim.x + threadIdx.x) * kSlot;
  const long long first = r0 + threadIdx.y;
  const int n = first < r1 ? (int)((r1 - first + th - 1) / th) : 0;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < n) copy_async<kSlot>(ring + k * kThreads * kSlot, x + (first + (long long)k * th) *
                                                              geo.C + c0);
    commit_group();
  }
  for (int k = 0; k < n; ++k) {
    const int next = k + S - 1;
    if (next < n)
      copy_async<kSlot>(ring + (next % S) * kThreads * kSlot,
                        x + (first + (long long)next * th) * geo.C + c0);
    commit_group();
    wait_groups<S - 1>();
    float v[kVe];
    load_vec<T, kVe, false>(reinterpret_cast<const T*>(ring + (k % S) * kThreads * kSlot), v);
#pragma unroll
    for (int j = 0; j < kVe; ++j) a[j] += v[j], b[j] += v[j] * v[j];
  }
  wait_groups<0>();
}

// The thread's sums through registers, U rows in flight: x and x^2, or
// (kGrad) g and g (x - mean).
template <typename T, int kVe, bool kGrad>
__device__ __forceinline__ void rows_sums_regs(const T* __restrict__ x, const T* __restrict__ g,
                                               const float* __restrict__ stat, const Geo& geo,
                                               int c0, long long r0, long long r1,
                                               float (&a)[kVe], float (&b)[kVe]) {
  constexpr int U = unroll<T, kVe, kGrad ? 2 : 1, kSumBytes>();
  const int th = blockDim.y;
  float mean[kVe];
#pragma unroll
  for (int j = 0; j < kVe; ++j) mean[j] = kGrad ? stat[c0 + j] : 0.0f;
  for (long long r = r0 + threadIdx.y; r < r1; r += (long long)th * U) {
    float xv[U][kVe], gv[U][kVe];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + (long long)u * th;
      if (rr < r1) {
        load_vec<T, kVe, false>(x + rr * geo.C + c0, xv[u]);
        if (kGrad) load_vec<T, kVe, false>(g + rr * geo.C + c0, gv[u]);
      } else {
#pragma unroll
        for (int j = 0; j < kVe; ++j) xv[u][j] = gv[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < kVe; ++j) {
        if (kGrad) {
          a[j] += gv[u][j];
          b[j] += gv[u][j] * (xv[u][j] - mean[j]);
        } else {
          a[j] += xv[u][j];
          b[j] += xv[u][j] * xv[u][j];
        }
      }
    }
  }
}

// The block's sums of its tile's channels, written to partial[split].
template <typename T, int kVe, bool kGrad>
__device__ __forceinline__ void rows_partials(const T* __restrict__ x, const T* __restrict__ g,
                                              const float* __restrict__ stat, const Geo& geo,
                                              float* __restrict__ partial) {
  constexpr bool kRing = !kGrad && kVe * sizeof(T) >= 4;
  // the ring while the rows stream in, then the block's sums:
  // red[sum][row of the block * channels of the tile + channel]
  __shared__ __align__(16) float smem[kRingBytes / sizeof(float)];
  __shared__ float lanes[kThreads];
  static_assert(2 * kThreads * 8 * sizeof(float) <= kRingBytes, "red does not fit");
  float(*red)[kThreads * kVe] = reinterpret_cast<float(*)[kThreads * kVe]>(smem);
  const int tx = threadIdx.x, ty = threadIdx.y, th = blockDim.y;
  const int tc = blockDim.x * kVe;  // channels of a tile
  const int c0 = (blockIdx.x * blockDim.x + tx) * kVe;
  const long long r0 = (long long)blockIdx.y * geo.per_split;
  const long long r1 = min(geo.outer, r0 + geo.per_split);
  float a[kVe], b[kVe];
#pragma unroll
  for (int j = 0; j < kVe; ++j) a[j] = b[j] = 0.0f;
  if constexpr (kRing) {
    if (c0 < geo.C)
      rows_sums_ring<T, kVe>(x, geo, c0, r0, r1, reinterpret_cast<unsigned char*>(smem), a, b);
    __syncthreads();  // every thread is done with its slots
  } else if (c0 < geo.C) {
    rows_sums_regs<T, kVe, kGrad>(x, g, stat, geo, c0, r0, r1, a, b);
  }
#pragma unroll
  for (int j = 0; j < kVe; ++j) {
    red[0][ty * tc + tx * kVe + j] = a[j];
    red[1][ty * tc + tx * kVe + j] = b[j];
  }
  __syncthreads();
  // The tile's (sum, channel) pairs over the block's rows, in order: a
  // pair a thread where there are as many pairs as threads or more, else
  // `nl` lanes a pair (rows ty = lane, lane + nl, ...), then the lanes in
  // order. Both are powers of 2.
  const int pairs = 2 * tc, tid = ty * blockDim.x + tx;
  const size_t out = (size_t)blockIdx.y * 2 * geo.C + (size_t)blockIdx.x * tc;
  if (pairs >= kThreads) {
    for (int p = tid; p < pairs; p += kThreads) {
      const int k = p / tc, e = p % tc;
      float s = 0.0f;
      for (int r = 0; r < th; ++r) s += red[k][r * tc + e];
      if ((int)blockIdx.x * tc + e < geo.C) partial[out + (size_t)k * geo.C + e] = s;
    }
    return;
  }
  const int nl = kThreads / pairs, p = tid % pairs, lane = tid / pairs;
  const int k = p / tc, e = p % tc;
  float s = 0.0f;
  for (int r = lane; r < th; r += nl) s += red[k][r * tc + e];
  lanes[lane * pairs + p] = s;
  __syncthreads();
  if (tid < pairs && (int)blockIdx.x * tc + e < geo.C) {
    s = 0.0f;
    for (int l = 0; l < nl; ++l) s += lanes[l * pairs + tid];
    partial[out + (size_t)k * geo.C + e] = s;
  }
}

// ---------------------------------------------------------------------------
// Channels-first layout: warp w of block (group, split) takes channel
// c = group * kWarps + w of the runs b in the split's range. Run (b, c)
// holds flat elements [(b C + c) R, + R); item (b, j) is the j-th
// kVe-aligned chunk that can touch it, j < J = (R + 2 kVe - 2) / kVe, and
// the warp's lanes take the items in turn, runs of the split in order.

// A lane's place in its items: run bi of the split, chunk j of the run;
// step() moves it on by 32 items (a warp's turn).
struct RunCursor {
  int bi, j, J, qs, rs;
  __device__ __forceinline__ RunCursor(int item, int J_) : J(J_) {
    bi = item / J, j = item % J, qs = 32 / J, rs = 32 % J;
  }
  __device__ __forceinline__ void step() {
    bi += qs, j += rs;
    if (j >= J) j -= J, ++bi;
  }
};

// The cursor's chunk: its first element e0 and the bits of its kVe
// elements that lie in the run (none where it lies past the run's end).
template <int kVe>
__device__ __forceinline__ unsigned run_chunk(const Geo& geo, int c, long long b0,
                                              const RunCursor& cur, long long* e0) {
  const long long start = ((b0 + cur.bi) * geo.C + c) * geo.inner;
  *e0 = ((long long)((unsigned long long)start / kVe) + cur.j) * kVe;
  const long long lo = start - *e0, hi = lo + geo.inner;
  if (hi <= 0) return 0u;
  const unsigned below = lo > 0 ? (1u << lo) - 1u : 0u;
  return (hi >= kVe ? (1u << kVe) - 1u : (1u << hi) - 1u) & ~below;
}

// The lane's sums of x and x^2 over its items, through the ring: item k
// goes through slot k % S of its own; in[] holds the bits of the run of
// the items in flight.
template <typename T, int kVe>
__device__ __forceinline__ void runs_sums_ring(const T* __restrict__ x, const Geo& geo, int c,
                                               long long b0, int runs, float& a, float& b) {
  constexpr int kSlot = kVe * (int)sizeof(T), S = ring_stages<kSlot, kRunsRingBytes>();
  __shared__ __align__(16) unsigned char smem[kRunsRingBytes];
  unsigned char* ring = smem + (size_t)threadIdx.x * kSlot;
  const int lane = threadIdx.x % 32, J = (geo.inner + 2 * kVe - 2) / kVe;
  const long long items = (long long)runs * J;
  const int n = lane < items ? (int)((items - lane + 31) / 32) : 0;
  RunCursor cur(lane, J);
  unsigned in[S];
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    in[k] = 0u;
    if (k < n) {
      long long e0;
      in[k] = run_chunk<kVe>(geo, c, b0, cur, &e0);
      if (in[k]) copy_async<kSlot>(ring + k * kThreads * kSlot, x + e0);
    }
    cur.step();
    commit_group();
  }
  for (int base = 0; base < n; base += S) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int next = (k + S - 1) % S;  // the slot item base + k - 1 left
      in[next] = 0u;
      if (base + k + S - 1 < n) {
        long long e0;
        in[next] = run_chunk<kVe>(geo, c, b0, cur, &e0);
        if (in[next]) copy_async<kSlot>(ring + next * kThreads * kSlot, x + e0);
      }
      cur.step();
      commit_group();
      wait_groups<S - 1>();
      if (base + k < n && in[k]) {
        float v[kVe];
        load_vec<T, kVe, false>(reinterpret_cast<const T*>(ring + k * kThreads * kSlot), v);
#pragma unroll
        for (int j = 0; j < kVe; ++j) {
          const float xj = (in[k] >> j) & 1u ? v[j] : 0.0f;
          a += xj;
          b += xj * xj;
        }
      }
    }
  }
  wait_groups<0>();
}

// The lane's sums through registers, U items in flight: x and x^2, or
// (kGrad) g and g (x - mean).
template <typename T, int kVe, bool kGrad>
__device__ __forceinline__ void runs_sums_regs(const T* __restrict__ x, const T* __restrict__ g,
                                               float mean, const Geo& geo, int c, long long b0,
                                               int runs, float& a, float& b) {
  constexpr int U = unroll<T, kVe, kGrad ? 2 : 1, kSumBytes>();
  RunCursor cur(threadIdx.x % 32, (geo.inner + 2 * kVe - 2) / kVe);
  while (cur.bi < runs) {
    float xv[U][kVe], gv[U][kVe];
    unsigned in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = 0u;
      if (cur.bi < runs) {
        long long e0;
        in[u] = run_chunk<kVe>(geo, c, b0, cur, &e0);
        if (in[u]) {
          load_vec<T, kVe, false>(x + e0, xv[u]);
          if (kGrad) load_vec<T, kVe, false>(g + e0, gv[u]);
        }
      }
      cur.step();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < kVe; ++j) {
        const bool on = (in[u] >> j) & 1u;
        if (kGrad) {
          const float gj = on ? gv[u][j] : 0.0f;
          a += gj;
          b += gj * ((on ? xv[u][j] : mean) - mean);
        } else {
          const float xj = on ? xv[u][j] : 0.0f;
          a += xj;
          b += xj * xj;
        }
      }
    }
  }
}

// The warp's sums of its channel, written to partial[split].
template <typename T, int kVe, bool kGrad>
__device__ __forceinline__ void runs_partials(const T* __restrict__ x, const T* __restrict__ g,
                                              const float* __restrict__ stat, const Geo& geo,
                                              float* __restrict__ partial) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= geo.C) return;
  const long long b0 = (long long)blockIdx.y * geo.per_split;
  const int runs = (int)min((long long)geo.per_split, geo.outer - b0);
  float a = 0.0f, b = 0.0f;
  if constexpr (!kGrad && kVe * sizeof(T) >= 4)
    runs_sums_ring<T, kVe>(x, geo, c, b0, runs, a, b);
  else
    runs_sums_regs<T, kVe, kGrad>(x, g, kGrad ? stat[c] : 0.0f, geo, c, b0, runs, a, b);
  // the warp's sums: a butterfly, read at lane 0
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    partial[(size_t)blockIdx.y * 2 * geo.C + c] = a;
    partial[((size_t)blockIdx.y * 2 + 1) * geo.C + c] = b;
  }
}

// ---------------------------------------------------------------------------
// The kernels.

template <typename T, int kVe, bool kRuns>
__global__ void __launch_bounds__(kThreads)
    bn_train_stats_kernel(const T* __restrict__ x, Geo geo, float* __restrict__ partial) {
  if (kRuns)
    runs_partials<T, kVe, false>(x, x, nullptr, geo, partial);
  else
    rows_partials<T, kVe, false>(x, x, nullptr, geo, partial);
}

template <typename T, int kVe, bool kRuns>
__global__ void __launch_bounds__(kThreads)
    bn_train_grad_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               const float* __restrict__ stat, Geo geo,
                               float* __restrict__ partial) {
  if (kRuns)
    runs_partials<T, kVe, true>(x, g, stat, geo, partial);
  else
    rows_partials<T, kVe, true>(x, g, stat, geo, partial);
}

// Block i finishes channels [16 i, 16 i + 16): thread (channel, lane) adds
// splits lane, lane + 32, ..., then the lanes in order.
template <typename F>
__device__ __forceinline__ void finish_channels(const float* __restrict__ partial, int splits,
                                                int C, const F& f) {
  __shared__ float sums[2][kFinishLanes][kFinishChannels];
  const int cl = threadIdx.x % kFinishChannels, lane = threadIdx.x / kFinishChannels;
  const int c = blockIdx.x * kFinishChannels + cl;
  float s0 = 0.0f, s1 = 0.0f;
  if (c < C)
    for (int s = lane; s < splits; s += kFinishLanes) {
      s0 += partial[(size_t)s * 2 * C + c];
      s1 += partial[((size_t)s * 2 + 1) * C + c];
    }
  sums[0][lane][cl] = s0;
  sums[1][lane][cl] = s1;
  __syncthreads();
  if (threadIdx.x < kFinishChannels && c < C) {
    s0 = s1 = 0.0f;
    for (int l = 0; l < kFinishLanes; ++l) s0 += sums[0][l][cl], s1 += sums[1][l][cl];
    finish(f, C, c, s0, s1);
  }
}

__global__ void __launch_bounds__(kThreads)
    bn_train_finish_kernel(const float* __restrict__ partial, int splits, int C, Fwd f) {
  finish_channels(partial, splits, C, f);
}

__global__ void __launch_bounds__(kThreads)
    bn_train_grad_finish_kernel(const float* __restrict__ partial, int splits, int C, Bwd b) {
  finish_channels(partial, splits, C, b);
}

__global__ void __launch_bounds__(kThreads)
    bn_train_totals_kernel(const float* __restrict__ partial, int splits, int C, Tot t) {
  finish_channels(partial, splits, C, t);
}

// The element-wise passes. Normalize: y = (x - mean) * mul + bias. Grad:
// dx = mul * g + k2 * (x - mean) + k3. Per channel: mean, mul, and bias or
// k2 and k3.
template <bool kGrad>
__device__ __forceinline__ float pointwise(float x, float g, float mean, float c1, float c2,
                                           float c3) {
  const float d = __fsub_rn(x, mean);
  if (kGrad) return __fadd_rn(__fadd_rn(__fmul_rn(c1, g), __fmul_rn(c2, d)), c3);
  return __fadd_rn(__fmul_rn(d, c1), c2);
}

template <typename T, int kVe, bool kRuns, bool kGrad>
__device__ __forceinline__ void elementwise(const T* __restrict__ x, const T* __restrict__ g,
                                            T* __restrict__ out, const Geo& geo,
                                            const float* __restrict__ stat,
                                            const float* __restrict__ coef,
                                            const void* bias, int param_bf16) {
  constexpr int U = unroll<T, kVe, kGrad ? 2 : 1, kPassBytes>();
  const int C = geo.C;
  if (!kRuns) {
    const int tx = threadIdx.x, ty = threadIdx.y, th = blockDim.y;
    const int c0 = (blockIdx.x * blockDim.x + tx) * kVe;
    if (c0 >= C) return;
    float mean[kVe], c1[kVe], c2[kVe], c3[kVe];
#pragma unroll
    for (int j = 0; j < kVe; ++j) {
      mean[j] = stat[c0 + j];
      c1[j] = stat[2 * C + c0 + j];
      c2[j] = kGrad ? coef[c0 + j] : param(bias, param_bf16, c0 + j);
      c3[j] = kGrad ? coef[C + c0 + j] : 0.0f;
    }
    const long long r0 = (long long)blockIdx.y * geo.per_split;
    const long long r1 = min(geo.outer, r0 + geo.per_split);
    for (long long r = r0 + ty; r < r1; r += (long long)th * U) {
      float xv[U][kVe], gv[U][kVe];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * th;
        if (rr < r1) {
          load_vec<T, kVe, true>(x + rr * C + c0, xv[u]);
          if (kGrad) load_vec<T, kVe, true>(g + rr * C + c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * th;
        if (rr < r1) {
          float o[kVe];
#pragma unroll
          for (int j = 0; j < kVe; ++j)
            o[j] = pointwise<kGrad>(xv[u][j], kGrad ? gv[u][j] : 0.0f, mean[j], c1[j], c2[j],
                                    c3[j]);
          store_vec<T, kVe>(out + rr * C + c0, o);
        }
      }
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= C) return;
  const float mean = stat[c], c1 = stat[2 * C + c];
  const float c2 = kGrad ? coef[c] : param(bias, param_bf16, c);
  const float c3 = kGrad ? coef[C + c] : 0.0f;
  const long long b0 = (long long)blockIdx.y * geo.per_split;
  const int runs = (int)min((long long)geo.per_split, geo.outer - b0);
  const int J = (geo.inner + 2 * kVe - 2) / kVe;
  RunCursor cur(lane, J);
  while (cur.bi < runs) {
    float xv[U][kVe], gv[U][kVe];
    long long e0[U];
    unsigned in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = 0u;
      if (cur.bi < runs) {
        in[u] = run_chunk<kVe>(geo, c, b0, cur, &e0[u]);
        if (in[u]) {
          load_vec<T, kVe, true>(x + e0[u], xv[u]);
          if (kGrad) load_vec<T, kVe, true>(g + e0[u], gv[u]);
        }
      }
      cur.step();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!in[u]) continue;
      float o[kVe];
#pragma unroll
      for (int j = 0; j < kVe; ++j)
        o[j] = pointwise<kGrad>(xv[u][j], kGrad ? gv[u][j] : 0.0f, mean, c1, c2, c3);
      if (in[u] == (1u << kVe) - 1u) {
        store_vec<T, kVe>(out + e0[u], o);
      } else {
#pragma unroll
        for (int j = 0; j < kVe; ++j)
          if ((in[u] >> j) & 1u) out[e0[u] + j] = from_f32<T>(o[j]);
      }
    }
  }
}

template <typename T, int kVe, bool kRuns>
__global__ void __launch_bounds__(kThreads)
    bn_train_normalize_kernel(const T* __restrict__ x, T* __restrict__ y, Geo geo,
                              const float* __restrict__ stat, const void* bias, int param_bf16) {
  elementwise<T, kVe, kRuns, false>(x, x, y, geo, stat, nullptr, bias, param_bf16);
}

template <typename T, int kVe, bool kRuns>
__global__ void __launch_bounds__(kThreads)
    bn_train_grad_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                         Geo geo, const float* __restrict__ stat,
                         const float* __restrict__ coef) {
  elementwise<T, kVe, kRuns, true>(x, g, dx, geo, stat, coef, nullptr, 0);
}

// ---------------------------------------------------------------------------
// Launches. `ve` (elements an access) is 8, 4 or 1 for bfloat16 and 4, 2 or
// 1 for float32; the wrapper picks it so that every access is aligned:
// base addresses aligned to ve elements, and C (rows) or the element count
// (channels-first) a multiple of ve. `tile` (rows): vector columns of a
// block, a power of 2 up to 128; channels-first blocks are 16 channels.

struct Launch {
  Geo geo;
  dim3 grid, block;
  cudaStream_t stream;
  int splits;
};

int geometry(int channels_first, int ve, long long outer, int inner, int C, int splits,
             int per_split, int tile, void* stream, Launch* l) {
  if (outer < 1 || inner < 1 || C < 1 || splits < 1 || splits > 65535 || per_split < 1 ||
      (long long)splits * per_split < outer || (long long)(splits - 1) * per_split >= outer)
    return (int)cudaErrorInvalidValue;
  if (channels_first) {
    // every flat element index must fit its type
    if (outer * C > (1ll << 62) / inner) return (int)cudaErrorInvalidValue;
    l->grid = dim3((unsigned int)((C + kWarps - 1) / kWarps), (unsigned int)splits);
    l->block = dim3(kThreads, 1);
  } else {
    if (C % ve != 0 || inner != 1 || tile < 1 || tile > kMaxTile || (tile & (tile - 1)))
      return (int)cudaErrorInvalidValue;
    l->grid = dim3((unsigned int)((C / ve + tile - 1) / tile), (unsigned int)splits);
    l->block = dim3(tile, kThreads / tile);
  }
  l->geo = Geo{outer, inner, C, per_split};
  l->stream = (cudaStream_t)stream;
  l->splits = splits;
  return (int)cudaSuccess;
}

// Calls f.template go<T, kVe, kRuns>() for the runtime choice.
template <typename F>
int dispatch(int bf16, int channels_first, int ve, const F& f) {
#define TFKS_BN_CASE(T, V)                                                   \
  if (ve == V)                                                               \
    return channels_first ? f.template go<T, V, true>() : f.template go<T, V, false>();
  if (bf16) {
    TFKS_BN_CASE(__nv_bfloat16, 8)
    TFKS_BN_CASE(__nv_bfloat16, 4)
    TFKS_BN_CASE(__nv_bfloat16, 1)
  } else {
    TFKS_BN_CASE(float, 4)
    TFKS_BN_CASE(float, 2)
    TFKS_BN_CASE(float, 1)
  }
#undef TFKS_BN_CASE
  return (int)cudaErrorInvalidValue;
}

int finish_grid(int C) { return (C + kFinishChannels - 1) / kFinishChannels; }

struct StatsLaunch {
  const void* x;
  float* partial;
  Launch l;
  Fwd f;
  template <typename T, int V, bool R>
  int go() const {
    bn_train_stats_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>((const T*)x, l.geo,
                                                                     partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bn_train_finish_kernel<<<finish_grid(l.geo.C), kThreads, 0, l.stream>>>(partial, l.splits,
                                                                            l.geo.C, f);
    return (int)cudaGetLastError();
  }
};

// The sums of x and x^2 (or of g and g (x - mean)) into totals, for a group.
struct SumsLaunch {
  int grad;
  const void* x;
  const void* g;
  const float* stat;
  float* partial;
  Launch l;
  Tot t;
  template <typename T, int V, bool R>
  int go() const {
    if (grad)
      bn_train_grad_stats_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>(
          (const T*)x, (const T*)g, stat, l.geo, partial);
    else
      bn_train_stats_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>((const T*)x, l.geo,
                                                                       partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bn_train_totals_kernel<<<finish_grid(l.geo.C), kThreads, 0, l.stream>>>(partial, l.splits,
                                                                            l.geo.C, t);
    return (int)cudaGetLastError();
  }
};

struct NormalizeLaunch {
  const void* x;
  void* y;
  Launch l;
  const float* stat;
  const void* bias;
  int param_bf16;
  template <typename T, int V, bool R>
  int go() const {
    bn_train_normalize_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>(
        (const T*)x, (T*)y, l.geo, stat, bias, param_bf16);
    return (int)cudaGetLastError();
  }
};

struct GradStatsLaunch {
  const void* x;
  const void* g;
  float* partial;
  Launch l;
  Bwd b;
  template <typename T, int V, bool R>
  int go() const {
    bn_train_grad_stats_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>(
        (const T*)x, (const T*)g, b.stat, l.geo, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bn_train_grad_finish_kernel<<<finish_grid(l.geo.C), kThreads, 0, l.stream>>>(
        partial, l.splits, l.geo.C, b);
    return (int)cudaGetLastError();
  }
};

struct GradLaunch {
  const void* x;
  const void* g;
  void* dx;
  Launch l;
  const float* stat;
  const float* coef;
  template <typename T, int V, bool R>
  int go() const {
    bn_train_grad_kernel<T, V, R><<<l.grid, l.block, 0, l.stream>>>(
        (const T*)x, (const T*)g, (T*)dx, l.geo, stat, coef);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Each returns the launch's CUDA error (0 on success). bf16: x (and g, y,
// dx) bfloat16, else float32; param_bf16: scale and bias (and dscale,
// dbias) bfloat16, else float32; the running statistics, stat and coef are
// float32; partial holds splits x 2 x C floats. The two statistics entry
// points launch their sums and then their finish. A group's pass runs
// tfks_bn_train_sums, then (after the all-reduce) tfks_bn_train_finish or
// tfks_bn_train_grad_finish on the [2, C] totals and the count.
extern "C" int tfks_bn_train_stats(int bf16, int channels_first, int ve, const void* x,
                                   const void* scale, int param_bf16, void* run_mean,
                                   void* run_var, void* stat, void* partial, long long outer,
                                   int inner, int C, int splits, int per_split, int tile,
                                   float factor, float eps, float momentum, float one_minus,
                                   void* stream) {
  StatsLaunch s;
  const int err = geometry(channels_first, ve, outer, inner, C, splits, per_split, tile,
                           stream, &s.l);
  if (err) return err;
  s.x = x;
  s.partial = (float*)partial;
  s.f = Fwd{scale, param_bf16, (float*)run_mean, (float*)run_var, (float*)stat,
            factor, eps, momentum, one_minus, nullptr};
  return dispatch(bf16, channels_first, ve, s);
}

extern "C" int tfks_bn_train_normalize(int bf16, int channels_first, int ve, const void* x,
                                       void* y, const void* stat, const void* bias,
                                       int param_bf16, long long outer, int inner, int C,
                                       int splits, int per_split, int tile, void* stream) {
  NormalizeLaunch s;
  const int err = geometry(channels_first, ve, outer, inner, C, splits, per_split, tile,
                           stream, &s.l);
  if (err) return err;
  s.x = x, s.y = y, s.stat = (const float*)stat, s.bias = bias, s.param_bf16 = param_bf16;
  return dispatch(bf16, channels_first, ve, s);
}

extern "C" int tfks_bn_train_grad_stats(int bf16, int channels_first, int ve, const void* x,
                                        const void* g, const void* stat, void* coef,
                                        void* dscale, void* dbias, int param_bf16,
                                        void* partial, long long outer, int inner, int C,
                                        int splits, int per_split, int tile, float factor,
                                        void* stream) {
  GradStatsLaunch s;
  const int err = geometry(channels_first, ve, outer, inner, C, splits, per_split, tile,
                           stream, &s.l);
  if (err) return err;
  s.x = x, s.g = g;
  s.partial = (float*)partial;
  s.b = Bwd{(const float*)stat, (float*)coef, dscale, dbias, param_bf16, factor, nullptr,
            nullptr};
  return dispatch(bf16, channels_first, ve, s);
}

extern "C" int tfks_bn_train_grad(int bf16, int channels_first, int ve, const void* x,
                                  const void* g, void* dx, const void* stat, const void* coef,
                                  long long outer, int inner, int C, int splits, int per_split,
                                  int tile, void* stream) {
  GradLaunch s;
  const int err = geometry(channels_first, ve, outer, inner, C, splits, per_split, tile,
                           stream, &s.l);
  if (err) return err;
  s.x = x, s.g = g, s.dx = dx, s.stat = (const float*)stat, s.coef = (const float*)coef;
  return dispatch(bf16, channels_first, ve, s);
}

// grad 0: the sums of x and x^2 into totals [2, C]; grad 1: of g and
// g (x - mean) into totals and (where not null) copy.
extern "C" int tfks_bn_train_sums(int bf16, int channels_first, int ve, int grad, const void* x,
                                  const void* g, const void* stat, void* partial, void* totals,
                                  void* copy, long long outer, int inner, int C, int splits,
                                  int per_split, int tile, void* stream) {
  SumsLaunch s;
  const int err = geometry(channels_first, ve, outer, inner, C, splits, per_split, tile,
                           stream, &s.l);
  if (err) return err;
  if (grad && !stat) return (int)cudaErrorInvalidValue;
  s.grad = grad, s.x = x, s.g = g, s.stat = (const float*)stat, s.partial = (float*)partial;
  s.t = Tot{(float*)totals, (float*)copy};
  return dispatch(bf16, channels_first, ve, s);
}

// The forward's finish on a group's totals [2, C] and its row count.
extern "C" int tfks_bn_train_finish(const void* totals, const void* count, int C,
                                    const void* scale, int param_bf16, void* run_mean,
                                    void* run_var, void* stat, float eps, float momentum,
                                    float one_minus, void* stream) {
  if (C < 1 || !count) return (int)cudaErrorInvalidValue;
  const Fwd f{scale, param_bf16, (float*)run_mean, (float*)run_var, (float*)stat,
              0.0f, eps, momentum, one_minus, (const float*)count};
  bn_train_finish_kernel<<<finish_grid(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)totals, 1, C, f);
  return (int)cudaGetLastError();
}

// The backward's finish on a group's totals [2, C], the rank's own sums
// `local` and the group's row count.
extern "C" int tfks_bn_train_grad_finish(const void* totals, const void* local,
                                         const void* count, int C, const void* stat, void* coef,
                                         void* dscale, void* dbias, int param_bf16,
                                         void* stream) {
  if (C < 1 || !count || !local) return (int)cudaErrorInvalidValue;
  const Bwd b{(const float*)stat, (float*)coef, dscale, dbias, param_bf16, 0.0f,
              (const float*)count, (const float*)local};
  bn_train_grad_finish_kernel<<<finish_grid(C), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)totals, 1, C, b);
  return (int)cudaGetLastError();
}
