// Kaldi compressed-matrix dequantization (CharToFloat) for Hopper.
//
// Replaces: tf_kaldi_speaker_tpu/ops/cm_dequant_pallas.py:_kernel, the Pallas
// TPU kernel that cm_dequantize launches with one utterance block per program.
//
// codes [B, L, D] uint8 and headers [B, 4, D] float32 (p0, p25, p75, p100 of
// each utterance column) -> out [B, L, D] float32:
//   c <= 64  : p0  + (p25  - p0)  * (c / 64)
//   c <= 192 : p25 + (p75  - p25) * ((c - 64) / 128)
//   else     : p75 + (p100 - p75) * ((c - 192) / 63)
//
// What bounds it on the H100: device memory. Each element reads 1 byte and
// writes 4, and the arithmetic is a few operations. Design:
// - Grid (chunks of one utterance's L*D codes, B): a block's utterance is
//   blockIdx.y, so no element needs 64-bit index arithmetic. A thread finds
//   its first column with one 32-bit remainder and advances it by one per
//   code.
// - Shared memory per block: the utterance's headers as (base, p_hi - p_lo)
//   pairs for each of the three segments and column, and the 256 codes'
//   fractions (c / 64, (c - 64) / 128, (c - 192) / 63). Each is computed once
//   per block with the expression it has in the map, so an element costs
//   three shared loads, a multiply and an add.
// - Coalesced stores. The f32 output is 4/5 of the bytes, so the layout is
//   chosen for it: a block's 256 threads take 4096 codes as four chunks of
//   1024, and in chunk k thread t reads codes [1024 k + 4 t, + 4) with one
//   4-byte load and writes them with one 16-byte store. Each warp
//   instruction then reads 128 and writes 512 contiguous bytes. (A thread
//   that owns 16 adjacent codes reads them with one 16-byte load, but its
//   four 16-byte stores lie 64 bytes apart across the warp.) The loads are
//   issued before the shared-memory set-up, which hides their latency.
//   This needs L*D % 4 == 0 and 4-byte-aligned codes, which every
//   extraction bucket has (L a multiple of 8, D = 30); anything else takes
//   the same layout with byte loads and scalar stores.
//
// Every value is the correctly rounded result of the same operations, in
// the same order, as the TPU kernel and the plain PyTorch version: the
// __f*_rn intrinsics are never contracted into FMA, and precomputing the
// difference and the fraction changes no rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // one fraction per code and thread
constexpr int kChunk = 4 * kThreads;   // codes per chunk: 4 per thread
constexpr int kChunks = 4;             // chunks per block
constexpr int kPerBlock = kChunk * kChunks;
constexpr int kMaxSmem = 227 * 1024;   // the H100's per-block shared memory

__device__ __forceinline__ float code_fraction(int code) {
  const float c = (float)code;
  if (code <= 64) return __fdiv_rn(c, 64.0f);
  if (code <= 192) return __fdiv_rn(__fsub_rn(c, 64.0f), 128.0f);
  return __fdiv_rn(__fsub_rn(c, 192.0f), 63.0f);
}

// Shared memory: frac[256], then base[3][D] and delta[3][D] with segment
// s of column d at s * D + d.
__device__ __forceinline__ float dequant(uint32_t code, int d, int D,
                                         const float* frac, const float* base,
                                         const float* delta) {
  const int k = ((code > 64u) + (code > 192u)) * D + d;
  return __fadd_rn(base[k], __fmul_rn(delta[k], frac[code]));
}

template <bool kVecAccess>
__global__ void __launch_bounds__(kThreads)
    cm_dequantize_kernel(const uint8_t* __restrict__ codes,
                         const float* __restrict__ headers,
                         float* __restrict__ out, int n, int D) {
  extern __shared__ float smem[];
  float* frac = smem;
  float* base = frac + 256;
  float* delta = base + 3 * D;
  const uint8_t* c_b = codes + (size_t)blockIdx.y * n;
  float* o_b = out + (size_t)blockIdx.y * n;
  // This thread's codes: [e + k * kChunk, + 4) for chunk k.
  const int e = blockIdx.x * kPerBlock + 4 * threadIdx.x;
  uint32_t words[kChunks];
  if (kVecAccess) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (e + k * kChunk < n) words[k] = *reinterpret_cast<const uint32_t*>(c_b + e + k * kChunk);
  }

  const float* h = headers + (size_t)blockIdx.y * 4 * D;
  frac[threadIdx.x] = code_fraction(threadIdx.x);
  for (int i = threadIdx.x; i < 3 * D; i += kThreads) {
    const float lo = h[i], hi = h[i + D];  // segment i / D: p_lo, p_hi
    base[i] = lo;
    delta[i] = __fsub_rn(hi, lo);
  }
  __syncthreads();

  const int step = kChunk % D;
  int d = e % D;
#pragma unroll
  for (int k = 0; k < kChunks; ++k, d = d + step >= D ? d + step - D : d + step) {
    const int ek = e + k * kChunk;
    if (ek >= n) break;
    if (kVecAccess) {
      float r[4];
      int dj = d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = dequant((words[k] >> (8 * j)) & 0xffu, dj, D, frac, base, delta);
        if (++dj == D) dj = 0;
      }
      *reinterpret_cast<float4*>(o_b + ek) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      int dj = d;
      for (int j = 0; j < 4 && ek + j < n; ++j) {
        o_b[ek + j] = dequant(c_b[ek + j], dj, D, frac, base, delta);
        if (++dj == D) dj = 0;
      }
    }
  }
}

}  // namespace

// Returns the launch's CUDA error (0 on success). Needs L * D < 2^31 - 2^12,
// B <= 65535 and 4 * (256 + 6 * D) bytes of shared memory.
extern "C" int tfks_cm_dequantize(const void* codes, const void* headers,
                                  void* out, int B, int L, int D,
                                  void* stream) {
  const long long n = (long long)L * D;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (256 + 6 * (size_t)D);
  if (n >= (1ll << 31) - kPerBlock || B > 65535 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (uintptr_t)codes % 4 == 0 && (uintptr_t)out % 16 == 0;
  void (*kernel)(const uint8_t*, const float*, float*, int, int) = cm_dequantize_kernel<false>;
  if (vec) kernel = cm_dequantize_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned int)((n + kPerBlock - 1) / kPerBlock), B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)headers, (float*)out, (int)n, D);
  return (int)cudaGetLastError();
}

extern "C" const char* tfks_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
