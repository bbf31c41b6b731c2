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
// writes 4; the 16 bytes of header for a column are reused by all L frames of
// that column and come from L1/L2. There is no reuse for tiles to exploit, so
// the design is one thread per output element over the flattened B*L*D range:
// consecutive threads touch consecutive addresses, so the uint8 loads and
// float stores coalesce. At the extraction shapes (tens of thousands of
// frames of 30 columns) a launch moves a few MB and its time is mostly launch
// latency; fusing it into the pool gather or into CMVN is later work.
//
// The arithmetic keeps the TPU kernel's expression order and uses the
// __f*_rn intrinsics, which nvcc never contracts into FMA, so each result is
// the correctly rounded value of the same sequence of operations that the
// plain PyTorch version runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cm_dequantize_kernel(const uint8_t* __restrict__ codes,
                                     const float* __restrict__ headers,
                                     float* __restrict__ out,
                                     long long n, int L, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = (int)(i % D);
  const long long b = i / ((long long)L * D);
  const float* p = headers + b * 4 * D + d;
  const float p0 = p[0], p25 = p[D], p75 = p[2 * D], p100 = p[3 * D];
  const uint8_t code = codes[i];
  const float c = (float)code;
  float v;
  if (code <= 64) {
    v = __fadd_rn(p0, __fmul_rn(__fsub_rn(p25, p0), __fdiv_rn(c, 64.0f)));
  } else if (code <= 192) {
    v = __fadd_rn(p25, __fmul_rn(__fsub_rn(p75, p25),
                                 __fdiv_rn(__fsub_rn(c, 64.0f), 128.0f)));
  } else {
    v = __fadd_rn(p75, __fmul_rn(__fsub_rn(p100, p75),
                                 __fdiv_rn(__fsub_rn(c, 192.0f), 63.0f)));
  }
  out[i] = v;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tfks_cm_dequantize(const void* codes, const void* headers,
                                  void* out, int B, int L, int D,
                                  void* stream) {
  const long long n = (long long)B * L * D;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  cm_dequantize_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)headers, (float*)out, n, L, D);
  return (int)cudaGetLastError();
}

extern "C" const char* tfks_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
