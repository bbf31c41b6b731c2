// Four adjacent columns per thread: the loads and stores the pooling
// kernels (stats_pooling.cu, stats_pooling_bwd.cu) share. A wide access is
// one 16-B (float) or 8-B (bfloat16) streaming access (ld.global.cs /
// st.global.cs: the data is touched once, so L2 allocates its lines
// evict-first); the narrow path reads or writes the first n columns one by
// one, for D % 4 != 0 or a base address not aligned to 4 elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tfks {

constexpr int kVec = 4;  // adjacent columns per thread

struct F4 {
  float v[kVec];
};

template <bool kWide>
__device__ __forceinline__ F4 load4(const float* p, int n) {
  F4 r;
  if (kWide) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    r.v[0] = u.x, r.v[1] = u.y, r.v[2] = u.z, r.v[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = j < n ? p[j] : 0.0f;
  }
  return r;
}

template <bool kWide>
__device__ __forceinline__ F4 load4(const __nv_bfloat16* p, int n) {
  F4 r;
  if (kWide) {
    // bf16 -> f32 is the bf16 bits in the high half of the f32 word
    // (little-endian: the lower address holds the low half).
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    r.v[0] = __uint_as_float(u.x << 16), r.v[1] = __uint_as_float(u.x & 0xffff0000u);
    r.v[2] = __uint_as_float(u.y << 16), r.v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
  }
  return r;
}

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

template <bool kWide>
__device__ __forceinline__ void store4(float* p, const F4& r, int n) {
  if (kWide) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(r.v[0], r.v[1], r.v[2], r.v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) p[j] = r.v[j];
  }
}

template <bool kWide>
__device__ __forceinline__ void store4(__nv_bfloat16* p, const F4& r, int n) {
  if (kWide) {
    uint32_t h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = __bfloat16_as_ushort(__float2bfloat16(r.v[j]));
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16)));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) p[j] = __float2bfloat16(r.v[j]);
  }
}

}  // namespace tfks
