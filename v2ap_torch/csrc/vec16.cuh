// 16-byte vectors of bf16 or f32 as f32 values: the loads, stores and
// roundings that the elementwise kernels (norms.cu, quantize.cu) share.
// Pack<T>::round(v) is v rounded to T (to nearest even) and back, so a
// chain of f32 steps rounds where PyTorch's plain T ops round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kElems = 4;          // elements of a 16-byte vector
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float v) { return v; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {           // bf16 -> f32 is exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) {  // round to nearest even
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float v) {
    return __uint_as_float(bits(v) << 16);
  }
  __device__ static float load(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bits(v));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

}  // namespace
