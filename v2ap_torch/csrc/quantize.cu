// Fused int8 quantize and dequantize (sm_90a) around the int8 GEMM of an
// int8 `Linear` (v2ap_torch/utils/quantize.py): AQT's dynamic-range numerics
// in the int8 towers (and in T5 and the CFM where they are set to int8).
//
// Q1  quantize:    per row of x (rows, k), absmax over the row (0 taken as
//                  1), scale = T(absmax * f32(1/127.5)), inv = T(1 / scale)
//                  (an infinite inv taken as 1), codes =
//                  int8(rint(clamp(T(x * inv), +-127))); the codes written
//                  straight into the zero-padded (rows_p, kp) buffer that
//                  torch._int_mm takes (kp = k rounded up to 8, rows past
//                  `rows` all zero), one scale a row.
// Q2  dequantize:  out = T(T(T(T(acc) * sx[r]) * sw[c]) + bias[c]) from the
//                  int32 sums (>= rows, acc_cols) into the (rows, cols)
//                  output, the bias optional.
// T is bf16 (serving) or f32; every step is one f32 operation rounded to T,
// as the plain PyTorch chain in quantize.py rounds it.
//
// Replaces no TPU kernel: AQT's quantize and dequantize are plain jnp ops,
// which XLA fuses into the passes around its int8 product. In PyTorch the
// same chain is ~17 kernels a Linear (abs, amax, where, products,
// reciprocal, isinf, clamp, round, casts, pads), each a full pass over the
// tensor: ~21 bytes moved for each element quantized and ~18 for each
// output element dequantized.
//
// Bound on an H100 SXM: bytes at 3.35 TB/s. Q1 reads each element once and
// writes one code (3 bytes an element in bf16); Q2 reads one int32 sum and
// writes one output element (6 bytes). Design, Q1: 32 W threads a row (W =
// 1, 2, 4 or 8 warps, the fewest whose threads hold the row in at most 8
// 16-byte vectors each; 8 rows a block at W = 1), neighbouring threads on
// neighbouring 16-byte vectors; the row stays in registers while its absmax
// is reduced by warp shuffles (across a row's warps through shared memory),
// and the codes go out from registers, 8 (bf16) or 4 (f32) bytes a thread,
// a warp's stores contiguous. Q2: one thread
// for 16 bytes of output: the int32 sums in 16-byte loads, the row's scale,
// the column scales and the bias (16-byte loads from L1 / L2), one 16-byte
// store.
//
// Exactness: absmax is exact in any order, and every later step is one IEEE
// f32 operation rounded to nearest even (_rn intrinsics, so nothing is
// contracted into a fused multiply-add; the reciprocal by true division)
// followed by the plain chain's rounding to T, so both kernels give the
// plain chain's bits. The int32 sums go to T through f32 (__int2float_rn,
// then the rounding to T), as `acc.to(T)` does; that differs from one
// rounding of the integer above 2^24, which fc2's sums reach. Build without
// fast math.
//
// Rows that do not fit 16-byte vectors (a width off the vector, a strided
// or misaligned view, a bias that is not contiguous) take a scalar route of
// the same arithmetic; the wrapper picks the route. So does a row wider
// than 8 warps hold (16 384 bf16 elements), which no served product has.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps a block
constexpr int kMaxWarps = kThreads / 32;    // Q1: at most a block a row
constexpr int kRegVectors = 8;              // Q1: 16-byte vectors a thread holds
constexpr float kInvBound = static_cast<float>(1.0 / 127.5);
constexpr float kClip = 127.0f;

// the larger of two magnitudes, keeping a NaN as torch.amax does
__device__ __forceinline__ float amax(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// --------------------------------------------------------------------- Q1

struct QuantArgs {
  const void* x;          // (rows, k): row r, column c at r * x_sr + c * x_sc
  int8_t* codes;          // (rows_p, kp), contiguous
  void* scale;            // (rows,), contiguous
  long long rows, rows_p;
  long long x_sr, x_sc;
  int k, kp;
  int warps;              // warps a row: 1, 2, 4 or 8
};

// the row's scale and the reciprocal its codes are taken with
template <typename T>
__device__ __forceinline__ void row_scale(float absmax, float& scale,
                                          float& inv) {
  if (absmax == 0.0f) absmax = 1.0f;
  scale = Pack<T>::round(__fmul_rn(absmax, kInvBound));
  inv = Pack<T>::round(__fdiv_rn(1.0f, scale));
  if (isinf(inv)) inv = 1.0f;
}

template <typename T>
__device__ __forceinline__ uint32_t code(float x, float inv) {
  const float v = fminf(fmaxf(Pack<T>::round(__fmul_rn(x, inv)), -kClip), kClip);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v)));
}

template <typename T>
__device__ __forceinline__ float vector_absmax(const uint4& v, float m) {
  constexpr int E = Pack<T>::kElems;
  float f[E];
  Pack<T>::unpack(v, f);
#pragma unroll
  for (int e = 0; e < E; ++e) m = amax(m, fabsf(f[e]));
  return m;
}

// the E codes of one 16-byte vector, E bytes at dst
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint4& v,
                                            float inv) {
  constexpr int E = Pack<T>::kElems;
  float f[E];
  Pack<T>::unpack(v, f);
  uint32_t w[E / 4];
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    w[i] = code<T>(f[4 * i], inv) | (code<T>(f[4 * i + 1], inv) << 8)
         | (code<T>(f[4 * i + 2], inv) << 16) | (code<T>(f[4 * i + 3], inv) << 24);
  if constexpr (E == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// the absmax of a row over its 32 * warps threads; every thread of the
// block calls it (the shared-memory step synchronises the block)
__device__ __forceinline__ float row_absmax(float m, int warps) {
  __shared__ float partial[kMaxWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = amax(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (warps == 1) return m;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = m;
  __syncthreads();
  const int first = warp - warp % warps;
  m = partial[first];
  for (int w = 1; w < warps; ++w) m = amax(m, partial[first + w]);
  return m;
}

enum Route { kHold = 0, kScalar = 1 };

// Rows past `rows` (up to rows_p) read as zeros, which give zero codes.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) quantize_kernel(QuantArgs a) {
  constexpr int E = Pack<T>::kElems;
  const int group = 32 * a.warps;
  const int t = threadIdx.x % group;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / group) + threadIdx.x / group;
  const bool live = row < a.rows;
  const bool stored = row < a.rows_p;
  const T* x = static_cast<const T*>(a.x) + (live ? row * a.x_sr : 0);
  int8_t* codes = a.codes + (stored ? row : 0) * static_cast<long long>(a.kp);
  float scale, inv, m = 0.0f;

  if constexpr (R == kHold) {
    const int nvec = a.k / E;
    uint4 v[kRegVectors];
    // every load in flight before the first is used (zeros past the row
    // leave the absmax as it is)
#pragma unroll
    for (int j = 0; j < kRegVectors; ++j) {
      const int c = t + group * j;
      v[j] = live && c < nvec ? load16(x + static_cast<long long>(c) * E)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kRegVectors; ++j) m = vector_absmax<T>(v[j], m);
    row_scale<T>(row_absmax(m, a.warps), scale, inv);
    if (stored) {
#pragma unroll
      for (int j = 0; j < kRegVectors; ++j) {
        const int c = t + group * j;
        if (c < nvec) store_codes<T>(codes + c * E, v[j], inv);
      }
      // f32 rows of k = 4 mod 8: the zero codes of the last 4 columns
      for (int c = nvec + t; c < a.kp / E; c += group)
        store_codes<T>(codes + c * E, make_uint4(0u, 0u, 0u, 0u), inv);
    }
  } else {
    if (live)
      for (int c = t; c < a.k; c += group)
        m = amax(m, fabsf(Pack<T>::load(x + c * a.x_sc)));
    row_scale<T>(row_absmax(m, a.warps), scale, inv);
    if (stored)
      for (int c = t; c < a.kp; c += group)
        codes[c] = static_cast<int8_t>(
            live && c < a.k ? code<T>(Pack<T>::load(x + c * a.x_sc), inv) : 0u);
  }
  if (live && t == 0) Pack<T>::store(static_cast<T*>(a.scale) + row, scale);
}

template <typename T>
int launch_quantize(QuantArgs a, bool vec, cudaStream_t s) {
  constexpr int E = Pack<T>::kElems;
  const long long vectors = (a.k + E - 1) / E;
  a.warps = 1;
  while (a.warps < kMaxWarps && vectors > 32LL * a.warps * kRegVectors)
    a.warps *= 2;
  const int rows_per_block = kMaxWarps / a.warps;
  const dim3 grid(static_cast<unsigned>((a.rows_p + rows_per_block - 1) /
                                        rows_per_block)),
      block(kThreads);
  if (vec && vectors <= 32LL * a.warps * kRegVectors)
    quantize_kernel<T, kHold><<<grid, block, 0, s>>>(a);
  else
    quantize_kernel<T, kScalar><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- Q2

struct DequantArgs {
  const int32_t* acc;     // (>= rows, acc_cols), contiguous
  const void* sx;         // (rows,), contiguous
  const void* sw;         // (cols,), contiguous
  const void* bias;       // (cols,) elements bias_s apart, or null
  void* out;              // (rows, cols), contiguous
  long long rows, acc_cols, bias_s;
  int cols;
};

// the plain chain's four roundings of one output element
template <typename T>
__device__ __forceinline__ float dequant(int32_t acc, float sx, float sw,
                                         const float* b) {
  float y = Pack<T>::round(__int2float_rn(acc));
  y = Pack<T>::round(__fmul_rn(y, sx));
  y = Pack<T>::round(__fmul_rn(y, sw));
  return b ? Pack<T>::round(__fadd_rn(y, *b)) : y;
}

// one thread for E consecutive outputs of a row (E: 16 bytes of T)
template <typename T>
__global__ void __launch_bounds__(kThreads) dequantize_vec_kernel(DequantArgs a) {
  constexpr int E = Pack<T>::kElems;
  const long long nvec = a.cols / E;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.rows * nvec) return;
  const long long r = i / nvec;
  const int c = static_cast<int>(i - r * nvec) * E;
  const int4* acc = reinterpret_cast<const int4*>(a.acc + r * a.acc_cols + c);
  int32_t s[E];
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int4 v = __ldg(acc + q);
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
  const float sx = Pack<T>::load(static_cast<const T*>(a.sx) + r);
  float sw[E], b[E], f[E];
  Pack<T>::unpack(load16(static_cast<const T*>(a.sw) + c), sw);
  if (a.bias) Pack<T>::unpack(load16(static_cast<const T*>(a.bias) + c), b);
#pragma unroll
  for (int e = 0; e < E; ++e)
    f[e] = dequant<T>(s[e], sx, sw[e], a.bias ? &b[e] : nullptr);
  reinterpret_cast<uint4*>(static_cast<T*>(a.out) + r * a.cols)[c / E] =
      Pack<T>::pack(f);
}

// one thread an output element: any width, a strided bias
template <typename T>
__global__ void __launch_bounds__(kThreads) dequantize_scalar_kernel(DequantArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.rows * a.cols) return;
  const long long r = i / a.cols;
  const int c = static_cast<int>(i - r * a.cols);
  float b = 0.0f;
  if (a.bias) b = Pack<T>::load(static_cast<const T*>(a.bias) + c * a.bias_s);
  const float y = dequant<T>(__ldg(a.acc + r * a.acc_cols + c),
                             Pack<T>::load(static_cast<const T*>(a.sx) + r),
                             Pack<T>::load(static_cast<const T*>(a.sw) + c),
                             a.bias ? &b : nullptr);
  Pack<T>::store(static_cast<T*>(a.out) + i, y);
}

template <typename T>
int launch_dequantize(const DequantArgs& a, bool vec, cudaStream_t s) {
  const long long threads = a.rows * (vec ? a.cols / Pack<T>::kElems : a.cols);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads)),
      block(kThreads);
  if (vec)
    dequantize_vec_kernel<T><<<grid, block, 0, s>>>(a);
  else
    dequantize_scalar_kernel<T><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Q1. bf16: nonzero for bf16 tensors, zero for f32; vec: nonzero where the
// 16-byte vector route may be taken (x_sc 1, k a multiple of the vector's
// elements, 16-byte aligned base and row stride). Returns 0 on success, a cudaError_t
// value when the launch failed.
int v2ap_int8_quantize(int bf16, int vec, const void* x, void* codes,
                       void* scale, long long rows, long long rows_p,
                       long long x_sr, long long x_sc, int k, int kp,
                       void* stream) {
  QuantArgs a{x, static_cast<int8_t*>(codes), scale, rows, rows_p,
              x_sr, x_sc, k, kp, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_quantize<__nv_bfloat16>(a, vec, s)
              : launch_quantize<float>(a, vec, s);
}

// Q2. Same conventions; vec: cols a multiple of the vector's elements and a
// contiguous, 16-byte aligned bias (or none). bias may be null.
int v2ap_int8_dequantize(int bf16, int vec, const void* acc, const void* sx,
                         const void* sw, const void* bias, void* out,
                         long long rows, long long acc_cols, long long bias_s,
                         int cols, void* stream) {
  DequantArgs a{static_cast<const int32_t*>(acc), sx, sw, bias, out, rows,
                acc_cols, bias_s, cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dequantize<__nv_bfloat16>(a, vec, s)
              : launch_dequantize<float>(a, vec, s);
}

}  // extern "C"
