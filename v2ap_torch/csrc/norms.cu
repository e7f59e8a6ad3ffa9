// Fused RMS norm and AdaLN-Zero gated residual (sm_90a): the normalisation
// and gating of the CFM transformer's tri-stream blocks
// (v2ap_torch/ops/norms.py, models/transformer.py).
//
// N1  rms_norm:        out = T(x / sqrt(max(sum x^2, eps^2)) * scale * gain)
//     for RMSNorm (gain = g, per channel), AdaptiveRMSNorm (gain = 1 + gamma,
//     a per-batch-row f32 projection) and the transformer's final_norm.
// N2  gated_residual:  out = T(x + T(branch * sigmoid(gamma)))
//     for the three `x = x + gate(branch)` sites of AudioBlock (AdaLN-Zero).
// T is bf16 (serving) or f32 (the checks); every step is computed in f32.
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses each into one pass. In PyTorch each is 5-9 f32 elementwise kernels
// (cast, square, sum, clamp, sqrt, divide, two products, cast back), which
// move ~7x the bytes of one pass and pay a launch each; 121 such chains run
// in every CFG evaluation of the sampler.
//
// Bound on an H100 SXM: bytes at 3.35 TB/s (a norm reads x and writes the
// output once; the gate reads x and branch and writes once; gains are a
// row's worth, read through L1/L2). Design: one warp per row, 16-byte loads
// and stores, neighbouring lanes on neighbouring vectors. N1 keeps the
// row in registers (NV 16-byte vectors a lane: a 1280-wide bf16 row is 5),
// reduces the sum of squares by shuffles and writes once; no shared memory.
// Wider rows than the register variants hold re-read the row (from L1/L2)
// instead. Four rows a block: 416 blocks at the served 1664 rows, 3328 at
// 13 312, enough to fill 132 SMs.
//
// Numerics follow the plain PyTorch versions in ops/norms.py: the squares
// are rounded f32 products (as x * x is), and the division, the product by
// scale and the product by the gain are separate f32 operations in that
// order, so only the order of the sum differs. N2 rounds where the plain
// version rounds (the gated branch to T, then the sum to T), with
// sigmoid(g) = 1 / (1 + expf(-g)) as PyTorch computes it on CUDA, so in bf16
// it is bit-equal to the plain version. Build without fast math.
//
// Rows are any (b, n, d) view with a contiguous last dim and 16-byte
// aligned base and strides (x[:, r:] of final_norm included); outputs are
// contiguous (b, n, d). d is a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kRowsPerBlock = 4;            // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxRegVectors = 8;           // N1 holds up to 8 vectors a lane

// E f32 values (E = 4 or 8) at a 16-byte aligned address
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}

struct NormArgs {
  const void* x;
  const float* gain;     // (d,) with g_sb 0, or (b, d) rows g_sb apart
  void* out;             // contiguous (b, n, d)
  long long rows, n;     // rows = b * n
  long long x_sb, x_sn;  // element strides of x
  long long g_sb;
  int d;
  int plus_one;          // gain is 1 + gain[...] (AdaptiveRMSNorm)
  float scale;           // sqrt(d)
  float eps2;            // the floor of the sum of squares
};

template <typename T, int E>
__device__ __forceinline__ void norm_store(const NormArgs& a, const uint4& v,
                                           const float* g, T* out, int c,
                                           float norm) {
  float f[E], gv[E];
  Pack<T>::unpack(v, f);
  load_f32<E>(g + c * E, gv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float gain = a.plus_one ? gv[e] + 1.0f : gv[e];
    f[e] = f[e] / norm;
    f[e] = f[e] * a.scale;
    f[e] = f[e] * gain;
  }
  reinterpret_cast<uint4*>(out)[c] = Pack<T>::pack(f);
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  constexpr int E = Pack<T>::kElems;
  float f[E], s = 0.0f;
  Pack<T>::unpack(v, f);
#pragma unroll
  for (int e = 0; e < E; ++e) s = __fadd_rn(s, __fmul_rn(f[e], f[e]));
  return s;
}

// NV > 0: the row stays in NV vectors a lane; NV == 0: any width, the row
// is read twice.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(NormArgs a) {
  constexpr int E = Pack<T>::kElems;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const long long b = row / a.n;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + (row - b * a.n) * a.x_sn;
  const float* g = a.gain + b * a.g_sb;
  T* out = static_cast<T*>(a.out) + row * a.d;
  const int nvec = a.d / E;

  float ss = 0.0f;
  uint4 v[NV > 0 ? NV : 1];
  if constexpr (NV > 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        v[j] = load16(x + c * E);
        ss += sum_squares<T>(v[j]);
      }
    }
  } else {
    for (int c = lane; c < nvec; c += 32) ss += sum_squares<T>(load16(x + c * E));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // clamp keeps a NaN, as torch.clamp does
  const float norm = sqrtf(ss < a.eps2 ? a.eps2 : ss);

  if constexpr (NV > 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) norm_store<T, E>(a, v[j], g, out, c, norm);
    }
  } else {
    for (int c = lane; c < nvec; c += 32)
      norm_store<T, E>(a, load16(x + c * E), g, out, c, norm);
  }
}

struct GateArgs {
  const void* x;         // the residual stream
  const void* branch;
  const float* gamma;    // (b, d) rows g_sb apart (0: one row for all)
  void* out;             // contiguous (b, n, d)
  long long rows, n;
  long long x_sb, x_sn, br_sb, br_sn, g_sb;
  int d;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gated_residual_kernel(GateArgs a) {
  constexpr int E = Pack<T>::kElems;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const long long b = row / a.n;
  const long long i = row - b * a.n;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + i * a.x_sn;
  const T* br = static_cast<const T*>(a.branch) + b * a.br_sb + i * a.br_sn;
  const float* g = a.gamma + b * a.g_sb;
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + row * a.d);
  const int nvec = a.d / E;
  for (int c = lane; c < nvec; c += 32) {
    float fx[E], fb[E], gv[E];
    Pack<T>::unpack(load16(x + c * E), fx);
    Pack<T>::unpack(load16(br + c * E), fb);
    load_f32<E>(g + c * E, gv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float gate = 1.0f / (1.0f + expf(-gv[e]));
      // _rn: no fused multiply-add across the plain version's two kernels
      fx[e] = __fadd_rn(fx[e], Pack<T>::round(__fmul_rn(fb[e], gate)));
    }
    out[c] = Pack<T>::pack(fx);
  }
}

int blocks(long long rows) {
  return static_cast<int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
int launch_norm(const NormArgs& a, cudaStream_t s) {
  const int nv = (a.d / Pack<T>::kElems + 31) / 32;
  const dim3 grid(blocks(a.rows)), block(kThreads);
  switch (nv > kMaxRegVectors ? 0 : nv) {
    case 1: rms_norm_kernel<T, 1><<<grid, block, 0, s>>>(a); break;
    case 2: rms_norm_kernel<T, 2><<<grid, block, 0, s>>>(a); break;
    case 3: rms_norm_kernel<T, 3><<<grid, block, 0, s>>>(a); break;
    case 4: rms_norm_kernel<T, 4><<<grid, block, 0, s>>>(a); break;
    case 5: rms_norm_kernel<T, 5><<<grid, block, 0, s>>>(a); break;
    case 6: rms_norm_kernel<T, 6><<<grid, block, 0, s>>>(a); break;
    case 7: rms_norm_kernel<T, 7><<<grid, block, 0, s>>>(a); break;
    case 8: rms_norm_kernel<T, 8><<<grid, block, 0, s>>>(a); break;
    default: rms_norm_kernel<T, 0><<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// N1. bf16: nonzero for bf16 tensors, zero for f32. Returns 0 on success, a
// cudaError_t value when the launch failed.
int v2ap_rms_norm(int bf16, const void* x, const void* gain, void* out,
                  long long rows, long long n, long long x_sb, long long x_sn,
                  long long g_sb, int d, int plus_one, float scale, float eps2,
                  void* stream) {
  NormArgs a{x, static_cast<const float*>(gain), out, rows, n, x_sb, x_sn,
             g_sb, d, plus_one, scale, eps2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_norm<__nv_bfloat16>(a, s) : launch_norm<float>(a, s);
}

// N2. Same conventions as v2ap_rms_norm.
int v2ap_gated_residual(int bf16, const void* x, const void* branch,
                        const void* gamma, void* out, long long rows,
                        long long n, long long x_sb, long long x_sn,
                        long long br_sb, long long br_sn, long long g_sb, int d,
                        void* stream) {
  GateArgs a{x, branch, static_cast<const float*>(gamma), out, rows, n,
             x_sb, x_sn, br_sb, br_sn, g_sb, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(rows)), block(kThreads);
  if (bf16)
    gated_residual_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
  else
    gated_residual_kernel<float><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
