// Flash-attention backward in f32 on the CUDA cores: two strided kernels,
// the gradient of flash_fwd.cu's forward, for the head-packed (b, n, h*d)
// and the (b, h, n, d) layouts alike. bf16 runs on the tensor cores
// (flash_bwd_sm90.cu); these kernels keep f32 in full f32 for the f32
// checks.
//
// Replaces, for f32 inputs, the Pallas TPU backward kernels of
// v2ap_tpu/ops/flash_attention.py:
//   K4  _flash_bwd_dq_kernel / _packed_bwd_dq_kernel:   dq = scale * sum_k ds k
//   K5  _flash_bwd_dkv_kernel / _packed_bwd_dkv_kernel: dv = sum_q p^T dO,
//                                                       dk = sum_q ds^T q_scaled
// with _recompute_p's semantics. Each kernel recomputes, tile by tile,
//   s  = (q * scale) k^T,  s_c = c tanh(s / c)        (softclamp c, if any)
//   p  = exp(s_c - lse)                               (lse from the forward)
//   p  = 0 where the key is masked, past nk, or the row past nq
//   dp = dO v^T,  ds = p (dp - D) (1 - (s_c / c)^2)
// where D = rowsum(dO * O) is computed outside the kernels, as in JAX. Masked
// probabilities are zeroed explicitly rather than trusted to underflow: a
// batch element whose keys are all masked stores lse ~ -1e30, and
// exp(-1e30 - lse) would give p = 1 for every key. Such an element therefore
// gets exactly zero gradient, as the Pallas kernels give it.
//
// Two kernels, as in JAX, so that no atomics are needed and every sum runs
// in a fixed order: K4 owns one (b, h, 64-row q tile) and loops over key
// tiles; K5 owns one (b, h, 64-key tile) and loops over q tiles.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35
// TB/s): the function is five products, 10*b*h*nq*nk*d FLOP, split as K4 6
// (s, dp, ds k) and K5 4 (p^T dO, ds^T q); K5 also recomputes s and dp (4
// more). What this design does: the (nq, nk) scores never reach HBM; each
// block keeps its own tiles in shared memory and its accumulators in
// registers; the products run as f32 FMAs (each thread a 4x4 score tile and
// a 4 x ceil(d/16) accumulator tile), exact to f32 summation order.
//
// Inputs, lse and D are f32; lse and D (b, h, nq) contiguous. Strides are
// explicit (elements; the last dim must be contiguous). Linked into one
// library with flash_fwd.cu, whose v2ap_cuda_error_string serves both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPS = kBlockK + 1;  // padded row of a 64-wide score tile

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const uint8_t* mask;  // (b, nk), nonzero == attend; nullptr == all attend
  const float* lse;     // (b, h, nq)
  const float* delta;   // (b, h, nq), rowsum(dO * O)
  float* g0;            // dq (K4) or dk (K5)
  float* g1;            // dv (K5)
  int batch, heads, nq, nk;
  // (batch, head, row) strides of q, k, v, dO, g0, g1, then the mask's
  // batch stride
  long long s[19];
  float scale;
  float softclamp;  // <= 0: no softclamp
};

enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kG0 = 12, kG1 = 15, kM = 18 };

__device__ __forceinline__ const float* head_ptr(const float* base,
                                                 const long long* s, int b,
                                                 int h) {
  return base + b * s[0] + h * s[1];
}

// rows x D tile of a (n, D) head into shared memory (row stride D + 1),
// times `mul`; rows past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0, int n,
                                          int rows, float mul) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    float x = 0.f;
    if (r0 + r < n) x = src[(r0 + r) * row_stride + c] * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// softclamp and its chain-rule factor d(clamped)/d(raw); the same
// expression as the forward, so s_c - lse matches the forward's logits
__device__ __forceinline__ float clamp_logit(float x, float c, float* deriv) {
  if (c > 0.f) {
    x = tanhf(x / c) * c;
    const float r = x / c;
    *deriv = 1.f - r * r;
  } else {
    *deriv = 1.f;
  }
  return x;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(4) * kBlockQ * (D + 1) + size_t(kBlockQ) * kPS) +
         sizeof(int) * kBlockK;
}

// K4: one block per (b, h, 64-row q tile). Thread (tx, ty) holds rows
// 4ty..4ty+3 against keys tx + 16j of each key tile, and dq columns
// tx + 16c of its four rows.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int DS = D + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBlockQ x DS, pre-scaled q
  float* dOs = Qs + kBlockQ * DS;   // kBlockQ x DS
  float* Ks = dOs + kBlockQ * DS;   // kBlockK x DS
  float* Vs = Ks + kBlockK * DS;    // kBlockK x DS
  float* dSs = Vs + kBlockK * DS;   // kBlockQ x kPS
  int* valid = reinterpret_cast<int*>(dSs + kBlockQ * kPS);  // 1 attend, 0 masked, -1 past nk

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.nq;

  const float* q = head_ptr(p.q, p.s + kQ, b, h);
  const float* k = head_ptr(p.k, p.s + kK, b, h);
  const float* v = head_ptr(p.v, p.s + kV, b, h);
  const float* dout = head_ptr(p.dout, p.s + kDO, b, h);
  float* dq = p.g0 + b * p.s[kG0] + h * p.s[kG0 + 1];

  load_tile<D>(Qs, q, p.s[kQ + 2], q0, p.nq, kBlockQ, p.scale);
  load_tile<D>(dOs, dout, p.s[kDO + 2], q0, p.nq, kBlockQ, 1.f);

  float lse_r[4], dl_r[4], acc[4][DC];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_ok[i] = r < p.nq;
    lse_r[i] = row_ok[i] ? p.lse[row0 + r] : 0.f;
    dl_r[i] = row_ok[i] ? p.delta[row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's Ks/Vs/dSs reads are done
    load_tile<D>(Ks, k, p.s[kK + 2], k0, p.nk, kBlockK, 1.f);
    load_tile<D>(Vs, v, p.s[kV + 2], k0, p.nk, kBlockK, 1.f);
    if (tid < kBlockK) {
      const int j = k0 + tid;
      valid[tid] = j >= p.nk ? -1
                   : (p.mask == nullptr || p.mask[b * p.s[kM] + j] != 0) ? 1
                                                                          : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * DS + d];
        g[i] = dOs[(ty * 4 + i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * DS + d];
        vv[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool attend = valid[tx + 16 * j] == 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float deriv;
        const float x = clamp_logit(s[i][j], p.softclamp, &deriv);
        const float pij = (attend && row_ok[i]) ? expf(x - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * kPS + tx + 16 * j] = pij * (dp[i][j] - dl_r[i]) * deriv;
      }
    }
    __syncthreads();

    const int kn = min(kBlockK, p.nk - k0);
    for (int c = 0; c < kn; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float kv = Ks[c * DS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < p.nq) {
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) dq[r * p.s[kG0 + 2] + d] = acc[i][cc] * p.scale;
      }
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t(4) * kBlockK * (D + 1) + size_t(2) * kBlockK * kPS +
                          size_t(2) * kBlockQ);
}

// K5: one block per (b, h, 64-key tile). Thread (tx, ty) holds keys
// 4ty..4ty+3 against q rows tx + 16i of each q tile, and dk/dv columns
// tx + 16c of its four keys.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int DS = D + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // kBlockK x DS
  float* Vs = Ks + kBlockK * DS;    // kBlockK x DS
  float* Qs = Vs + kBlockK * DS;    // kBlockQ x DS, pre-scaled q
  float* dOs = Qs + kBlockQ * DS;   // kBlockQ x DS
  float* Ps = dOs + kBlockQ * DS;   // kBlockK x kPS, p^T
  float* dSs = Ps + kBlockK * kPS;  // kBlockK x kPS, ds^T
  float* lse_s = dSs + kBlockK * kPS;  // kBlockQ
  float* dl_s = lse_s + kBlockQ;       // kBlockQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.nq;

  const float* q = head_ptr(p.q, p.s + kQ, b, h);
  const float* k = head_ptr(p.k, p.s + kK, b, h);
  const float* v = head_ptr(p.v, p.s + kV, b, h);
  const float* dout = head_ptr(p.dout, p.s + kDO, b, h);
  float* dk = p.g0 + b * p.s[kG0] + h * p.s[kG0 + 1];
  float* dv = p.g1 + b * p.s[kG1] + h * p.s[kG1 + 1];

  load_tile<D>(Ks, k, p.s[kK + 2], k0, p.nk, kBlockK, 1.f);
  load_tile<D>(Vs, v, p.s[kV + 2], k0, p.nk, kBlockK, 1.f);

  bool key_ok[4];
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    key_ok[j] = key < p.nk &&
                (p.mask == nullptr || p.mask[b * p.s[kM] + key] != 0);
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;
  }

  for (int q0 = 0; q0 < p.nq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs reads are done
    load_tile<D>(Qs, q, p.s[kQ + 2], q0, p.nq, kBlockQ, p.scale);
    load_tile<D>(dOs, dout, p.s[kDO + 2], q0, p.nq, kBlockQ, 1.f);
    if (tid < kBlockQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < p.nq ? p.lse[row0 + r] : 0.f;
      dl_s[tid] = r < p.nq ? p.delta[row0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // [key j][row i]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[4], vv[4], a[4], g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(ty * 4 + j) * DS + d];
        vv[j] = Vs[(ty * 4 + j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(tx + 16 * i) * DS + d];
        g[i] = dOs[(tx + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(a[i], kk[j], s[j][i]);
          dp[j][i] = fmaf(g[i], vv[j], dp[j][i]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = tx + 16 * i;
      const bool row_ok = q0 + rl < p.nq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float deriv;
        const float x = clamp_logit(s[j][i], p.softclamp, &deriv);
        const float pji = (key_ok[j] && row_ok) ? expf(x - lse_s[rl]) : 0.f;
        Ps[(ty * 4 + j) * kPS + rl] = pji;
        dSs[(ty * 4 + j) * kPS + rl] = pji * (dp[j][i] - dl_s[rl]) * deriv;
      }
    }
    __syncthreads();

    const int qn = min(kBlockQ, p.nq - q0);
    for (int r = 0; r < qn; ++r) {
      float pj[4], dsj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pj[j] = Ps[(ty * 4 + j) * kPS + r];
        dsj[j] = dSs[(ty * 4 + j) * kPS + r];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float go = dOs[r * DS + d];
          const float qq = Qs[r * DS + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[j][cc] = fmaf(pj[j], go, dv_acc[j][cc]);
            dk_acc[j][cc] = fmaf(dsj[j], qq, dk_acc[j][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key < p.nk) {
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          dk[key * p.s[kG0 + 2] + d] = dk_acc[j][cc];
          dv[key * p.s[kG1 + 2] + d] = dv_acc[j][cc];
        }
      }
    }
  }
}

template <int D, bool kDq>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = kDq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  auto kernel = kDq ? flash_bwd_dq_kernel<D> : flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n = kDq ? p.nq : p.nk;
  const int tile = kDq ? kBlockQ : kBlockK;
  const dim3 grid((n + tile - 1) / tile, p.heads, p.batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDq>
int dispatch_head_dim(int head_dim, const BwdParams& p, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, kDq>(p, s);
    case 32: return launch<32, kDq>(p, s);
    case 64: return launch<64, kDq>(p, s);
    case 104: return launch<104, kDq>(p, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// f32 backward: K4 (dkv == 0: writes g0 = dq) or K5 (dkv != 0: writes g0 =
// dk, g1 = dv). strides: 19 values, the (batch, head, row) strides of q, k,
// v, dO, g0 and g1 (g1's unused by K4), then the mask's batch stride.
// Returns 0 on success, a cudaError_t value when the launch failed, -1 for
// an unsupported head dim.
int v2ap_flash_bwd(int dkv, int head_dim, const void* q, const void* k,
                   const void* v, const void* dout, const void* mask,
                   const void* lse, const void* delta, void* g0, void* g1,
                   int batch, int heads, int nq, int nk,
                   const long long* strides, float scale, float softclamp,
                   void* stream) {
  BwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = static_cast<float*>(g0);
  p.g1 = static_cast<float*>(g1);
  p.batch = batch;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  for (int i = 0; i < 19; ++i) p.s[i] = strides[i];
  p.scale = scale;
  p.softclamp = softclamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dkv) return dispatch_head_dim<false>(head_dim, p, s);
  return dispatch_head_dim<true>(head_dim, p, s);
}

}  // extern "C"
