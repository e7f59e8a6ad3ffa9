// Flash-attention forward in f32 on the CUDA cores (sm_90a): one strided
// kernel serves the head-packed (b, n, h*d) layout and the (b, h, n, d)
// layout.
//
// Replaces, for f32 inputs, the Pallas TPU kernels of
// v2ap_tpu/ops/flash_attention.py:
//   K1  _packed_fwd_kernel (+ _packed_online_softmax), entry
//       flash_attention_packed: every attention of the CFM transformer;
//   K2  _flash_kernel (+ _online_softmax), entry flash_attention: the 48
//       attention layers of CLIP ViT-bigG (head dim 104);
//   K3  _flash_kernel_lse and _packed_fwd_kernel with lse_ref: the same
//       forward under autograd, which also stores the per-row log-sum-exp
//       lse = m + log(max(l, 1e-30)) as f32 (b, h, nq) for the backward
//       kernels of flash_bwd.cu. One kernel with an optional second output,
//       not a copy: a null lse pointer skips the store.
// and P1, _bnhd_fwd_kernel of scripts/probe_flash_bnhd.py (K1's function on
// the packed layout). bf16 inputs, the serving and training paths, run the
// tensor-core kernel of flash_fwd_sm90.cu instead: its wgmma products would
// round f32 inputs, and the f32 checks (card against CPU, the f32 kernel
// tests) need full f32.
// Both kernels compute  out = softmax(mask(softclamp(q k^T * scale))) v
// with an online softmax over key tiles: running max and denominator in
// f32, masked logits set to -1e30, the denominator floored at 1e-20.
// Softclamp c*tanh(s/c) comes before the mask. A row whose in-range keys
// are all masked therefore averages v over those keys, as the plain version
// does.
//
// Bound on an H100 SXM: the operations as f32 FMAs at 67 TFLOP/s. This
// kernel serves the small f32 checks, not a hot path: each block owns one
// (b, h, 64-row q tile), keeps its q tile, one 64-key K/V tile and the
// 64x64 probability tile in shared memory and never writes the (nq, nk)
// scores to HBM; each thread holds a 4x4 score tile and a 4 x ceil(d/16)
// output tile in registers.
//
// Lengths are ragged: q rows past nq are neither computed into HBM nor
// written, and keys past nk get probability exactly 0. Strides are explicit
// (elements; the last dim must be contiguous), so the packed layout and the
// 4D layout are just different stride choices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid: 4 q rows x 4 keys each
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // (b, nk), nonzero == attend; nullptr == all attend
  float* o;
  float* lse;           // (b, h, nq) contiguous; nullptr == not stored
  int batch, heads, nq, nk;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long m_sb;
  float scale;
  float softclamp;  // <= 0: no softclamp
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs and Ks rows padded to D + 1 floats so that column reads by 16
  // threads fall in distinct banks; Ps rows padded to kBlockK + 1.
  return sizeof(float) * (size_t(kBlockQ) * (D + 1) + size_t(kBlockK) * (D + 1) +
                          size_t(kBlockK) * D + size_t(kBlockQ) * (kBlockK + 1)) +
         sizeof(int) * kBlockK;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Params p) {
  constexpr int DS = D + 1;
  constexpr int PS = kBlockK + 1;
  constexpr int DC = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // kBlockQ x DS, pre-scaled q
  float* Ks = Qs + kBlockQ * DS;     // kBlockK x DS
  float* Vs = Ks + kBlockK * DS;     // kBlockK x D
  float* Ps = Vs + kBlockK * D;      // kBlockQ x PS, probabilities
  int* valid = reinterpret_cast<int*>(Ps + kBlockQ * PS);  // 1 attend, 0 masked, -1 past nk

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column lane
  const int ty = tid >> 4;  // owns q rows 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    float x = 0.f;
    if (q0 + r < p.nq) x = q[(q0 + r) * p.q_sn + c] * p.scale;
    Qs[r * DS + c] = x;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const bool clamp = p.softclamp > 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.nk) {
        kx = k[(k0 + r) * p.k_sn + c];
        vx = v[(k0 + r) * p.v_sn + c];
      }
      Ks[r * DS + c] = kx;
      Vs[r * D + c] = vx;
    }
    if (tid < kBlockK) {
      const int j = k0 + tid;
      valid[tid] = j >= p.nk ? -1
                   : (p.mask == nullptr || p.mask[b * p.m_sb + j] != 0) ? 1
                                                                         : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    int vj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vj[j] = valid[tx + 16 * j];

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (clamp) x = tanhf(x / p.softclamp) * p.softclamp;
        if (vj[j] == 0) x = kNegInf;
        s[i][j] = x;
        if (vj[j] >= 0) mx = fmaxf(mx, x);
      }
      // the 16 lanes sharing ty hold one row between them
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = vj[j] >= 0 ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    const int kn = min(kBlockK, p.nk - k0);  // keys past nk have p == 0
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < p.nq) {
      const float denom = fmaxf(l_i[i], 1e-20f);
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) o[r * p.o_sn + d] = acc[i][cc] / denom;
      }
      if (p.lse != nullptr && tx == 0)
        p.lse[(static_cast<long long>(b) * p.heads + h) * p.nq + r] =
            m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + kBlockQ - 1) / kBlockQ, p.heads, p.batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims built: 64 (the CFM), 104 (ViT-bigG), 16 and 32 (the tiny test
// configuration, so that it trains on the card through the same kernels).
int dispatch_head_dim(int head_dim, const Params& p, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 104: return launch<104>(p, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// f32 forward. lse may be null. Returns 0 on success, a cudaError_t value
// when the launch failed, -1 for an unsupported head dim.
int v2ap_flash_fwd(int head_dim, const void* q, const void* k,
                   const void* v, const void* mask, void* o, void* lse,
                   int batch,
                   int heads, int nq, int nk, long long q_sb, long long q_sh,
                   long long q_sn, long long k_sb, long long k_sh,
                   long long k_sn, long long v_sb, long long v_sh,
                   long long v_sn, long long o_sb, long long o_sh,
                   long long o_sn, long long m_sb, float scale,
                   float softclamp, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.batch = batch;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sn = q_sn;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sn = k_sn;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sn = v_sn;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sn = o_sn;
  p.m_sb = m_sb;
  p.scale = scale;
  p.softclamp = softclamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim(head_dim, p, s);
}

const char* v2ap_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
