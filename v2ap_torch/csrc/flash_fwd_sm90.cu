// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a): wgmma
// products on tiles that TMA brings into shared memory.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels
//   K1  _packed_fwd_kernel  v2ap_tpu/ops/flash_attention.py:503 (_packed_impl
//       :598, pallas_call :624): every attention of the CFM transformer;
//   K2  _flash_kernel       v2ap_tpu/ops/flash_attention.py:103 (_flash_impl
//       :227, pallas_call :238): the 48 layers of CLIP ViT-bigG, d = 104;
//   K3  _flash_kernel_lse   v2ap_tpu/ops/flash_attention.py:116 and
//       _packed_fwd_kernel with lse_ref: the forward under autograd, which
//       also stores lse = m + log(max(l, 1e-30)) as f32 (b, h, nq);
//   P1  _bnhd_fwd_kernel    scripts/probe_flash_bnhd.py:44 (flash_bnhd :86,
//       pallas_call :109): K1's function on the packed layout.
// f32 inputs stay on the CUDA-core kernel of flash_fwd.cu: the tensor cores
// would round them to bf16 or TF32.
//
// It computes what flash_fwd.cu computes:
//   out = softmax(mask(softclamp(q k^T * scale))) v
// with softclamp c*tanh(s/c) before the (b, nk) key mask, masked logits set
// to the finite -1e30 (so a row whose in-range keys are all masked averages
// v over them), keys past nk given probability exactly 0, the denominator
// floored at 1e-20, and lse stored when its pointer is not null.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): 4*b*h*nq*nk*d
// FLOP against q + k + v + o bytes. K2 (n = 257, d = 104) does ~130 FLOP per
// byte, under the card's ~295 ridge: its bound is the bytes. K1, K3 and P1
// (n = 768-800, d = 64) do ~400: their bound is the operations. Softclamp
// and the softmax add work on the multi-function unit that the bound does
// not count: per logit one exp2 for the softmax and, with softclamp, an
// exp2 and a reciprocal.
//
// Design:
// - Tiles. A block owns (b, h, a 64-row q tile): one consumer warpgroup
//   (128 threads) runs the products and the softmax, one producer warp
//   issues the loads. 64 rows rather than 128 because K1 at (2, 800,
//   16x64) has only 32 (b, h) pairs: 416 blocks of 64 rows against 224 of
//   128 on 132 SMs, and at n = 257 (K2) the ragged last tile wastes 63 rows
//   instead of 127. K/V tiles of 64 keys sit in a ring of 2 stages at
//   d <= 64 (4 blocks an SM) and 3 at d = 104 (2 blocks an SM, by shared
//   memory): several blocks on an SM keep the tensor cores busy while one
//   runs its softmax.
// - Loads. TMA fills Q once and the K/V ring, completing on mbarriers; the
//   producer waits for a stage to be released before it refills it. The
//   tensor maps are 4D (d, n, h, b) maps of the strides the wrapper passes,
//   so the packed (b, n, h*d) layout and the (b, h, n, d) layout are only
//   different strides. cuTensorMapEncodeTiled is fetched with
//   cudaGetDriverEntryPoint: the library needs no -lcuda. Host cost: the
//   sampler launches K1 1152 times a generate and the host sets its pace,
//   so encoded maps are kept by what they encode (address, extents,
//   strides), and a call whose views sit where an earlier call's did, as
//   the caching allocator's blocks recur, copies its maps. The producer
//   warp also turns each tile's 64 keys into two bit words (attends, in
//   range) with one ballot each, stored beside the K tile; a tile whose keys
//   all attend, the common case, then skips the masking entirely.
// - Head dim. A box is 64 columns (128 bytes, the 128-byte swizzle span);
//   d = 104 is two boxes over a map whose inner extent is 104, so columns
//   104-127 arrive as zeros. Q K^T runs ceil(d/16) k16 steps (7 at d = 104,
//   the last over columns 96-111 of which 104-111 are zero); P V runs with
//   N = 128, whose columns past 104 are zero and never stored. d = 16 and
//   32 (the tiny test configuration) are one 64-column box, zero past d.
// - S = Q K^T. wgmma m64n64k16 with both operands in shared memory
//   (K-major, 128-byte swizzle) and f32 accumulators. Softclamp, the mask
//   and the online softmax run on those registers, in log2 units.
// - O += P V. P goes to bf16 in registers as the A operand: the f32
//   accumulator layout of m64nNk16 is the A-fragment layout. V is the B
//   operand read from its (keys, d) row-major tile through wgmma's transpose
//   bit (MN-major), with no transposed copy. The row sums l add the f32 p,
//   as the plain version does; only P V sees p rounded to bf16. S of the
//   next tile and P V of this one are issued as one group.
// - Ragged lengths. TMA fills rows past nq and nk with zeros. Keys past nk
//   get the logit -inf in log2 units, so p = exp2(-inf) = 0 exactly, apart
//   from masked keys (-1e30, finite); the running max starts at -1e30 and
//   stays finite, so no -inf - -inf arises. Rows past nq are computed on
//   zeros and never stored.
// - Softclamp as c - 2c / (exp(2 s / c) + 1) on exp2 and a reciprocal: an
//   absolute error of ~1e-5 in a logit near 50. tanh.approx.f32 (one
//   instruction) has a relative error of ~2^-11, up to ~0.025 in such a
//   logit: as much in lse, against lse's 1e-3 check, and too close to the
//   2^-7 * max(1, max|ref|) output tolerance at logits of std 40.
// - Strides and alignment. TMA needs 16-byte aligned bases and strides
//   (the wrapper checks and raises ValueError otherwise; there is no
//   fallback). The output is stored from registers as bf16 pairs through
//   its own strides, rows < nq and columns < d only.
// Not here: warp specialisation with setmaxnreg, a persistent grid, and
// a softmax that runs beside the products of the same warpgroup.

#include "sm90_common.cuh"

namespace {

constexpr int kBlockM = 64;          // q rows per block: one warpgroup
constexpr int kBlockN = 64;          // keys per K/V tile
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr float kNegInf2 = -1e30f * kLog2e;  // a masked logit, log2 units

template <int D>
struct Tile {
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kDP = kBoxes * kBoxCols;   // padded head dim
  static constexpr int kQKSteps = (D + 15) / 16;  // k16 steps of Q K^T
  static constexpr int kBytes = kBoxes * kBoxBytes;  // Q, K or V tile
  // Blocks per SM and K/V ring stages: d <= 64 fits 4 blocks of 2 stages
  // (41 KB; ptxas then caps a thread at 96 registers and spills 144
  // bytes), d = 104 fits 2 of 3 (115 KB): of the settings timed on the
  // card, the fastest for K1, K3 and P1 and for K2 (PERF.md). At (2, 800,
  // 16x64) K1's 416 blocks fit one wave at 4 blocks an SM and take two at 3.
  static constexpr int kMinBlocks = kBoxes == 1 ? 4 : 2;
  static constexpr int kStages = kBoxes == 1 ? 2 : 3;
  // Q, the K and V rings, 128 bytes of mbarriers, the key words
  static constexpr int kSmem = kBytes * (1 + 2 * kStages) + 128 + 16 * kStages;
};

struct Params {
  CUtensorMap q_map, k_map, v_map;  // (d, n, h, b) bf16, 64 x 64 boxes
  const uint8_t* mask;              // (b, nk), nonzero == attend; null == all
  long long m_sb;
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_sn;
  float* lse;                       // (b, h, nq); null == not stored
  int heads, nq, nk;
  Clamp clamp;                      // softclamp, if any (sm90_common.cuh)
};

// ----------------------------------------------------------------- kernel

// Softclamp, the key mask and the online softmax over one 64-key tile.
// On entry sc holds this thread's raw Q K^T products (rows r = 0, 1; see
// the consumer's layout), on exit their probabilities exp2(x - m) in f32.
// keys: bit i of x / y = key i / 32 + i attends (in range and not masked),
// of z / w = key in range. m_run and l_run move on; alpha is the factor by
// which the O accumulated so far must shrink.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockN / 2],
                                             const Params& p, uint4 keys,
                                             int quad, float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2]) {
  // every key attends: the common case, the same for the whole warpgroup
  const bool all = (keys.x & keys.y) == 0xffffffffu;
  const uint32_t att[2] = {keys.x >> (2 * quad), keys.y >> (2 * quad)};
  const uint32_t inr[2] = {keys.z >> (2 * quad), keys.w >> (2 * quad)};
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    float x = logit_log2(sc[i], p.clamp);
    if (!all) {  // column 8g + 2*quad + e of the tile
      const int g = i / 4, shift = 8 * (g % 4) + i % 2;
      if (!((att[g / 4] >> shift) & 1))
        x = ((inr[g / 4] >> shift) & 1) ? kNegInf2 : -INFINITY;
    }
    sc[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m_run[r] - mx[r]);
    m_run[r] = mx[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const int r = (i / 2) % 2;
    const float pr = ex2(sc[i] - m_run[r]);
    sc[i] = pr;
    l_run[r] += pr;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using T = Tile<D>;
  constexpr int kS = T::kStages;
  constexpr int kAcc = T::kDP / 2;  // O accumulators per thread
  extern __shared__ __align__(1024) uint8_t smem[];
  // 128-byte swizzled tiles need 1024-byte alignment; the dynamic shared
  // memory of a kernel without static shared memory starts there
  if ((smem_u32(smem) & 1023u) != 0) __trap();
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + T::kBytes;           // kS tiles
  const uint32_t sV = sK + kS * T::kBytes;      // kS tiles
  const uint32_t bars = sV + kS * T::kBytes;    // mbarriers, then key words
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kS + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kS + s); };
  uint4* key_words = reinterpret_cast<uint4*>(smem + (bars - sQ) + 128);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.nk + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(k_full(s), 2);  // the K loads' arrival, the key words'
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: lane 0 issues every load; the warp also turns the
    // tile's 64 keys into bit words (attends, in range) beside K
    if (lane == 0) {
      prefetch_map(&p.q_map);
      prefetch_map(&p.k_map);
      prefetch_map(&p.v_map);
      mbar_expect_tx(q_full, T::kBytes);
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load(sQ + x * kBoxBytes, &p.q_map, q_full, x * kBoxCols, q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kS;
      if (j >= kS) mbar_wait(empty(s), ((j / kS) - 1) & 1);
      uint32_t in[2], att[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = j * kBlockN + 32 * half + lane;
        const bool inside = key < p.nk;
        const bool attends = inside && (p.mask == nullptr ||
                                        p.mask[b * p.m_sb + key] != 0);
        in[half] = __ballot_sync(0xffffffffu, inside);
        att[half] = __ballot_sync(0xffffffffu, attends);
      }
      if (lane == 0) {
        key_words[s] = make_uint4(att[0], att[1], in[0], in[1]);
        mbar_expect_tx(k_full(s), T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(sK + s * T::kBytes + x * kBoxBytes, &p.k_map, k_full(s),
                   x * kBoxCols, j * kBlockN, h, b);
        mbar_arrive(k_full(s));  // releases the key words
        mbar_expect_tx(v_full(s), T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(sV + s * T::kBytes + x * kBoxBytes, &p.v_map, v_full(s),
                   x * kBoxCols, j * kBlockN, h, b);
      }
      __syncwarp();
    }
    return;
  }

  // ---- the consumer warpgroup: thread (warp w, lane l) holds rows
  // 16w + l/4 (r = 0) and 16w + l/4 + 8 (r = 1) of the tile, and of each
  // 8-column group the columns 2*(l%4) and 2*(l%4) + 1.
  const int warp = tid >> 5;
  const int quad = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  // S = Q K_j^T into sc, issued and committed, not waited for
  auto issue_qk = [&](float (&sc)[kBlockN / 2], int j) {
    const int s = j % kS;
    mbar_wait(k_full(s), (j / kS) & 1);
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kQKSteps; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(sQ + off, 16, 1024),
                   sw128_desc(sK + s * T::kBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf2, kNegInf2};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};            // this thread's share of the sums
  float alpha[2];
  float sc[kBlockN / 2];          // S of one tile, then its probabilities
  uint32_t pa[kBlockN / 16][4];   // P of one tile: the A fragments of P V
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  };

  mbar_wait(q_full, 0);
  issue_qk(sc, 0);
  wgmma_wait_all();
  fence_regs(sc);
  softmax_tile(sc, p, key_words[0], quad, m_run, l_run, alpha);
  pack_p();

  // S_{j+1} = Q K_{j+1}^T and O += P_j V_j go to the tensor cores as one
  // group, back to back; then the softmax of tile j + 1, the rescale of O
  // and the next A fragments. Waiting for S_{j+1} alone, to run the
  // softmax beside P_j V_j, makes ptxas serialise every wgmma (C7514:
  // accumulators read inside a pipeline stage) and timed slower; the
  // other blocks on the SM fill the tensor cores during a softmax instead.
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kS;
    const bool next = j + 1 < n_tiles;
    fence_regs(acc);  // before any product of this round starts
    if (next) issue_qk(sc, j + 1);
    mbar_wait(v_full(s), (j / kS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               sw128_desc(sV + s * T::kBytes + kk * 16 * 128, kBoxBytes, 1024),
               1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));
    if (next) {
      fence_regs(sc);
      softmax_tile(sc, p, key_words[(j + 1) % kS], quad, m_run, l_run, alpha);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i / 2) % 2];
      pack_p();
    }
  }

  // epilogue: the row sums across the quad, O / max(l, 1e-20) in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-20f);
    __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn;
#pragma unroll
    for (int g = 0; g < T::kDP / 8; ++g) {
      const int col = 8 * g + 2 * quad;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[4 * g + 2 * r] * inv, acc[4 * g + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && quad == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.nq + row] =
          m_run[r] * kLn2 + logf(fmaxf(l_run[r], 1e-30f));
  }
}

template <int D>
int launch(Params& p, int batch, const void* q, const void* k,
           const void* v, const long long* st, cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -999;
  CUresult res = cached_map(fn, &p.q_map, q, D, p.nq, p.heads, batch, st);
  if (res == CUDA_SUCCESS)
    res = cached_map(fn, &p.k_map, k, D, p.nk, p.heads, batch, st + 3);
  if (res == CUDA_SUCCESS)
    res = cached_map(fn, &p.v_map, v, D, p.nk, p.heads, batch, st + 6);
  if (res != CUDA_SUCCESS) return -1000 - static_cast<int>(res);
  constexpr int smem = Tile<D>::kSmem;
  static bool smem_set[64] = {};  // per device: the attribute is set once
  const cudaError_t err =
      set_smem_once(flash_fwd_sm90_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + kBlockM - 1) / kBlockM, p.heads, batch);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 forward. Strides in elements, (sb, sh, sn) of q, k, v (their tensor
// maps') and of o. mask and lse may be null. Returns 0 on success, a
// cudaError_t value when the launch failed, -1 for a head dim without a
// build, -999 without cuTensorMapEncodeTiled, -1000 - CUresult when a
// tensor map could not be encoded.
int v2ap_flash_fwd_sm90(int head_dim, const void* q, const void* k,
                        const void* v, const void* mask, void* o, void* lse,
                        int batch, int heads, int nq, int nk, long long q_sb,
                        long long q_sh, long long q_sn, long long k_sb,
                        long long k_sh, long long k_sn, long long v_sb,
                        long long v_sh, long long v_sn, long long o_sb,
                        long long o_sh, long long o_sn, long long m_sb,
                        float scale, float softclamp, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_sn, k_sb, k_sh,
                                k_sn, v_sb, v_sh, v_sn};
  Params p;
  p.mask = static_cast<const uint8_t*>(mask);
  p.m_sb = m_sb;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sn = o_sn;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.clamp = make_clamp(scale, softclamp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, q, k, v, strides, s);
    case 32: return launch<32>(p, batch, q, k, v, strides, s);
    case 64: return launch<64>(p, batch, q, k, v, strides, s);
    case 104: return launch<104>(p, batch, q, k, v, strides, s);
    default: return -1;
  }
}

}  // extern "C"
