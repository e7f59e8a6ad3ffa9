// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a): wgmma
// products on tiles that TMA brings into shared memory.
//
// Replaces, for bf16 inputs, the Pallas TPU backward kernels of
// v2ap_tpu/ops/flash_attention.py:
//   K4  _flash_bwd_dq_kernel :151 (_flash_bwd_impl :289, pallas_call :319)
//       and _packed_bwd_dq_kernel :524 (_packed_bwd_impl :635, :662):
//       dq = scale * sum_k ds k;
//   K5  _flash_bwd_dkv_kernel :184 (pallas_call :335) and
//       _packed_bwd_dkv_kernel :559 (:677): dv = sum_q p^T dO,
//       dk = sum_q ds^T (q * scale);
// with _recompute_p's semantics (:131-148). f32 inputs stay on the
// CUDA-core kernels of flash_bwd.cu: the tensor cores would round them.
//
// Each kernel recomputes, tile by tile,
//   s_c = softclamp((q * scale) k^T)     in log2 units, as the forward did
//   p   = exp(s_c - lse)                 (lse from the forward, K3)
//   p   = 0 where the key is masked, past nk, or the row past nq
//   dp  = dO v^T,  ds = p (dp - D) (1 - (s_c / c)^2)
// where D = rowsum(dO * O) comes from outside, as in JAX. Masked
// probabilities are forced to 0 by a select, never trusted to underflow: a
// batch element whose keys are all masked stored lse ~ -1e30, and
// exp(s - lse) would be 1 (in f32, inf) for every key. Such an element
// gets exactly zero gradients.
//
// Two kernels and no atomics, the JAX structure: K4 owns a 64-row q tile
// and streams the key tiles, K5 owns a 64-key tile and streams the q tiles.
// Every sum runs in a fixed order, so two calls on the same inputs give
// bit-equal gradients.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the function
// (dq, dk, dv from q, k, v, dO, lse, D) is five products, 10*b*h*nq*nk*d
// FLOP, which chip_smoke.py's bound splits as K4 6 (S, dP, dS K) and K5 4
// (P^T dO, dS^T Q); K5 also recomputes S and dP, 4 more units the bound
// does not count (14 in all). At the training shapes (nq = nk = 782, d =
// 64) that is hundreds of FLOP per byte of q, k, v, dO and the gradients:
// the tensor cores set the bound. The pace is set elsewhere, though: per
// logit each kernel spends three multi-function-unit operations (the
// softclamp's exp2 and reciprocal, p's exp2), ~0.06 ms per kernel at that
// shape against ~0.03 ms of tensor-core work. What the design does: the
// (nq, nk) scores never leave registers; the products run on wgmma with
// f32 accumulators; P and dS go to bf16 in registers as the A operands of
// the next products (the f32 accumulator layout of m64nNk16 is the
// A-fragment layout), and the B operands are read from the swizzled TMA
// tiles as they arrived, K-major or through wgmma's transpose bit, with no
// transposed copy; several blocks an SM (K4 three, K5 two at d <= 64), so
// that one block's products run while another's P and dS take the
// multi-function unit.
//
// Design:
// - K4 (dq). A block owns (b, h, a 64-row q tile): one consumer warpgroup
//   of 128 threads and one producer warp. TMA loads the Q and dO tiles
//   once; a ring of 64-key K/V tiles streams in; the producer turns each
//   tile's keys into two bit words (attends) with a ballot each. The
//   consumers keep their rows' lse (in log2 units) and D in registers.
//   S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands
//   K-major in shared memory; P and dS form in the accumulators; dQ += dS
//   K runs with dS as the register A operand and K read MN-major through
//   the transpose bit (as the forward reads V for P V), N = the padded d.
//   The next tile's S and dP go to the tensor cores in one group with this
//   tile's dQ product. Three blocks an SM at d <= 64: ptxas then caps a
//   thread at 126 registers and spills 144 bytes, and it timed faster than
//   two blocks at 138 registers without spills (PERF.md).
// - K5 (dk, dv). A block owns (b, h, a 64-key tile). TMA loads K and V
//   once; a ring streams Q, dO and each q tile's 64 lse and D values (the
//   producer warp loads those, +inf and 0 past nq). It computes the
//   transposed scores S^T = K Q^T and dP^T = V dO^T, both operands
//   K-major, so that P^T and dS^T are already A fragments: dV += P^T dO
//   and dK += dS^T Q read dO and Q through the transpose bit. dK is scaled
//   by `scale` at the store. dK and dV stay in registers through the
//   loop (64 f32 a thread at d <= 64, 128 at d = 104), so K5 waits for
//   each tile's S^T and dP^T before its gradient products: issuing the
//   next tile's with them needs 64 more and at two blocks an SM (a
//   thread's cap is 168 registers there: three warps of the two blocks
//   share an SM sub-partition's 16K) ptxas spilled and serialised the
//   wgmma; that timed slower (PERF.md). One block an SM at d = 104.
// - Softclamp is the forward's (sm90_common.cuh, logit_log2): the lse the
//   kernels read was stored from that same expression, so p sums to 1 over
//   a row; the derivative 1 - (s_c/c)^2 comes from that s_c.
// - Ragged lengths and masks. TMA fills rows past nq and nk with zeros.
//   Keys past nk or masked: p = 0 by a select on the key's bit (K4: the
//   producer's words, and a tile whose keys all attend skips the test; K5:
//   each thread's two keys, fixed for the block). Rows past nq get lse =
//   +inf, so p = exp2(-inf) = 0 exactly, and D = 0.
// - Precision. P and dS are rounded to bf16 before their products, the
//   accumulators stay f32 (dS = p (dp - D) cancels in f32 first).
// - Head dim. A box is 64 columns (128 bytes, the swizzle span); d = 104
//   is two boxes over a map of inner extent 104 (columns 104-127 arrive as
//   zeros); S and dP run ceil(d/16) k16 steps, the gradient products N =
//   64 or 128, whose columns past d are never stored. d = 16 and 32 are one
//   zero-filled box.
// - Strides and alignment. TMA needs 16-byte aligned bases and strides of
//   q, k, v and dO; the gradients are stored from registers as bf16 pairs
//   through their own strides (4-byte aligned). The wrapper checks both
//   (ops/flash_attention.py, bwd_launch_plan) and raises ValueError.
// Not here: one fused kernel with an f32 dQ accumulated by atomics (half
// the multi-function-unit work, not deterministic), warp specialisation
// with setmaxnreg, a persistent grid.

#include "sm90_common.cuh"

namespace {

constexpr int kBlock = 64;  // q rows (K4) or keys (K5) of a block and of a tile
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBarBytes = 64;              // mbarriers, at most 8

// The settings at d <= 64, timed on the card against the others (PERF.md
// §6): K4 three blocks an SM, K5 two, three stages in both rings.
constexpr int kDqBlocks = 3;
constexpr int kDkvBlocks = 2;
constexpr int kStages64 = 3;

template <int D>
struct Shape {
  static constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kDP = kBoxes * kBoxCols;      // padded head dim
  static constexpr int kQKSteps = (D + 15) / 16;     // k16 steps over d
  static constexpr int kBytes = kBoxes * kBoxBytes;  // one 64-row tile
  static constexpr int kAcc = kDP / 2;  // f32 per thread of a (64, kDP) tile
};

// K4: Q and dO once, a ring of K and V tiles, the key words
template <int D>
struct DqTile : Shape<D> {
  using S = Shape<D>;
  static constexpr int kStages = S::kBoxes == 1 ? kStages64 : 2;
  static constexpr int kMinBlocks = S::kBoxes == 1 ? kDqBlocks : 1;
  static constexpr int kSmem =
      S::kBytes * (2 + 2 * kStages) + kBarBytes + 8 * kStages;
};

// K5: K and V once, a ring of Q and dO tiles with their lse and D rows
template <int D>
struct DkvTile : Shape<D> {
  using S = Shape<D>;
  static constexpr int kStages = S::kBoxes == 1 ? kStages64 : 3;
  static constexpr int kMinBlocks = S::kBoxes == 1 ? kDkvBlocks : 1;
  static constexpr int kSmem = S::kBytes * (2 + 2 * kStages) + kBarBytes +
                               2 * kStages * kBlock * 4;
};

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;  // (d, n, h, b) bf16, 64 x 64 boxes
  const uint8_t* mask;                      // (b, nk), nonzero == attend; null == all
  long long m_sb;
  const float* lse;                         // (b, h, nq), from the forward
  const float* delta;                       // (b, h, nq), rowsum(dO * O)
  __nv_bfloat16* g0;                        // dq (K4) or dk (K5)
  long long g0_sb, g0_sh, g0_sn;
  __nv_bfloat16* g1;                        // dv (K5)
  long long g1_sb, g1_sh, g1_sn;
  int heads, nq, nk;
  float scale;
  float inv_clamp;                          // 1 / (c log2(e)); 0: no softclamp
  Clamp clamp;
};

// ----------------------------------------------------------------- kernels

// p and ds of one logit, in place: s (the raw Q K^T product) becomes p,
// dp (the dO V^T product) becomes ds. lse2 is the row's lse in log2 units,
// dd its D.
__device__ __forceinline__ void grad_logit(float& s, float& dp, float lse2,
                                           float dd, bool attends,
                                           const BwdParams& p) {
  const float x = logit_log2(s, p.clamp);
  const float pr = attends ? ex2(x - lse2) : 0.f;
  float ds = pr * (dp - dd);
  if (p.clamp.on) {
    const float r = x * p.inv_clamp;
    ds *= 1.f - r * r;
  }
  s = pr;
  dp = ds;
}

// The A fragments of a (64 x 64) f32 accumulator tile, rounded to bf16.
__device__ __forceinline__ void pack_frags(const float (&t)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(t[8 * kk + 2 * x], t[8 * kk + 2 * x + 1]);
}

// Two (64 x 64) products of k16 steps over d, both operands K-major:
// c1 = A1 B1^T and c2 = A2 B2^T, issued, not committed.
template <int D>
__device__ __forceinline__ void issue_scores(float (&c1)[32], uint32_t a1,
                                             uint32_t b1, float (&c2)[32],
                                             uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) c1[i] = c2[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Shape<D>::kQKSteps; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64(c1, sw128_desc(a1 + off, 16, 1024),
                 sw128_desc(b1 + off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < Shape<D>::kQKSteps; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64(c2, sw128_desc(a2 + off, 16, 1024),
                 sw128_desc(b2 + off, 16, 1024), kk > 0);
  }
}

// acc (64 x kDP) += A (64 x 64, registers) . B (64 rows x kDP of a tile in
// shared memory, MN-major through the transpose bit), issued.
template <int N>
__device__ __forceinline__ void issue_grad(float (&acc)[N],
                                           const uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, a[kk], sw128_desc(tile + kk * 16 * 128, kBoxBytes, 1024), 1);
}

// A (64 x kDP) f32 gradient tile, times `mul`, as bf16 pairs: rows
// row0 + 8r below n, columns below D.
template <int D, int N>
__device__ __forceinline__ void store_tile(const float (&acc)[N],
                                           __nv_bfloat16* base, long long sn,
                                           int row0, int n, int quad,
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* o = base + row * sn;
#pragma unroll
    for (int g = 0; g < Shape<D>::kDP / 8; ++g) {
      const int col = 8 * g + 2 * quad;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
    }
  }
}

// Consumer thread (warp w, lane l) holds, of every (64 x N) accumulator
// tile, rows 16w + l/4 (r = 0) and 16w + l/4 + 8 (r = 1), and of each
// 8-column group g the columns 8g + 2*(l%4) + e: register 4g + 2r + e.

template <int D>
__global__ void __launch_bounds__(kThreads, DqTile<D>::kMinBlocks)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ BwdParams p) {
  using T = DqTile<D>;
  constexpr int kS = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem[];
  if ((smem_u32(smem) & 1023u) != 0) __trap();
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + T::kBytes;           // dO
  const uint32_t sK = sO + T::kBytes;           // kS tiles
  const uint32_t sV = sK + kS * T::kBytes;      // kS tiles
  const uint32_t bars = sV + kS * T::kBytes;
  const uint32_t q_full = bars;
  auto kv_full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kS + s); };
  uint2* key_words = reinterpret_cast<uint2*>(smem + (bars - sQ) + kBarBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.nk + kBlock - 1) / kBlock;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(kv_full(s), 2);  // the loads' arrival, the key words'
      mbar_init(empty(s), kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: lane 0 issues every load; the warp turns each
    // tile's 64 keys into two bit words (attends: in range, not masked)
    if (lane == 0) {
      prefetch_map(&p.q_map);
      prefetch_map(&p.k_map);
      prefetch_map(&p.v_map);
      prefetch_map(&p.do_map);
      mbar_expect_tx(q_full, 2 * T::kBytes);
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load(sQ + x * kBoxBytes, &p.q_map, q_full, x * kBoxCols, q0, h, b);
        tma_load(sO + x * kBoxBytes, &p.do_map, q_full, x * kBoxCols, q0, h,
                 b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kS;
      if (j >= kS) mbar_wait(empty(s), ((j / kS) - 1) & 1);
      uint32_t att[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = j * kBlock + 32 * half + lane;
        att[half] = __ballot_sync(
            0xffffffffu, key < p.nk && (p.mask == nullptr ||
                                        p.mask[b * p.m_sb + key] != 0));
      }
      if (lane == 0) {
        key_words[s] = make_uint2(att[0], att[1]);
        mbar_expect_tx(kv_full(s), 2 * T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(sK + s * T::kBytes + x * kBoxBytes, &p.k_map, kv_full(s),
                   x * kBoxCols, j * kBlock, h, b);
          tma_load(sV + s * T::kBytes + x * kBoxBytes, &p.v_map, kv_full(s),
                   x * kBoxCols, j * kBlock, h, b);
        }
        mbar_arrive(kv_full(s));  // releases the key words
      }
      __syncwarp();
    }
    return;
  }

  const int warp = tid >> 5;
  const int quad = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const long long rows = (static_cast<long long>(b) * p.heads + h) * p.nq;
  float lse2[2], dd[2];  // this thread's two rows: lse in log2 units, D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.nq ? p.lse[rows + row] * kLog2e : INFINITY;
    dd[r] = row < p.nq ? p.delta[rows + row] : 0.f;
  }

  float acc[T::kAcc];     // dQ / scale
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
  float sc[32], dp[32];   // S and dP of one tile, then P and dS
  uint32_t dsa[4][4];     // dS of one tile: the A fragments of dS K

  auto scores = [&](int j) {
    const int s = j % kS;
    mbar_wait(kv_full(s), (j / kS) & 1);
    issue_scores<D>(sc, sQ, sK + s * T::kBytes, dp, sO, sV + s * T::kBytes);
  };
  auto form = [&](int j) {
    const uint2 kw = key_words[j % kS];
    // every key attends: the common case, the same for the whole warpgroup
    const bool all = (kw.x & kw.y) == 0xffffffffu;
    const uint32_t att[2] = {kw.x >> (2 * quad), kw.y >> (2 * quad)};
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // column 8g + 2*quad + e of the tile
      const int g = i / 4, r = (i / 2) % 2;
      const bool attends = all || ((att[g / 4] >> (8 * (g % 4) + i % 2)) & 1);
      grad_logit(sc[i], dp[i], lse2[r], dd[r], attends, p);
    }
    pack_frags(dp, dsa);
  };

  mbar_wait(q_full, 0);
  scores(0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);
  form(0);

  // S_{j+1}, dP_{j+1} and dQ += dS_j K_j go to the tensor cores as one
  // group; then P and dS of tile j + 1 on its results.
  for (int j = 0; j < n_tiles; ++j) {
    const bool next = j + 1 < n_tiles;
    fence_regs(acc);
    fence_regs(dsa);
    if (next) scores(j + 1);
    wgmma_fence();
    issue_grad(acc, dsa, sK + (j % kS) * T::kBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(j % kS));
    if (next) {
      fence_regs(sc);
      fence_regs(dp);
      form(j + 1);
    }
  }

  store_tile<D>(acc, p.g0 + b * p.g0_sb + h * p.g0_sh, p.g0_sn, row0, p.nq,
                quad, p.scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads, DkvTile<D>::kMinBlocks)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ BwdParams p) {
  using T = DkvTile<D>;
  constexpr int kS = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem[];
  if ((smem_u32(smem) & 1023u) != 0) __trap();
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + T::kBytes;
  const uint32_t sQ = sV + T::kBytes;           // kS tiles
  const uint32_t sO = sQ + kS * T::kBytes;      // kS tiles of dO
  const uint32_t bars = sO + kS * T::kBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kS + s); };
  // per stage: 64 lse values in log2 units, then 64 D values
  float* row_vals = reinterpret_cast<float*>(smem + (bars - sK) + kBarBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.nq + kBlock - 1) / kBlock;
  const long long rows = (static_cast<long long>(b) * p.heads + h) * p.nq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1 + 32);  // the loads' arrival, each lane's rows
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: lane 0 issues the loads, every lane writes two
    // rows' lse (log2 units; +inf past nq, so p = 0 there) and D
    if (lane == 0) {
      prefetch_map(&p.q_map);
      prefetch_map(&p.k_map);
      prefetch_map(&p.v_map);
      prefetch_map(&p.do_map);
      mbar_expect_tx(kv_full, 2 * T::kBytes);
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load(sK + x * kBoxBytes, &p.k_map, kv_full, x * kBoxCols, k0, h,
                 b);
        tma_load(sV + x * kBoxBytes, &p.v_map, kv_full, x * kBoxCols, k0, h,
                 b);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kS;
      if (i >= kS) mbar_wait(empty(s), ((i / kS) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(sQ + s * T::kBytes + x * kBoxBytes, &p.q_map, full(s),
                   x * kBoxCols, i * kBlock, h, b);
          tma_load(sO + s * T::kBytes + x * kBoxBytes, &p.do_map, full(s),
                   x * kBoxCols, i * kBlock, h, b);
        }
      }
      float* vals = row_vals + s * 2 * kBlock;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 32 * half + lane;
        const int row = i * kBlock + c;
        vals[c] = row < p.nq ? p.lse[rows + row] * kLog2e : INFINITY;
        vals[kBlock + c] = row < p.nq ? p.delta[rows + row] : 0.f;
      }
      mbar_arrive(full(s));
    }
    return;
  }

  const int warp = tid >> 5;
  const int quad = lane & 3;
  const int key0 = k0 + warp * 16 + (lane >> 2);
  bool key_ok[2];  // this thread's two keys: in range and attended
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    key_ok[r] = key < p.nk &&
                (p.mask == nullptr || p.mask[b * p.m_sb + key] != 0);
  }

  float dk[T::kAcc], dv[T::kAcc];  // dK / scale, dV
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];      // S^T and dP^T of one q tile, then P^T and dS^T
  uint32_t pa[4][4], dsa[4][4];  // their A fragments

  auto scores = [&](int i) {
    const int s = i % kS;
    mbar_wait(full(s), (i / kS) & 1);
    issue_scores<D>(sc, sK, sQ + s * T::kBytes, dp, sV, sO + s * T::kBytes);
  };
  auto form = [&](int i) {
    const float* vals = row_vals + (i % kS) * 2 * kBlock;
#pragma unroll
    for (int g = 0; g < 8; ++g) {  // q rows 8g + 2*quad + e of the tile
      const float2 l2 = *reinterpret_cast<const float2*>(vals + 8 * g + 2 * quad);
      const float2 d2 =
          *reinterpret_cast<const float2*>(vals + kBlock + 8 * g + 2 * quad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        grad_logit(sc[4 * g + 2 * r], dp[4 * g + 2 * r], l2.x, d2.x,
                   key_ok[r], p);
        grad_logit(sc[4 * g + 2 * r + 1], dp[4 * g + 2 * r + 1], l2.y, d2.y,
                   key_ok[r], p);
      }
    }
    pack_frags(sc, pa);
    pack_frags(dp, dsa);
  };
  auto finish = [&]() {  // the products issued so far, and their registers
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
  };

  // each q tile's S^T and dP^T first, then dV and dK as one group
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t s = i % kS;
    scores(i);
    finish();
    fence_regs(sc);
    fence_regs(dp);
    form(i);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    issue_grad(dv, pa, sO + s * T::kBytes);
    issue_grad(dk, dsa, sQ + s * T::kBytes);
    finish();
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_tile<D>(dk, p.g0 + b * p.g0_sb + h * p.g0_sh, p.g0_sn, key0, p.nk,
                quad, p.scale);
  store_tile<D>(dv, p.g1 + b * p.g1_sb + h * p.g1_sh, p.g1_sn, key0, p.nk,
                quad, 1.f);
}

// ------------------------------------------------------------------- host

template <int D, bool kDkv>
int launch(BwdParams& p, int batch, const void* q, const void* k,
           const void* v, const void* dout, const long long* st,
           cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -999;
  CUresult res = cached_map(fn, &p.q_map, q, D, p.nq, p.heads, batch, st);
  if (res == CUDA_SUCCESS)
    res = cached_map(fn, &p.k_map, k, D, p.nk, p.heads, batch, st + 3);
  if (res == CUDA_SUCCESS)
    res = cached_map(fn, &p.v_map, v, D, p.nk, p.heads, batch, st + 6);
  if (res == CUDA_SUCCESS)
    res = cached_map(fn, &p.do_map, dout, D, p.nq, p.heads, batch, st + 9);
  if (res != CUDA_SUCCESS) return -1000 - static_cast<int>(res);
  constexpr int smem = kDkv ? DkvTile<D>::kSmem : DqTile<D>::kSmem;
  auto kernel = kDkv ? flash_bwd_dkv_sm90_kernel<D> : flash_bwd_dq_sm90_kernel<D>;
  static bool smem_set[64] = {};  // per device: the attribute is set once
  const cudaError_t err = set_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(((kDkv ? p.nk : p.nq) + kBlock - 1) / kBlock, p.heads,
                  batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDkv>
int dispatch(int head_dim, BwdParams& p, int batch, const void* q,
             const void* k, const void* v, const void* dout,
             const long long* st, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, kDkv>(p, batch, q, k, v, dout, st, s);
    case 32: return launch<32, kDkv>(p, batch, q, k, v, dout, st, s);
    case 64: return launch<64, kDkv>(p, batch, q, k, v, dout, st, s);
    case 104: return launch<104, kDkv>(p, batch, q, k, v, dout, st, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// bf16 backward: K4 (dkv == 0: writes g0 = dq) or K5 (dkv != 0: writes
// g0 = dk, g1 = dv). strides: 19 values in elements, the (sb, sh, sn) of
// q, k, v and dO (their tensor maps'), of g0 and g1 (g1's unused by K4),
// then the mask's batch stride. lse and delta are contiguous f32 (b, h,
// nq); mask may be null. Returns 0 on success, a cudaError_t value when the
// launch failed, -1 for a head dim without a build, -999 without
// cuTensorMapEncodeTiled, -1000 - CUresult when a tensor map could not be
// encoded.
int v2ap_flash_bwd_sm90(int dkv, int head_dim, const void* q, const void* k,
                        const void* v, const void* dout, const void* mask,
                        const void* lse, const void* delta, void* g0, void* g1,
                        int batch, int heads, int nq, int nk,
                        const long long* strides, float scale, float softclamp,
                        void* stream) {
  BwdParams p;
  p.mask = static_cast<const uint8_t*>(mask);
  p.m_sb = strides[18];
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = static_cast<__nv_bfloat16*>(g0);
  p.g0_sb = strides[12];
  p.g0_sh = strides[13];
  p.g0_sn = strides[14];
  p.g1 = static_cast<__nv_bfloat16*>(g1);
  p.g1_sb = strides[15];
  p.g1_sh = strides[16];
  p.g1_sn = strides[17];
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale = scale;
  p.clamp = make_clamp(scale, softclamp);
  p.inv_clamp = p.clamp.on ? 1.f / p.clamp.clamp_out : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dkv)
    return dispatch<true>(head_dim, p, batch, q, k, v, dout, strides, s);
  return dispatch<false>(head_dim, p, batch, q, k, v, dout, strides, s);
}

}  // extern "C"
