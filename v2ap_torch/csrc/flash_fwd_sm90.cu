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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockM = 64;          // q rows per block: one warpgroup
constexpr int kBlockN = 64;          // keys per K/V tile
constexpr int kBoxCols = 64;         // bf16 columns per TMA box: 128 bytes
constexpr int kBoxBytes = 64 * 128;  // one box of 64 rows
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
  int clamp;                        // 0: no softclamp
  float scale_log2;                 // scale * log2(e)
  float clamp_in;                   // 2 * scale * log2(e) / c
  float clamp_out;                  // c * log2(e)
};

// ------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a 4D tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// K-major operands: sbo = 1024 (8 rows of 128 bytes), lbo unused.
// MN-major operands: lbo = the stride between 64-column atoms, sbo = 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) {+}= A (64 x 16) . B (16 x 64), both bf16 in shared memory,
// K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16 in
// shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16 in
// shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

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
    float x;
    if (p.clamp) {
      const float t = ex2(sc[i] * p.clamp_in);
      x = p.clamp_out - 2.f * p.clamp_out * rcp(t + 1.f);
    } else {
      x = sc[i] * p.scale_log2;
    }
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
      const CUtensorMap* maps[3] = {&p.q_map, &p.k_map, &p.v_map};
      for (int m = 0; m < 3; ++m)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(maps[m]))
                     : "memory");
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

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (d, n, h, b) map of a bf16 (b, h, n, d) view with strides (sb, sh, sn)
// in elements (the wrapper checks that they are 16-byte multiples), boxes
// of 64 columns x 64 rows, zeros out of bounds.
CUresult encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                    int d, int n, int h, int b, const long long* st) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(n), cuuint64_t(h),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {kBoxCols, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The last kMapCache maps this thread encoded, by what they encode. A map
// holds an address, extents and strides and no reference to the memory, so
// an entry stays right whatever is freed or allocated there later.
struct MapKey {
  const void* ptr;
  long long d, n, h, b, sb, sh, sn;
};
constexpr int kMapCache = 32;

CUresult cached_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                    int d, int n, int h, int b, const long long* st) {
  struct Cache {
    MapKey key[kMapCache];
    CUtensorMap map[kMapCache];
    int size = 0, next = 0;
  };
  thread_local Cache cache;
  const MapKey key{ptr, d, n, h, b, st[0], st[1], st[2]};
  for (int i = 0; i < cache.size; ++i) {
    if (memcmp(&cache.key[i], &key, sizeof key) == 0) {
      *map = cache.map[i];
      return CUDA_SUCCESS;
    }
  }
  const CUresult res = encode_map(fn, map, ptr, d, n, h, b, st);
  if (res == CUDA_SUCCESS) {
    cache.key[cache.next] = key;
    cache.map[cache.next] = *map;
    cache.next = (cache.next + 1) % kMapCache;
    if (cache.size < kMapCache) ++cache.size;
  }
  return res;
}

template <int D>
int launch(Params& p, int batch, int padded_dim, const void* q,
           const void* k, const void* v, const long long* st,
           cudaStream_t stream) {
  if (padded_dim != Tile<D>::kDP) return -1;
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  const dim3 grid((p.nq + kBlockM - 1) / kBlockM, p.heads, batch);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 forward. Strides in elements, (sb, sh, sn) of q, k, v (their tensor
// maps') and of o. mask and lse may be null. Returns 0 on success, a
// cudaError_t value when the launch failed, -1 for a head dim / padded dim
// without a build, -999 without cuTensorMapEncodeTiled, -1000 - CUresult
// when a tensor map could not be encoded.
int v2ap_flash_fwd_sm90(int head_dim, int padded_dim, int box_cols,
                        const void* q, const void* k, const void* v,
                        const void* mask, void* o, void* lse, int batch,
                        int heads, int nq, int nk, long long q_sb,
                        long long q_sh, long long q_sn, long long k_sb,
                        long long k_sh, long long k_sn, long long v_sb,
                        long long v_sh, long long v_sn, long long o_sb,
                        long long o_sh, long long o_sn, long long m_sb,
                        float scale, float softclamp, void* stream) {
  if (box_cols != kBoxCols) return -1;
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
  p.clamp = softclamp > 0.f;
  p.scale_log2 = scale * kLog2e;
  p.clamp_in = p.clamp ? 2.f * scale * kLog2e / softclamp : 0.f;
  p.clamp_out = p.clamp ? softclamp * kLog2e : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, padded_dim, q, k, v, strides, s);
    case 32: return launch<32>(p, batch, padded_dim, q, k, v, strides, s);
    case 64: return launch<64>(p, batch, padded_dim, q, k, v, strides, s);
    case 104: return launch<104>(p, batch, padded_dim, q, k, v, strides, s);
    default: return -1;
  }
}

}  // extern "C"
