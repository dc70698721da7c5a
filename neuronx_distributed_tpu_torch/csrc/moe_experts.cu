// The routed SwiGLU expert product of a MoE decode step for Hopper
// (sm_90a): MX (bf16 experts) and MXq (int8 or fp8 e4m3 experts with f32
// scales), one source templated on the weight format.
//
// It replaces no `pallas_call`: it computes what XLA fuses on the TPU for
// JAX's selective-loading strategy (neuronx_distributed_tpu/modules/moe/
// expert_mlps.py:327 `_selective`), with the dequantize that
// `_declare_kernel` (parallel/layers.py:48) puts in the weights' load for
// quantized experts. For each token t and slot j of its top-k,
//   y_t = sum_j w_tj * down[e_tj] . (silu(gate[e_tj] . x_t) * (up[e_tj] . x_t))
// with JAX's rounding: a dequantized weight is bf16(f32(q) * scale), the
// gate and up outputs are bf16 before the activation, silu and the product
// round to bf16 (as torch's ops on bf16 do), each pair's down output rounds
// to bf16, and the combine sums the k slots in f32 in slot order with each
// affinity rounded to bf16 first. Every sum is f32.
//
// What bounds it on an H100 is bytes: every expert that some pair routes
// to must be read once (3 x 4096 x 14336 weights at Mixtral-8x7B width, 2 B
// each in bf16, 1 B with scales in int8 or fp8); 2 x 3 x H x I operations a
// pair are few for that many bytes (5.6 GFLOP a layer at 8 tokens).
//
// The design:
//  * a block owns 64 output rows of one expert's stack (and, for `down`, a
//    fixed share of its input columns: the split). The weights are the
//    `wgmma` A operand (rows as M, input columns as K: torch's (E, out, in)
//    is K-major), the expert's pairs the B operand (N = NP pairs a pass, 8
//    or 16, K-major in shared memory), so every pair of an expert shares
//    one pass over its rows: a top-2 decode step's 16 pairs at most, skewed
//    routes included (more pairs take further passes). Gate and up
//    share the block: two products a k-step, both sums in registers for
//    the SwiGLU epilogue;
//  * one producer warp keeps a ring of stages in flight behind mbarrier
//    full/empty pairs: each stage is a 64-row x 128-byte box of each stack
//    by TMA (2-D tensor maps over (E * out, in), 128-byte swizzle), and the
//    pairs' input columns for the same k range by cp.async, gathered by the
//    pair list. The grid is E x row tiles x split from the shapes alone,
//    and a block lists its expert's pairs itself: a block whose expert no
//    pair routes to returns before it reads a weight, so an untouched
//    expert is not read and a touched one is read once a pass;
//  * bf16 weights feed `wgmma` from shared memory (both operands K-major,
//    B128 descriptors). Codes are dequantized by the consumer warpgroup
//    into A fragments in registers, two half-stages in flight: a thread
//    reads 16 contiguous bytes of each of its two rows a half-stage, and
//    the pairs' inputs are permuted to match (within each 128-column box,
//    physical column 32 t + 4 kk + j of the weights is column 16 kk + 2 t +
//    (j & 1) + 8 (j >> 1) of the product, which is where thread
//    column-quad t keeps code j of k-step kk): x by a first launch, the
//    activations by the gate/up epilogue, which writes them both in order
//    and permuted;
//  * the dequantize takes no conversion instruction: an int8 code q, xor
//    0x80, is put by `prmt` into the low byte of 2^23 (0x4B000000), and
//    2^23 + 128 taken off gives f32(q) exactly; an e4m3 code's sign and 7
//    magnitude bits shifted into an f32's sign, exponent and mantissa are
//    2^-120 times its value (subnormal codes too), so a multiply by 2^120
//    (exact) and one by the scale give __fmul_rn(f32(q), scale) of every
//    finite code (the NaN codes 0x7F / 0xFF, which the quantizer never
//    writes, read as 480); `cvt.rn.bf16x2.f32` rounds two of them to bf16,
//    packed as the fragment wants them. A code costs ~4.5 instructions
//    (int8: prmt, add, mul, half a cvt) or ~6.3 (fp8: prmt, shift, lop3,
//    two muls, half a cvt) in the stage loop, where the CUDA-core kernel
//    this replaced spent an I2F (or an fp8 unpack), a multiply and an
//    F2F round trip on each, then an FMA for each of up to 8 pairs;
//  * `down` (K = I) is cut into `split` column shares so that enough
//    blocks work when few experts are touched; each writes its f32 partial
//    sums, and the combine adds the shares in order before the round to
//    bf16. Three launches (four for codes: x permuted first): (1) gate and
//    up with the SwiGLU epilogue into a (pairs, I) bf16 scratch, (2) down
//    into a (split, pairs, H) f32 scratch, (3) the combine: each pair's
//    down output (written to a (pairs, H) bf16 scratch) and each token's k
//    pairs in slot order. No atomics: the result is the same bits at every
//    run, as the serving engine's captured = eager streams need.
// At Mixtral-8x7B's shapes and 8 tokens it reads 1.08x its bytes bound in
// bf16, 1.17x in int8 and 1.31x in fp8 (`chip_moe_ab.py --kernel`, one
// H100 SXM at 700 W; PERF.md).
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nxd_hopper;

constexpr int MAX_PAIRS = 256;       // (token, slot) pairs a call
constexpr int ROWS = 64;             // output rows a block: one wgmma M
constexpr int CONSUMERS = 128;       // one warpgroup
constexpr int PRODUCER = CONSUMERS / 32;  // the producer's warp
constexpr int THREADS = CONSUMERS + 32;
constexpr int BOX = ROWS * 128;      // one weight box: 64 rows x 128 bytes
constexpr int MAX_SPLIT = 8;         // down's column shares at most
constexpr int COMBINE_THREADS = 256;
constexpr int QBOX = 128;            // the columns of a code box: the permutation's period

enum { FMT_BF16 = 0, FMT_INT8 = 1, FMT_FP8 = 2 };

// A ring stage: MATS weight boxes of the same k range, then the pairs'
// columns of that range as SLABS K-major slabs of NP rows x 64 bf16. The
// ring is 96 KB (two blocks an SM) for bf16 at 16 pairs a pass, else
// 64 KB (three where the registers allow): the faster of the two for
// each kernel at Mixtral-8x7B's shapes, T = 1 and 8 (`chip_moe_ab.py
// --kernel` on an H100; the code kernels' gate/up, at 130-150 registers,
// run two blocks an SM either way).
template <int FMT, int MATS, int NP>
struct Shape {
  static constexpr int KB = FMT == FMT_BF16 ? 64 : 128;  // input columns a stage
  static constexpr int SLABS = KB / 64;
  static constexpr int STAGE = MATS * BOX + SLABS * NP * 128;  // a multiple of 1024
  static constexpr int RING = (FMT == FMT_BF16 && NP == 16 ? 96 : 64) * 1024;
  static constexpr int STAGES = RING / STAGE < 2 ? 2 : (RING / STAGE > 8 ? 8 : RING / STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack for the 1024-byte alignment
};

struct Params {
  const __nv_bfloat16* in;  // the pairs' inputs: pair p reads row p / in_div, in the
  int in_div, pitch;        // product's column order (permuted for codes), pitch columns a row
  const int* pair_expert;
  int n_all;
  const float* s0;  // per-row scales (E * R) of the codes, or null
  const float* s1;
  int R, C, split;
  __nv_bfloat16* act;   // gate/up: (pairs, R) bf16
  __nv_bfloat16* actp;  // gate/up, codes: act permuted, (pairs, actp_pitch), or null
  int actp_pitch;
  float* part;          // down: (split, pairs, R) f32
};

// Where the product reads physical column P (0..127) of a code box.
__device__ __forceinline__ int permuted(int P) {
  return 16 * ((P >> 2) & 7) + 2 * (P >> 5) + (P & 1) + 8 * ((P >> 1) & 1);
}

// ---------------------------------------------------------------- wgmma
// acc (64 x N) (+)= A B^T, B (N x 16) K-major from shared memory: A from
// shared memory (wgmma_ss, K-major) or as bf16 fragments in registers
// (wgmma_rs); the descriptors advance by OA / OB 16-byte units inside the
// instruction; `acc` 0 starts the sum from zero.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "add.s64 a, %4, %7;\n"
      "add.s64 b, %5, %8;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, a, b, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
}
template <int OB>
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "add.s64 b, %8, %10;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, b, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "add.s64 a, %8, %11;\n"
      "add.s64 b, %9, %12;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, a, b, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
}
template <int OB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 b;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "add.s64 b, %12, %14;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, b, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(OB));
}

// k-steps KK.. of a bf16 stage: MATS products a k-step, 4 k-steps (64
// columns, one slab) a stage.
template <int MATS, int NP, int KK = 0>
__device__ __forceinline__ void ss_stage(float (&acc)[MATS][NP / 2], const unsigned char* sw,
                                         uint64_t db, int accumulate) {
  const int a = KK > 0 ? 1 : accumulate;
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    wgmma_ss<kmajor_step(ROWS, KK), kmajor_step(NP, KK)>(acc[m], desc_kmajor(sw + m * BOX, 0), db,
                                                         a);
  if constexpr (KK < 3) ss_stage<MATS, NP, KK + 1>(acc, sw, db, accumulate);
}

// Half-stage HALF (k-steps 4 HALF .. 4 HALF + 3) of a code stage.
template <int MATS, int NP, int HALF, int KK = 0>
__device__ __forceinline__ void rs_half(float (&acc)[MATS][NP / 2], const uint32_t (&a)[MATS][4][4],
                                        uint64_t db, int accumulate) {
  const int ac = (HALF > 0 || KK > 0) ? 1 : accumulate;
#pragma unroll
  for (int m = 0; m < MATS; ++m) wgmma_rs<kmajor_step(NP, 4 * HALF + KK)>(acc[m], a[m][KK], db, ac);
  if constexpr (KK < 3) rs_half<MATS, NP, HALF, KK + 1>(acc, a, db, accumulate);
}

template <int MATS, int N>
__device__ __forceinline__ void fence_acc(float (&acc)[MATS][N]) {
#pragma unroll
  for (int m = 0; m < MATS; ++m) fence_regs(acc[m]);
}
template <int MATS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[MATS][4][4]) {
#pragma unroll
  for (int m = 0; m < MATS; ++m) fence_regs(a[m]);
}

// ----------------------------------------------------------- dequantize
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four int8 codes of `w` (byte j) as bf16(f32(q) * s): (j0, j1) into
// lo, (j2, j3) into hi. 0x4B0000uu is the f32 2^23 + uu, exact.
__device__ __forceinline__ void dq_int8(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fmul_rn(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | j)),
                               8388736.f),
                     s);
  lo = pack_bf16x2(f[0], f[1]);
  hi = pack_bf16x2(f[2], f[3]);
}

// The four e4m3 codes of `w` the same way: byte j at the top of a word,
// shifted right by 4 with its sign, the sign copies cleared: the code's
// sign, exponent and mantissa in an f32's, 2^-120 times its value.
__device__ __forceinline__ void dq_fp8(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int top = static_cast<int>(__byte_perm(w, 0u, 0x0444u | (j << 12)));
    const float v = __uint_as_float(static_cast<uint32_t>(top >> 4) & 0x87FFFFFFu);
    f[j] = __fmul_rn(__fmul_rn(v, 0x1p120f), s);
  }
  lo = pack_bf16x2(f[0], f[1]);
  hi = pack_bf16x2(f[2], f[3]);
}

// ------------------------------------------------------------- producer
// Fill the ring in the order the consumers read it: pass after pass, the
// block's k range box by box. Lane 0 brings the weight boxes by TMA; the
// lanes copy the pass's pairs' columns in 16-byte chunks to their swizzled
// places (``src`` holds each listed pair's input row). Columns past the
// pitch arrive as zeros; rows of the stage past the pass's pairs are left
// as they are (they only reach accumulator columns never read).
template <int FMT, int MATS, int NP>
__device__ __forceinline__ void produce(const CUtensorMap* tm0, const CUtensorMap* tm1,
                                        const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, const int* src, int n, int e, int row0,
                                        int kb0, int steps, int passes, int lane) {
  using S = Shape<FMT, MATS, NP>;
  const int iters = passes * steps;
  for (int it = 0; it < iters; ++it) {
    const int st = it % S::STAGES, use = it / S::STAGES;
    if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
    const int pass = it / steps, kb = kb0 + it - pass * steps;
    unsigned char* sw = ring + st * S::STAGE;
    unsigned char* sb = sw + MATS * BOX;
    const int c0 = kb * S::KB;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[st], MATS * BOX);
      tma_load_2d(sw, tm0, &full[st], c0, e * p.R + row0);
      if constexpr (MATS == 2) tma_load_2d(sw + BOX, tm1, &full[st], c0, e * p.R + row0);
    }
    const int first = pass * NP, nv = min(NP, n - first);
    constexpr int CH = S::SLABS * 8;  // 16-byte chunks of a pair's columns a stage
    for (int i = lane; i < nv * CH; i += 32) {
      const int j = i / CH, c = i % CH, col = c0 + 8 * c;
      cp_async16(sb + (c >> 3) * NP * 128 + j * 128 + (((c & 7) ^ (j & 7)) << 4),
                 p.in + (size_t)src[first + j] * p.pitch + min(col, p.pitch - 8),
                 col < p.pitch ? 16 : 0);
    }
    cp_async_mbar_arrive(&full[st]);
  }
  cp_async_wait_all();
}

// ------------------------------------------------------------ consumers
// One pass of bf16 stages: products from shared memory; a stage is released
// once the products that read it are done (the next stage's are issued).
template <int MATS, int NP>
__device__ __forceinline__ void consume_bf16(float (&acc)[MATS][NP / 2], unsigned char* ring,
                                             uint64_t* full, uint64_t* empty, int it0,
                                             int steps) {
  using S = Shape<FMT_BF16, MATS, NP>;
  int prev = 0;
  for (int step = 0; step < steps; ++step) {
    const int it = it0 + step, st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const unsigned char* sw = ring + st * S::STAGE;
    wgmma_fence();
    ss_stage<MATS, NP>(acc, sw, desc_kmajor(sw + MATS * BOX, 0), step > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (step > 0) mbar_arrive(&empty[prev]);
    prev = st;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive(&empty[prev]);
}

// This thread's 16 bytes of half-stage HALF of each (matrix, row) as A
// fragments: row rl + 8 h (h = 0, 1) of box m, chunk 2 t4 + HALF; word kk
// holds the four codes of k-step 4 HALF + kk.
template <int FMT, int MATS, int HALF>
__device__ __forceinline__ void dequant_half(uint32_t (&a)[MATS][4][4], const unsigned char* sw,
                                             const float (&sc)[MATS][2], int rl, int t4) {
  uint4 raw[MATS][2];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      raw[m][h] = *reinterpret_cast<const uint4*>(sw + m * BOX + r * 128 +
                                                  (((2 * t4 + HALF) ^ (r & 7)) << 4));
    }
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t wv[4] = {raw[m][h].x, raw[m][h].y, raw[m][h].z, raw[m][h].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (FMT == FMT_INT8)
          dq_int8(wv[kk], sc[m][h], a[m][kk][h], a[m][kk][2 + h]);
        else
          dq_fp8(wv[kk], sc[m][h], a[m][kk][h], a[m][kk][2 + h]);
      }
    }
}

// One pass of code stages, two half-stages of fragments in flight: a
// half's fragments are rewritten once the products that read them are
// done, and a stage is released once both its halves' products are.
template <int FMT, int MATS, int NP>
__device__ __forceinline__ void consume_codes(float (&acc)[MATS][NP / 2], unsigned char* ring,
                                              uint64_t* full, uint64_t* empty, int it0,
                                              int steps, const float (&sc)[MATS][2], int rl,
                                              int t4) {
  using S = Shape<FMT, MATS, NP>;
  uint32_t a0[MATS][4][4], a1[MATS][4][4];
  int prev = 0;
  for (int step = 0; step < steps; ++step) {
    const int it = it0 + step, st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const unsigned char* sw = ring + st * S::STAGE;
    const uint64_t db = desc_kmajor(sw + MATS * BOX, 0);
    wgmma_wait<1>();  // the products that read a0 are done
    fence_frags(a0);
    dequant_half<FMT, MATS, 0>(a0, sw, sc, rl, t4);
    wgmma_fence();
    rs_half<MATS, NP, 0>(acc, a0, db, step > 0);
    wgmma_commit();
    wgmma_wait<1>();  // those that read a1, and with them the previous stage
    fence_frags(a1);
    if (step > 0) mbar_arrive(&empty[prev]);
    dequant_half<FMT, MATS, 1>(a1, sw, sc, rl, t4);
    wgmma_fence();
    rs_half<MATS, NP, 1>(acc, a1, db, 1);
    wgmma_commit();
    prev = st;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frags(a0);
  fence_frags(a1);
  mbar_arrive(&empty[prev]);
}

// out[p, r] for every pair p routed to expert blockIdx.y and every row r
// of this block's 64: MATS == 2 -> act, bf16(bf16(silu(bf16(g))) * bf16(u))
// with g, u the pair's input . gate[e, r] and . up[e, r]; MATS == 1 ->
// part[split share, p, r], the f32 sum of the share's columns of the
// input . down[e, r]. The grid is (row tiles x split, E).
template <int FMT, int MATS, int NP>
__global__ void __launch_bounds__(THREADS, 2)
    routed_mma_kernel(const __grid_constant__ CUtensorMap tm0,
                      const __grid_constant__ CUtensorMap tm1, const __grid_constant__ Params p) {
  using S = Shape<FMT, MATS, NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  __shared__ int pairs[MAX_PAIRS], src[MAX_PAIRS];  // listed pairs, their input rows
  __shared__ int n_pairs;
  const int e = blockIdx.y, tile = blockIdx.x / p.split, share = blockIdx.x % p.split;
  const int row0 = tile * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = 16 * warp + (lane >> 2), t4 = lane & 3;  // a consumer's rows rl, rl + 8

  if (warp == PRODUCER) {  // the expert's pairs, in pair order
    int n = 0;
    for (int b = 0; b < p.n_all; b += 32) {
      const int q = b + lane;
      const bool hit = q < p.n_all && p.pair_expert[q] == e;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int at = n + __popc(mask & ((1u << lane) - 1));
        pairs[at] = q;
        src[at] = q / p.in_div;
      }
      n += __popc(mask);
    }
    if (lane == 0) {
      n_pairs = n;
      for (int s = 0; s < S::STAGES; ++s) {
        mbar_init(&full[s], 33);  // each lane's copies, and lane 0's transactions
        mbar_init(&empty[s], CONSUMERS);
      }
      mbar_init_fence();
    }
  }
  __syncthreads();
  const int n = n_pairs;
  if (n == 0) return;  // an expert no pair routes to is not read

  const int nkb = (p.C + S::KB - 1) / S::KB;
  const int kb0 = share * nkb / p.split, steps = (share + 1) * nkb / p.split - kb0;
  const int passes = (n + NP - 1) / NP;
  if (warp == PRODUCER) {
    produce<FMT, MATS, NP>(&tm0, &tm1, p, ring, full, empty, src, n, e, row0, kb0, steps, passes,
                           lane);
    return;
  }
  float sc[MATS][2];  // the scales of this thread's rows
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rl + 8 * h;
      const float* s = m == 0 ? p.s0 : p.s1;
      sc[m][h] = (FMT != FMT_BF16 && r < p.R) ? s[(size_t)e * p.R + r] : 1.f;
    }

  for (int pass = 0; pass < passes; ++pass) {
    float acc[MATS][NP / 2];
    if constexpr (FMT == FMT_BF16) {
      consume_bf16<MATS, NP>(acc, ring, full, empty, pass * steps, steps);
    } else {
      consume_codes<FMT, MATS, NP>(acc, ring, full, empty, pass * steps, steps, sc, rl, t4);
    }

    // acc[m][4 j + 2 h + c]: row rl + 8 h, pair column 8 j + 2 t4 + c
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int idx = pass * NP + 8 * j + 2 * t4 + c;
        if (idx >= n) continue;
        const size_t pr = pairs[idx];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + rl + 8 * h;
          if (r >= p.R) continue;
          const float a0 = acc[0][4 * j + 2 * h + c];
          if constexpr (MATS == 2) {
            const float g = bf16r(a0), u = bf16r(acc[MATS - 1][4 * j + 2 * h + c]);
            const float s = bf16r(g / (1.f + expf(-g)));
            const __nv_bfloat16 o = __float2bfloat16_rn(s * u);
            p.act[pr * p.R + r] = o;
            if (FMT != FMT_BF16)
              p.actp[pr * p.actp_pitch + (r & ~(QBOX - 1)) + permuted(r & (QBOX - 1))] = o;
          } else {
            p.part[((size_t)share * p.n_all + pr) * p.R + r] = a0;
          }
        }
      }
  }
}

// xp[t, b QBOX + permuted(P)] = x[t, b QBOX + P] (zeros past C): each
// token's input in the code product's column order, a thread 8 columns.
__global__ void __launch_bounds__(COMBINE_THREADS) moe_permute_kernel(
    const __nv_bfloat16* __restrict__ x, long long rows, int C, int pitch,
    __nv_bfloat16* __restrict__ xp) {
  const long long chunks = pitch / 8, i = blockIdx.x * (long long)COMBINE_THREADS + threadIdx.x;
  if (i >= rows * chunks) return;
  const long long r = i / chunks;
  const int col = (int)(i - r * chunks) * 8, P = col & (QBOX - 1);
  const uint4 v = col < C ? *reinterpret_cast<const uint4*>(x + r * C + col) : make_uint4(0, 0, 0, 0);
  uint32_t* dst = reinterpret_cast<uint32_t*>(xp + r * pitch + (col - P));
  dst[permuted(P) / 2] = v.x;  // columns P, P + 1
  dst[permuted(P + 2) / 2] = v.y;
  dst[permuted(P + 4) / 2] = v.z;
  dst[permuted(P + 6) / 2] = v.w;
}

// y[p, c] = bf16(sum over the split shares, in order, of part[s, p, c]);
// out[t, c] = bf16(sum_j bf16(w[t, j]) * y[t * k + j, c]), the slots summed
// in order in f32: a thread a token's 8 columns.
__global__ void __launch_bounds__(COMBINE_THREADS) moe_combine_kernel(
    const float* __restrict__ part, int split, const float* __restrict__ top_w, long long T, int k,
    int H, __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ out) {
  const long long vecs = H / 8;
  const long long i = blockIdx.x * (long long)COMBINE_THREADS + threadIdx.x;
  if (i >= T * vecs) return;
  const long long t = i / vecs, c = (i - t * vecs) * 8;
  const size_t share = (size_t)T * k * H / 4;  // in float4
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const long long pr = t * k + j;
    const float4* src = reinterpret_cast<const float4*>(part + pr * H + c);
    float4 sh[MAX_SPLIT][2];  // every share's 8 columns, loaded before any is added
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s)
      if (s < split) {
        sh[s][0] = src[s * share];
        sh[s][1] = src[s * share + 1];
      }
    float v[8] = {sh[0][0].x, sh[0][0].y, sh[0][0].z, sh[0][0].w,
                  sh[0][1].x, sh[0][1].y, sh[0][1].z, sh[0][1].w};
#pragma unroll
    for (int s = 1; s < MAX_SPLIT; ++s)
      if (s < split) {
        v[0] += sh[s][0].x; v[1] += sh[s][0].y; v[2] += sh[s][0].z; v[3] += sh[s][0].w;
        v[4] += sh[s][1].x; v[5] += sh[s][1].y; v[6] += sh[s][1].z; v[7] += sh[s][1].w;
      }
    const float w = bf16r(top_w[pr]);
    uint4 yo;
    __nv_bfloat162* yb = reinterpret_cast<__nv_bfloat162*>(&yo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      yb[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      const float2 f = __bfloat1622float2(yb[q]);
      acc[2 * q] = fmaf(w, f.x, acc[2 * q]);
      acc[2 * q + 1] = fmaf(w, f.y, acc[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(y + pr * H + c) = yo;
  }
  uint4 o;
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int q = 0; q < 4; ++q) ob[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
  *reinterpret_cast<uint4*>(out + t * H + c) = o;
}

template <int FMT, int MATS, int NP>
void launch_mma(const CUtensorMap& m0, const CUtensorMap& m1, const Params& p, int E,
                cudaStream_t st) {
  using S = Shape<FMT, MATS, NP>;
  auto kernel = routed_mma_kernel<FMT, MATS, NP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  const dim3 grid((p.R + ROWS - 1) / ROWS * p.split, E);
  kernel<<<grid, THREADS, S::SMEM, st>>>(m0, m1, p);
}

struct Buffers {
  const __nv_bfloat16* x;
  const int* pe;
  const float* top_w;
  const void *gate, *up, *down;
  const float *gs, *us, *ds;
  __nv_bfloat16 *act, *y;
  float* part;
  __nv_bfloat16 *out, *xp, *actp;  // xp, actp: codes only
};

constexpr int padded(int c) { return (c + QBOX - 1) / QBOX * QBOX; }

template <int FMT, int NP>
int launch_all(const Buffers& b, long long T, int k, int E, int H, int I, int split,
               cudaStream_t st) {
  constexpr int WB = FMT == FMT_BF16 ? 2 : 1;
  CUtensorMap mg, mu, md;
  int err;
  if ((err = encode_rows(&mg, b.gate, (long long)E * I, H, WB, ROWS))) return err;
  if ((err = encode_rows(&mu, b.up, (long long)E * I, H, WB, ROWS))) return err;
  if ((err = encode_rows(&md, b.down, (long long)E * H, I, WB, ROWS))) return err;
  const int n_all = (int)(T * k);
  const bool q = FMT != FMT_BF16;
  if (q) {
    const long long threads = T * (padded(H) / 8);
    moe_permute_kernel<<<(unsigned)((threads + COMBINE_THREADS - 1) / COMBINE_THREADS),
                     COMBINE_THREADS, 0, st>>>(b.x, T, H, padded(H), b.xp);
  }
  launch_mma<FMT, 2, NP>(mg, mu,
                         Params{q ? b.xp : b.x, k, q ? padded(H) : H, b.pe, n_all, b.gs, b.us, I,
                                H, 1, b.act, b.actp, padded(I), nullptr},
                         E, st);
  launch_mma<FMT, 1, NP>(md, md,
                         Params{q ? b.actp : b.act, 1, q ? padded(I) : I, b.pe, n_all, b.ds,
                                nullptr, H, I, split, nullptr, nullptr, 0, b.part},
                         E, st);
  const long long threads = T * (H / 8);
  moe_combine_kernel<<<(unsigned)((threads + COMBINE_THREADS - 1) / COMBINE_THREADS),
                       COMBINE_THREADS, 0, st>>>(b.part, split, b.top_w, T, k, H, b.y, b.out);
  return (int)cudaGetLastError();
}

template <int FMT>
int launch_fmt(int np, const Buffers& b, long long T, int k, int E, int H, int I, int split,
               cudaStream_t st) {
#define NXD_MX_NP(N) \
  if (np == N) return launch_all<FMT, N>(b, T, k, E, H, I, split, st);
  NXD_MX_NP(8)
  NXD_MX_NP(16)
#undef NXD_MX_NP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (T, H) bf16; pair_expert (T * k,) int32, the expert of pair t * k + j;
// top_w (T * k,) f32; gate, up (E, I, H) and down (E, H, I), contiguous and
// 16-byte aligned, bf16 (fmt 0), int8 (1) or fp8 e4m3 (2) codes with f32
// scales gate_s, up_s (E, I) and down_s (E, H) (ignored for bf16); act (T *
// k, I) and y (T * k, H) bf16 scratch, part (split, T * k, H) f32 scratch;
// out (T, H) bf16; for codes also xp (T, H') and actp (T * k, I') bf16
// scratch, H' and I' the widths rounded up to 128 (actp zeroed where I' >
// I), else null. H and I multiples of 16, T * k <= 256; np (pairs a pass:
// 8 or 16) and split (down's column shares, 1 .. min(8, max(1, I /
// 128))) from the wrapper's plan. Returns cudaGetLastError() after the launches,
// or a code from hopper.cuh when a tensor map cannot be made.
extern "C" int nxd_moe_experts_fwd(const void* x, const void* pair_expert, const void* top_w,
                                   const void* gate, const void* up, const void* down,
                                   const void* gate_s, const void* up_s, const void* down_s,
                                   void* act, void* y, void* part, void* out, void* xp, void* actp,
                                   long long T, int k, int E, int H, int I, int fmt, int np,
                                   int split, void* stream) {
  if (T == 0) return 0;
  if (T * k > MAX_PAIRS || H % 16 || I % 16 || split < 1 || split > MAX_SPLIT ||
      split > (I < 256 ? 1 : I / 128) ||
      (fmt != FMT_BF16 && (xp == nullptr || actp == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const Buffers b{static_cast<const bf*>(x), static_cast<const int*>(pair_expert),
                  static_cast<const float*>(top_w), gate, up, down,
                  static_cast<const float*>(gate_s), static_cast<const float*>(up_s),
                  static_cast<const float*>(down_s), static_cast<bf*>(act), static_cast<bf*>(y),
                  static_cast<float*>(part), static_cast<bf*>(out), static_cast<bf*>(xp),
                  static_cast<bf*>(actp)};
  if (fmt == FMT_BF16) return launch_fmt<FMT_BF16>(np, b, T, k, E, H, I, split, st);
  if (fmt == FMT_INT8) return launch_fmt<FMT_INT8>(np, b, T, k, E, H, I, split, st);
  return launch_fmt<FMT_FP8>(np, b, T, k, E, H, I, split, st);
}

extern "C" int nxd_moe_experts_max_pairs() { return MAX_PAIRS; }
