// Flash attention forward for Hopper (sm_90a): K1, bf16 in, f32 softmax
// state, O in bf16 and LSE in f32.
//
// Replaces the TPU kernel `_fwd_kernel` / `_flash_fwd`
// (neuronx_distributed_tpu/kernels/flash_attention.py:78,199): causal
// (top-left: query i sees keys <= i) attention with online softmax, an
// optional equal-segment mask (padding = segment -1), GQA by q-head h ->
// kv-head h / group, emitting O and LSE = m + log(l).
//
// What bounds it on an H100: two products, 2 * D FLOPs each per live
// (query, key) pair, against ~2 bytes per element of Q, K, V and O moved
// once: at S = 4096 (B = 1, H = 32, D = 128, causal) ~87 GFLOP against
// ~50 MB, so the tensor cores bound it (989 TFLOP/s bf16: 0.088 ms). Below
// S ~ 512 the bytes and the launch bound it instead.
//
// What the design does about it (K3's shape, flash_attention_bwd.cu, on
// the pieces of hopper.cuh):
//  * one block per (128-row query tile, q-head, batch), numbered heaviest
//    first: under causal masking the highest query tiles have the most key
//    tiles, so they lead, across every (head, batch), and the lightest
//    ones fill the tail;
//  * two consumer warpgroups own 64 rows each; both products are `wgmma`:
//    S = Q K^T from shared memory (both operands K-major), then O += P V
//    with P in registers and V read MN-major. S, P and O never touch shared
//    memory: the f32 scores become P in place, are rounded to bf16 once,
//    straight into A-fragment order, and l is summed from the unrounded P;
//  * TMA brings Q in once and K/V tiles of 128 keys through a 2-stage ring
//    behind mbarrier full/empty pairs; warp 0 doubles as the loader (one
//    lane issues the copies of a stage as soon as both warpgroups have
//    released it), so no thread computes an address or moves a byte of
//    Q, K or V. Tensor maps read strided (B, S, H, D) operands in place and
//    zero-fill rows past S or Sk, so any length (S < 128 included) and
//    Sk != S need no special path;
//  * online softmax in exp2 with scale * log2(e) folded into one FMA, on
//    the special-function unit with subnormal results flushed to 0 (the
//    softmax, not the products, sets the pace between two products: the
//    full-range exp2f read 5% slower); a row's max reduces over the 4 lanes
//    that hold it once a tile, its sum only at the end; LSE is returned in
//    natural log;
//  * key tiles above the causal diagonal are never visited, tile pairs
//    whose segment-id ranges (per-tile (min, max) from the wrapper) cannot
//    meet are skipped, and the mask is evaluated only on tiles that cut
//    the diagonal, the ragged key edge or a segment boundary;
//  * rows that have seen no live key keep m = -1e30 and use 0 as the exp
//    reference, the TPU kernel's guard, so l stays 0, O = 0 and
//    LSE ~ -1e30;
//  * no atomics: every output element is written once, two runs give the
//    same bits.
//  * the head_dim-96 build (-DNXD_HEAD_DIM=96, flash_common.cuh;
//    GPT-NeoX-20B) keeps the 128-column tiles and `wgmma` shapes: the
//    tensor maps' head dim is 96, so TMA zero-fills columns 96..127 of
//    every tile, S = Q K^T stops after six k-steps (96 columns), O += P V
//    runs 128 columns of which 32 are zeros (4/3 of that product's work),
//    and the epilogue stores 96 columns.
// Tried and dropped, each no faster in a same-call A/B (PERF.md): a
// producer-only warp (ptxas then caps a thread at 168 registers and
// spills), ping-pong of the two warpgroups on named barriers, the softmax
// of the next tile overlapped with this tile's P V inside a warpgroup, a
// third stage, and a loader that refills without waiting for the other
// warpgroup.
#include "flash_common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace nxd_flash;
using namespace nxd_hopper;

constexpr int BQ = 128;  // query rows a block
constexpr int BK = 128;  // keys a tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 256;  // two warpgroups; warp 0 also loads, every thread consumes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int SM_Q = 0;
constexpr int SM_K = SM_Q + tile_bytes(BQ);           // STAGES tiles of BK rows
constexpr int SM_V = SM_K + STAGES * tile_bytes(BK);  // STAGES tiles of BK rows
constexpr int SM_KSEG = SM_V + STAGES * tile_bytes(BK);  // per stage: BK key segment ids
constexpr int SM_META = SM_KSEG + STAGES * BK * 4;  // per stage: key tile (-1 = done), masked
constexpr int SM_BAR = SM_META + 2 * STAGES * 4;    // full[], empty[], q
constexpr int SMEM = SM_BAR + (2 * STAGES + 1) * 8 + 1024;
static_assert(SM_BAR % 8 == 0, "mbarriers are 8-byte aligned");

struct Params {
  bf16* o; float* lse;               // o (B, S, H, D) strided; lse (B, H, S) contiguous
  const int* qseg; const int* kseg;  // (B, S) / (B, Sk), row stride qsegb / ksegb
  const int* qmin; const int* qmax;  // (B, ceil(S / BQ)) segment range per query tile
  const int* kmin; const int* kmax;  // (B, ceil(Sk / BK))
  int B, S, Sk, H, Hkv, causal;
  long long sob, sos, soh, qsegb, ksegb;
  float scale;
};

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm + SM_Q;
  int* kseg = reinterpret_cast<int*>(sm + SM_KSEG);
  int* meta = reinterpret_cast<int*>(sm + SM_META);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + SM_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int tid = threadIdx.x;
  const int nqt = (p.S + BQ - 1) / BQ, nkt = (p.Sk + BK - 1) / BK;
  const int per_qt = p.H * p.B;
  const int qt = nqt - 1 - blockIdx.x / per_qt;  // heaviest first: the highest query tiles lead
  const int h = blockIdx.x % per_qt / p.B, b = blockIdx.x % p.B;
  const int q0 = qt * BQ, hk = h / (p.H / p.Hkv);
  const bool segs = p.qseg != nullptr;
  // key tiles at or below the diagonal: keys <= the tile's last row
  const int n_kt = p.causal ? min(nkt, (q0 + BQ - 1) / BK + 1) : nkt;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 33);  // each lane's copies, and lane 0's transactions
      mbar_init(&empty[s], NTHREADS);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Consumer warpgroup wg (uniform by construction, as wgmma requires) owns
  // rows [64 wg, 64 wg + 64); its warp 0 is also the loader.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool loader = __shfl_sync(0xffffffffu, tid / 32, 0) == 0;
  const int w = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  // The plan of flash_fwd_tile_plan (kernels/flash_attention.py), one key
  // tile at a time: a pair is visited unless its segment ranges cannot
  // meet; a visited pair is masked when it cuts the diagonal, the ragged
  // key edge or a segment boundary (ranges not all one id).
  auto tiles_meet = [&](int j) {
    if (!segs) return true;
    return p.qmax[b * nqt + qt] >= p.kmin[b * nkt + j] && p.qmin[b * nqt + qt] <= p.kmax[b * nkt + j];
  };
  auto tile_masked = [&](int j) {
    const int k0 = j * BK;
    if ((p.causal && k0 + BK - 1 > q0) || k0 + BK > p.Sk) return 1;
    if (!segs) return 0;
    const int id = p.qmin[b * nqt + qt];
    return (p.qmax[b * nqt + qt] == id && p.kmin[b * nkt + j] == id && p.kmax[b * nkt + j] == id)
               ? 0 : 1;
  };

  // The loader fills the ring in the order it is consumed: stage fill_st
  // gets live key tile fill_j (its segment ids by the lanes' cp.async; K
  // and V by TMA from lane 0) or, past the last, the end mark. It refills
  // a stage as soon as both warpgroups have released it.
  auto next_live = [&](int j) {
    while (j < n_kt && !tiles_meet(j)) ++j;
    return j;
  };
  int fill_j = 0, fill_st = 0;
  bool filled_all = false;
  auto fill = [&]() {
    const int st = fill_st;
    if (++fill_st == STAGES) fill_st = 0;
    if (fill_j >= n_kt) {
      filled_all = true;
      if (lane == 0) {
        meta[2 * st] = -1;
        mbar_arrive(&full[st]);
      }
      mbar_arrive(&full[st]);
      return;
    }
    const int k0 = fill_j * BK;
    if (segs)  // keys past Sk read as zeros
      for (int i = lane; i < BK; i += 32)
        cp_async4(kseg + st * BK + i, p.kseg + b * p.ksegb + min(k0 + i, p.Sk - 1),
                  k0 + i < p.Sk ? 4 : 0);
    if (lane == 0) {
      meta[2 * st] = fill_j;
      meta[2 * st + 1] = tile_masked(fill_j);
      mbar_arrive_expect_tx(&full[st], 2 * tile_bytes(BK));
      tma_load_tile<BK>(sm + SM_K + st * tile_bytes(BK), &tm_k, &full[st], k0, hk, b);
      tma_load_tile<BK>(sm + SM_V + st * tile_bytes(BK), &tm_v, &full[st], k0, hk, b);
    }
    cp_async_mbar_arrive(&full[st]);
    fill_j = next_live(fill_j + 1);
  };
  if (loader) {  // the block's Q, resident, and the first stages
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, tile_bytes(BQ));
      tma_load_tile<BQ>(Qs, &tm_q, q_bar, q0, h, b);
    }
    fill_j = next_live(0);
    for (int i = 0; i < STAGES && !filled_all; ++i) fill();
  }

  const int r0 = q0 + wg * 64 + w * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int qs0 = (segs && r0 < p.S) ? p.qseg[b * p.qsegb + r0] : 0;
  const int qs1 = (segs && r1 < p.S) ? p.qseg[b * p.qsegb + r1] : 0;
  const float sl2 = p.scale * LOG2E;

  // O (64 x 128 f32 a warpgroup), cleared before any product is issued;
  // every later ordinary write to it (the rescale) follows a wait that
  // leaves no product on it in flight
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // m in log2 units of the scaled score (scale * log2(e) * s); l per thread
  // (its 32 columns of each row), summed over the row's 4 lanes at the end
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);
  const uint64_t q_desc = desc_kmajor(Qs, wg * 64);

  // Per stage: wait for S, form P, issue O += P V, then the next stage's S
  // before P V is waited for, so the tensor cores pass from stage to stage
  // without draining. P is formed and O rescaled only when no product is in
  // flight: an accumulator written while one may be would make ptxas
  // serialize every product.
  auto k_tile = [&](int stage) { return sm + SM_K + stage * tile_bytes(BK); };
  auto v_tile = [&](int stage) { return sm + SM_V + stage * tile_bytes(BK); };
  auto issue_s = [&](float (&acc)[64], int stage) {
    wgmma_fence();
    ss_product_n128<BQ, BK, DH / 16>(acc, q_desc, desc_kmajor(k_tile(stage), 0));
    wgmma_commit();
  };
  float s[64];
  uint32_t pa[BK / 16][4];
  int st = 0;
  uint32_t ph = 0;
  mbar_wait(&full[st], ph);
  int j = meta[2 * st];
  if (j >= 0) issue_s(s, st);
  while (j >= 0) {
    const bool masked = meta[2 * st + 1] != 0;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);

    // thread columns (keys) 8 n + 2 t4 (+1); masked entries -> -inf
    if (masked) {
      const int k0 = j * BK;
      const int* ks = kseg + st * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int cl = 8 * n + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + cl + (e & 1), row = e < 2 ? r0 : r1;
          bool ok = col < p.Sk;
          if (p.causal) ok = ok && col <= row;
          if (segs) ok = ok && ks[cl + (e & 1)] == (e < 2 ? qs0 : qs1);
          if (!ok) s[4 * n + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // a row with no live key so far keeps m = -1e30 and the reference 0
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float ref0 = mn0 > NEG_INF * 0.5f ? mn0 : 0.f;
    const float ref1 = mn1 > NEG_INF * 0.5f ? mn1 : 0.f;
    const float alpha0 = ex2(m0 - ref0), alpha1 = ex2(m1 - ref1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], sl2, -ref0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], sl2, -ref0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], sl2, -ref1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], sl2, -ref1));
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    acc_to_a(s, pa);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }

    // O += P V: the V stage read MN-major
    wgmma_fence();
    rs_product(o, pa, desc_mnmajor<BK>(v_tile(st)), 1);
    wgmma_commit();
    const int nst = st + 1 == STAGES ? 0 : st + 1;
    const uint32_t nph = nst == 0 ? ph ^ 1 : ph;
    mbar_wait(&full[nst], nph);
    const int nj = meta[2 * nst];
    if (nj >= 0) {
      issue_s(s, nst);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[st]);
    if (loader && !filled_all) {
      mbar_wait(&empty[st], ph);  // both warpgroups are done with the stage
      fill();
    }
    st = nst, ph = nph, j = nj;
  }
  // Nothing is in flight here, but ptxas cannot tell (the next stage's S is
  // issued only when there is one) and would otherwise serialize the
  // products of the loop to make the reads of O below safe.
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.sob + h * p.soh;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {  // O's columns past DH are zeros, never stored
    const int d = 8 * n + 2 * t4;
    if (r0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * p.sos + d) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (r1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * p.sos + d) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  if (t4 == 0) {
    // natural log; a row with no live key: -1e30 + log(1e-30), as the TPU kernel
    float* lb = p.lse + ((long long)b * p.H + h) * p.S;
    const float ln0 = m0 > NEG_INF * 0.5f ? m0 * LN2 : NEG_INF;
    const float ln1 = m1 > NEG_INF * 0.5f ? m1 * LN2 : NEG_INF;
    if (r0 < p.S) lb[r0] = ln0 + logf(fmaxf(l0, 1e-30f));
    if (r1 < p.S) lb[r1] = ln1 + logf(fmaxf(l1, 1e-30f));
  }
}

}  // namespace

// Strides `st` (14 values, in elements): q, k, v, o, each as (batch, seq,
// head); then the row strides of qseg and kseg. qmin/qmax and kmin/kmax are
// the per-tile segment ranges at nxd_flash_attention_fwd_q_tile() and
// _k_tile() rows (null with no segments). Returns a CUDA error, or a code
// from hopper.cuh when a tensor map cannot be made.
extern "C" int nxd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg, const void* qmin, const void* qmax,
    const void* kmin, const void* kmax,
    int B, int S, int Sk, int H, int Hkv, int causal, const long long* st, float scale,
    void* stream) {
  Params p;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qmin = static_cast<const int*>(qmin);
  p.qmax = static_cast<const int*>(qmax);
  p.kmin = static_cast<const int*>(kmin);
  p.kmax = static_cast<const int*>(kmax);
  p.B = B; p.S = S; p.Sk = Sk; p.H = H; p.Hkv = Hkv; p.causal = causal;
  p.sob = st[9]; p.sos = st[10]; p.soh = st[11];
  p.qsegb = st[12]; p.ksegb = st[13];
  p.scale = scale;
  CUtensorMap m[3];
  int err;
  if ((err = encode_bshd(&m[0], q, B, S, H, st[0], st[1], st[2], BQ, 1, DH))) return err;
  if ((err = encode_bshd(&m[1], k, B, Sk, Hkv, st[3], st[4], st[5], BK, 1, DH))) return err;
  if ((err = encode_bshd(&m[2], v, B, Sk, Hkv, st[6], st[7], st[8], BK, 1, DH))) return err;
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const int grid = (S + BQ - 1) / BQ * H * B;
  if (grid == 0) return 0;
  flash_fwd_kernel<<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(m[0], m[1], m[2],
                                                                                 p);
  return (int)cudaGetLastError();
}

// What K1 takes as launched, into out[4]: dynamic shared memory bytes a
// block, registers a thread, local (spill) bytes a thread, blocks per SM.
extern "C" int nxd_flash_attention_fwd_resources(int* out) {
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_fwd_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel, NTHREADS, SMEM);
  out[0] = SMEM;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return (int)e;
}

extern "C" int nxd_flash_attention_head_dim() { return DH; }

// Rows per tile of the segment ranges K1 reads (qmin/qmax, kmin/kmax).
extern "C" int nxd_flash_attention_fwd_q_tile() { return BQ; }
extern "C" int nxd_flash_attention_fwd_k_tile() { return BK; }
