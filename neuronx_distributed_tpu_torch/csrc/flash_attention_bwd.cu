// Flash attention backward for Hopper (sm_90a): K2 (dK, dV) and K3 (dQ).
//
// Replaces the TPU kernels `_dkdv_kernel` / `_flash_dkdv` and `_dq_kernel` /
// `_flash_dq` (neuronx_distributed_tpu/kernels/flash_attention.py:242,389
// and :315,448). Both recompute P = exp(S * scale - LSE) blockwise from the
// LSE the forward (K1) emits, with delta = rowsum(dO * O) computed outside
// (a torch op, as JAX computes it outside Pallas):
//   dV = P^T dO,   dS = P * (dO V^T - delta) * scale,   dK = dS^T Q,   dQ = dS K.
// Causal (top-left: query i sees keys <= i), an optional equal-segment mask
// (padding = segment -1), GQA by q-head h -> kv-head h / group. Entries that
// are masked get P = 0 explicitly: a fully masked row carries LSE ~ -1e30,
// so exp(S - LSE) there would overflow (the TPU kernel's guard).
//
// What bounds them on an H100: K2 does four products and K3 three, each
// 2 * D FLOPs per live (query, key) pair, against ~2 bytes per element of
// Q, K, V, dO read once: thousands of FLOPs per byte, so the tensor cores
// bound them (989 TFLOP/s bf16; 0.556 and 0.417 ms at B=2, S=4096, H=32,
// D=128, causal). What the design does about it: every product is a
// `wgmma` (hopper.cuh) on operands that TMA stages, swizzled, into shared
// memory, and two warpgroups of 64 rows each issue them. Warp 0 doubles as
// the loader: one lane issues the TMA copies of a stage, behind an mbarrier
// pair, as soon as both warpgroups have released it, so no thread computes
// an address or moves a byte of Q, K, V or dO. (A third, producer-only
// warpgroup with `setmaxnreg` caps the compiler at 168 registers a thread
// for 384 threads: both kernels then spilled and ran slower.) The
// score, P and dS tiles never leave the registers: S and dP accumulate in
// f32, P and dS are rounded to bf16 once each and handed, already in
// A-fragment order, to the next product (the TPU kernel keeps them in f32).
//
// K2: one block per (128-key tile, kv-head, batch); consumer warpgroup c
// owns keys [64 c, 64 c + 64) and keeps their dK and dV (64 x 128 f32 each)
// in registers for the whole block, so no atomics and no second pass: the
// result is the same bits every run. K and V load once; Q and dO tiles of
// 64 query rows stream through a 3-stage ring for every q-head of the
// kv-head's group and every query tile that can see the keys -- the loop
// that replaces the TPU's sequential grid axis t = g * nQ + i. It works in
// the transposed frame: S^T = K Q^T and dP^T = V dO^T put keys on the rows
// (A = K or V, B = the stage, both K-major), so P^T and dS^T leave the
// accumulators as the A operands of dV += P^T dO and dK += dS^T Q (B = the
// same stage read MN-major).
//
// K3: one block per (128-row query tile, q-head, batch); consumer warpgroup
// c owns rows [64 c, 64 c + 64) and keeps their dQ in registers. Q and dO
// load once; K and V tiles of 128 keys stream through a 2-stage ring.
// S = Q K^T and dP = dO V^T (both K-major), dQ += dS K (B = the K stage
// read MN-major). A kernel of its own: ring attention calls K2 and K3 apart.
//
// Both skip tiles above the causal diagonal, and tile pairs whose segment-id
// ranges cannot meet (ranges per tile come from the wrapper, computed with
// torch ops); masks are tested only on tiles that cut the diagonal, the
// ragged edge (any S: TMA zero-fills rows past it) or a segment boundary.
// The causal test compares a row base plus offset with a column base plus
// offset. Blocks are numbered heaviest first: K2's lowest key tiles and
// K3's highest query tiles, across every (head, batch), fill the first wave.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace nxd_flash;
using namespace nxd_hopper;

constexpr int BK = 128;   // keys per K2 block and per K3 tile
constexpr int BQ2 = 64;   // query rows per K2 stage
constexpr int BQ3 = 128;  // query rows per K3 block
constexpr int K2_STAGES = 3;
constexpr int K3_STAGES = 2;
constexpr int NTHREADS = 256;  // two warpgroups; warp 0 also loads, every thread consumes
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

struct Params {
  const float* lse; const float* delta;  // (B, H, S) contiguous
  bf16* dq; bf16* dk; bf16* dv;
  const int* qseg; const int* kseg;      // (B, S) / (B, Sk), row stride qsegb / ksegb
  const int* qmin; const int* qmax;      // (B, ceil(S / query tile)) segment range per tile
  const int* kmin; const int* kmax;      // (B, ceil(Sk / BK))
  int B, S, Sk, H, Hkv, causal;
  long long sgb, sgs, sgh;  // strides of dq (K3) or of dk / dv (K2, equal layouts)
  long long qsegb, ksegb;
  float scale;
};

__device__ __forceinline__ bool tiles_meet(const Params& p, int b, int qi, int nqt, int kj,
                                           int nkt) {
  if (p.qseg == nullptr) return true;
  return p.qmax[b * nqt + qi] >= p.kmin[b * nkt + kj] &&
         p.qmin[b * nqt + qi] <= p.kmax[b * nkt + kj];
}

// Rows [r0, r0 + 64) of a 64 x 128 f32 accumulator pair, as bf16, at row
// stride `rs` (only rows below `n`); thread rows 16 w + g (+8).
__device__ __forceinline__ void store_rows(bf16* out, long long rs, const float (&acc)[64],
                                           int row0, int n, int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t4;
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row0 * rs + d) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (row0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + 8) * rs + d) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// S = A_s B_s^T and dP = A_p B_p^T of one stage (A rows of RA-row tiles by
// base descriptor, B an RB-row stage, both K-major) as two commit groups,
// so that S can be waited for alone.
template <int RA, int RB, int M>
__device__ __forceinline__ void issue_scores(float (&s)[M], float (&dp)[M], uint64_t a_s,
                                             uint64_t a_p, const unsigned char* b_s,
                                             const unsigned char* b_p) {
  wgmma_fence();
  if constexpr (M == 32) {
    ss_product_n64<RA, RB>(s, a_s, desc_kmajor(b_s, 0));
    wgmma_commit();
    ss_product_n64<RA, RB>(dp, a_p, desc_kmajor(b_p, 0));
  } else {
    ss_product_n128<RA, RB>(s, a_s, desc_kmajor(b_s, 0));
    wgmma_commit();
    ss_product_n128<RA, RB>(dp, a_p, desc_kmajor(b_p, 0));
  }
  wgmma_commit();
}

// ---------------------------------------------------------------- K2: dK, dV

constexpr int K2_K = 0;
constexpr int K2_V = K2_K + tile_bytes(BK);
constexpr int K2_Q = K2_V + tile_bytes(BK);                // K2_STAGES tiles of BQ2 rows
constexpr int K2_DO = K2_Q + K2_STAGES * tile_bytes(BQ2);  // K2_STAGES tiles of BQ2 rows
constexpr int K2_ROWS = K2_DO + K2_STAGES * tile_bytes(BQ2);  // per stage: lse, delta, qseg
constexpr int K2_KSEG = K2_ROWS + K2_STAGES * 3 * BQ2 * 4;
constexpr int K2_META = K2_KSEG + BK * 4;                   // per stage: the tile, or -1 = done
constexpr int K2_BAR = K2_META + 16;                        // full[], empty[], kv
constexpr int K2_SMEM = K2_BAR + (2 * K2_STAGES + 1) * 8 + 1024;

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Ks = sm + K2_K;
  unsigned char* Vs = sm + K2_V;
  float* rows = reinterpret_cast<float*>(sm + K2_ROWS);
  int* kseg = reinterpret_cast<int*>(sm + K2_KSEG);
  int* meta = reinterpret_cast<int*>(sm + K2_META);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K2_BAR);
  uint64_t* empty = full + K2_STAGES;
  uint64_t* kv_bar = empty + K2_STAGES;

  const int tid = threadIdx.x;
  const int per_kt = p.Hkv * p.B;
  const int kt = blockIdx.x / per_kt;  // heaviest first: the lowest key tiles lead
  const int hk = blockIdx.x % per_kt / p.B, b = blockIdx.x % p.B;
  const int k0 = kt * BK;
  const int group = p.H / p.Hkv;
  const bool segs = p.qseg != nullptr;
  const int nqt = (p.S + BQ2 - 1) / BQ2, nkt = (p.Sk + BK - 1) / BK;
  // query tiles that can see a key of this tile: rows >= k0 when causal
  const int i0 = p.causal ? min(k0 / BQ2, nqt) : 0;
  const int per_head = nqt - i0;
  const int n_iter = group * per_head;

  if (tid == 0) {
    for (int s = 0; s < K2_STAGES; ++s) {
      mbar_init(&full[s], 33);  // each lane's copies, and lane 0's transactions
      mbar_init(&empty[s], NTHREADS);
    }
    mbar_init(kv_bar, 32);
    mbar_init_fence();
  }
  __syncthreads();

  // Consumer warpgroup wg (uniform by construction, as wgmma requires) owns
  // keys [64 wg, 64 wg + 64); its warp 0 is also the loader.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool loader = __shfl_sync(0xffffffffu, tid / 32, 0) == 0;
  const int w = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  // The loader fills the ring in the order it is consumed: stage fill_st
  // gets live tile fill_t (its rows' lse, delta and segment ids by the
  // lanes' cp.async; Q and dO by TMA from lane 0) or, past the last, the end
  // mark. It refills a stage as soon as both warpgroups have released it,
  // and never waits for a copy to land.
  auto next_live = [&](int t) {
    while (t < n_iter && !tiles_meet(p, b, i0 + t % per_head, nqt, kt, nkt)) ++t;
    return t;
  };
  int fill_t = 0, fill_st = 0;
  bool filled_all = false;
  auto fill = [&]() {
    const int st = fill_st;
    if (++fill_st == K2_STAGES) fill_st = 0;
    if (fill_t >= n_iter) {
      filled_all = true;
      if (lane == 0) {
        meta[st] = -1;
        mbar_arrive(&full[st]);
      }
      mbar_arrive(&full[st]);
      return;
    }
    const int h = hk * group + fill_t / per_head, q0 = (i0 + fill_t % per_head) * BQ2;
    float* lse = rows + st * 3 * BQ2;
    float* dl = lse + BQ2;
    int* qs = reinterpret_cast<int*>(dl + BQ2);
    for (int r = lane; r < BQ2; r += 32) {  // rows past S read as zeros
      const int row = min(q0 + r, p.S - 1), n = q0 + r < p.S ? 4 : 0;
      const long long o = ((long long)b * p.H + h) * p.S + row;
      cp_async4(lse + r, p.lse + o, n);
      cp_async4(dl + r, p.delta + o, n);
      if (segs) cp_async4(qs + r, p.qseg + b * p.qsegb + row, n);
    }
    if (lane == 0) {
      meta[st] = fill_t;
      mbar_arrive_expect_tx(&full[st], 2 * tile_bytes(BQ2));
      tma_load_tile<BQ2>(sm + K2_Q + st * tile_bytes(BQ2), &tm_q, &full[st], q0, h, b);
      tma_load_tile<BQ2>(sm + K2_DO + st * tile_bytes(BQ2), &tm_do, &full[st], q0, h, b);
    }
    cp_async_mbar_arrive(&full[st]);
    fill_t = next_live(fill_t + 1);
  };
  if (loader) {  // the block's K and V, resident, and the first stages
    for (int i = lane; i < BK; i += 32)
      kseg[i] = (segs && k0 + i < p.Sk) ? p.kseg[b * p.ksegb + k0 + i] : 0;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * tile_bytes(BK));
      tma_load_tile<BK>(Ks, &tm_k, kv_bar, k0, hk, b);
      tma_load_tile<BK>(Vs, &tm_v, kv_bar, k0, hk, b);
    } else {
      mbar_arrive(kv_bar);
    }
    fill_t = next_live(0);
    for (int i = 0; i < K2_STAGES && !filled_all; ++i) fill();
  }

  const int kl0 = wg * 64 + w * 16 + g;  // this thread's key rows: kl0 and kl0 + 8
  const int key0 = k0 + kl0, key1 = key0 + 8;
  const float sl2 = p.scale * LOG2E;

  // dK and dV: the first product overwrites them (`acc` 0), so no ordinary
  // instruction writes them before the end (see rs_product)
  float dk[64], dv[64];
  int acc = 0;
  mbar_wait(kv_bar, 0);
  const int ks0 = kseg[kl0], ks1 = kseg[kl0 + 8];
  const uint64_t k_desc = desc_kmajor(Ks, wg * 64), v_desc = desc_kmajor(Vs, wg * 64);

  // Per stage: wait for S^T and dP^T, form P^T and dS^T, issue dV and dK,
  // then the next stage's S^T and dP^T before dV and dK are waited for, so
  // the tensor cores pass from stage to stage without draining. P and dS
  // are formed only when no product is in flight: an accumulator written
  // while one may be would make ptxas serialize every product. A
  // warpgroup whose keys all follow a tile's last query has nothing live
  // there.
  auto live = [&](int t) {
    return t >= 0 && !(p.causal && k0 + wg * 64 > (i0 + t % per_head) * BQ2 + BQ2 - 1);
  };
  auto q_tile = [&](int stage) { return sm + K2_Q + stage * tile_bytes(BQ2); };
  auto do_tile = [&](int stage) { return sm + K2_DO + stage * tile_bytes(BQ2); };
  float s[32], dp[32];
  uint32_t pa[BQ2 / 16][4], dsa[BQ2 / 16][4];
  int st = 0;
  uint32_t ph = 0;
  mbar_wait(&full[st], ph);
  int t = meta[st];
  bool on = live(t);
  if (on) issue_scores<BK, BQ2>(s, dp, k_desc, v_desc, q_tile(st), do_tile(st));
  while (t >= 0) {
    if (on) {
      const int q0 = (i0 + t % per_head) * BQ2;
      const float* lse = rows + st * 3 * BQ2;
      const float* dl = lse + BQ2;
      const int* qs = reinterpret_cast<const int*>(dl + BQ2);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T in f32; thread columns (queries) 8 j + 2 t4 (+1)
      const bool edge = (p.causal && k0 + wg * 64 + 63 > q0) || q0 + BQ2 > p.S ||
                        k0 + BK > p.Sk || segs;
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j) {
        const int ql = 8 * j + 2 * t4;
        const float2 l = *reinterpret_cast<const float2*>(lse + ql);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2f(fmaf(s[4 * j + e], sl2, -l2[e & 1]));
          if (edge) {
            const int key = e < 2 ? key0 : key1, row = q0 + ql + (e & 1);
            bool ok = key < p.Sk && row < p.S;
            if (p.causal) ok = ok && key <= row;
            if (segs) ok = ok && qs[ql + (e & 1)] == (e < 2 ? ks0 : ks1);
            if (!ok) pe = 0.f;
          }
          s[4 * j + e] = pe;
        }
      }
      acc_to_a(s, pa);

      // dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * (i >> 2) + 2 * t4);
          dsa[kk][r] = pack_bf16x2(s[i] * (dp[i] - d2.x) * p.scale,
                                   s[i + 1] * (dp[i + 1] - d2.y) * p.scale);
        }
      // dV += P^T dO and dK += dS^T Q: the stage read MN-major
      wgmma_fence();
      rs_product(dv, pa, desc_mnmajor<BQ2>(do_tile(st)), acc);
      rs_product(dk, dsa, desc_mnmajor<BQ2>(q_tile(st)), acc);
      wgmma_commit();
      acc = 1;
    }
    const int nst = st + 1 == K2_STAGES ? 0 : st + 1;
    const uint32_t nph = nst == 0 ? ph ^ 1 : ph;
    mbar_wait(&full[nst], nph);
    const int nt = meta[nst];
    const bool non = live(nt);
    if (non) issue_scores<BK, BQ2>(s, dp, k_desc, v_desc, q_tile(nst), do_tile(nst));
    if (on) {
      if (non)
        wgmma_wait<2>();
      else
        wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
    }
    mbar_arrive(&empty[st]);
    if (loader && !filled_all) {
      mbar_wait(&empty[st], ph);  // both warpgroups are done with the stage
      fill();
    }
    st = nst, ph = nph, t = nt, on = non;
  }
  // Nothing is in flight here, but ptxas cannot tell (a warpgroup issues
  // the next stage's products only when it has work there) and would
  // otherwise serialize every product of the loop to make the reads of dK
  // and dV below safe.
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  if (!acc) {  // no live tile: the sums are empty
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  }
  const long long o = b * p.sgb + hk * p.sgh;
  store_rows(p.dk + o, p.sgs, dk, key0, p.Sk, t4);
  store_rows(p.dv + o, p.sgs, dv, key0, p.Sk, t4);
}

// ---------------------------------------------------------------- K3: dQ

constexpr int K3_Q = 0;
constexpr int K3_DO = K3_Q + tile_bytes(BQ3);
constexpr int K3_K = K3_DO + tile_bytes(BQ3);             // K3_STAGES tiles of BK rows
constexpr int K3_V = K3_K + K3_STAGES * tile_bytes(BK);   // K3_STAGES tiles of BK rows
constexpr int K3_KSEG = K3_V + K3_STAGES * tile_bytes(BK);  // per stage: BK key segment ids
constexpr int K3_META = K3_KSEG + K3_STAGES * BK * 4;
constexpr int K3_BAR = K3_META + 16;  // full[], empty[], q
constexpr int K3_SMEM = K3_BAR + (2 * K3_STAGES + 1) * 8 + 1024;

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm + K3_Q;
  unsigned char* dOs = sm + K3_DO;
  int* kseg = reinterpret_cast<int*>(sm + K3_KSEG);
  int* meta = reinterpret_cast<int*>(sm + K3_META);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K3_BAR);
  uint64_t* empty = full + K3_STAGES;
  uint64_t* q_bar = empty + K3_STAGES;

  const int tid = threadIdx.x;
  const int nqt = (p.S + BQ3 - 1) / BQ3, nkt = (p.Sk + BK - 1) / BK;
  const int per_qt = p.H * p.B;
  const int qt = nqt - 1 - blockIdx.x / per_qt;  // heaviest first: the highest query tiles lead
  const int h = blockIdx.x % per_qt / p.B, b = blockIdx.x % p.B;
  const int q0 = qt * BQ3, hk = h / (p.H / p.Hkv);
  const bool segs = p.qseg != nullptr;
  const int n_kt = p.causal ? min(nkt, (q0 + BQ3 - 1) / BK + 1) : nkt;

  if (tid == 0) {
    for (int s = 0; s < K3_STAGES; ++s) {
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

  // The loader fills the ring in the order it is consumed: stage fill_st
  // gets live key tile fill_j (its segment ids by the lanes' cp.async; K
  // and V by TMA from lane 0) or, past the last, the end mark. It refills
  // a stage as soon as both warpgroups have released it.
  auto next_live = [&](int j) {
    while (j < n_kt && !tiles_meet(p, b, qt, nqt, j, nkt)) ++j;
    return j;
  };
  int fill_j = 0, fill_st = 0;
  bool filled_all = false;
  auto fill = [&]() {
    const int st = fill_st;
    if (++fill_st == K3_STAGES) fill_st = 0;
    if (fill_j >= n_kt) {
      filled_all = true;
      if (lane == 0) {
        meta[st] = -1;
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
      meta[st] = fill_j;
      mbar_arrive_expect_tx(&full[st], 2 * tile_bytes(BK));
      tma_load_tile<BK>(sm + K3_K + st * tile_bytes(BK), &tm_k, &full[st], k0, hk, b);
      tma_load_tile<BK>(sm + K3_V + st * tile_bytes(BK), &tm_v, &full[st], k0, hk, b);
    }
    cp_async_mbar_arrive(&full[st]);
    fill_j = next_live(fill_j + 1);
  };
  if (loader) {  // the block's Q and dO, resident, and the first stages
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * tile_bytes(BQ3));
      tma_load_tile<BQ3>(Qs, &tm_q, q_bar, q0, h, b);
      tma_load_tile<BQ3>(dOs, &tm_do, q_bar, q0, h, b);
    }
    fill_j = next_live(0);
    for (int i = 0; i < K3_STAGES && !filled_all; ++i) fill();
  }

  const int r0 = q0 + wg * 64 + w * 16 + g, r1 = r0 + 8;  // this thread's rows
  const float sl2 = p.scale * LOG2E;
  const long long o = ((long long)b * p.H + h) * p.S;
  const float l0 = r0 < p.S ? p.lse[o + r0] * LOG2E : 0.f;
  const float l1 = r1 < p.S ? p.lse[o + r1] * LOG2E : 0.f;
  const float dl0 = r0 < p.S ? p.delta[o + r0] : 0.f;
  const float dl1 = r1 < p.S ? p.delta[o + r1] : 0.f;
  const int qs0 = (segs && r0 < p.S) ? p.qseg[b * p.qsegb + r0] : 0;
  const int qs1 = (segs && r1 < p.S) ? p.qseg[b * p.qsegb + r1] : 0;

  float dq[64];  // the first product overwrites it (`acc` 0)
  int acc = 0;
  mbar_wait(q_bar, 0);
  const uint64_t q_desc = desc_kmajor(Qs, wg * 64), do_desc = desc_kmajor(dOs, wg * 64);

  // Per stage: wait for S and dP, form P and dS, issue dQ, then the next
  // stage's S and dP before dQ is waited for (as in K2, P and dS are
  // formed only when no product is in flight).
  auto k_tile = [&](int stage) { return sm + K3_K + stage * tile_bytes(BK); };
  auto v_tile = [&](int stage) { return sm + K3_V + stage * tile_bytes(BK); };
  float s[64], dp[64];
  uint32_t dsa[BK / 16][4];
  int st = 0;
  uint32_t ph = 0;
  mbar_wait(&full[st], ph);
  int j = meta[st];
  if (j >= 0) issue_scores<BQ3, BK>(s, dp, q_desc, do_desc, k_tile(st), v_tile(st));
  while (j >= 0) {
    const int k0 = j * BK;
    const int* ks = kseg + st * BK;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P in f32; thread columns (keys) 8 n + 2 t4 (+1)
    const bool edge = (p.causal && k0 + BK - 1 > q0 + wg * 64) || q0 + BQ3 > p.S ||
                      k0 + BK > p.Sk || segs;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int cl = 8 * n + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(fmaf(s[4 * n + e], sl2, -(e < 2 ? l0 : l1)));
        if (edge) {
          const int col = k0 + cl + (e & 1), row = e < 2 ? r0 : r1;
          bool ok = col < p.Sk && row < p.S;
          if (p.causal) ok = ok && col <= row;
          if (segs) ok = ok && ks[cl + (e & 1)] == (e < 2 ? qs0 : qs1);
          if (!ok) pe = 0.f;
        }
        s[4 * n + e] = pe;
      }
    }
    // dS = P (dP - delta) scale
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float dl = (r & 1) ? dl1 : dl0;
        dsa[kk][r] = pack_bf16x2(s[i] * (dp[i] - dl) * p.scale,
                                 s[i + 1] * (dp[i + 1] - dl) * p.scale);
      }

    // dQ += dS K: the K stage read MN-major
    wgmma_fence();
    rs_product(dq, dsa, desc_mnmajor<BK>(k_tile(st)), acc);
    wgmma_commit();
    acc = 1;
    const int nst = st + 1 == K3_STAGES ? 0 : st + 1;
    const uint32_t nph = nst == 0 ? ph ^ 1 : ph;
    mbar_wait(&full[nst], nph);
    const int nj = meta[nst];
    if (nj >= 0) {
      issue_scores<BQ3, BK>(s, dp, q_desc, do_desc, k_tile(nst), v_tile(nst));
      wgmma_wait<2>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dq);
    fence_regs(dsa);
    mbar_arrive(&empty[st]);
    if (loader && !filled_all) {
      mbar_wait(&empty[st], ph);  // both warpgroups are done with the stage
      fill();
    }
    st = nst, ph = nph, j = nj;
  }
  if (!acc) {  // no live key tile: the sum is empty
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  }
  store_rows(p.dq + b * p.sgb + h * p.sgh, p.sgs, dq, r0, p.S, t4);
}

Params make_params(const void* lse, const void* delta, const void* qseg, const void* kseg,
                   const void* qmin, const void* qmax, const void* kmin, const void* kmax,
                   int B, int S, int Sk, int H, int Hkv, int causal, const long long* st,
                   float scale) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qmin = static_cast<const int*>(qmin);
  p.qmax = static_cast<const int*>(qmax);
  p.kmin = static_cast<const int*>(kmin);
  p.kmax = static_cast<const int*>(kmax);
  p.B = B; p.S = S; p.Sk = Sk; p.H = H; p.Hkv = Hkv; p.causal = causal;
  p.sgb = st[12]; p.sgs = st[13]; p.sgh = st[14];
  p.qsegb = st[15]; p.ksegb = st[16];
  p.scale = scale;
  return p;
}

// Tensor maps of q, k, v and dout (strides st[0..11]); boxes of q_rows
// query rows and BK keys.
int make_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout,
              int B, int S, int Sk, int H, int Hkv, const long long* st, int q_rows) {
  int err;
  if ((err = encode_bshd(&m[0], q, B, S, H, st[0], st[1], st[2], q_rows))) return err;
  if ((err = encode_bshd(&m[1], k, B, Sk, Hkv, st[3], st[4], st[5], BK))) return err;
  if ((err = encode_bshd(&m[2], v, B, Sk, Hkv, st[6], st[7], st[8], BK))) return err;
  return encode_bshd(&m[3], dout, B, S, H, st[9], st[10], st[11], q_rows);
}

}  // namespace

// Strides `st` (17 values, in elements): q, k, v, dout, then the output
// (dq for K3; dk and dv, which share one layout, for K2), each as (batch,
// seq, head); then the row strides of qseg and kseg. Returns a CUDA error,
// or a code from hopper.cuh when a tensor map cannot be made.
extern "C" int nxd_flash_attention_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* qseg, const void* kseg,
    const void* qmin, const void* qmax, const void* kmin, const void* kmax,
    int B, int S, int Sk, int H, int Hkv, int causal, const long long* st, float scale,
    void* stream) {
  Params p = make_params(lse, delta, qseg, kseg, qmin, qmax, kmin, kmax, B, S, Sk, H, Hkv, causal,
                         st, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  CUtensorMap m[4];
  if (int err = make_maps(m, q, k, v, dout, B, S, Sk, H, Hkv, st, BQ2)) return err;
  cudaFuncSetAttribute(flash_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K2_SMEM);
  const int grid = (Sk + BK - 1) / BK * Hkv * B;
  flash_dkdv_kernel<<<grid, NTHREADS, K2_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

extern "C" int nxd_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* qseg, const void* kseg,
    const void* qmin, const void* qmax, const void* kmin, const void* kmax,
    int B, int S, int Sk, int H, int Hkv, int causal, const long long* st, float scale,
    void* stream) {
  Params p = make_params(lse, delta, qseg, kseg, qmin, qmax, kmin, kmax, B, S, Sk, H, Hkv, causal,
                         st, scale);
  p.dq = static_cast<bf16*>(dq);
  CUtensorMap m[4];
  if (int err = make_maps(m, q, k, v, dout, B, S, Sk, H, Hkv, st, BQ3)) return err;
  cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM);
  const int grid = (S + BQ3 - 1) / BQ3 * H * B;
  flash_dq_kernel<<<grid, NTHREADS, K3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

// What K2 (which = 0) or K3 (1) takes as launched, into out[4]: dynamic
// shared memory bytes a block, registers a thread at entry (before
// `setmaxnreg`), local (spill) bytes a thread, and blocks per SM.
extern "C" int nxd_flash_attention_bwd_resources(int which, int* out) {
  const void* fn = which == 0 ? reinterpret_cast<const void*>(flash_dkdv_kernel)
                              : reinterpret_cast<const void*>(flash_dq_kernel);
  const int smem = which == 0 ? K2_SMEM : K3_SMEM;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NTHREADS, smem);
  out[0] = smem;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return (int)e;
}

extern "C" int nxd_flash_attention_bwd_head_dim() { return D; }

// Query rows per tile of the segment ranges each kernel reads (qmin/qmax).
extern "C" int nxd_flash_attention_dkdv_q_tile() { return BQ2; }
extern "C" int nxd_flash_attention_dq_q_tile() { return BQ3; }
extern "C" int nxd_flash_attention_bwd_k_tile() { return BK; }
