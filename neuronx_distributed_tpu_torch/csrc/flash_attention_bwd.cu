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
// What bounds them on an H100: at the training shapes (S = 4096, D = 128)
// K2 does four products and K3 three, 2*D FLOPs per live (query, key) pair
// each, against ~2 bytes per element of Q, K, V, dO read once: thousands of
// FLOPs per byte, so tensor-core bound (989 TFLOP/s bf16). Every product
// runs on `mma.sync` m16n8k16 (bf16 in, f32 accumulation); the S x S score,
// probability and dS tiles never leave the registers: each product's
// accumulators are packed to bf16 and fed to the next as its A operand. P
// and dS are rounded to bf16 for the products dV += P^T dO, dK += dS^T Q and
// dQ += dS K (the TPU kernel keeps them in f32); dS itself is formed in f32.
//
// K2: one block of 4 warps per (64-key tile, kv-head, batch). Each warp owns
// 16 keys and keeps their dK and dV (16 x 128 f32 each) in registers for the
// whole block, so no atomics and no second pass: the result is the same bits
// every run. The block loops over every q-head of the kv-head's group and
// every 32-row query tile that can see its keys -- the loop that replaces the
// TPU's sequential grid axis t = g * nQ + i. It works in the transposed
// frame: S^T = K Q^T puts keys on the rows, so P^T and dS^T come out of the
// accumulators already in A-fragment form. Q and dO tiles, with their LSE,
// delta and segment ids, arrive by double-buffered `cp.async`.
//
// K3: one block of 4 warps per (64-row query tile, q-head, batch), each warp
// 16 rows, dQ (16 x 128 f32) in registers; K/V tiles double-buffered, as in
// K1. Kept a kernel of its own: ring attention calls K2 and K3 apart.
//
// Both skip tiles above the causal diagonal, and tile pairs whose segment-id
// ranges cannot meet (ranges per tile come from the wrapper, computed with
// torch ops). Ragged lengths (any S) are masked in-kernel.
#include "flash_common.cuh"

namespace {

using namespace nxd_flash;

constexpr int NTHREADS = 128;
constexpr int BK = 64;   // keys per K2 block / per K3 tile
constexpr int BQ2 = 32;  // query rows per K2 iteration
constexpr int BQ3 = 64;  // query rows per K3 block

struct Params {
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  const float* lse; const float* delta;  // (B, H, S) contiguous
  bf16* dq; bf16* dk; bf16* dv;
  const int* qseg; const int* kseg;      // (B, S) / (B, Sk), row stride qsegb / ksegb
  const int* qmin; const int* qmax;      // (B, ceil(S / query tile)) segment range per tile
  const int* kmin; const int* kmax;      // (B, ceil(Sk / BK))
  int B, S, Sk, H, Hkv, causal;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh;
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

// ---------------------------------------------------------------- K2: dK, dV

constexpr size_t K2_TILE_K = (size_t)BK * LD * sizeof(bf16);
constexpr size_t K2_TILE_Q = (size_t)BQ2 * LD * sizeof(bf16);
constexpr size_t K2_K_OFF = 0;
constexpr size_t K2_V_OFF = K2_K_OFF + K2_TILE_K;
constexpr size_t K2_Q_OFF = K2_V_OFF + K2_TILE_K;        // 2 stages
constexpr size_t K2_DO_OFF = K2_Q_OFF + 2 * K2_TILE_Q;   // 2 stages
constexpr size_t K2_ROW_OFF = K2_DO_OFF + 2 * K2_TILE_Q; // lse, delta, qseg: 2 stages each
constexpr size_t K2_SMEM = K2_ROW_OFF + (3 * 2 * BQ2 + BK) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) flash_dkdv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + K2_K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + K2_V_OFF);
  bf16* Qst = reinterpret_cast<bf16*>(smem + K2_Q_OFF);
  bf16* dOst = reinterpret_cast<bf16*>(smem + K2_DO_OFF);
  float* lse_st = reinterpret_cast<float*>(smem + K2_ROW_OFF);
  float* dl_st = lse_st + 2 * BQ2;
  int* qseg_st = reinterpret_cast<int*>(dl_st + 2 * BQ2);
  int* kseg_s = qseg_st + 2 * BQ2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kt = blockIdx.x, k0 = kt * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const bool segs = p.qseg != nullptr;
  const int nqt = (p.S + BQ2 - 1) / BQ2, nkt = (p.Sk + BK - 1) / BK;

  // this block's K and V rows, resident for the whole sweep
  stage_rows<BK, NTHREADS>(Ks, p.k + b * p.skb + hk * p.skh, p.sks, k0, p.Sk, tid);
  stage_rows<BK, NTHREADS>(Vs, p.v + b * p.svb + hk * p.svh, p.svs, k0, p.Sk, tid);
  cp_async_commit();
  if (tid < BK) kseg_s[tid] = (segs && k0 + tid < p.Sk) ? p.kseg[b * p.ksegb + k0 + tid] : 0;

  // query tiles that can see a key of this tile: rows >= k0 when causal
  const int i0 = p.causal ? min(k0 / BQ2, nqt) : 0;
  const int per_head = nqt - i0;
  const int n_iter = group * per_head;
  auto live = [&](int t) -> bool { return tiles_meet(p, b, i0 + t % per_head, nqt, kt, nkt); };
  auto next_live = [&](int t) -> int {
    while (t < n_iter && !live(t)) ++t;
    return t;
  };
  auto load_q = [&](int t, int st) {
    const int h = hk * group + t / per_head, q0 = (i0 + t % per_head) * BQ2;
    stage_rows<BQ2, NTHREADS>(Qst + st * BQ2 * LD, p.q + b * p.sqb + h * p.sqh, p.sqs, q0,
                              p.S, tid);
    stage_rows<BQ2, NTHREADS>(dOst + st * BQ2 * LD, p.dout + b * p.sob + h * p.soh, p.sos, q0,
                              p.S, tid);
    if (tid < BQ2) {
      const int row = q0 + tid;
      const bool ok = row < p.S;
      const long long r = ((long long)b * p.H + h) * p.S + row;
      lse_st[st * BQ2 + tid] = ok ? p.lse[r] : 0.f;
      dl_st[st * BQ2 + tid] = ok ? p.delta[r] : 0.f;
      qseg_st[st * BQ2 + tid] = (segs && ok) ? p.qseg[b * p.qsegb + row] : 0;
    }
  };

  // this warp's 16 keys: rows (key0, key0 + 8) of its fragments
  const int krow = warp * 16;
  const int key0 = k0 + krow + g, key1 = key0 + 8;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int cur = next_live(0), st = 0;
  if (cur < n_iter) load_q(cur, 0);
  cp_async_commit();
  while (cur < n_iter) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_iter) {
      load_q(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // K/V and the current tile have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qst + st * BQ2 * LD;
    const bf16* dOt = dOst + st * BQ2 * LD;
    const float* lse_t = lse_st + st * BQ2;
    const float* dl_t = dl_st + st * BQ2;
    const int* qseg_t = qseg_st + st * BQ2;
    const int q0 = (i0 + cur % per_head) * BQ2;
    const int ks0 = kseg_s[krow + g], ks1 = kseg_s[krow + g + 8];

    // S^T = K Q^T and dP^T = V dO^T: keys on the rows, 32 queries as 4 tiles of 8
    float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
    for (int n = 0; n < BQ2 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ka[4], va[4];
      load_a(ka, Ks, krow, kk * 16, lane);
      load_a(va, Vs, krow, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BQ2 / 8; ++n) {
        const bf16* qp = Qt + (n * 8 + g) * LD + kk * 16 + tig * 2;
        const bf16* dp_ = dOt + (n * 8 + g) * LD + kk * 16 + tig * 2;
        mma_bf16(s[n], ka, lds32(qp), lds32(qp + 8));
        mma_bf16(dp[n], va, lds32(dp_), lds32(dp_ + 8));
      }
    }

    // P^T and dS^T (f32), packed to bf16 A fragments: k dimension = queries
    unsigned pa[BQ2 / 16][4], dsa[BQ2 / 16][4];
#pragma unroll
    for (int n = 0; n < BQ2 / 8; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + tig * 2 + (e & 1);
        const int row = q0 + ql;
        const int key = e < 2 ? key0 : key1;
        bool ok = key < p.Sk && row < p.S;
        if (p.causal) ok = ok && key <= row;
        if (segs) ok = ok && qseg_t[ql] == (e < 2 ? ks0 : ks1);
        pv[e] = ok ? expf(s[n][e] * p.scale - lse_t[ql]) : 0.f;
        dsv[e] = pv[e] * (dp[n][e] - dl_t[ql]) * p.scale;
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsa[n / 2][(n & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      dsa[n / 2][(n & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dV += P^T dO, dK += dS^T Q: B operands transposed out of shared memory
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, dOt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(dv[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(dv[2 * np + 1], pa[kk], r[2], r[3]);
        ldmatrix_x4_trans(r, Qt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(dk[2 * np], dsa[kk], r[0], r[1]);
        mma_bf16(dk[2 * np + 1], dsa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // the stage is rewritten two iterations on
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();  // a block with no live tile still retires its K/V copies

  bf16* dkb = p.dk + b * p.sgb + hk * p.sgh;
  bf16* dvb = p.dv + b * p.sgb + hk * p.sgh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + tig * 2;
    if (key0 < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key0 * p.sgs + d) =
          __floats2bfloat162_rn(dk[n][0], dk[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key0 * p.sgs + d) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (key1 < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key1 * p.sgs + d) =
          __floats2bfloat162_rn(dk[n][2], dk[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key1 * p.sgs + d) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------- K3: dQ

constexpr size_t K3_TILE = (size_t)BK * LD * sizeof(bf16);
constexpr size_t K3_Q_OFF = 0;
constexpr size_t K3_DO_OFF = K3_Q_OFF + (size_t)BQ3 * LD * sizeof(bf16);
constexpr size_t K3_K_OFF = K3_DO_OFF + (size_t)BQ3 * LD * sizeof(bf16);  // 2 stages
constexpr size_t K3_V_OFF = K3_K_OFF + 2 * K3_TILE;                       // 2 stages
constexpr size_t K3_ROW_OFF = K3_V_OFF + 2 * K3_TILE;  // lse, delta, qseg; kseg 2 stages
constexpr size_t K3_SMEM = K3_ROW_OFF + (3 * BQ3 + 2 * BK) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + K3_Q_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + K3_DO_OFF);
  bf16* Kst = reinterpret_cast<bf16*>(smem + K3_K_OFF);
  bf16* Vst = reinterpret_cast<bf16*>(smem + K3_V_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + K3_ROW_OFF);
  float* dl_s = lse_s + BQ3;
  int* qseg_s = reinterpret_cast<int*>(dl_s + BQ3);
  int* kseg_st = qseg_s + BQ3;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x, q0 = qt * BQ3, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const bool segs = p.qseg != nullptr;
  const int nqt = (p.S + BQ3 - 1) / BQ3;
  const int nkt_all = (p.Sk + BK - 1) / BK;
  const int n_kt = p.causal ? min(nkt_all, (q0 + BQ3 - 1) / BK + 1) : nkt_all;

  stage_rows<BQ3, NTHREADS>(Qs, p.q + b * p.sqb + h * p.sqh, p.sqs, q0, p.S, tid);
  stage_rows<BQ3, NTHREADS>(dOs, p.dout + b * p.sob + h * p.soh, p.sos, q0, p.S, tid);
  if (tid < BQ3) {
    const int row = q0 + tid;
    const bool ok = row < p.S;
    const long long r = ((long long)b * p.H + h) * p.S + row;
    lse_s[tid] = ok ? p.lse[r] : 0.f;
    dl_s[tid] = ok ? p.delta[r] : 0.f;
    qseg_s[tid] = (segs && ok) ? p.qseg[b * p.qsegb + row] : 0;
  }
  auto next_tile = [&](int j) -> int {
    while (j < n_kt && !tiles_meet(p, b, qt, nqt, j, nkt_all)) ++j;
    return j;
  };
  auto load_kv = [&](int j, int st) {
    const int k0 = j * BK;
    stage_rows<BK, NTHREADS>(Kst + st * BK * LD, p.k + b * p.skb + hk * p.skh, p.sks, k0, p.Sk,
                             tid);
    stage_rows<BK, NTHREADS>(Vst + st * BK * LD, p.v + b * p.svb + hk * p.svh, p.svs, k0, p.Sk,
                             tid);
    if (tid < BK)
      kseg_st[st * BK + tid] = (segs && k0 + tid < p.Sk) ? p.kseg[b * p.ksegb + k0 + tid] : 0;
  };

  const int mrow = warp * 16;
  const int row0 = q0 + mrow + g, row1 = row0 + 8;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int cur = next_tile(0), st = 0;
  if (cur < n_kt) load_kv(cur, 0);
  cp_async_commit();  // Q and dO ride in the first group
  __syncthreads();    // lse / delta / qseg stores are visible
  const float lse0 = lse_s[mrow + g], lse1 = lse_s[mrow + g + 8];
  const float dl0 = dl_s[mrow + g], dl1 = dl_s[mrow + g + 8];
  const int qs0 = qseg_s[mrow + g], qs1 = qseg_s[mrow + g + 8];
  while (cur < n_kt) {
    const int nxt = next_tile(cur + 1);
    if (nxt < n_kt) {
      load_kv(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Kst + st * BK * LD;
    const bf16* Vs = Vst + st * BK * LD;
    const int* kseg_s = kseg_st + st * BK;
    const int k0 = cur * BK;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], da[4];
      load_a(qa, Qs, mrow, kk * 16, lane);
      load_a(da, dOs, mrow, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const bf16* kp = Ks + (n * 8 + g) * LD + kk * 16 + tig * 2;
        const bf16* vp = Vs + (n * 8 + g) * LD + kk * 16 + tig * 2;
        mma_bf16(s[n], qa, lds32(kp), lds32(kp + 8));
        mma_bf16(dp[n], da, lds32(vp), lds32(vp + 8));
      }
    }

    // dS = P * (dP - delta) * scale, packed to bf16 A fragments (k = keys)
    unsigned dsa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + tig * 2 + (e & 1);
        const int col = k0 + cl;
        const int row = e < 2 ? row0 : row1;
        bool ok = col < p.Sk && row < p.S;
        if (p.causal) ok = ok && col <= row;
        if (segs) ok = ok && kseg_s[cl] == (e < 2 ? qs0 : qs1);
        const float pv = ok ? expf(s[n][e] * p.scale - (e < 2 ? lse0 : lse1)) : 0.f;
        dsv[e] = pv * (dp[n][e] - (e < 2 ? dl0 : dl1)) * p.scale;
      }
      dsa[n / 2][(n & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      dsa[n / 2][(n & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dQ += dS K: K fragments transposed out of shared memory
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Ks + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * np], dsa[kk], r[0], r[1]);
        mma_bf16(dq[2 * np + 1], dsa[kk], r[2], r[3]);
      }
    }
    __syncthreads();
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();  // a block with no live tile still retires its Q/dO copies

  bf16* db = p.dq + b * p.sgb + h * p.sgh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + tig * 2;
    if (row0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(db + (long long)row0 * p.sgs + d) =
          __floats2bfloat162_rn(dq[n][0], dq[n][1]);
    if (row1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(db + (long long)row1 * p.sgs + d) =
          __floats2bfloat162_rn(dq[n][2], dq[n][3]);
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qseg, const void* kseg,
                   const void* qmin, const void* qmax, const void* kmin, const void* kmax,
                   int B, int S, int Sk, int H, int Hkv, int causal, const long long* st,
                   float scale) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
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
  p.sqb = st[0]; p.sqs = st[1]; p.sqh = st[2];
  p.skb = st[3]; p.sks = st[4]; p.skh = st[5];
  p.svb = st[6]; p.svs = st[7]; p.svh = st[8];
  p.sob = st[9]; p.sos = st[10]; p.soh = st[11];
  p.sgb = st[12]; p.sgs = st[13]; p.sgh = st[14];
  p.qsegb = st[15]; p.ksegb = st[16];
  p.scale = scale;
  return p;
}

}  // namespace

// Strides `st` (17 values, in elements): q, k, v, dout, then the output
// (dq for K3; dk and dv, which share one layout, for K2), each as (batch,
// seq, head); then the row strides of qseg and kseg.
extern "C" int nxd_flash_attention_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* qseg, const void* kseg,
    const void* qmin, const void* qmax, const void* kmin, const void* kmax,
    int B, int S, int Sk, int H, int Hkv, int causal, const long long* st, float scale,
    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, qmin, qmax, kmin, kmax, B, S, Sk,
                         H, Hkv, causal, st, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  cudaFuncSetAttribute(flash_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)K2_SMEM);
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  flash_dkdv_kernel<<<grid, NTHREADS, K2_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int nxd_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* qseg, const void* kseg,
    const void* qmin, const void* qmax, const void* kmin, const void* kmax,
    int B, int S, int Sk, int H, int Hkv, int causal, const long long* st, float scale,
    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, qmin, qmax, kmin, kmax, B, S, Sk,
                         H, Hkv, causal, st, scale);
  p.dq = static_cast<bf16*>(dq);
  cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)K3_SMEM);
  dim3 grid((S + BQ3 - 1) / BQ3, H, B);
  flash_dq_kernel<<<grid, NTHREADS, K3_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int nxd_flash_attention_bwd_head_dim() { return D; }

// Query rows per tile of the segment ranges each kernel reads (qmin/qmax).
extern "C" int nxd_flash_attention_dkdv_q_tile() { return BQ2; }
extern "C" int nxd_flash_attention_dq_q_tile() { return BQ3; }
extern "C" int nxd_flash_attention_bwd_k_tile() { return BK; }
