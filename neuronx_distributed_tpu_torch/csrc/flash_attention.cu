// Flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces the TPU kernel `_fwd_kernel` / `_flash_fwd`
// (neuronx_distributed_tpu/kernels/flash_attention.py:78,179): causal
// attention with online softmax, an optional equal-segment mask (padding =
// segment -1), GQA by q-head h -> kv-head h / group, emitting O and
// LSE = m + log(l).
//
// What bounds it on an H100: at the prefill shapes (S = 4096, D = 128) the
// work is ~2*B*H*S^2*D causal FLOPs against ~4*B*S*(H+2*Hkv)*D bytes, about
// 1000 FLOP per byte — tensor-core bound (989 TFLOP/s bf16). So both
// products run on the tensor cores (`mma.sync` m16n8k16 bf16, f32
// accumulation), K/V tiles are staged once in shared memory and reused by
// the 64 query rows of the block, and the S x S score matrix never leaves
// the registers.
//
// Design (flash-attention-2 shape; `wgmma`, TMA and warp specialisation are
// later work):
//  * one block of 4 warps per (64-row query tile, q-head, batch); each warp
//    owns 16 query rows; the K/V sequence is a loop inside the block (the
//    TPU grid's sequential axis);
//  * the warp's Q fragments, its scores, P and the running output all live
//    in registers in the mma fragment layouts: a row's max and sum reduce
//    over the 4 lanes that hold it, the output is rescaled in place, and the
//    score accumulators turn into the A operand of P·V without touching
//    shared memory (P rounded to bf16 for that product, l summed in f32);
//  * K/V tiles are copied with 16-byte `cp.async`, double-buffered: the next
//    tile loads while the current one is multiplied;
//  * Q, K, V are read in place through their strides: (B, S, H, D) layout,
//    no host transposes; ragged edges (any S) are masked in-kernel;
//  * K tiles above the causal diagonal are never visited, and tiles whose
//    segment-id range cannot meet the query tile's are skipped;
//  * rows that have seen no live key keep m = -1e30 and use 0 as the exp
//    reference, exactly the TPU kernel's guard, so l stays 0, O = 0 and
//    LSE ~ -1e30.
#include <climits>

#include "flash_common.cuh"

namespace {

using namespace nxd_flash;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NTHREADS = 128;

constexpr size_t TILE = (size_t)BK * LD * sizeof(bf16);
constexpr size_t Q_OFF = 0;
constexpr size_t K_OFF = Q_OFF + (size_t)BQ * LD * sizeof(bf16);
constexpr size_t V_OFF = K_OFF + 2 * TILE;
constexpr size_t SEG_OFF = V_OFF + 2 * TILE;
constexpr size_t SMEM_BYTES = SEG_OFF + (BQ + 2 * BK + 4) * sizeof(int);

struct Params {
  const bf16* q; const bf16* k; const bf16* v; bf16* o; float* lse;
  const int* qseg; const int* kseg;
  int B, S, Sk, H, Hkv, causal;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh;
  long long qsegb, ksegb;
  float scale;
};

// Issue the copies of K/V rows [k0, k0 + BK) (zero rows past Sk, so P·V
// never multiplies garbage) and stage the tile's key segment ids.
__device__ __forceinline__ void load_kv(const Params& p, bf16* Ks, bf16* Vs, int* kseg_s,
                                        int b, int hk, int k0, int tid) {
  const bf16* kb = p.k + b * p.skb + hk * p.skh;
  const bf16* vb = p.v + b * p.svb + hk * p.svh;
  constexpr int VPR = D / 8;
  for (int i = tid; i < BK * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (k0 + r < p.Sk) {
      cp_async16(Ks + r * LD + c, kb + (long long)(k0 + r) * p.sks + c);
      cp_async16(Vs + r * LD + c, vb + (long long)(k0 + r) * p.svs + c);
    } else {
      *reinterpret_cast<int4*>(Ks + r * LD + c) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(Vs + r * LD + c) = make_int4(0, 0, 0, 0);
    }
  }
  if (p.qseg != nullptr && tid < BK)
    kseg_s[tid] = k0 + tid < p.Sk ? p.kseg[b * p.ksegb + k0 + tid] : 0;
}

__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  bf16* Kst = reinterpret_cast<bf16*>(smem + K_OFF);  // 2 stages
  bf16* Vst = reinterpret_cast<bf16*>(smem + V_OFF);  // 2 stages
  int* qseg_s = reinterpret_cast<int*>(smem + SEG_OFF);
  int* kseg_st = qseg_s + BQ;                          // 2 stages of BK
  int* misc = kseg_st + 2 * BK;  // [0] q seg min, [1] q seg max, [2] next tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q_valid = min(BQ, p.S - q0);
  const bool segs = p.qseg != nullptr;

  // Q tile and its segment ids
  {
    const bf16* qb = p.q + b * p.sqb + h * p.sqh;
    constexpr int VPR = D / 8;
    for (int i = tid; i < BQ * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      int4 val = make_int4(0, 0, 0, 0);
      if (r < q_valid) val = *reinterpret_cast<const int4*>(qb + (long long)(q0 + r) * p.sqs + c);
      *reinterpret_cast<int4*>(Qs + r * LD + c) = val;
    }
    if (tid < BQ) qseg_s[tid] = (segs && tid < q_valid) ? p.qseg[b * p.qsegb + q0 + tid] : 0;
  }
  __syncthreads();
  if (segs && warp == 0) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = lane; r < q_valid; r += 32) {
      mn = min(mn, qseg_s[r]);
      mx = max(mx, qseg_s[r]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) { misc[0] = mn; misc[1] = mx; }
  }
  __syncthreads();

  int n_kt = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  // first tile at or after t whose key segment range can meet this query
  // tile's (block-uniform; every tile when there are no segments)
  auto next_tile = [&](int t) -> int {
    if (!segs) return t;
    for (; t < n_kt; ++t) {
      if (warp == 0) {
        const int k0 = t * BK, kv = min(BK, p.Sk - k0);
        int mn = INT_MAX, mx = INT_MIN;
        for (int c = lane; c < kv; c += 32) {
          const int s = p.kseg[b * p.ksegb + k0 + c];
          mn = min(mn, s);
          mx = max(mx, s);
        }
        for (int o = 16; o > 0; o >>= 1) {
          mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) misc[2] = (misc[1] >= mn) && (misc[0] <= mx);
      }
      __syncthreads();
      const bool run = misc[2];
      __syncthreads();
      if (run) break;
    }
    return t;
  };

  // this warp's 16 query rows as mma A fragments, for all of D
  const int mrow = warp * 16;
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* base = Qs + (mrow + g) * LD + kk * 16 + tig * 2;
    qa[kk][0] = lds32(base);
    qa[kk][1] = lds32(base + 8 * LD);
    qa[kk][2] = lds32(base + 8);
    qa[kk][3] = lds32(base + 8 * LD + 8);
  }
  const int row0 = q0 + mrow + g, row1 = row0 + 8;
  const int qs0 = qseg_s[mrow + g], qs1 = qseg_s[mrow + g + 8];

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int cur = next_tile(0), stage = 0;
  if (cur < n_kt) load_kv(p, Kst, Vst, kseg_st, b, hk, cur * BK, tid);
  cp_async_commit();
  while (cur < n_kt) {
    const int nxt = next_tile(cur + 1);
    if (nxt < n_kt) {
      load_kv(p, Kst + (stage ^ 1) * BK * LD, Vst + (stage ^ 1) * BK * LD,
              kseg_st + (stage ^ 1) * BK, b, hk, nxt * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();  // the current tile has landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Kst + stage * BK * LD;
    const bf16* Vs = Vst + stage * BK * LD;
    const int* kseg_s = kseg_st + stage * BK;
    const int k0 = cur * BK;

    // S = Q K^T: 8 column tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const bf16* kp = Ks + (n * 8 + g) * LD + kk * 16 + tig * 2;
        mma_bf16(s[n], qa[kk], lds32(kp), lds32(kp + 8));
      }
    }

    // mask, scale and the row maxima (a row lives on 4 lanes)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + tig * 2 + (e & 1);
        const int col = k0 + cl;
        const int row = e < 2 ? row0 : row1;
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && col <= row;
        if (segs) ok = ok && kseg_s[cl] == (e < 2 ? qs0 : qs1);
        const float v = ok ? s[n][e] * p.scale : NEG_INF;
        s[n][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ref0 = mn0 > NEG_INF * 0.5f ? mn0 : 0.f;
    const float ref1 = mn1 > NEG_INF * 0.5f ? mn1 : 0.f;
    const float alpha0 = expf(m0 - ref0), alpha1 = expf(m1 - ref1);

    // P = exp(S - ref): f32 row sums, bf16 A fragments for P V
    float sum0 = 0.f, sum1 = 0.f;
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = expf(s[n][0] - ref0), p1 = expf(s[n][1] - ref0);
      const float p2 = expf(s[n][2] - ref1), p3 = expf(s[n][3] - ref1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha0; o[n][1] *= alpha0;
      o[n][2] *= alpha1; o[n][3] *= alpha1;
    }

    // O += P V: V fragments transposed out of shared memory by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // the stage is rewritten two tiles on
    cur = nxt;
    stage ^= 1;
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.sob + h * p.soh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + tig * 2;
    if (row0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * p.sos + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * p.sos + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (tig == 0) {
    float* lb = p.lse + ((long long)b * p.H + h) * p.S;
    if (row0 < p.S) lb[row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row1 < p.S) lb[row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

}  // namespace

extern "C" int nxd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* qseg, const void* kseg,
    int B, int S, int Sk, int H, int Hkv, int causal,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    long long qsegb, long long ksegb, float scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.B = B; p.S = S; p.Sk = Sk; p.H = H; p.Hkv = Hkv; p.causal = causal;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.qsegb = qsegb; p.ksegb = ksegb;
  p.scale = scale;
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int nxd_flash_attention_head_dim() { return D; }
