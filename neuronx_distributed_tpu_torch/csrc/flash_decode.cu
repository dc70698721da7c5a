// Decode attention against the row-per-slot KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` / `_flash_decode_call`
// (neuronx_distributed_tpu/kernels/flash_decode.py:233,285): the R = group*s
// query rows of one kv-head attend the cache (B, L, Hkv, D) in one pass with
// an online softmax; each row sees slots <= its position minus the slots
// `kv_valid` marks invalid; columns past max(pos) are never read. Emits O and
// LSE (-1e30 where a row saw no live slot).
//
// What bounds it on an H100: bytes. Every cache column read (K and V, 2*D
// bf16 per kv-head) feeds only 4*R*D FLOPs — R = 4 for Llama-3-8B at s = 1,
// about 4 FLOP per byte against the card's ~295 — so the floor is the K/V
// bytes up to the bound over 3.35 TB/s. The design streams each K/V byte
// from device memory once, with many bytes in flight, keeps scores and the
// softmax state on chip, and stops at the live bound instead of at L.
//
// Design (right and simple first):
//  * one block of 256 threads per (kv-head, batch row); the cache length is
//    a loop of 128-column tiles inside the block;
//  * each tile's K and V (64 KB) are copied to shared memory with 16-byte
//    `cp.async` loads, double-buffered: the next tile is in flight while the
//    current one is scored, so a block keeps ~64 KB of loads outstanding;
//  * phase 1: two threads per column score it against all R rows (q staged
//    in shared memory in f32); phase 2: one warp per row folds the tile into
//    that row's (m, l), with the TPU kernel's guard for rows that have seen
//    no live slot (exp reference 0); phase 3: each thread owns two head-dim
//    lanes of a few rows and accumulates P·V (P in f32) in registers.
// One block per (b, kv-head) fills only B*Hkv SMs (64 of 132 at 8 slots and
// 8 kv-heads); splitting L across blocks is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;
constexpr int NTHREADS = 256;
constexpr int TL = 128;                 // cache columns per tile
constexpr int KP = D + 16;              // K tile row pitch (bf16): conflict-free 16-byte reads
constexpr int NG = NTHREADS / (D / 2);  // row groups in phase 3
constexpr int CHUNKS = D / 8;           // 16-byte chunks per cache row
constexpr float NEG_INF = -1e30f;
constexpr size_t STAGE_BYTES = (size_t)TL * (KP + D) * sizeof(bf16);

struct Params {
  const bf16* q; const bf16* k; const bf16* v; bf16* o; float* lse;
  const int* q_pos; const uint8_t* kv_valid;
  int s, H, Hkv, L;
  long long sqb, sqs, sqh, skb, skl, skh, svb, svl, svh, sob, sos, soh, validb;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Issue the copies of columns [c0, min(c0 + TL, bound)) of K and V.
__device__ __forceinline__ void load_tile(unsigned char* stage, const bf16* kbase,
                                          const bf16* vbase, long long skl, long long svl,
                                          int c0, int bound, int tid) {
  bf16* Ks = reinterpret_cast<bf16*>(stage);
  bf16* Vs = Ks + TL * KP;
  for (int i = tid; i < TL * CHUNKS; i += NTHREADS) {
    const int c = i / CHUNKS, ch = (i % CHUNKS) * 8;
    if (c0 + c < bound) {
      cp_async16(Ks + c * KP + ch, kbase + (long long)(c0 + c) * skl + ch);
      cp_async16(Vs + c * D + ch, vbase + (long long)(c0 + c) * svl + ch);
    }
  }
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  unsigned char* stages = dsm;                                        // 2 x [K | V]
  float* q_s = reinterpret_cast<float*>(dsm + 2 * STAGE_BYTES);       // [RMAX][D]
  float* S_s = q_s + RMAX * D;                                        // [RMAX][TL]
  float* m_s = S_s + RMAX * TL;                                       // [RMAX]
  float* l_s = m_s + RMAX;
  float* a_s = l_s + RMAX;
  int* pos_s = reinterpret_cast<int*>(a_s + RMAX);                    // [RMAX]
  int* bound_s = pos_s + RMAX;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int R = G * p.s;  // row r = g * s + t  ->  q-head hk*G + g, token t

  for (int i = tid; i < R * D; i += NTHREADS) {
    const int r = i / D, d = i % D, g = r / p.s, t = r % p.s;
    q_s[i] = __bfloat162float(p.q[b * p.sqb + t * p.sqs + (hk * G + g) * p.sqh + d]);
  }
  if (tid < R) {
    pos_s[tid] = p.q_pos[tid % p.s];
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  if (tid == 0) {
    int mx = -1;
    for (int t = 0; t < p.s; ++t) mx = max(mx, p.q_pos[t]);
    *bound_s = min(mx + 1, p.L);
  }
  __syncthreads();
  const int bound = *bound_s;
  const int n_tiles = (bound + TL - 1) / TL;

  const bf16* kbase = p.k + b * p.skb + hk * p.skh;
  const bf16* vbase = p.v + b * p.svb + hk * p.svh;
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.validb : nullptr;

  const int dp = (tid % (D / 2)) * 2;  // phase 3: this thread's two head-dim lanes
  const int rg = tid / (D / 2);        // and its rows rg, rg + NG, ...
  constexpr int RPT = (RMAX + NG - 1) / NG;
  float acc[RPT][2];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k][0] = acc[k][1] = 0.f;

  if (n_tiles > 0) load_tile(stages, kbase, vbase, p.skl, p.svl, 0, bound, tid);
  cp_async_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * TL;
    if (tile + 1 < n_tiles) {
      load_tile(stages + ((tile + 1) & 1) * STAGE_BYTES, kbase, vbase, p.skl, p.svl,
                c0 + TL, bound, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this tile landed; the next stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = reinterpret_cast<const bf16*>(stages + (tile & 1) * STAGE_BYTES);
    const bf16* Vs = Ks + TL * KP;

    // phase 1: two threads per column, interleaved 16-byte chunks of D
    {
      const int c = tid >> 1, h = tid & 1, j = c0 + c;
      float dots[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dots[r] = 0.f;
      if (j < bound) {
#pragma unroll
        for (int i = 0; i < CHUNKS / 2; ++i) {
          const int d0 = (2 * i + h) * 8;
          const int4 raw = *reinterpret_cast<const int4*>(Ks + c * KP + d0);
          const __nv_bfloat162* kv2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float kf[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(kv2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r < R) {
              const float4 qa = *reinterpret_cast<const float4*>(q_s + r * D + d0);
              const float4 qb = *reinterpret_cast<const float4*>(q_s + r * D + d0 + 4);
              dots[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                         qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dots[r] += __shfl_xor_sync(0xffffffffu, dots[r], 1);
      if (h == 0) {
        const bool live = j < bound && (valid == nullptr || valid[j] != 0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < R) S_s[r * TL + c] = (live && pos_s[r] >= j) ? dots[r] * p.scale : NEG_INF;
      }
    }
    __syncthreads();

    // phase 2: fold the tile into each row's softmax state
    for (int r = warp; r < R; r += NTHREADS / 32) {
      float* srow = S_s + r * TL;
      float mx = NEG_INF;
      for (int i = lane; i < TL; i += 32) mx = fmaxf(mx, srow[i]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float ref = m_new > NEG_INF * 0.5f ? m_new : 0.f;
      float sum = 0.f;
      for (int i = lane; i < TL; i += 32) {
        const float pv = expf(srow[i] - ref);
        srow[i] = pv;
        sum += pv;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - ref);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // phase 3: acc = acc * alpha + P V over the tile's columns
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = rg + k * NG;
      if (r < R) {
        acc[k][0] *= a_s[r];
        acc[k][1] *= a_s[r];
      }
    }
    const int ncols = min(TL, bound - c0);
#pragma unroll 8
    for (int jj = 0; jj < ncols; ++jj) {
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vs + jj * D + dp));
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg + k * NG;
        if (r < R) {
          const float pr = S_s[r * TL + jj];
          acc[k][0] += pr * vf.x;
          acc[k][1] += pr * vf.y;
        }
      }
    }
    __syncthreads();  // the stage and S_s are rewritten next
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = rg + k * NG;
    if (r < R) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      const int g = r / p.s, t = r % p.s;
      __nv_bfloat162 out;
      out.x = __float2bfloat16(acc[k][0] * inv);
      out.y = __float2bfloat16(acc[k][1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(
          p.o + b * p.sob + t * p.sos + (hk * G + g) * p.soh + dp) = out;
    }
  }
  if (tid < R)
    p.lse[((long long)b * p.Hkv + hk) * R + tid] =
        l_s[tid] > 0.f ? m_s[tid] + logf(l_s[tid]) : NEG_INF;
}

template <int RMAX>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = 2 * STAGE_BYTES + (size_t)RMAX * (D + TL) * sizeof(float) +
                      3 * RMAX * sizeof(float) + (RMAX + 1) * sizeof(int);
  cudaFuncSetAttribute(flash_decode_kernel<RMAX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(p.Hkv, B);
  flash_decode_kernel<RMAX><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nxd_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* kv_valid,
    int B, int s, int H, int Hkv, int L,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sos, long long soh,
    long long validb, float scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.s = s; p.H = H; p.Hkv = Hkv; p.L = L;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.skl = skl; p.skh = skh;
  p.svb = svb; p.svl = svl; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.validb = validb;
  p.scale = scale;
  const int R = (H / Hkv) * s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 4) return launch<4>(p, B, st);
  if (R <= 8) return launch<8>(p, B, st);
  if (R <= 16) return launch<16>(p, B, st);
  if (R <= 32) return launch<32>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nxd_flash_decode_max_rows() { return 32; }
extern "C" int nxd_flash_decode_head_dim() { return D; }
