// Decode attention against the KV cache for Hopper (sm_90a): the row-per-slot
// layout (K4) and the paged layout (K5), one tile loop for both, split over
// the cache length ("flash-decoding") and merged by LSE.
//
// K4 replaces the TPU kernel `_decode_kernel` / `_flash_decode_call`
// (neuronx_distributed_tpu/kernels/flash_decode.py:233,285): the R = group*s
// query rows of one kv-head attend the cache (B, L, Hkv, D) with an online
// softmax; each row sees slots <= its position minus the slots `kv_valid`
// marks invalid; columns past max(pos) are never read. Emits O and LSE
// (-1e30, and O = 0, where a row saw no live slot).
//
// K5 replaces `_paged_decode_kernel` / `paged_flash_decode_attention`
// (neuronx_distributed_tpu/kernels/flash_decode.py:481,532,617): the same
// math with K/V read straight from a page pool (P, page_size, Hkv, D)
// through a block table (B, n_log) int32 — logical column c of slot b is row
// c % page_size of pool page bt[b, c / page_size]. Page 0 is the null page:
// unmapped logical pages point at it and `kv_valid` masks their columns.
// K5 is K4 with each column's address read through the table (`PagedCols`
// for `RowCols`); everything else — the split plan, which tiles and columns
// are read, every sum and its order, the merge — depends only on B, Hkv, R,
// L, `q_pos` and `kv_valid`, never on the layout, strides or pool. So K5
// through a table equals K4 on the gathered logical view bit for bit (the
// reference's contract, flash_decode.py:548-552). There is no scalar
// prefetch on Hopper: a thread reads the table entry of each column it
// copies (L1-resident) before issuing the copy.
//
// What bounds both on an H100: bytes. Every live cache column (K and V, 2*D
// bf16 of one kv-head, 512 B) feeds only 4*R*D FLOPs — R = 4 for Llama-3-8B
// at s = 1, about 4 FLOP per byte against the card's ~295 — so the floor is
// the LIVE K/V bytes over 3.35 TB/s. The design:
//
//  * Split the length. The grid is (Hkv, B, L / SPLIT): one block of 256
//    threads per 256-column range of one (slot, kv-head), the range index
//    slowest so the ranges near the front of every slot go first. The host
//    sizes the grid from L alone; a block whose range starts at or past the
//    live bound max(q_pos) + 1 exits at once (the Pallas kernel's `run`
//    guard, flash_decode.py:246). At 8 slots x 8 kv-heads and a bound of
//    4100, 1088 blocks run, about four waves at two blocks an SM, so the
//    scheduler evens out slots with much and little live cache.
//  * Skip dead tiles and columns. A block first reads its range's 256
//    `kv_valid` bytes (one per thread); a 64-column tile with no live column
//    is neither loaded nor scored, and inside a live tile a dead column is
//    not read either (`cp.async` zero-fills it). Skipping a dead tile is
//    exact: all its scores would be -1e30, so the tile max is -1e30 and
//    m_new = m_prev. If the row already has a live m, ref = m_prev, alpha =
//    expf(0) = 1 and every p = expf(-1e30 - ref) = 0: l and acc are
//    unchanged. If it has none yet, ref = 0 and alpha = p = 0, which is the
//    initial state. Zero-filled dead columns score -1e30 as well (masked),
//    and their p = 0 multiplies V = 0. For K5 this stops the re-reads of
//    the null page.
//  * Keep bytes in flight. Tiles of 64 columns (K 17 KB + V 16 KB) go
//    through a 3-stage ring of 16-byte `cp.async` copies, two tiles ahead;
//    ~106 KB of shared memory a block lets two blocks share an SM. (TMA bulk
//    copies, one per 256-byte column, measured slower here.)
//  * Work per tile. S = Q K^T on the tensor cores (`mma.sync` m16n8k16,
//    bf16 in, f32 sums of exact products; rows past R are zero): each warp
//    scores 8 columns and writes its row maxima. Then every thread owns 8
//    head-dim lanes x 4 rows over a fixed subset of the tile's columns: it
//    rescales its accumulators by alpha, forms p = expf(s - ref) in f32 for
//    its share of the columns (no warp idles at R = 4), and after a
//    half-warp barrier accumulates P V on the CUDA cores from 16-byte V
//    loads, P kept in f32. Two block barriers per tile.
//  * Merge. Each block reduces its column groups in a fixed order and
//    writes its range's O (normalised, f32) and LSE to a workspace the
//    wrapper allocates. A second kernel, one block per (slot, kv-head, row)
//    and one thread per head-dim lane, merges the ranges in range order by
//    the JAX length split's rule (flash_decode.py:442-453): m = max lse, w =
//    exp(lse - m) (0 where lse <= -1e30/2), O = sum w o / max(sum w, 1e-30),
//    LSE = m + log(sum w). No atomics: K4 and K5 are bitwise reproducible
//    run to run.
//
// More than 32 rows (R = group * s for a suffix prefill of s tokens behind a
// reused prefix, the Pallas kernel's one block of R rows): the split path's
// partials would be (n_splits, B, Hkv, R, D) f32, over a GB at R = 8192 and
// L = 8192, and the rows alone give parallelism enough. So the multi-row
// path runs one block per (32-row tile, kv-head, slot), which walks its
// rows' whole live length range by range through the same tile loop, with
// its softmax state in registers, and writes O and LSE itself: no
// workspace, no merge, one launch. A row tile takes 32 / G suffix tokens of
// every head of the group (rows fold as r = g * s + t) and reads columns up
// to its own largest position only. What bounds it at a 1600-column prefix
// and a 200-token suffix is operations (~4 D R per live column, ~800 FLOP a
// byte); this path is right and simple first: `mma.sync` for Q K^T, P V on
// the CUDA cores, K/V re-read by every row tile, and at the 32-row plan's
// ~120 KB of shared memory one block an SM (the `wgmma` redesign is later
// work). R <= 32 keeps the split plan above, bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using nxd_flash::bf16;
using nxd_flash::D;
using nxd_flash::NEG_INF;
using nxd_flash::cp_async_commit;
using nxd_flash::cp_async_wait;
using nxd_flash::lds32;
using nxd_flash::load_a;
using nxd_flash::mma_bf16;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TL = 64;                   // cache columns per tile: 8 per warp in S = Q K^T
constexpr int SPLIT_TILES = 4;
constexpr int SPLIT = SPLIT_TILES * TL;  // columns per block
constexpr int STAGES = 3;
constexpr int KP = nxd_flash::LD;        // K and Q row pitch (D + 8): conflict-free fragments
constexpr int CHUNKS = D / 8;            // 16-byte chunks per cache row
constexpr int STAGE_BYTES = TL * (KP + D) * (int)sizeof(bf16);
constexpr int RMAX_ALL = 32;             // rows of the split path; more take the multi-row path
constexpr int ROW_TILE = RMAX_ALL;       // rows a block of the multi-row path holds: the largest plan
constexpr int MERGE_CHUNK = 32;          // ranges whose loads the merge issues together
static_assert(TL == 8 * NWARPS, "each warp scores one 8-column slice of a tile");
static_assert(SPLIT == NTHREADS && TL % 32 == 0, "a thread per column; a warp's vote in one tile");
static_assert(SPLIT_TILES <= 32, "live tiles are a bit mask");

// K5 reads skb/svb as the pool's page stride and skl/svl as the stride of a
// row inside a page; bt/sbt/ps_shift are K5's alone.
struct Params {
  const bf16* q; const bf16* k; const bf16* v; bf16* o; float* lse;
  const int* q_pos; const uint8_t* kv_valid; const int* bt;
  float* wo; float* wl;  // workspace: O (f32) and LSE of every range
  int B, s, H, Hkv, L, ps_shift, n_splits;
  long long sqb, sqs, sqh, skb, skl, skh, svb, svl, svh, sob, sos, soh, validb, sbt;
  float scale;
};

// K4: column c of slot b's cache row.
struct RowCols {
  const bf16* k; const bf16* v; long long skl, svl;
  __device__ RowCols(const Params& p, int b, int hk)
      : k(p.k + b * p.skb + hk * p.skh), v(p.v + b * p.svb + hk * p.svh),
        skl(p.skl), svl(p.svl) {}
  __device__ __forceinline__ void at(int c, const bf16*& kc, const bf16*& vc) const {
    kc = k + (long long)c * skl;
    vc = v + (long long)c * svl;
  }
};

// K5: logical column c of slot b through its block-table row.
struct PagedCols {
  const bf16* k; const bf16* v; const int* bt; int shift, mask;
  long long skp, skr, svp, svr;
  __device__ PagedCols(const Params& p, int b, int hk)
      : k(p.k + hk * p.skh), v(p.v + hk * p.svh), bt(p.bt + b * p.sbt),
        shift(p.ps_shift), mask((1 << p.ps_shift) - 1),
        skp(p.skb), skr(p.skl), svp(p.svb), svr(p.svl) {}
  __device__ __forceinline__ void at(int c, const bf16*& kc, const bf16*& vc) const {
    const long long page = __ldg(bt + (c >> shift));
    const int row = c & mask;
    kc = k + page * skp + row * skr;
    vc = v + page * svp + row * svr;
  }
};

// Shared memory of one block at R <= RMAX.
template <int RMAX>
struct Smem {
  static constexpr int MT = (RMAX + 15) / 16;  // 16-row m-tiles of S = Q K^T
  static constexpr int NRG = RMAX / 4;         // row groups of 4 in P V
  static constexpr int NCG = 16 / NRG;         // column groups in P V
  unsigned char* stages;  // STAGES x [K (TL x KP) | V (TL x D)] bf16; later the reductions
  bf16* q;                // [16 MT][KP]
  float* S;               // [TL][RMAX]: scores, then p
  float* wmax;            // [RMAX][NWARPS]
  float* lred;            // [NCG][RMAX]
  float* m;               // [RMAX]
  int* pos;               // [16 MT]
  int* wlive;             // [NWARPS]: whether each warp read a live column
  uint8_t* live;          // [SPLIT]
  static constexpr size_t bytes() {
    return (size_t)STAGES * STAGE_BYTES + 16 * MT * KP * sizeof(bf16) +
           ((size_t)TL * RMAX + RMAX * NWARPS + NCG * RMAX + RMAX) * sizeof(float) +
           (16 * MT + NWARPS) * sizeof(int) + SPLIT;
  }
  __device__ explicit Smem(unsigned char* dsm) {
    stages = dsm;
    q = reinterpret_cast<bf16*>(dsm + STAGES * STAGE_BYTES);
    S = reinterpret_cast<float*>(q + 16 * MT * KP);
    wmax = S + TL * RMAX;
    lred = wmax + RMAX * NWARPS;
    m = lred + NCG * RMAX;
    pos = reinterpret_cast<int*>(m + RMAX);
    wlive = pos + 16 * MT;
    live = reinterpret_cast<uint8_t*>(wlive + NWARPS);
  }
};

// 16-byte copy that reads `n` (0 or 16) bytes of src and zero-fills the rest.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// The position of the (n+1)-th set bit of mask (n >= 0).
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
  for (int k = 0; k < n; ++k) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// Issue the copies of tile `tile` of the range starting at c_begin: live
// columns are read, dead ones zero-filled without a read.
template <class Cols>
__device__ __forceinline__ void load_tile(unsigned char* stage, const Cols& cols,
                                          const uint8_t* live_s, int c_begin, int tile, int tid) {
  bf16* Ks = reinterpret_cast<bf16*>(stage);
  bf16* Vs = Ks + TL * KP;
#pragma unroll
  for (int j = 0; j < TL * CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int c = i / CHUNKS, ch = (i % CHUNKS) * 8;
    const int cs = tile * TL + c;  // column within the range
    const bf16 *kc = cols.k, *vc = cols.v;
    const bool live = live_s[cs] != 0;
    if (live) cols.at(c_begin + cs, kc, vc);
    cp_async16_zfill(Ks + c * KP + ch, kc + ch, live ? 16 : 0);
    cp_async16_zfill(Vs + c * D + ch, vc + ch, live ? 16 : 0);
  }
}

// The softmax state of a block's rows that one thread carries: P V
// accumulators of head-dim lanes [8 dg, 8 dg + 8) of rows [4 rg, 4 rg + 4),
// those rows' running maxima, and its share of one row's exp-sum.
struct RowState {
  float acc[4][8];
  float m[4];
  float lp;
  __device__ __forceinline__ RowState() : lp(0.f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m[k] = NEG_INF;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
    }
  }
};

// The tile loop over the live tiles (`tiles`, a bit per tile) of the range
// starting at c_begin, folded into `st`. It leaves copies in flight: the
// caller waits before it reuses the stages. `Cols` is the only difference
// between K4 and K5.
template <int RMAX, class Cols>
__device__ __forceinline__ void tile_loop(const Params& p, const Smem<RMAX>& sm, const Cols& cols,
                                          unsigned tiles, int c_begin, RowState& st) {
  constexpr int MT = Smem<RMAX>::MT;
  constexpr int NRG = Smem<RMAX>::NRG;
  constexpr int NCG = Smem<RMAX>::NCG;
  constexpr int CPG = TL / NCG;  // columns of a tile per column group
  constexpr int EPT = CPG / 4;   // p entries a thread forms per tile
  static_assert(NRG * NCG == 16, "16 row x column groups of 16 lanes");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = __popc(tiles);

  // P V ownership: head-dim lanes [8 dg, 8 dg + 8) of rows [4 rg, 4 rg + 4)
  // over the tile's columns cg, cg + NCG, ...; p entries of row 4 rg + kk
  const int dg = lane & 15, grp = tid >> 4;
  const int cg = grp % NCG, rg = grp / NCG, kk = dg & 3;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles)
      load_tile(sm.stages + i * STAGE_BYTES, cols, sm.live, c_begin, nth_bit(tiles, i), tid);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i (and q) landed
    __syncthreads();              // ... for every thread; tile i-1 is done with
    if (i + STAGES - 1 < n_tiles)
      load_tile(sm.stages + ((i + STAGES - 1) % STAGES) * STAGE_BYTES, cols, sm.live, c_begin,
                nth_bit(tiles, i + STAGES - 1), tid);
    cp_async_commit();
    const int tile = nth_bit(tiles, i);
    const bf16* Ks = reinterpret_cast<const bf16*>(sm.stages + (i % STAGES) * STAGE_BYTES);
    const bf16* Vs = Ks + TL * KP;

    // S = Q K^T for this warp's 8 columns; masked, scaled; row maxima
    {
      const int g = lane >> 2, tig = lane & 3;
      const int c = warp * 8 + 2 * tig;  // this lane's two columns in the tile
      const int cs = tile * TL + c;      // ... in the range
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k16 = 0; k16 < D / 16; ++k16) {
          unsigned a[4];
          load_a(a, sm.q, mt * 16, k16 * 16, lane);
          const bf16* kp = Ks + (warp * 8 + g) * KP + k16 * 16 + tig * 2;
          mma_bf16(sc, a, lds32(kp), lds32(kp + 8));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          const int r = mt * 16 + g + 8 * h;
          float mx_r = NEG_INF;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = c_begin + cs + e;
            const bool ok = sm.live[cs + e] && sm.pos[r] >= j;  // pos = -1 past R
            const float sv = ok ? sc[2 * h + e] * p.scale : NEG_INF;
            if (r < RMAX) sm.S[(c + e) * RMAX + r] = sv;
            mx_r = fmaxf(mx_r, sv);
          }
          mx_r = fmaxf(mx_r, __shfl_xor_sync(0xffffffffu, mx_r, 1));
          mx_r = fmaxf(mx_r, __shfl_xor_sync(0xffffffffu, mx_r, 2));
          if (tig == 0 && r < RMAX) sm.wmax[r * NWARPS + warp] = mx_r;
        }
      }
    }
    __syncthreads();

    // fold the tile into the softmax state of rows 4 rg .. 4 rg + 3
    float alpha[4], ref_own = 0.f, alpha_own = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w = sm.wmax + (4 * rg + k) * NWARPS;
      float tmax = NEG_INF;
#pragma unroll
      for (int x = 0; x < NWARPS; ++x) tmax = fmaxf(tmax, w[x]);
      const float m_new = fmaxf(st.m[k], tmax);
      const float ref = m_new > NEG_INF * 0.5f ? m_new : 0.f;
      alpha[k] = expf(st.m[k] - ref);
      st.m[k] = m_new;
      if (k == kk) {
        ref_own = ref;
        alpha_own = alpha[k];
      }
    }
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      float* sp = sm.S + (cg + NCG * ((dg >> 2) + 4 * e)) * RMAX + 4 * rg + kk;
      const float pv = expf(*sp - ref_own);
      *sp = pv;
      psum += pv;
    }
    st.lp = st.lp * alpha_own + psum;
    __syncwarp();  // a half-warp reads exactly the p entries it formed

    // acc = acc * alpha + P V over this thread's columns
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) st.acc[k][e] *= alpha[k];
#pragma unroll 4
    for (int j = 0; j < CPG; ++j) {
      const int c = cg + NCG * j;
      const float4 pr = *reinterpret_cast<const float4*>(sm.S + c * RMAX + 4 * rg);
      const int4 raw = *reinterpret_cast<const int4*>(Vs + c * D + 8 * dg);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float vf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        vf[2 * e] = f.x;
        vf[2 * e + 1] = f.y;
      }
      const float pk[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) st.acc[k][e] += pk[k] * vf[e];
    }
  }
}

// Reduce the column groups' partial sums of `st` in a fixed order. After it
// the stages hold acc per (column group, row), [NCG][RMAX][D] f32 (the
// returned pointer), sm.lred the exp-sums and sm.m the row maxima.
template <int RMAX>
__device__ __forceinline__ const float* reduce_rows(const Smem<RMAX>& sm, const RowState& st) {
  constexpr int NCG = Smem<RMAX>::NCG;
  const int tid = threadIdx.x, lane = tid & 31;
  const int dg = lane & 15, grp = tid >> 4;
  const int cg = grp % NCG, rg = grp / NCG;
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: they hold the partial sums now
  float* red = reinterpret_cast<float*>(sm.stages);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* dst = red + (cg * RMAX + 4 * rg + k) * D + 8 * dg;
    *reinterpret_cast<float4*>(dst) =
        make_float4(st.acc[k][0], st.acc[k][1], st.acc[k][2], st.acc[k][3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(st.acc[k][4], st.acc[k][5], st.acc[k][6], st.acc[k][7]);
  }
  float lp = st.lp;
  lp += __shfl_xor_sync(0xffffffffu, lp, 4);
  lp += __shfl_xor_sync(0xffffffffu, lp, 8);
  if (dg < 4) sm.lred[cg * RMAX + 4 * rg + dg] = lp;
  if (cg == 0 && dg == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) sm.m[4 * rg + k] = st.m[k];
  __syncthreads();
  return red;
}

// Row r's (O numerator, exp-sum) at head-dim lane d after reduce_rows.
template <int RMAX>
__device__ __forceinline__ float2 row_sums(const Smem<RMAX>& sm, const float* red, int r, int d) {
  float a = 0.f, l = 0.f;
#pragma unroll
  for (int x = 0; x < Smem<RMAX>::NCG; ++x) {
    a += red[(x * RMAX + r) * D + d];
    l += sm.lred[x * RMAX + r];
  }
  return make_float2(a, l);
}

// The tile loop of one range that holds a live tile, then the range's O
// (f32, normalised) and LSE into the workspace at row `part`.
template <int RMAX, class Cols>
__device__ __forceinline__ void range_tiles(const Params& p, const Smem<RMAX>& sm,
                                            const Cols& cols, unsigned tiles, int c_begin,
                                            int R, long long part) {
  RowState st;
  tile_loop<RMAX>(p, sm, cols, tiles, c_begin, st);
  const float* red = reduce_rows<RMAX>(sm, st);
  for (int i = threadIdx.x; i < R * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const float2 al = row_sums<RMAX>(sm, red, r, d);
    p.wo[(part * R + r) * D + d] = al.y > 0.f ? al.x / al.y : 0.f;
    if (d == 0) p.wl[part * R + r] = al.y > 0.f ? sm.m[r] + logf(al.y) : NEG_INF;
  }
}

// The live bound max(q_pos) + 1, capped at L; the same in every block.
__device__ __forceinline__ int live_bound(const Params& p) {
  int mx = -1;
  for (int t = 0; t < p.s; ++t) mx = max(mx, __ldg(p.q_pos + t));
  return min(mx + 1, p.L);
}

// Merge the ranges of one row of one (slot, kv-head) in range order; thread
// d owns head-dim lane d. The ranges' LSEs and O lanes are loaded
// MERGE_CHUNK ranges at a time, all at once: up to L = MERGE_CHUNK *
// split_cols that is one round of loads.
__device__ __forceinline__ void merge_row(const Params& p) {
  const int d = threadIdx.x, hk = blockIdx.x, b = blockIdx.y, r = blockIdx.z;
  const int G = p.H / p.Hkv, R = G * p.s;
  const int n = (live_bound(p) + SPLIT - 1) / SPLIT;  // the ranges that ran
  const long long slot = (long long)b * p.Hkv + hk;
  const long long stride = (long long)p.B * p.Hkv * R;  // workspace: range-major
  const float* wl = p.wl + slot * R + r;                // + x * stride
  const float* wo = p.wo + (slot * R + r) * D + d;      // + x * stride * D
  float m = NEG_INF;
  if (n > MERGE_CHUNK) {  // a long cache: the maximum first
    for (int x = 0; x < n; ++x) m = fmaxf(m, wl[x * stride]);
  }
  float den = 0.f, num = 0.f;
  for (int x0 = 0; x0 < n; x0 += MERGE_CHUNK) {
    float l[MERGE_CHUNK], o[MERGE_CHUNK];
#pragma unroll
    for (int x = 0; x < MERGE_CHUNK; ++x) {
      const bool in = x0 + x < n;
      l[x] = in ? wl[(x0 + x) * stride] : NEG_INF;
      o[x] = in ? wo[(x0 + x) * stride * D] : 0.f;
    }
    if (n <= MERGE_CHUNK) {  // one chunk: its maximum is the maximum
#pragma unroll
      for (int x = 0; x < MERGE_CHUNK; ++x) m = fmaxf(m, l[x]);
    }
    const float safe = m > NEG_INF * 0.5f ? m : 0.f;
#pragma unroll
    for (int x = 0; x < MERGE_CHUNK; ++x) {
      if (l[x] > NEG_INF * 0.5f) {  // a dead range weighs 0; its O is never written
        const float w = expf(l[x] - safe);
        den += w;
        num += w * o[x];
      }
    }
  }
  const float safe = m > NEG_INF * 0.5f ? m : 0.f;
  const int g = r / p.s, t = r % p.s;
  p.o[b * p.sob + t * p.sos + (hk * G + g) * p.soh + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  if (d == 0) p.lse[slot * R + r] = den > 0.f ? safe + logf(den) : NEG_INF;
}

// One block: one range of one (slot, kv-head).
template <int RMAX, class Cols>
__device__ __forceinline__ void decode_range(const Params& p, unsigned char* dsm) {
  constexpr int MT = Smem<RMAX>::MT;
  const Smem<RMAX> sm(dsm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int c_begin = split * SPLIT;
  const int G = p.H / p.Hkv;
  const int R = G * p.s;  // row r = g * s + t  ->  q-head hk*G + g, token t

  // this thread's column's kv_valid byte and the live bound (from q_pos,
  // the same in every block), read together
  const int col = c_begin + tid;
  const bool valid = p.kv_valid == nullptr || (col < p.L && p.kv_valid[b * p.validb + col] != 0);
  const int bound = live_bound(p);
  if (c_begin >= bound) return;  // past every row's position: nothing to read or write

  // the rows' positions, and which columns and tiles of the range are live
  if (tid < 16 * MT) sm.pos[tid] = tid < R ? __ldg(p.q_pos + tid % p.s) : -1;
  const bool live = c_begin + tid < bound && valid;
  sm.live[tid] = live;
  const int warp_live = __any_sync(0xffffffffu, live);
  if (lane == 0) sm.wlive[warp] = warp_live;
  __syncthreads();
  unsigned tiles = 0;  // bit j: tile j of the range holds a live column
#pragma unroll
  for (int w = 0; w < NWARPS; ++w)
    if (sm.wlive[w]) tiles |= 1u << (w * 32 / TL);

  const long long part = (split * (long long)p.B + b) * p.Hkv + hk;  // workspace row of R
  if (!tiles) {  // nothing live in range: LSE -1e30 tells the merge to skip its O
    if (tid < R) p.wl[part * R + tid] = NEG_INF;
    return;
  }
  // q rows into shared memory (bf16; rows past R zero), in flight with the
  // first tiles
  for (int i = tid; i < 16 * MT * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, ch = (i % CHUNKS) * 8;
    const bf16* src = p.q;
    if (r < R) src = p.q + b * p.sqb + (r % p.s) * p.sqs + (hk * G + r / p.s) * p.sqh + ch;
    cp_async16_zfill(sm.q + r * KP + ch, src, r < R ? 16 : 0);
  }
  cp_async_commit();
  range_tiles<RMAX>(p, sm, Cols(p, b, hk), tiles, c_begin, R, part);
}

// One block of the multi-row path (R > RMAX_ALL, a suffix prefill): one
// tile of ROW_TILE rows of one (slot, kv-head), walking the whole live
// length of its rows with the softmax state in registers, so no workspace
// and no merge. Rows fold as r = g * s + t, so a tile takes T = ROW_TILE / G
// suffix tokens t0 .. t0 + T - 1 of every head g of the group: local row
// g * T + j is token t0 + j of q-head hk * G + g. The tile reads columns up
// to its own largest position only (causal over the suffix, plus the live
// prefix); dead tiles and columns are skipped as in a range. Tiles are
// numbered heaviest (latest tokens) first.
template <class Cols>
__device__ __forceinline__ void decode_rows(const Params& p, unsigned char* dsm) {
  constexpr int RMAX = ROW_TILE;
  constexpr int MT = Smem<RMAX>::MT;
  const Smem<RMAX> sm(dsm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.Hkv, T = ROW_TILE / G;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * T;
  const int nt = min(T, p.s - t0);  // tokens of this tile
  int bound = -1;
  for (int j = 0; j < nt; ++j) bound = max(bound, __ldg(p.q_pos + t0 + j));
  bound = min(bound + 1, p.L);

  if (tid < 16 * MT) {
    const int g = tid / T, j = tid % T;
    sm.pos[tid] = g < G && j < nt ? __ldg(p.q_pos + t0 + j) : -1;
  }
  for (int i = tid; i < 16 * MT * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, ch = (i % CHUNKS) * 8, g = r / T, j = r % T;
    const bool row = g < G && j < nt;
    const bf16* src = p.q;
    if (row) src = p.q + b * p.sqb + (t0 + j) * p.sqs + (hk * G + g) * p.sqh + ch;
    cp_async16_zfill(sm.q + r * KP + ch, src, row ? 16 : 0);
  }
  cp_async_commit();

  const Cols cols(p, b, hk);
  RowState st;
  for (int c_begin = 0; c_begin < bound; c_begin += SPLIT) {
    const int col = c_begin + tid;
    const bool live =
        col < bound && (p.kv_valid == nullptr || p.kv_valid[b * p.validb + col] != 0);
    sm.live[tid] = live;
    const int warp_live = __any_sync(0xffffffffu, live);
    if (lane == 0) sm.wlive[warp] = warp_live;
    __syncthreads();
    unsigned tiles = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      if (sm.wlive[w]) tiles |= 1u << (w * 32 / TL);
    if (tiles) tile_loop<RMAX>(p, sm, cols, tiles, c_begin, st);
    cp_async_wait<0>();
    __syncthreads();  // the range's tiles are done with the stages and sm.live
  }

  const float* red = reduce_rows<RMAX>(sm, st);
  const long long lse_row = ((long long)b * p.Hkv + hk) * G * p.s;
  for (int i = tid; i < RMAX * D; i += NTHREADS) {
    const int r = i / D, d = i % D, g = r / T, j = r % T;
    if (g >= G || j >= nt) continue;
    const float2 al = row_sums<RMAX>(sm, red, r, d);
    const int t = t0 + j;
    p.o[b * p.sob + t * p.sos + (hk * G + g) * p.soh + d] =
        __float2bfloat16(al.y > 0.f ? al.x / al.y : 0.f);
    if (d == 0) p.lse[lse_row + g * p.s + t] = al.y > 0.f ? sm.m[r] + logf(al.y) : NEG_INF;
  }
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, RowCols>(p, dsm);
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) paged_flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, PagedCols>(p, dsm);
}

// The merges of K4 and K5 are one function under two names, so a profile
// files each under its own kernel's family.
__global__ void __launch_bounds__(D) flash_decode_kernel_merge(Params p) { merge_row(p); }
__global__ void __launch_bounds__(D) paged_flash_decode_kernel_merge(Params p) { merge_row(p); }

__global__ void __launch_bounds__(NTHREADS, 2) flash_decode_kernel_rows(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_rows<RowCols>(p, dsm);
}

__global__ void __launch_bounds__(NTHREADS, 2) paged_flash_decode_kernel_rows(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_rows<PagedCols>(p, dsm);
}

void (*rows_kernel_of(bool paged))(Params) {
  return paged ? &paged_flash_decode_kernel_rows : &flash_decode_kernel_rows;
}

template <int RMAX>
void (*kernel_of(bool paged))(Params) {
  return paged ? &paged_flash_decode_kernel<RMAX> : &flash_decode_kernel<RMAX>;
}

// Let the kernel take its shared memory, and the SM give shared memory all
// it can.
int configure(void (*kernel)(Params), size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <int RMAX>
int launch(const Params& p, bool paged, cudaStream_t stream) {
  const int code = configure(kernel_of<RMAX>(paged), Smem<RMAX>::bytes());
  if (code) return code;
  kernel_of<RMAX>(paged)<<<dim3(p.Hkv, p.B, p.n_splits), NTHREADS, Smem<RMAX>::bytes(),
                           stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  (paged ? paged_flash_decode_kernel_merge
         : flash_decode_kernel_merge)<<<dim3(p.Hkv, p.B, (p.H / p.Hkv) * p.s), D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The multi-row path: one launch, no merge.
int launch_rows(const Params& p, bool paged, cudaStream_t stream) {
  const int code = configure(rows_kernel_of(paged), Smem<ROW_TILE>::bytes());
  if (code) return code;
  const int T = ROW_TILE / (p.H / p.Hkv);
  rows_kernel_of(paged)<<<dim3(p.Hkv, p.B, (p.s + T - 1) / T), NTHREADS,
                          Smem<ROW_TILE>::bytes(), stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(Params p, bool paged, void* stream) {
  const int R = (p.H / p.Hkv) * p.s;
  p.n_splits = (p.L + SPLIT - 1) / SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 4) return launch<4>(p, paged, st);
  if (R <= 8) return launch<8>(p, paged, st);
  if (R <= 16) return launch<16>(p, paged, st);
  if (R <= 32) return launch<32>(p, paged, st);
  if (p.H / p.Hkv > ROW_TILE) return (int)cudaErrorInvalidValue;
  return launch_rows(p, paged, st);
}

Params common(const void* q, const void* k, const void* v, void* o, void* lse,
              const void* q_pos, const void* kv_valid, void* work_o, void* work_lse,
              int B, int s, int H, int Hkv, int L,
              long long sqb, long long sqs, long long sqh, long long sob, long long sos,
              long long soh, long long validb, float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.wo = static_cast<float*>(work_o);
  p.wl = static_cast<float*>(work_lse);
  p.B = B; p.s = s; p.H = H; p.Hkv = Hkv; p.L = L;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.validb = validb;
  p.scale = scale;
  return p;
}

}  // namespace

// work_o is (ceil(L / split_cols), B, Hkv, R, D) f32 and work_lse
// (ceil(L / split_cols), B, Hkv, R) f32, uninitialised: the kernels write
// every entry the merge reads.
extern "C" int nxd_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* kv_valid, void* work_o, void* work_lse,
    int B, int s, int H, int Hkv, int L,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sos, long long soh,
    long long validb, float scale, void* stream) {
  Params p = common(q, k, v, o, lse, q_pos, kv_valid, work_o, work_lse, B, s, H, Hkv, L, sqb, sqs, sqh, sob, sos, soh, validb, scale);
  p.skb = skb; p.skl = skl; p.skh = skh;
  p.svb = svb; p.svl = svl; p.svh = svh;
  return dispatch(p, false, stream);
}

// K5: k/v are pools (P, page_size, Hkv, D) with strides (skp, skr, skh);
// bt is the (B, n_log) block table, row stride sbt; page_size = 1 << ps_shift.
extern "C" int nxd_paged_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* kv_valid, const void* bt, void* work_o, void* work_lse,
    int B, int s, int H, int Hkv, int n_log, int ps_shift,
    long long sqb, long long sqs, long long sqh,
    long long skp, long long skr, long long skh,
    long long svp, long long svr, long long svh,
    long long sob, long long sos, long long soh,
    long long validb, long long sbt, float scale, void* stream) {
  Params p = common(q, k, v, o, lse, q_pos, kv_valid, work_o, work_lse, B, s, H, Hkv,
                    n_log << ps_shift, sqb, sqs, sqh, sob, sos, soh, validb, scale);
  p.bt = static_cast<const int*>(bt);
  p.sbt = sbt;
  p.ps_shift = ps_shift;
  p.skb = skp; p.skl = skr; p.skh = skh;
  p.svb = svp; p.svl = svr; p.svh = svh;
  return dispatch(p, true, stream);
}

// Resources of K4 (paged 0) or K5 (paged 1) at R <= rmax (4, 8, 16 or 32;
// 0: the multi-row kernel, R > 32): dynamic shared memory a block,
// registers a thread, local bytes a thread and blocks an SM.
extern "C" int nxd_flash_decode_resources(int paged, int rmax, int* out) {
  void (*kernel)(Params) = nullptr;
  size_t smem = 0;
  switch (rmax) {
    case 0: kernel = rows_kernel_of(paged); smem = Smem<ROW_TILE>::bytes(); break;
    case 4: kernel = kernel_of<4>(paged); smem = Smem<4>::bytes(); break;
    case 8: kernel = kernel_of<8>(paged); smem = Smem<8>::bytes(); break;
    case 16: kernel = kernel_of<16>(paged); smem = Smem<16>::bytes(); break;
    case 32: kernel = kernel_of<32>(paged); smem = Smem<32>::bytes(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int code = configure(kernel, smem);
  if (code) return code;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NTHREADS, smem);
  out[0] = (int)smem;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return (int)e;
}

extern "C" int nxd_flash_decode_max_rows() { return RMAX_ALL; }
extern "C" int nxd_flash_decode_head_dim() { return D; }
extern "C" int nxd_flash_decode_split_cols() { return SPLIT; }
extern "C" int nxd_flash_decode_tile_cols() { return TL; }
