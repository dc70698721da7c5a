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
// Head dims. Tiles are 128 columns wide. The head_dim-96 build
// (-DNXD_HEAD_DIM=96, flash_common.cuh; GPT-NeoX-20B) copies 96 columns a
// cache row on the split path, stops Q K^T at 96 and skips the P V lanes
// past 96; on the multi-row path TMA zero-fills columns 96..127, Q K^T stops
// at 96 and P V runs the tile's 128 columns, 32 of them zeros (4/3 of its
// work). Only 96 columns of O are stored and merged. K5q reads 128-column
// int8 pages: its entry points refuse the 96 build.
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
// K5q is K5 over an int8 pool (ServingEngine(quantize=QuantConfig(kv=
// "int8"))): pages (P, page_size, Hkv, D) int8 with a bf16 scale per (page,
// kv-head), (P, 1, Hkv, 1). It computes what the JAX engine runs for such a
// pool, the dequantized gathered view (`paged_gather_leaf_dequant`,
// flash_decode.py:201) and K4 over it, without writing that view. Bound:
// bytes, about half of K5's (128 B of K and of V a live column, plus a
// scale a page). The design:
//  * K5's plan: a block a (range, slot, kv-head), the range index slowest;
//    a range past the live bound returns at once, one with no live tile
//    writes LSE -1e30; then K5's merge kernel under K5q's name.
//  * Loads a page at a time. A range with a live tile reads its table
//    entries once, after its vote (most blocks of a serving step hold no
//    live tile, and return without that read); a tile's int8 K and V (64
//    columns, 8 KB each) go through K5's 3-stage `cp.async` ring, 16 bytes
//    a copy, and a page's two scales are copied once a tile (the 4-byte
//    word that holds each).
//  * Conversion where the products read. S = Q K^T takes its B fragments as
//    int8 pairs from shared memory and turns them into bf16 pairs in
//    registers; P V reads V as 8 int8 a lane. Both use the plain version's
//    bf16_rn(__fmul_rn(float(q), scale)), so every product sees K4's bits on
//    the dequantized view; a dead column is zero-filled and converts to 0.
//    No bf16 tile and no barrier of its own: ~18 KB a stage, ~54 KB a block
//    (two blocks an SM, by registers). At R <= 4 each element converts once;
//    at R = 16/32 P V converts each V element R/4 times (no int8-pool path
//    runs R > 4 yet).
// The per-range sums and the merge are K5's, so K5q through a table equals
// K4 on the dequantized gathered view bit for bit. It has the split path
// only (R <= 32): a quantized pool's multi-row suffix prefill attends a
// float row (serving/engine.py), as the JAX engine's does. Tried and
// dropped, each timed by chip_decode_variants.py and chip_k5q_real.py
// (PERF.md): the merge inside the range launch (an arrival counter a
// (slot, kv-head), the last block to arrive merging; its merge tail cost
// more than this merge launch), a persistent grid of the blocks the card
// holds striding the items (a block's fixed share makes the tail), a TMA
// box a page through an mbarrier ring in place of the `cp.async` ring (no
// faster), and the table read by every block before its bound check.
//
// K5q with the write (qpaged_write_attend; `qpaged_flash_decode_kernel_write`,
// then K5q's merge): a decode step over an int8 pool writes its s new rows
// (QW, csrc/kv_quant.cu: every page of the write window re-quantized) and
// then attends the pool, always on the same (slot, kv-head, page). As two
// launches QW is a graph node of its own, a chain of dependent reads (the
// window's pages and first column, then the codes, scale and rows, then a
// maximum, then the writes) that costs 15x its bytes, and K5q then reads
// the same page again. Fused, block (range, b, hk) first re-quantizes
// kv-head hk of the window pages of slot b whose logical columns fall in
// its 256-column range, K with threads 0-127 and V with 128-255, by QW's
// steps 1-7 unchanged (`write_window`): the window is QW's, `n_win` = 1 at
// s = 1, else (s - 1) / page_size + 2 logical pages from the first
// column's, each read from the block table (a logical page past the table
// is the null page). It writes them before either early exit (the range
// past the live bound, the range with no live tile): a window page past a
// row's bound is mapped for later steps and JAX re-quantizes it too. A
// block barrier follows the writes, and only then does the block read its
// range (the new codes and scales, through K5's `cp.async` ring), so the
// tile loop, the sums, their order and the merge are K5q's: the result is
// QW then K5q bit for bit, and K4 on the dequantized gathered view. The
// null page is not written (QW writes it; nothing reads it). Hazards, none
// of which can occur:
//  * Another block reading a page while its owner writes it. Window pages
//    are the slot's own (copy-on-write keeps shared prefix pages out of
//    every write window, serving/paging.py `assert_writable`), a page's
//    columns lie in one range (page_size divides 256), and a block reads
//    only its own range's pages and its own kv-head's codes: the owner is
//    the page's only reader. The scale words that K5q's copies read hold
//    two kv-heads' bf16 scales; a block writes its own half and uses only
//    its own half.
//  * A page with two owners: at s > 1 a window can cross a range boundary;
//    each of its pages still lies in exactly one range.
//  * The null page: every row whose window runs past its table (or a free
//    slot) maps it; no block writes it, and K5q never reads it (its
//    columns are dead, zero-filled without a read).
// It takes K5q's rows, R = group x s <= 32: the decode step (s = 1) and the
// speculative verify window (s = gamma = 4, R = 16). Prefills keep QW.

// More than 32 rows (R = group * s for a suffix prefill of s tokens behind a
// reused prefix, the Pallas kernel's one block of R rows): the multi-row
// path (`decode_rows`, one launch, no workspace, no merge kernel).
//
// What bounds it on an H100: operations. Every live (row, column) pair
// costs 4 D FLOPs of tensor work (S = Q K^T and P V), ~800 FLOP a byte of
// K/V at a 1600-column prefix and 256 suffix tokens; at phase 5c's
// geometry the bound is 0.0073 ms at R = 1024 (7.25 GFLOP).
//
// What the design does about it (K1's shape, flash_attention.cu, on
// hopper.cuh):
//  * One block per (64-row tile, kv-head, slot), numbered latest tokens
//    first. A row tile is T = 64 / G whole tokens of every head of the group
//    (local row g * T + j), so Q is one TMA box a half (64 columns x T
//    tokens x G heads of q's 4-D map; tokens past s arrive as zeros) and
//    every K/V tile that lands feeds all G heads. The grid, the order and
//    the split of the work come from B, Hkv, R and L alone.
//  * Three consumer warpgroups a block share Q, each walking every third
//    visited 64-column tile through its own 2-stage ring (its warp 0 the
//    loader, K1's pattern), and merge (m, l, O) through shared memory at
//    the end in warpgroup order; ~215 KB of shared memory at L = 8192, one
//    block an SM. K4 loads a tile as one box a half of the row cache's map;
//    K5 as one box a page (page_size rows) a half of the pool's map, the
//    lanes issuing the pages, each table entry read one fill ahead; a page
//    past the table is read past the pool's end, as zeros. The bytes that
//    land, and so every sum, are K4's on the gathered view: K5 = K4 bit for
//    bit.
//  * Both products on `wgmma`: S from shared memory (`ss_product_n64`), O +=
//    P V with P in registers (`rs_product`). P keeps f32 accuracy as the
//    Pallas kernel's f32 P does (flash_decode.py:252-270): P = P_hi + P_lo,
//    both bf16, two register-A products into one accumulator, exact to
//    ~2^-17 of P; l is summed from the unrounded P. Online softmax in exp2
//    on the special-function unit (K1's).
//  * The tile plan (`flash_decode_rows_plan` in kernels/flash_decode.py):
//    the block reads kv_valid up to its largest position + 1 into a bit
//    per column; a column tile with no live bit is neither loaded nor
//    scored (exact, as argued above for the split path); the mask runs only
//    on tiles with a dead column or past the tile's smallest position.
//    Dead columns inside a visited tile are read: their P is 0, so any
//    finite value they hold changes no bit.
// Tried and dropped, each in a same-call A/B on the card (PERF.md): the
// first multi-row kernel (one block per 32-row tile of 256 threads,
// `mma.sync` for S and P V on the CUDA cores, 120 KB, K/V re-read by every
// 32-row tile; 36x its bound); one warpgroup a block at 2, 3, 4 and 6 stages (no gain from
// depth: issue-bound, not load-bound); two warpgroups a block. One
// warpgroup at two blocks an SM is 10% faster at R = 2048 and 20% slower at
// R <= 1024. What holds it at 4x its bound is tensor throughput an SM: the
// lo product costs a quarter of the time, the exp a fifteenth.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace nxd_hopper;
using nxd_flash::bf16;
using nxd_flash::D;
using nxd_flash::DH;
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
constexpr int CHUNKS = DH / 8;           // 16-byte chunks per cache row (a tile row holds D)
constexpr int STAGE_BYTES = TL * (KP + D) * (int)sizeof(bf16);
constexpr int RMAX_ALL = 32;             // rows of the split path; more take the multi-row path
constexpr int MERGE_CHUNK = 32;          // ranges whose loads the merge issues together
static_assert(TL == 8 * NWARPS, "each warp scores one 8-column slice of a tile");
static_assert(SPLIT == NTHREADS && TL % 32 == 0, "a thread per column; a warp's vote in one tile");
static_assert(SPLIT_TILES <= 32, "live tiles are a bit mask");
static_assert(TL * CHUNKS % NTHREADS == 0, "a tile's row copies split evenly over the threads");

// K5 reads skb/svb as the pool's page stride and skl/svl as the stride of a
// row inside a page; bt/sbt/ps_shift/n_pages are K5's alone. K5q's k/v are
// int8 pools (the pointers are reinterpreted), ks/vs their bf16 scales with
// page and kv-head strides sksp/sksh and svsp/svsh. K5q with the write also
// takes the new rows xk/xv (B, s, Hkv, D) bf16 with strides (sxkb, sxks,
// sxkh), (sxvb, sxvs, sxvh), and w0, the logical column of their first token.
struct Params {
  const bf16* q; const bf16* k; const bf16* v; bf16* o; float* lse;
  const int* q_pos; const uint8_t* kv_valid; const int* bt;
  const bf16* ks; const bf16* vs;
  float* wo; float* wl;  // workspace: O (f32) and LSE of every range
  const bf16* xk; const bf16* xv; const long long* w0;
  int B, s, H, Hkv, L, ps_shift, n_splits, n_pages;
  long long sqb, sqs, sqh, skb, skl, skh, svb, svl, svh, sob, sos, soh, validb, sbt;
  long long sksp, sksh, svsp, svsh;
  long long sxkb, sxks, sxkh, sxvb, sxvs, sxvh;
  float scale;
};

enum Kind { ROW = 0, PAGED = 1, QPAGED = 2, QPAGED_WRITE = 3 };

// K4: column c of slot b's cache row.
struct RowCols {
  static constexpr bool QUANT = false;
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
  static constexpr bool QUANT = false;
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

// K5q: kv-head hk of the int8 pools and scales, and slot b's pages of the
// range (`pg`, read once a range into shared memory; 0 past the table). It
// keeps no copy of a stride or a pointer of `p`: they are read from the
// kernel's parameters where used, which keeps K5q within K5's registers.
// A page's first column in a tile copies its scales: one copy each for K
// and V a page, or a tile where a page spans several (`sshift`).
struct QPagedCols {
  static constexpr bool QUANT = true;
  const Params& p; const int* pg; int hk;
  __device__ QPagedCols(const Params& p_, int hk_, const int* pg_) : p(p_), pg(pg_), hk(hk_) {}
  __device__ __forceinline__ int sshift() const { return min(p.ps_shift, 6); }
  __device__ __forceinline__ const int8_t* codes(const bf16* pool, long long page, int row,
                                                 long long sp, long long sr, long long sh) const {
    return reinterpret_cast<const int8_t*>(pool) + page * sp + row * sr + hk * sh;
  }
};

// K5q's stage: K codes (TL x QKP bytes: the pitch keeps S's fragment reads
// conflict-free), V codes (TL x D), then the 4-byte word that holds each
// page slot's bf16 scale, K's and V's (TL slots: page_size 1), then which
// half of the word holds it (a byte each).
constexpr int QKP = D + 16;
constexpr int QSTAGE_BYTES = TL * QKP + TL * D + 2 * TL * 4 + 2 * TL;
static_assert(QSTAGE_BYTES % 16 == 0, "stages keep 16-byte alignment");
static_assert(STAGES * QSTAGE_BYTES >= 64 * D * (int)sizeof(float),
              "K5q's stages hold reduce_rows' partial sums ([NCG][RMAX][D], NCG x RMAX = 64)");
static_assert(TL == 64, "sshift caps a scale slot at one tile");

template <class Cols>
__host__ __device__ constexpr int stage_bytes() { return Cols::QUANT ? QSTAGE_BYTES : STAGE_BYTES; }

// Shared memory of one block at R <= RMAX, for stages of `sb` bytes; K5q
// (`quant`) also keeps its range's pages.
template <int RMAX>
struct Smem {
  static constexpr int MT = (RMAX + 15) / 16;  // 16-row m-tiles of S = Q K^T
  static constexpr int NRG = RMAX / 4;         // row groups of 4 in P V
  static constexpr int NCG = 16 / NRG;         // column groups in P V
  unsigned char* stages;  // STAGES x [K | V] tiles; later the reductions
  bf16* q;                // [16 MT][KP]
  float* S;               // [TL][RMAX]: scores, then p
  float* wmax;            // [RMAX][NWARPS]
  float* lred;            // [NCG][RMAX]
  float* m;               // [RMAX]
  int* pos;               // [16 MT]
  int* wlive;             // [NWARPS]: whether each warp read a live column
  uint8_t* live;          // [SPLIT]
  int* pg;                // K5q: [SPLIT] pool pages of the range's pages
  static constexpr size_t bytes(int sb = STAGE_BYTES, bool quant = false) {
    return (size_t)STAGES * sb + 16 * MT * KP * sizeof(bf16) +
           ((size_t)TL * RMAX + RMAX * NWARPS + NCG * RMAX + RMAX) * sizeof(float) +
           (16 * MT + NWARPS) * sizeof(int) + SPLIT +
           (quant ? SPLIT * sizeof(int) : 0);
  }
  __device__ Smem(unsigned char* dsm, int sb) {
    stages = dsm;
    q = reinterpret_cast<bf16*>(dsm + STAGES * sb);
    S = reinterpret_cast<float*>(q + 16 * MT * KP);
    wmax = S + TL * RMAX;
    lred = wmax + RMAX * NWARPS;
    m = lred + NCG * RMAX;
    pos = reinterpret_cast<int*>(m + RMAX);
    wlive = pos + 16 * MT;
    live = reinterpret_cast<uint8_t*>(wlive + NWARPS);
    pg = reinterpret_cast<int*>(live + SPLIT);
  }
};

// 16-byte copy that reads `n` (0 or 16) bytes of src and zero-fills the rest.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// 4-byte copy that reads `n` (0 or 4) bytes of src and zero-fills the rest.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
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

// K5q: issue the copies of tile `tile` as load_tile does, of int8 codes: a
// column's K and V are 8 chunks of 16 bytes each, addressed through the
// range's pages; the thread of a page's first chunk in the tile also copies
// the page's two scale words (zeros for the null page, whose columns are
// all dead) and records which half holds each scale.
__device__ __forceinline__ void load_tile(unsigned char* stage, const QPagedCols& cols,
                                          const uint8_t* live_s, int c_begin, int tile, int tid) {
  constexpr int QCHUNKS = D / 16;
  const Params& p = cols.p;
  int8_t* Kq = reinterpret_cast<int8_t*>(stage);
  int8_t* Vq = Kq + TL * QKP;
  uint32_t* kw = reinterpret_cast<uint32_t*>(Vq + TL * D);
  uint32_t* vw = kw + TL;
  uint8_t* half = reinterpret_cast<uint8_t*>(vw + TL);
  const int sshift = cols.sshift();
#pragma unroll
  for (int j = 0; j < TL * QCHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int c = i / QCHUNKS, ch = (i % QCHUNKS) * 16;
    const int cs = tile * TL + c;
    const bool live = live_s[cs] != 0;
    const long long page = live ? cols.pg[cs >> p.ps_shift] : 0;
    const int row = (c_begin + cs) & ((1 << p.ps_shift) - 1);
    cp_async16_zfill(Kq + c * QKP + ch, cols.codes(p.k, page, row, p.skb, p.skl, p.skh) + ch,
                     live ? 16 : 0);
    cp_async16_zfill(Vq + c * D + ch, cols.codes(p.v, page, row, p.svb, p.svl, p.svh) + ch,
                     live ? 16 : 0);
    if (ch == 0 && (c & ((1 << sshift) - 1)) == 0) {  // the page's scale words, and the halves
      const int slot = c >> sshift;
      const long long pid = cols.pg[cs >> p.ps_shift];
      const uintptr_t ka = reinterpret_cast<uintptr_t>(p.ks + pid * p.sksp + cols.hk * p.sksh);
      const uintptr_t va = reinterpret_cast<uintptr_t>(p.vs + pid * p.svsp + cols.hk * p.svsh);
      cp_async4_zfill(kw + slot, reinterpret_cast<const void*>(ka & ~uintptr_t(3)), pid ? 4 : 0);
      cp_async4_zfill(vw + slot, reinterpret_cast<const void*>(va & ~uintptr_t(3)), pid ? 4 : 0);
      half[slot] = (uint8_t)((ka >> 1) & 1);
      half[TL + slot] = (uint8_t)((va >> 1) & 1);
    }
  }
}

// K5q: the f32 value of the bf16 scale of tile column c's page (V's when
// `is_v`) in a landed stage.
__device__ __forceinline__ float stage_scale(const unsigned char* st, const QPagedCols& cols,
                                             int c, bool is_v) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(st + TL * QKP + TL * D) + (is_v ? TL : 0);
  const uint8_t* half = reinterpret_cast<const uint8_t*>(st + TL * QKP + TL * D + 2 * TL * 4);
  const int slot = c >> cols.sshift();
  return __uint_as_float(((w[slot] >> (16 * half[(is_v ? TL : 0) + slot])) & 0xffffu) << 16);
}

// Two int8 codes (the low 16 bits of `two`) as the bf16 pair of their
// dequantized values, bf16_rn(float(q) * scale) each: the plain version's
// product, one rounding (`__fmul_rn` is never fused), then its cast.
__device__ __forceinline__ unsigned dq_pair(unsigned two, float sc) {
  const float lo = (float)(int8_t)(two & 0xffu), hi = (float)(int8_t)((two >> 8) & 0xffu);
  const __nv_bfloat162 r = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn(lo, sc)),
                                              __float2bfloat16_rn(__fmul_rn(hi, sc)));
  return *reinterpret_cast<const unsigned*>(&r);
}

// S's B fragment of tile column `col` at head-dim lanes k, k + 1 and k + 8,
// k + 9 (b0, b1): K4/K5 read the bf16 tile, K5q converts the int8 codes
// with their page's scale `ks`.
template <class Cols>
__device__ __forceinline__ void k_frag(const unsigned char* st, int col, int k, float ks,
                                       unsigned& b0, unsigned& b1) {
  if constexpr (Cols::QUANT) {
    const unsigned char* kq = st + col * QKP + k;
    b0 = dq_pair(*reinterpret_cast<const uint16_t*>(kq), ks);
    b1 = dq_pair(*reinterpret_cast<const uint16_t*>(kq + 8), ks);
  } else {
    const bf16* kp = reinterpret_cast<const bf16*>(st) + col * KP + k;
    b0 = lds32(kp);
    b1 = lds32(kp + 8);
  }
}

// V's head-dim lanes [d0, d0 + 8) of tile column c as f32: K4/K5 from the
// bf16 tile, K5q from 8 int8 codes with their page's scale `vs`.
template <class Cols>
__device__ __forceinline__ void v_row(const unsigned char* st, int c, int d0, float vs,
                                      float (&vf)[8]) {
  if constexpr (Cols::QUANT) {
    const uint2 raw = *reinterpret_cast<const uint2*>(st + TL * QKP + c * D + d0);
    const unsigned w[2] = {raw.x, raw.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned two = dq_pair(w[e >> 1] >> (16 * (e & 1)), vs);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&two));
      vf[2 * e] = f.x;
      vf[2 * e + 1] = f.y;
    }
  } else {
    const bf16* Vs = reinterpret_cast<const bf16*>(st) + TL * KP;
    const int4 raw = *reinterpret_cast<const int4*>(Vs + c * D + d0);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(v2[e]);
      vf[2 * e] = f.x;
      vf[2 * e + 1] = f.y;
    }
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

  constexpr int SB = stage_bytes<Cols>();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles)
      load_tile(sm.stages + i * SB, cols, sm.live, c_begin, nth_bit(tiles, i), tid);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i (and q) landed
    __syncthreads();              // ... for every thread; tile i-1 is done with
    if (i + STAGES - 1 < n_tiles)
      load_tile(sm.stages + ((i + STAGES - 1) % STAGES) * SB, cols, sm.live, c_begin,
                nth_bit(tiles, i + STAGES - 1), tid);
    cp_async_commit();
    const int tile = nth_bit(tiles, i);
    const unsigned char* stage = sm.stages + (i % STAGES) * SB;

    // S = Q K^T for this warp's 8 columns; masked, scaled; row maxima
    {
      const int g = lane >> 2, tig = lane & 3;
      const int c = warp * 8 + 2 * tig;  // this lane's two columns in the tile
      const int cs = tile * TL + c;      // ... in the range
      float ks = 0.f;                    // K5q: the scale of column warp * 8 + g's page
      if constexpr (Cols::QUANT) ks = stage_scale(stage, cols, warp * 8 + g, false);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k16 = 0; k16 < DH / 16; ++k16) {  // a tile's columns past DH are never read
          unsigned a[4], b0, b1;
          load_a(a, sm.q, mt * 16, k16 * 16, lane);
          k_frag<Cols>(stage, warp * 8 + g, k16 * 16 + tig * 2, ks, b0, b1);
          mma_bf16(sc, a, b0, b1);
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
    // head-dim lanes past DH (no copy wrote them) are skipped
#pragma unroll 4
    for (int j = 0; j < (DH == D || 8 * dg < DH ? CPG : 0); ++j) {
      const int c = cg + NCG * j;
      const float4 pr = *reinterpret_cast<const float4*>(sm.S + c * RMAX + 4 * rg);
      float vs = 0.f;  // K5q: the scale of column c's page
      if constexpr (Cols::QUANT) vs = stage_scale(stage, cols, c, true);
      float vf[8];
      v_row<Cols>(stage, c, 8 * dg, vs, vf);
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
  for (int i = threadIdx.x; i < R * DH; i += NTHREADS) {
    const int r = i / DH, d = i % DH;
    const float2 al = row_sums<RMAX>(sm, red, r, d);
    p.wo[(part * R + r) * DH + d] = al.y > 0.f ? al.x / al.y : 0.f;
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
  const float* wo = p.wo + (slot * R + r) * DH + d;     // + x * stride * DH
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
      o[x] = in ? wo[(x0 + x) * stride * DH] : 0.f;
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

constexpr float KV_QMAX = 127.f;     // int8 symmetric clamp bound
constexpr int WVEC = 16;              // elements a thread of the write moves at a time
constexpr int WROW_VECS = D / WVEC;   // 16-element pieces of a page row
constexpr int WTHREADS = NTHREADS / 2;  // threads of the write a leaf: K, then V

// Element chunk i (WVEC values of page row i / WROW_VECS) of a window page's
// values, QW's steps 2-3: the new row of x where the page row holds x's
// token t0 + row (0 <= t < s), else the old codes dequantized as
// bf16_rn(float(q) * sc).
__device__ __forceinline__ void window_chunk(const int8_t* codes, long long sr, const bf16* x,
                                             long long sxs, long long t0, int s, float sc, int i,
                                             uint4 (&o)[2]) {
  const int r = i / WROW_VECS, c = (i % WROW_VECS) * WVEC;
  const long long t = t0 + r;
  if (t >= 0 && t < s) {
    const uint4* src = reinterpret_cast<const uint4*>(x + t * sxs + c);
    o[0] = src[0];
    o[1] = src[1];
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(codes + r * sr + c);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
    for (int e = 0; e < WVEC / 2; ++e)
      o2[e] = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn((float)q[2 * e], sc)),
                                 __float2bfloat16_rn(__fmul_rn((float)q[2 * e + 1], sc)));
  }
}

// K5q with the write: re-quantize kv-head hk of slot b's write-window pages
// that lie in the range starting at c_begin, K with threads [0, WTHREADS)
// and V with the rest, by QW's arithmetic (csrc/kv_quant.cu steps 1-7).
// c0 is the logical column of the new rows' first token. A thread reads,
// then writes, only its own 16-byte pieces of a page: the second pass reads
// the old codes it read in the first, so the values need no shared memory.
// `red` holds the warps' maxima (NWARPS floats). Ends on a block barrier:
// the new codes and scales are visible to the whole block.
__device__ __forceinline__ void write_window(const Params& p, long long c0, float* red, int b,
                                             int hk, int c_begin) {
  const int tid = threadIdx.x, t = tid % WTHREADS, lane = tid & 31;
  const bool is_v = tid >= WTHREADS;
  const int shift = p.ps_shift, ps = 1 << shift;
  const long long first = c0 >> shift;
  const long long n_win = p.s == 1 ? 1 : (p.s - 1) / ps + 2;
  const long long lo = max(first, (long long)(c_begin >> shift));
  const long long hi = min(min(first + n_win, (long long)((c_begin + SPLIT) >> shift)),
                           (long long)(p.L >> shift));
  int8_t* pool = reinterpret_cast<int8_t*>(const_cast<bf16*>(is_v ? p.v : p.k)) +
                 hk * (is_v ? p.svh : p.skh);
  bf16* scales = const_cast<bf16*>(is_v ? p.vs : p.ks) + hk * (is_v ? p.svsh : p.sksh);
  const bf16* x = (is_v ? p.xv : p.xk) + b * (is_v ? p.sxvb : p.sxkb) + hk * (is_v ? p.sxvh : p.sxkh);
  const long long sp = is_v ? p.svb : p.skb, sr = is_v ? p.svl : p.skl;
  const long long ssp = is_v ? p.svsp : p.sksp, sxs = is_v ? p.sxvs : p.sxks;
  for (long long lp = lo; lp < hi; ++lp) {
    const long long page = __ldg(p.bt + b * p.sbt + lp);
    if (page == 0) continue;  // the null page: nothing reads it
    int8_t* codes = pool + page * sp;
    bf16* scale = scales + page * ssp;
    const long long t0 = (lp << shift) - c0;  // x's token at the page's row 0
    const float sc = __bfloat162float(*scale);
    // steps 1-4: the page's values, x's rows in place of the old ones; amax
    float amax = 0.f;
    for (int i = t; i < ps * WROW_VECS; i += WTHREADS) {
      uint4 o[2];
      window_chunk(codes, sr, x, sxs, t0, p.s, sc, i, o);
      const bf16* v = reinterpret_cast<const bf16*>(o);
#pragma unroll
      for (int e = 0; e < WVEC; ++e) amax = fmaxf(amax, fabsf(__bfloat162float(v[e])));
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    if (lane == 0) red[tid >> 5] = amax;
    __syncthreads();  // the warps' maxima; every read of the old scale is done
    constexpr int LEAF_WARPS = WTHREADS / 32;
#pragma unroll
    for (int w = 0; w < LEAF_WARPS; ++w) amax = fmaxf(amax, red[(is_v ? LEAF_WARPS : 0) + w]);
    // steps 5-7
    const bf16 s_new = __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-12f), KV_QMAX));
    const float sf = __bfloat162float(s_new);
    for (int i = t; i < ps * WROW_VECS; i += WTHREADS) {
      uint4 o[2];
      window_chunk(codes, sr, x, sxs, t0, p.s, sc, i, o);
      const bf16* v = reinterpret_cast<const bf16*>(o);
      uint4 out;
      int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int e = 0; e < WVEC; ++e)
        q[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(v[e]), sf)), -KV_QMAX), KV_QMAX);
      const int r = i / WROW_VECS, c = (i % WROW_VECS) * WVEC;
      *reinterpret_cast<uint4*>(codes + r * sr + c) = out;
    }
    if (t == 0) *scale = s_new;
    __syncthreads();  // the page's codes and scales written; `red` free again
  }
}

// One range `split` of one (slot b, kv-head hk): a block of K4, K5 and K5q;
// with WRITE, K5q's block that first writes its share of the write window.
template <int RMAX, class Cols, bool WRITE = false>
__device__ __forceinline__ void decode_range(const Params& p, unsigned char* dsm, int b, int hk,
                                             int split) {
  constexpr int MT = Smem<RMAX>::MT;
  const Smem<RMAX> sm(dsm, stage_bytes<Cols>());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c_begin = split * SPLIT;
  const int G = p.H / p.Hkv;
  const int R = G * p.s;  // row r = g * s + t  ->  q-head hk*G + g, token t

  // this thread's column's kv_valid byte and the live bound (from q_pos,
  // the same in every block), read together
  const int col = c_begin + tid;
  const bool valid = p.kv_valid == nullptr || (col < p.L && p.kv_valid[b * p.validb + col] != 0);
  const int bound = live_bound(p);
  // the write comes before both early exits: a window page past the bound
  // is written too (sm.wmax is free until the tile loop)
  if constexpr (WRITE) write_window(p, __ldg(p.w0), sm.wmax, b, hk, c_begin);
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
  if constexpr (Cols::QUANT) {
    // K5q: the range's pages, each read once (0 past the table), by a
    // range with a live tile only: a dead block returns without a read
    if ((tid & ((1 << p.ps_shift) - 1)) == 0)
      sm.pg[tid >> p.ps_shift] = col < p.L ? __ldg(p.bt + b * p.sbt + (col >> p.ps_shift)) : 0;
    __syncthreads();
    range_tiles<RMAX>(p, sm, Cols(p, hk, sm.pg), tiles, c_begin, R, part);
  } else {
    range_tiles<RMAX>(p, sm, Cols(p, b, hk), tiles, c_begin, R, part);
  }
}

// ------------------------------------------------------------ multi-row path
//
// One block per (64-row tile, kv-head, slot). A row tile holds T = 64 / G
// whole tokens of every head of the group: local row g * T + j is token
// t0 + j of q-head hk * G + g, so Q is one TMA box (64 columns x T tokens x
// G heads) a half. RWGS warpgroups share it, each walking every RWGS-th
// visited column tile with its own ring (its warp 0 the loader), and merge
// at the end.

constexpr int RBM = 64;        // rows a block
constexpr int RBN = 64;        // cache columns a tile
constexpr int RWGS = 3;        // consumer warpgroups a block
constexpr int RSTAGES = 2;     // K/V ring stages of a warpgroup
constexpr int RRING = RWGS * RSTAGES;  // warpgroup w's stage i is w * RSTAGES + i
constexpr int RTHREADS = 128 * RWGS;
constexpr int RTILE = RBN * D * 2;  // bytes of one K or V tile, and of the Q tile
static_assert(RBM * D * 2 == RTILE, "the Q tile is a K/V tile's size");
static_assert(RSTAGES * RTILE >= 64 * 128 * 4, "a warpgroup's K stages hold its O for the merge");
constexpr int RSM_Q = 0;
constexpr int RSM_K = RSM_Q + RTILE;                  // RRING tiles
constexpr int RSM_V = RSM_K + RRING * RTILE;          // RRING tiles
constexpr int RSM_META = RSM_V + RRING * RTILE;       // per stage: column tile (-1: done), masked
constexpr int RSM_BAR = RSM_META + 2 * RRING * 4;     // full[], empty[], q
constexpr int RSM_POS = RSM_BAR + (2 * RRING + 1) * 8;  // RBM row positions (-1: no row)
constexpr int RSM_BITS = RSM_POS + RBM * 4;           // 2 words a column tile
static_assert(RSM_BAR % 8 == 0, "mbarriers are 8-byte aligned");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a multi-row block over L cache columns (1024
// bytes of slack for align1024).
constexpr size_t rows_smem(int L) { return RSM_BITS + 8 * (size_t)((L + RBN - 1) / RBN) + 1024; }

// 2^x on the special-function unit, subnormal results flushed to 0 (K1's)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block of the multi-row path. `PAGED` reads K/V tiles page by page
// through the block table (K5) instead of one box a half (K4); the bytes
// that land, and so everything after, are the same.
template <bool PAGED>
__device__ __forceinline__ void decode_rows(unsigned char* dsm, const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const Params& p) {
  unsigned char* sm = align1024(dsm);
  unsigned char* Qs = sm + RSM_Q;
  int* meta = reinterpret_cast<int*>(sm + RSM_META);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + RSM_BAR);
  uint64_t* empty = full + RRING;
  uint64_t* q_bar = empty + RRING;
  int* spos = reinterpret_cast<int*>(sm + RSM_POS);
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + RSM_BITS);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform, as wgmma requires
  const int wg = warp >> 2, wtid = tid & 127, sb = wg * RSTAGES;  // sb: its first stage
  const int G = p.H / p.Hkv, T = RBM / G;
  const int per = p.Hkv * p.B;
  const int rt = gridDim.x / per - 1 - blockIdx.x / per;  // heaviest first: the latest tokens lead
  const int hk = blockIdx.x % per / p.B, b = blockIdx.x % p.B;
  const int t0 = rt * T, nt = min(T, p.s - t0);

  if (tid == 0) {
    for (int i = 0; i < RRING; ++i) {
      mbar_init(&full[i], 1);  // the loader lane's arrival with the stage's transactions
      mbar_init(&empty[i], 128);  // the warpgroup's threads
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
    // Q: T tokens x G heads a half; tokens past s arrive as zeros
    mbar_arrive_expect_tx(q_bar, 2 * T * G * 128);
    tma_load_4d(Qs, tm_q, q_bar, 0, t0, hk * G, b);
    tma_load_4d(Qs + RBM * 128, tm_q, q_bar, 64, t0, hk * G, b);
  }

  // The tile plan (flash_decode_rows_plan in kernels/flash_decode.py).
  // Every warp reduces the tile's positions itself: the bound (largest + 1)
  // and the smallest. Column tile j is visited when it holds a column below
  // the bound that kv_valid marks live, masked when one of its columns is
  // dead or lies past the smallest position.
  int mx = -1, mn = 0x7fffffff;
  for (int j = lane; j < nt; j += 32) {
    const int q = __ldg(p.q_pos + t0 + j);
    mx = max(mx, q);
    mn = min(mn, q);
  }
#pragma unroll
  for (int x = 16; x; x >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, x));
  }
  const int bound = min(mx + 1, p.L), pmin = mn;
  const int n_ct = (max(bound, 0) + RBN - 1) / RBN;  // column tiles before the bound
  if (tid < RBM) {
    const int g = tid / T, j = tid % T;
    spos[tid] = g < G && j < nt ? __ldg(p.q_pos + t0 + j) : -1;
  }
  // bit c % 32 of word c / 32: column c lies below the bound and is valid;
  // 16 columns a thread, their bytes loaded together
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.validb : nullptr;
  for (int base = 0; base < 4 * n_ct; base += RTHREADS) {
    const int ci = base + tid;
    uint32_t m16 = 0;
    if (ci < 4 * n_ct) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = 16 * ci + e;
        if (c < bound && (valid == nullptr || valid[c] != 0)) m16 |= 1u << e;
      }
    }
    const uint32_t hi = __shfl_down_sync(0xffffffffu, m16, 1);
    if (!(lane & 1) && ci < 4 * n_ct) bits[ci >> 1] = m16 | hi << 16;
  }
  __syncthreads();
  auto visited = [&](int j) { return (bits[2 * j] | bits[2 * j + 1]) != 0u; };
  auto masked = [&](int j) {
    return (bits[2 * j] & bits[2 * j + 1]) != 0xffffffffu || j * RBN + RBN - 1 > pmin;
  };
  auto next_live = [&](int j) {
    while (j < n_ct && !visited(j)) ++j;
    return j;
  };
  auto next_mine = [&](int j) {  // this warpgroup's visited tile after tile j
    for (int w = 0; w < RWGS; ++w) j = next_live(j + 1);
    return j;
  };

  // The loader (warp 0 of the warpgroup) fills its ring in the order it is
  // consumed: stage fill_st gets the warpgroup's next visited column tile
  // fill_j (K and V by TMA) or, past the last, the end mark, as soon as the
  // warpgroup has released the stage.
  // K5: one box a page (page_size rows, or 64 rows of a larger page) a
  // half, issued by the lanes, each page's table entry read one fill ahead.
  const bool loader = (warp & 3) == 0;
  const int psz = 1 << p.ps_shift, n_log = p.L >> p.ps_shift;
  const int npg = PAGED ? max(RBN >> p.ps_shift, 1) : 0, prows = min(psz, RBN);
  const int* bt = PAGED ? p.bt + b * p.sbt : nullptr;
  int pg[2] = {0, 0};
  auto table = [&](int j) {  // pool pages of tile j; past the table the pool's end (zeros)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k, lp = ((j * RBN) >> p.ps_shift) + i;
      if (i < npg) pg[k] = lp < n_log ? __ldg(bt + lp) : p.n_pages;
    }
  };
  int fill_j = 0, fill_st = 0;
  bool filled_all = false;
  auto fill = [&]() {
    const int st = sb + fill_st;
    if (++fill_st == RSTAGES) fill_st = 0;
    if (fill_j >= n_ct) {
      filled_all = true;
      if (lane == 0) {
        meta[2 * st] = -1;
        mbar_arrive(&full[st]);
      }
      return;
    }
    unsigned char* kt = sm + RSM_K + st * RTILE;
    unsigned char* vt = sm + RSM_V + st * RTILE;
    const int c0 = fill_j * RBN;
    if (lane == 0) {
      meta[2 * st] = fill_j;
      meta[2 * st + 1] = masked(fill_j);
      mbar_arrive_expect_tx(&full[st], 2 * RTILE);
      if (!PAGED) {
        tma_load_tile<RBN>(kt, tm_k, &full[st], c0, hk, b);
        tma_load_tile<RBN>(vt, tm_v, &full[st], c0, hk, b);
      }
    }
    if constexpr (PAGED) {
      __syncwarp();  // the transactions are expected before any page lands
      const int row0 = c0 & (psz - 1);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        if (i < npg) {
          const int off = i * prows * 128;
          tma_load_4d(kt + off, tm_k, &full[st], 0, row0, hk, pg[k]);
          tma_load_4d(kt + RBN * 128 + off, tm_k, &full[st], 64, row0, hk, pg[k]);
          tma_load_4d(vt + off, tm_v, &full[st], 0, row0, hk, pg[k]);
          tma_load_4d(vt + RBN * 128 + off, tm_v, &full[st], 64, row0, hk, pg[k]);
        }
      }
    }
    fill_j = next_mine(fill_j);
    if (PAGED && fill_j < n_ct) table(fill_j);
  };
  if (loader) {
    fill_j = next_live(0);
    for (int w = 0; w < wg; ++w) fill_j = next_live(fill_j + 1);
    if (PAGED && fill_j < n_ct) table(fill_j);
    for (int i = 0; i < RSTAGES && !filled_all; ++i) fill();
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g, r1 = r0 + 8;  // this thread's rows
  const int pos0 = spos[r0], pos1 = spos[r1];
  const float sl2 = p.scale * LOG2E;

  // O (64 x 128 f32), cleared before any product is issued; m in log2
  // units of the scaled score, l per thread (16 columns of each row a
  // tile), summed over the row's 4 lanes at the end
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);
  const uint64_t q_desc = desc_kmajor(Qs, 0);

  // K1's loop (flash_attention.cu) on each warpgroup and 64-column tiles:
  // per stage, wait for S, form P, issue O += P V, then the next stage's S
  // before P V is waited for. P stays f32 in effect: P = P_hi + P_lo, both
  // bf16, two register-A products into one accumulator.
  auto issue_s = [&](float (&acc)[32], int stage) {
    wgmma_fence();
    ss_product_n64<RBM, RBN, DH / 16>(acc, q_desc, desc_kmajor(sm + RSM_K + stage * RTILE, 0));
    wgmma_commit();
  };
  float s[32];
  uint32_t ph[RBN / 16][4], pl[RBN / 16][4];
  int st = sb;
  uint32_t par = 0;
  mbar_wait(&full[st], par);
  int j = meta[2 * st];
  if (j >= 0) issue_s(s, st);
  while (j >= 0) {
    const bool msk = meta[2 * st + 1] != 0;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);

    // thread columns 8 n + 2 t4 (+1) of the tile; dead or past a row's
    // position -> -inf
    if (msk) {
      const uint32_t w0 = bits[2 * j], w1 = bits[2 * j + 1];
      const int c0 = j * RBN;
#pragma unroll
      for (int n = 0; n < RBN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t4 + (e & 1);
          const uint32_t w = n < 4 ? w0 : w1;
          const bool ok = ((w >> (c & 31)) & 1u) && c0 + c <= (e < 2 ? pos0 : pos1);
          if (!ok) s[4 * n + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < RBN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // a row with no live column so far keeps m = -1e30 and the reference 0
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float ref0 = mn0 > NEG_INF * 0.5f ? mn0 : 0.f;
    const float ref1 = mn1 > NEG_INF * 0.5f ? mn1 : 0.f;
    const float alpha0 = ex2(m0 - ref0), alpha1 = ex2(m1 - ref1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < RBN / 8; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], sl2, -ref0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], sl2, -ref0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], sl2, -ref1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], sl2, -ref1));
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * alpha0 + sum0;  // from the unrounded P
    l1 = l1 * alpha1 + sum1;
    // P_hi = bf16(P), P_lo = bf16(P - P_hi): P_hi + P_lo is P to ~2^-17
#pragma unroll
    for (int kk = 0; kk < RBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(h);
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        pl[kk][r] = pack_bf16x2(a - hf.x, c - hf.y);
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }

    // O += P_hi V + P_lo V: the V stage read MN-major
    const uint64_t v_desc = desc_mnmajor<RBN>(sm + RSM_V + st * RTILE);
    wgmma_fence();
    rs_product(o, ph, v_desc, 1);
    rs_product(o, pl, v_desc, 1);
    wgmma_commit();
    const int nst = st + 1 == sb + RSTAGES ? sb : st + 1;
    const uint32_t npar = nst == sb ? par ^ 1 : par;
    mbar_wait(&full[nst], npar);
    const int nj = meta[2 * nst];
    if (nj >= 0) {
      issue_s(s, nst);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(&empty[st]);
    if (loader && !filled_all) {
      mbar_wait(&empty[st], par);  // the warpgroup is done with the stage
      fill();
    }
    st = nst, par = npar, j = nj;
  }
  // nothing is in flight, but ptxas cannot tell (see flash_attention.cu)
  wgmma_wait<0>();
  fence_regs(o);

  // Merge in warpgroup order: each later warpgroup leaves O, m and l (per
  // thread, the same fragment layout) in its own K and V stages; the first
  // folds them in and writes the rows.
  if (RWGS > 1) {
    if (wg > 0) {
      float* red = reinterpret_cast<float*>(sm + RSM_K + sb * RTILE);
      float* ml = reinterpret_cast<float*>(sm + RSM_V + sb * RTILE);
#pragma unroll
      for (int i = 0; i < 64; ++i) red[i * 128 + wtid] = o[i];
      ml[wtid] = m0;
      ml[128 + wtid] = m1;
      ml[256 + wtid] = l0;
      ml[384 + wtid] = l1;
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll 1
    for (int w = 1; w < RWGS; ++w) {
      const float* red = reinterpret_cast<const float*>(sm + RSM_K + w * RSTAGES * RTILE);
      const float* ml = reinterpret_cast<const float*>(sm + RSM_V + w * RSTAGES * RTILE);
      const float mb0 = ml[wtid], mb1 = ml[128 + wtid];
      const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
      const float ref0 = mn0 > NEG_INF * 0.5f ? mn0 : 0.f;
      const float ref1 = mn1 > NEG_INF * 0.5f ? mn1 : 0.f;
      const float a0 = ex2(m0 - ref0), b0 = ex2(mb0 - ref0);
      const float a1 = ex2(m1 - ref1), b1 = ex2(mb1 - ref1);
      l0 = l0 * a0 + ml[256 + wtid] * b0;
      l1 = l1 * a1 + ml[384 + wtid] * b1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] = o[4 * n] * a0 + red[(4 * n) * 128 + wtid] * b0;
        o[4 * n + 1] = o[4 * n + 1] * a0 + red[(4 * n + 1) * 128 + wtid] * b0;
        o[4 * n + 2] = o[4 * n + 2] * a1 + red[(4 * n + 2) * 128 + wtid] * b1;
        o[4 * n + 3] = o[4 * n + 3] * a1 + red[(4 * n + 3) * 128 + wtid] * b1;
      }
      m0 = mn0;
      m1 = mn1;
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const long long lse_row = ((long long)b * p.Hkv + hk) * G * p.s;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0, gq = r / T, jt = r % T;
    if (gq >= G || jt >= nt) continue;
    const float l = h ? l1 : l0, m = h ? m1 : m0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int t = t0 + jt;
    bf16* orow = p.o + b * p.sob + t * p.sos + (hk * G + gq) * p.soh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)  // O's columns past DH are zeros, never stored
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
    // natural log; a row that saw no live column: -1e30
    if (t4 == 0) p.lse[lse_row + gq * p.s + t] = l > 0.f ? m * LN2 + logf(l) : NEG_INF;
  }
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, RowCols>(p, dsm, blockIdx.y, blockIdx.x, blockIdx.z);
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) paged_flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, PagedCols>(p, dsm, blockIdx.y, blockIdx.x, blockIdx.z);
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) qpaged_flash_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, QPagedCols>(p, dsm, blockIdx.y, blockIdx.x, blockIdx.z);
}

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS, 2) qpaged_flash_decode_kernel_write(Params p) {
  extern __shared__ __align__(128) unsigned char dsm[];
  decode_range<RMAX, QPagedCols, true>(p, dsm, blockIdx.y, blockIdx.x, blockIdx.z);
}

// The merges of K4, K5 and K5q are one function under three names, so a
// profile files each under its own kernel's family (K5q with the write
// launches K5q's).
__global__ void __launch_bounds__(DH) flash_decode_kernel_merge(Params p) { merge_row(p); }
__global__ void __launch_bounds__(DH) paged_flash_decode_kernel_merge(Params p) { merge_row(p); }
__global__ void __launch_bounds__(DH) qpaged_flash_decode_kernel_merge(Params p) { merge_row(p); }

__global__ void __launch_bounds__(RTHREADS, RWGS == 1 ? 2 : 1)
    flash_decode_kernel_rows(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ Params p) {
  extern __shared__ unsigned char rsm[];
  decode_rows<false>(rsm, &tm_q, &tm_k, &tm_v, p);
}

__global__ void __launch_bounds__(RTHREADS, RWGS == 1 ? 2 : 1)
    paged_flash_decode_kernel_rows(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ Params p) {
  extern __shared__ unsigned char rsm[];
  decode_rows<true>(rsm, &tm_q, &tm_k, &tm_v, p);
}

typedef void (*RowsKernel)(CUtensorMap, CUtensorMap, CUtensorMap, Params);

RowsKernel rows_kernel_of(bool paged) {
  return paged ? &paged_flash_decode_kernel_rows : &flash_decode_kernel_rows;
}

template <int RMAX>
void (*kernel_of(int kind))(Params) {
  return kind == QPAGED_WRITE ? &qpaged_flash_decode_kernel_write<RMAX>
         : kind == QPAGED ? &qpaged_flash_decode_kernel<RMAX>
         : kind == PAGED ? &paged_flash_decode_kernel<RMAX> : &flash_decode_kernel<RMAX>;
}

void (*merge_of(int kind))(Params) {
  return kind >= QPAGED ? &qpaged_flash_decode_kernel_merge
         : kind == PAGED ? &paged_flash_decode_kernel_merge : &flash_decode_kernel_merge;
}

// Dynamic shared memory of a block of K4/K5 (kind 0, 1) or K5q (2; with
// the write, 3).
template <int RMAX>
size_t smem_of(int kind) {
  return kind >= QPAGED ? Smem<RMAX>::bytes(QSTAGE_BYTES, true) : Smem<RMAX>::bytes();
}

// Let the kernel take its shared memory, and the SM give shared memory all
// it can.
template <class Kernel>
int configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <int RMAX>
int launch(const Params& p, int kind, cudaStream_t stream) {
  const size_t smem = smem_of<RMAX>(kind);
  const int code = configure(kernel_of<RMAX>(kind), smem);
  if (code) return code;
  kernel_of<RMAX>(kind)<<<dim3(p.Hkv, p.B, p.n_splits), NTHREADS, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_of(kind)<<<dim3(p.Hkv, p.B, (p.H / p.Hkv) * p.s), DH, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The multi-row path: one launch, no merge, the grid (row tiles x Hkv x B)
// from the shapes alone. Q's map has a box of T tokens x G heads; K/V's
// the row cache's 64-row tiles (K4) or the pool's pages (K5).
int launch_rows(const Params& p, bool paged, cudaStream_t stream) {
  const int G = p.H / p.Hkv, T = RBM / G;
  const int kb = paged ? p.n_pages : p.B, kl = paged ? 1 << p.ps_shift : p.L;
  const int rows = paged && (1 << p.ps_shift) < RBN ? 1 << p.ps_shift : RBN;
  CUtensorMap m[3];
  int err;
  if ((err = encode_bshd(&m[0], p.q, p.B, p.s, p.H, p.sqb, p.sqs, p.sqh, T, G, DH))) return err;
  if ((err = encode_bshd(&m[1], p.k, kb, kl, p.Hkv, p.skb, p.skl, p.skh, rows, 1, DH))) return err;
  if ((err = encode_bshd(&m[2], p.v, kb, kl, p.Hkv, p.svb, p.svl, p.svh, rows, 1, DH))) return err;
  const size_t smem = rows_smem(p.L);
  if ((err = configure(rows_kernel_of(paged), smem))) return err;
  const int grid = (p.s + T - 1) / T * p.Hkv * p.B;
  rows_kernel_of(paged)<<<grid, RTHREADS, smem, stream>>>(m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

int dispatch(Params p, int kind, void* stream) {
  const int R = (p.H / p.Hkv) * p.s;
  p.n_splits = (p.L + SPLIT - 1) / SPLIT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 4) return launch<4>(p, kind, st);
  if (R <= 8) return launch<8>(p, kind, st);
  if (R <= 16) return launch<16>(p, kind, st);
  if (R <= 32) return launch<32>(p, kind, st);
  if (p.H / p.Hkv > RMAX_ALL || kind >= QPAGED) return (int)cudaErrorInvalidValue;
  return launch_rows(p, kind == PAGED, st);
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

// Dynamic shared memory a block, registers a thread, local bytes a thread
// and blocks an SM of one kernel as launched.
template <class Kernel>
int resources(Kernel kernel, size_t smem, int threads, int* out) {
  const int code = configure(kernel, smem);
  if (code) return code;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = (int)smem;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return (int)e;
}

}  // namespace

// work_o is (ceil(L / split_cols), B, Hkv, R, DH) f32 and work_lse
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
  return dispatch(p, ROW, stream);
}

// K5: k/v are pools (n_pages, page_size, Hkv, D) with strides (skp, skr,
// skh); bt is the (B, n_log) block table, row stride sbt; page_size = 1 <<
// ps_shift. Returns a CUDA error, or a code from hopper.cuh when a tensor
// map of the multi-row path cannot be made (K4 too).
extern "C" int nxd_paged_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* kv_valid, const void* bt, void* work_o, void* work_lse,
    int B, int s, int H, int Hkv, int n_log, int ps_shift, int n_pages,
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
  p.n_pages = n_pages;
  p.skb = skp; p.skl = skr; p.skh = skh;
  p.svb = svp; p.svl = svr; p.svh = svh;
  return dispatch(p, PAGED, stream);
}

// K5q: k/v are int8 pools (n_pages, page_size, Hkv, D) with strides (skp,
// skr, skh) in bytes; ks/vs their bf16 scales (n_pages, 1, Hkv, 1) with
// page and kv-head strides (sksp, sksh), (svsp, svsh); otherwise as K5.
// R = group * s must be at most 32.
extern "C" int nxd_qpaged_flash_decode_fwd(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, void* o,
    void* lse, const void* q_pos, const void* kv_valid, const void* bt, void* work_o,
    void* work_lse,
    int B, int s, int H, int Hkv, int n_log, int ps_shift, int n_pages,
    long long sqb, long long sqs, long long sqh,
    long long skp, long long skr, long long skh,
    long long svp, long long svr, long long svh,
    long long sksp, long long sksh, long long svsp, long long svsh,
    long long sob, long long sos, long long soh,
    long long validb, long long sbt, float scale, void* stream) {
  Params p = common(q, k, v, o, lse, q_pos, kv_valid, work_o, work_lse, B, s, H, Hkv,
                    n_log << ps_shift, sqb, sqs, sqh, sob, sos, soh, validb, scale);
  p.bt = static_cast<const int*>(bt);
  p.sbt = sbt;
  p.ps_shift = ps_shift;
  p.n_pages = n_pages;
  p.skb = skp; p.skl = skr; p.skh = skh;
  p.svb = svp; p.svl = svr; p.svh = svh;
  p.ks = static_cast<const bf16*>(ks);
  p.vs = static_cast<const bf16*>(vs);
  p.sksp = sksp; p.sksh = sksh; p.svsp = svsp; p.svsh = svsh;
  if (DH != D) return (int)cudaErrorInvalidValue;  // int8 pages are 128 columns wide
  return dispatch(p, QPAGED, stream);
}

// K5q with the write: first the s new rows xk/xv (B, s, Hkv, D) bf16, with
// strides (sxkb, sxks, sxkh) and (sxvb, sxvs, sxvh), land at logical columns
// *w0 + t of each slot (w0 one int64 on the device) and every page of the
// write window is re-quantized (QW's function; the pools and scales are
// written), then the pools are attended; otherwise as K5q. R = group * s
// must be at most 32.
extern "C" int nxd_qpaged_write_attend_fwd(
    const void* q, void* k, void* v, void* ks, void* vs, void* o,
    void* lse, const void* q_pos, const void* kv_valid, const void* bt, void* work_o,
    void* work_lse, const void* xk, const void* xv, const void* w0,
    int B, int s, int H, int Hkv, int n_log, int ps_shift, int n_pages,
    long long sqb, long long sqs, long long sqh,
    long long skp, long long skr, long long skh,
    long long svp, long long svr, long long svh,
    long long sksp, long long sksh, long long svsp, long long svsh,
    long long sob, long long sos, long long soh,
    long long validb, long long sbt,
    long long sxkb, long long sxks, long long sxkh,
    long long sxvb, long long sxvs, long long sxvh, float scale, void* stream) {
  Params p = common(q, k, v, o, lse, q_pos, kv_valid, work_o, work_lse, B, s, H, Hkv,
                    n_log << ps_shift, sqb, sqs, sqh, sob, sos, soh, validb, scale);
  p.bt = static_cast<const int*>(bt);
  p.sbt = sbt;
  p.ps_shift = ps_shift;
  p.n_pages = n_pages;
  p.skb = skp; p.skl = skr; p.skh = skh;
  p.svb = svp; p.svl = svr; p.svh = svh;
  p.ks = static_cast<const bf16*>(ks);
  p.vs = static_cast<const bf16*>(vs);
  p.sksp = sksp; p.sksh = sksh; p.svsp = svsp; p.svsh = svsh;
  p.xk = static_cast<const bf16*>(xk);
  p.xv = static_cast<const bf16*>(xv);
  p.w0 = static_cast<const long long*>(w0);
  p.sxkb = sxkb; p.sxks = sxks; p.sxkh = sxkh;
  p.sxvb = sxvb; p.sxvs = sxvs; p.sxvh = sxvh;
  if (DH != D) return (int)cudaErrorInvalidValue;  // int8 pages are 128 columns wide
  return dispatch(p, QPAGED_WRITE, stream);
}

// Resources of K4 (kind 0), K5 (1), K5q (2) or K5q with the write (3) at R
// <= rmax (4, 8, 16 or 32; 0: the multi-row kernel, R > 32, K4's and K5's
// alone), at L = 8192, into out[4].
extern "C" int nxd_flash_decode_resources(int paged, int rmax, int* out) {
  if (paged < ROW || paged > QPAGED_WRITE) return (int)cudaErrorInvalidValue;
  switch (rmax) {
    case 0:
      if (paged >= QPAGED) return (int)cudaErrorInvalidValue;
      return resources(rows_kernel_of(paged == PAGED), rows_smem(8192), RTHREADS, out);
    case 4: return resources(kernel_of<4>(paged), smem_of<4>(paged), NTHREADS, out);
    case 8: return resources(kernel_of<8>(paged), smem_of<8>(paged), NTHREADS, out);
    case 16: return resources(kernel_of<16>(paged), smem_of<16>(paged), NTHREADS, out);
    case 32: return resources(kernel_of<32>(paged), smem_of<32>(paged), NTHREADS, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nxd_flash_decode_max_rows() { return RMAX_ALL; }
extern "C" int nxd_flash_decode_head_dim() { return DH; }
extern "C" int nxd_flash_decode_split_cols() { return SPLIT; }
extern "C" int nxd_flash_decode_tile_cols() { return TL; }
// The multi-row path's tile: rows a block (whole tokens of every head of a
// group) and cache columns a tile.
extern "C" int nxd_flash_decode_row_tile() { return RBM; }
extern "C" int nxd_flash_decode_row_tile_cols() { return RBN; }
