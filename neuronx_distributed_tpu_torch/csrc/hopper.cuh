// Hopper (sm_90a) building blocks of the attention kernels K1
// (flash_attention.cu), K2 and K3 (flash_attention_bwd.cu), the
// multi-row decode path (flash_decode.cu) and the routed expert product
// (moe_experts.cu): mbarriers, TMA tile loads through tensor maps, `wgmma`
// products and the shared-memory descriptors they read.
//
// Tile convention. A tile is R rows x 128 bf16 columns (the head dim), kept
// as two halves of R x 64 columns, half h at byte offset h * R * 128: TMA's
// 128-byte swizzle caps a box's inner dimension at 128 bytes. Each half is
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c of row
// r lands at chunk c ^ (r % 8)) and read by `wgmma` through B128
// descriptors; every half starts on a 1024-byte boundary, where the pattern
// repeats.
//  * K-major operand (the 128 columns are the k dimension): k-step kk of 16
//    columns starts at half kk / 4, byte (kk % 4) * 32 of the row; 8-row
//    groups are 1024 bytes apart (SBO); LBO is unused.
//  * MN-major operand (the rows are the k dimension, the 128 columns are N):
//    k-step kk starts at row 16 kk of half 0; the 64-column halves are
//    R * 128 bytes apart (LBO), 8-row groups 1024 (SBO); the product sets
//    the transpose bit of B.
// The f32 accumulators of m64nN, packed to bf16 two columns at a time, are
// the A fragments of m64k16 in registers: thread (warp w, lane l) holds rows
// 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) of both.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace nxd_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The first 1024-byte boundary at or after `p` (dynamic shared memory is
// allocated with 1024 bytes of slack for it).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive and announce `bytes` of TMA transactions the phase must also see.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait for the phase of parity `parity` to complete. A barrier that never
// completes is a fault: trap after ~2^34 cycles (seconds) rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// ------------------------------------------------------------------ cp.async

// 4 bytes from global to shared memory, asynchronously; with `bytes` 0 the
// destination gets a zero and the source is not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// 16 bytes from global to shared memory through L2 only; with `bytes` 0
// the destination gets zeros and the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Arrive on `bar` (one of its expected arrivals) once every cp.async this
// thread issued before has landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ----------------------------------------------------------------------- TMA

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (column c0, row c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Rows [row, row + R) of head h, batch b of a (B, S, H, 128) map whose box
// is 64 x R: both halves of an R-row tile (2 * R * 128 bytes of
// transactions). Rows past S arrive as zeros.
template <int R>
__device__ __forceinline__ void tma_load_tile(unsigned char* tile, const CUtensorMap* map,
                                              uint64_t* bar, int row, int h, int b) {
  tma_load_4d(tile, map, bar, 0, row, h, b);
  tma_load_4d(tile + R * 128, map, bar, 64, row, h, b);
}

// --------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator registers across an async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A fragments stay live (and in place) until the product that reads them is waited for.
template <int KS>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// A B128-swizzled shared-memory matrix descriptor.
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand: rows from r0 of a tile, k-step 0.
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int r0) {
  return desc_b128(tile + r0 * 128, 16, 1024);
}
// MN-major operand: an R-row tile's rows as k (from row 0), its 128 columns as N.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile) {
  return desc_b128(tile, R * 128, 1024);
}
// How far k-step kk lies from k-step 0, in the descriptor's 16-byte units.
// Each product adds it to one base descriptor inside its instruction, so a
// loop-invariant operand costs two registers, not two per k-step.
__host__ __device__ constexpr int kmajor_step(int rows, int kk) {
  return ((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4;
}
__host__ __device__ constexpr int mnmajor_step(int kk) { return kk * 16 * 128 >> 4; }

// acc (64 x 64) (+)= A B^T, both K-major from shared memory; the descriptors
// advance by OA / OB 16-byte units inside the instruction.
template <int OA, int OB, int ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.s64 a, %32, %35;\n"
      "add.s64 b, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(ACC), "n"(OA), "n"(OB));
}

// acc (64 x 128) (+)= A B^T, both K-major from shared memory; the descriptors
// advance by OA / OB 16-byte units inside the instruction.
template <int OA, int OB, int ACC>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "add.s64 a, %64, %67;\n"
      "add.s64 b, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(ACC), "n"(OA), "n"(OB));
}

// acc (64 x 128) (+)= A B, A from registers, B MN-major (transposed) from
// shared memory, its descriptor advanced by OB 16-byte units; acc is
// overwritten when `accumulate` is 0.
template <int OB>
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "add.s64 b, %68, %69;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, b, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(accumulate));
}

// acc (64 x N) = 64 rows of an RA-row tile (base descriptor da) times N rows
// of an RB-row tile (db), transposed, over the first 16 NK of the 128
// columns (all of them by default): both K-major. These only issue: the
// caller fences, commits and waits.
template <int RA, int RB, int NK = 8, int KK = 0>
__device__ __forceinline__ void ss_product_n64(float (&acc)[32], uint64_t da, uint64_t db) {
  wgmma_ss_n64<kmajor_step(RA, KK), kmajor_step(RB, KK), (KK > 0)>(acc, da, db);
  if constexpr (KK + 1 < NK) ss_product_n64<RA, RB, NK, KK + 1>(acc, da, db);
}
template <int RA, int RB, int NK = 8, int KK = 0>
__device__ __forceinline__ void ss_product_n128(float (&acc)[64], uint64_t da, uint64_t db) {
  wgmma_ss_n128<kmajor_step(RA, KK), kmajor_step(RB, KK), (KK > 0)>(acc, da, db);
  if constexpr (KK + 1 < NK) ss_product_n128<RA, RB, NK, KK + 1>(acc, da, db);
}
// acc (64 x 128) (+)= A (64 x 16 KS, bf16 fragments in registers) times the
// first 16 KS rows of a tile read MN-major (base descriptor db). With
// `accumulate` 0 the product starts from zero: an accumulator that no
// ordinary instruction ever writes (not even to clear it) lets `ptxas` keep
// the products in flight instead of serializing them.
template <int KS, int KK = 0>
__device__ __forceinline__ void rs_product(float (&acc)[64], const uint32_t (&a)[KS][4],
                                           uint64_t db, int accumulate) {
  wgmma_rs_n128_tb<mnmajor_step(KK)>(acc, a[KK], db, KK > 0 ? 1 : accumulate);
  if constexpr (KK + 1 < KS) rs_product<KS, KK + 1>(acc, a, db, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}
// The accumulators of m64nN (N = 16 KS), rounded to bf16, as KS A fragments.
template <int M, int KS>
__device__ __forceinline__ void acc_to_a(const float (&acc)[M], uint32_t (&a)[KS][4]) {
  static_assert(M == 8 * KS, "m64nN holds N / 2 accumulators a thread");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// ------------------------------------------------------------- host: maps

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process already runs on:
// the libraries do not link libcuda.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<TensorMapEncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Entry-point codes past cudaError_t's range: no encoder (900), or the
// encoder refused a map (1000 + its CUresult).
constexpr int ERR_NO_ENCODER = 900;
constexpr int ERR_ENCODE = 1000;

// The map of a (B, S, H, dim) bf16 tensor with element strides (sb, ss, sh)
// and a unit-stride head dim of `dim` <= 128 columns: dims innermost first
// (dim, S, H, B), a box of 64 columns x `rows` rows x `heads` heads (row j
// of head i lands as row i * rows + j), 128-byte swizzle, zeros past the
// edges: a 128-column tile's columns past `dim` land as zeros.
inline int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, long long sb,
                       long long ss, long long sh, int rows, int heads = 1, int dim = 128) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, (cuuint32_t)heads, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// The map of a row-major (rows, cols) matrix of `elem_bytes`-byte elements
// (bf16, or 1-byte codes as UINT8): a box of 128 bytes of columns x
// `box_rows` rows, 128-byte swizzle, zeros past the edges. The row pitch
// (cols x elem_bytes) must be a multiple of 16 bytes.
inline int encode_rows(CUtensorMap* map, const void* base, long long rows, long long cols,
                       int elem_bytes, int box_rows) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         2, const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

}  // namespace nxd_hopper
