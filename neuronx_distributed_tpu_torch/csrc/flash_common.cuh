// Fragment and copy helpers of the flash-attention forward (K1,
// flash_attention.cu), whose products run on `mma.sync.m16n8k16` with bf16
// inputs and f32 accumulators; the backward (K2 and K3,
// flash_attention_bwd.cu) takes only D and bf16 from here and builds its
// `wgmma` products on hopper.cuh.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//  * A (16 x 16, row major): a0 = (row g, cols 2t..2t+1), a1 = (row g+8,
//    cols 2t..2t+1), a2 = (row g, cols 2t+8..2t+9), a3 = (row g+8, cols
//    2t+8..2t+9);
//  * B (16 x 8, column major): b0 = (rows 2t..2t+1, col g), b1 = (rows
//    2t+8..2t+9, col g);
//  * C (16 x 8): c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = (row g+8, cols
//    2t, 2t+1).
// So two C tiles side by side, packed to bf16, are one A fragment: the
// accumulators of one product feed the next without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nxd_flash {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;     // head dim (every Llama preset)
constexpr int LD = D + 8;  // bf16 row pitch of staged tiles: conflict-free fragment loads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed, from shared memory: the B operands of
// a product whose k dimension runs down the rows of a row-major tile.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ unsigned lds32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The A fragment of rows [row0, row0 + 16) x cols [col0, col0 + 16) of a
// row-major tile with pitch LD.
__device__ __forceinline__ void load_a(unsigned a[4], const bf16* tile, int row0, int col0,
                                       int lane) {
  const bf16* base = tile + (row0 + (lane >> 2)) * LD + col0 + (lane & 3) * 2;
  a[0] = lds32(base);
  a[1] = lds32(base + 8 * LD);
  a[2] = lds32(base + 8);
  a[3] = lds32(base + 8 * LD + 8);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Stage rows [r0, r0 + rows) of a (.., D) bf16 matrix with row stride
// `stride` into a pitch-LD tile by 16-byte `cp.async`; rows at or past
// `n_valid` are zero-filled directly, so no product ever reads garbage.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* src, long long stride, int r0,
                                           int n_valid, int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (r0 + r < n_valid)
      cp_async16(tile + r * LD + c, src + (long long)(r0 + r) * stride + c);
    else
      *reinterpret_cast<int4*>(tile + r * LD + c) = make_int4(0, 0, 0, 0);
  }
}

}  // namespace nxd_flash
