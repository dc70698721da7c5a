// Fragment and copy helpers of the decode kernels (K4 and K5,
// flash_decode.cu), whose products run on `mma.sync.m16n8k16` with bf16
// inputs and f32 accumulators; the flash-attention forward and backward
// (K1, flash_attention.cu; K2 and K3, flash_attention_bwd.cu) take only D,
// bf16 and NEG_INF from here and build their `wgmma` products on
// hopper.cuh.
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

}  // namespace nxd_flash
