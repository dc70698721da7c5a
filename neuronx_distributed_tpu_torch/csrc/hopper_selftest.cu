// On-card tests of hopper.cuh's building blocks, which K2 and K3
// (flash_attention_bwd.cu) are assembled from; no path of the port calls
// them. `tests/test_torch_cuda.py` holds each against torch.
//  * nxd_selftest_tma_tile: one R-row tile of a (B, S, H, 128) bf16 tensor
//    through a tensor map into the two swizzled halves, read back through
//    the swizzle formula (TMA, the map's strides, zeros past the edge).
//  * nxd_selftest_wgmma: S = A B1^T (SS, both K-major, N = 64 or 128), then
//    C = bf16(S) B2 with bf16(S) handed from the accumulators to the A
//    registers and B2's N rows as the k dimension (RS, B MN-major).
#include "hopper.cuh"

namespace {

using namespace nxd_hopper;
typedef __nv_bfloat16 bf16;

template <int R>
__global__ void tile_kernel(const __grid_constant__ CUtensorMap map, int row, int h, int b,
                            bf16* out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar;
  unsigned char* tile = align1024(smem_raw);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 2 * R * 128);
    tma_load_tile<R>(tile, &map, &bar, row, h, b);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < R * 128; i += blockDim.x) {
    const int r = i / 128, c = i % 128, cc = c % 64;
    const int chunk = (cc / 8) ^ (r % 8);
    out[i] = *reinterpret_cast<const bf16*>(tile + (c / 64) * R * 128 + r * 128 + chunk * 16 +
                                            (cc % 8) * 2);
  }
}

template <int N>
__global__ void wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                             const __grid_constant__ CUtensorMap mb1,
                             const __grid_constant__ CUtensorMap mb2, float* s_out,
                             float* c_out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar;
  unsigned char* a = align1024(smem_raw);
  unsigned char* b1 = a + 64 * 256;
  unsigned char* b2 = b1 + N * 256;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, (64 + 2 * N) * 256);
    tma_load_tile<64>(a, &ma, &bar, 0, 0, 0);
    tma_load_tile<N>(b1, &mb1, &bar, 0, 0, 0);
    tma_load_tile<N>(b2, &mb2, &bar, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  float s[N / 2];
  wgmma_fence();
  if constexpr (N == 64)
    ss_product_n64<64, N>(s, desc_kmajor(a, 0), desc_kmajor(b1, 0));
  else
    ss_product_n128<64, N>(s, desc_kmajor(a, 0), desc_kmajor(b1, 0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t4 + (i & 1);
    s_out[row * N + col] = s[i];
  }

  uint32_t fa[N / 16][4];
  acc_to_a(s, fa);
  float c[64];  // never cleared: the first k-step overwrites it
  wgmma_fence();
  rs_product(c, fa, desc_mnmajor<N>(b2), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(c);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t4 + (i & 1);
    c_out[row * 128 + col] = c[i];
  }
}

}  // namespace

// x: (B, S, H, 128) bf16 with element strides st[0..2] (batch, seq, head);
// out: rows x 128 bf16, contiguous. rows is 64 or 128.
extern "C" int nxd_selftest_tma_tile(const void* x, int B, int S, int H, const long long* st,
                                     int rows, int row, int h, int b, void* out, void* stream) {
  CUtensorMap map;
  if (int err = encode_bshd(&map, x, B, S, H, st[0], st[1], st[2], rows)) return err;
  const int smem = rows * 256 + 1024;
  auto kernel = rows == 64 ? tile_kernel<64> : tile_kernel<128>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(map, row, h, b,
                                                              static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// a: 64 x 128, b1 and b2: n x 128, all bf16 contiguous; n is 64 or 128.
// s_out: 64 x n f32; c_out: 64 x 128 f32.
extern "C" int nxd_selftest_wgmma(const void* a, const void* b1, const void* b2, int n,
                                  void* s_out, void* c_out, void* stream) {
  CUtensorMap ma, mb1, mb2;
  int err;
  if ((err = encode_bshd(&ma, a, 1, 64, 1, 64 * 128, 128, 128, 64))) return err;
  if ((err = encode_bshd(&mb1, b1, 1, n, 1, n * 128, 128, 128, n))) return err;
  if ((err = encode_bshd(&mb2, b2, 1, n, 1, n * 128, 128, 128, n))) return err;
  const int smem = (64 + 2 * n) * 256 + 1024;
  auto kernel = n == 64 ? wgmma_kernel<64> : wgmma_kernel<128>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ma, mb1, mb2, static_cast<float*>(s_out), static_cast<float*>(c_out));
  return (int)cudaGetLastError();
}
