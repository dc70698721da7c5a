// One-pass weight dequantize for Hopper (sm_90a): DQ.
//
// It computes what XLA fuses into the matmul's operand load on the TPU:
// JAX's `quantized_matmul` (neuronx_distributed_tpu/quantization/
// layers.py:33) dequantizes `(kernel_q.astype(f32) * scale).astype(bf16)`
// and hands the dense GEMM a bf16 weight. In eager PyTorch the same
// expression builds an f32 temporary (read 1 B, write 4, read 4, write 2
// a weight); DQ reads the 1-byte code and writes the bf16 weight once.
//
// out[r, c] = bf16_rn(float(q[r, c]) * scale[r]) for int8 or fp8 e4m3
// codes, one f32 scale per output row (scale_stride 1) or one for the
// tensor (scale_stride 0): the plain version's arithmetic, bit for bit (an
// fp8 or int8 code is exact in f32; the product rounds once, by
// `__fmul_rn`, which the compiler may not fuse; the cast rounds to
// nearest even).
//
// What bounds it on an H100: bytes, 3 a weight (1 read, 2 written), ~0.47
// ms for lm_head's 128256 x 4096 at 3.35 TB/s. The design: each thread
// turns 16 codes (one 16-byte load) into 16 bf16 values (two 16-byte
// stores), in a grid-stride loop; a row's length is a multiple of 16, so a
// thread's 16 codes share one scale.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // codes a thread converts at a time

template <bool FP8>
__device__ __forceinline__ float code_to_float(uint8_t b) {
  if constexpr (FP8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

template <bool FP8>
__global__ void __launch_bounds__(THREADS) dequantize_kernel(
    const uint4* __restrict__ q, const float* __restrict__ scale, long long scale_stride,
    uint4* __restrict__ out, long long n_vec, long long row_vecs) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * THREADS) {
    const float s = __ldg(scale + (i / row_vecs) * scale_stride);
    const uint4 raw = __ldg(q + i);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    uint4 o[2];
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e)
      o2[e] = __floats2bfloat162_rn(__fmul_rn(code_to_float<FP8>(b[2 * e]), s),
                                    __fmul_rn(code_to_float<FP8>(b[2 * e + 1]), s));
    out[2 * i] = o[0];
    out[2 * i + 1] = o[1];
  }
}

}  // namespace

// q (rows, cols) int8 (fp8 = 0) or fp8 e4m3 (fp8 = 1) codes, out (rows,
// cols) bf16, both contiguous and 16-byte aligned, cols a multiple of 16;
// scale f32, (rows,) with scale_stride 1 or one value with scale_stride 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nxd_dequantize_fwd(const void* q, const void* scale, long long scale_stride,
                                  void* out, long long rows, long long cols, int fp8,
                                  int n_blocks, void* stream) {
  const long long row_vecs = cols / VEC, n_vec = rows * row_vecs;
  if (n_vec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* qv = static_cast<const uint4*>(q);
  const float* sv = static_cast<const float*>(scale);
  uint4* ov = static_cast<uint4*>(out);
  if (fp8)
    dequantize_kernel<true><<<n_blocks, THREADS, 0, st>>>(qv, sv, scale_stride, ov, n_vec, row_vecs);
  else
    dequantize_kernel<false><<<n_blocks, THREADS, 0, st>>>(qv, sv, scale_stride, ov, n_vec, row_vecs);
  return (int)cudaGetLastError();
}

extern "C" int nxd_dequantize_vec() { return VEC; }
