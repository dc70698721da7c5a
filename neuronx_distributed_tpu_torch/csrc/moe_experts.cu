// The routed SwiGLU expert product of a MoE decode step for Hopper
// (sm_90a): MX (bf16 experts) and MXq (int8 or fp8 e4m3 experts with f32
// scales), one source templated on the weight format.
//
// It replaces no `pallas_call`: it computes what XLA fuses on the TPU for
// JAX's selective-loading strategy (neuronx_distributed_tpu/modules/moe/
// expert_mlps.py:327 `_selective`), with the dequantize that
// `_declare_kernel` (parallel/layers.py:48) puts in the weights' load for
// quantized experts. For each token t and slot j of its top-k,
//   y_t = sum_j w_tj * down[e_tj] . (silu(gate[e_tj] . x_t) * (up[e_tj] . x_t))
// with JAX's rounding: a dequantized weight is bf16(f32(q) * scale), the
// gate and up outputs are bf16 before the activation, silu and the product
// round to bf16 (as torch's ops on bf16 do), each pair's down output rounds
// to bf16, and the combine sums the k slots in f32 in slot order with each
// affinity rounded to bf16 first. Every sum is f32.
//
// Written as torch ops, `_selective` gathers each token's k expert slices:
// at Mixtral-8x7B width and 8 decode slots, 16 pairs x 3 x 4096 x 14336 x 2 B
// = 5.6 GB a layer, twice the layer's experts. What bounds the product on
// an H100 is bytes: every expert that some pair routes to must be read once
// (3 x 4096 x 14336 weights, 2 B each in bf16, 1 B with scales in int8 or
// fp8); 2 x 3 x H x I operations a pair are few for that many bytes.
//
// The design (simple and right first; wgmma and TMA are later work): a
// block per (expert, tile of output rows) of one weight stack. The block
// lists, in pair order, the (token, slot) pairs routed to its expert; a
// block whose expert no pair touches returns before it reads a weight, so
// an untouched expert is not read, and a touched one is read once (each of
// its rows by one block). The pairs' input vectors are staged in shared
// memory 1024 columns at a time; each warp streams its rows with 16-byte
// loads, dequantizes in registers, and keeps an f32 sum per (row, matrix,
// pair); the warp's lanes are summed by shuffles in a fixed order. Three
// launches: (1) gate and up with the SwiGLU epilogue into a (pairs, I) bf16
// scratch, (2) down into a (pairs, H) bf16 scratch, (3) the combine of each
// token's k pairs in slot order. No atomics: the result is the same bits at
// every run, as the serving engine's captured = eager streams need.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 1024;      // input columns staged in shared memory at a time
constexpr int MAX_PAIRS = 256;   // (token, slot) pairs a call

enum { FMT_BF16 = 0, FMT_INT8 = 1, FMT_FP8 = 2 };

template <int FMT>
struct Fmt {
  static constexpr int EPL = FMT == FMT_BF16 ? 8 : 16;  // weights a 16-byte load
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A 16-byte load of weights as f32 values: bf16 as they are, a code as
// bf16(f32(code) * scale), the dequantized weight JAX hands its einsum.
template <int FMT>
__device__ __forceinline__ void dequant(const uint4& raw, float scale, float* w) {
  if constexpr (FMT == FMT_BF16) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float c;
      if constexpr (FMT == FMT_FP8)
        c = __half2float(__half(__nv_cvt_fp8_to_halfraw(b[i], __NV_E4M3)));
      else
        c = static_cast<float>(static_cast<int8_t>(b[i]));
      w[i] = bf16r(__fmul_rn(c, scale));
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[p, r] for every pair p routed to expert blockIdx.y and every row r of
// this block's tile: MATS == 2 -> bf16(bf16(silu(bf16(g))) * bf16(u)) with
// g, u the pair's input . gate[e, r] and . up[e, r]; MATS == 1 -> bf16(the
// input . w0[e, r]). The input of pair p is row p / in_div of `in` (C
// columns, bf16): the token's x for gate and up (in_div = k), the pair's own
// activation for down (in_div = 1). Up to MAXP pairs share one pass over the
// weights; more (duplicate routes) take further passes.
template <int FMT, int MATS, int MAXP, int RW>
__global__ void __launch_bounds__(THREADS) routed_rows_kernel(
    const __nv_bfloat16* __restrict__ in, int in_div, const int* __restrict__ pair_expert,
    int n_all, const void* __restrict__ w0, const void* __restrict__ w1,
    const float* __restrict__ s0, const float* __restrict__ s1, int R, int C,
    __nv_bfloat16* __restrict__ out) {
  constexpr int EPL = Fmt<FMT>::EPL;
  constexpr int ITERS = CHUNK / (32 * EPL);
  constexpr int WBYTES = FMT == FMT_BF16 ? 2 : 1;
  __shared__ __align__(16) __nv_bfloat16 v[MAXP * CHUNK];
  __shared__ int pairs[MAX_PAIRS];
  __shared__ int n_pairs;
  const int e = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int p = 0; p < n_all; ++p)
      if (pair_expert[p] == e) pairs[n++] = p;
    n_pairs = n;
  }
  __syncthreads();
  const int n = n_pairs;
  if (n == 0) return;  // an expert no pair routes to is not read
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * (WARPS * RW) + warp * RW;
  const unsigned char* wb[2] = {static_cast<const unsigned char*>(w0),
                                static_cast<const unsigned char*>(w1)};
  const float* sp[2] = {s0, s1};

  float scale[RW][MATS];
#pragma unroll
  for (int rw = 0; rw < RW; ++rw)
#pragma unroll
    for (int m = 0; m < MATS; ++m)
      scale[rw][m] = (FMT != FMT_BF16 && row0 + rw < R) ? sp[m][(size_t)e * R + row0 + rw] : 1.f;

  for (int g0 = 0; g0 < n; g0 += MAXP) {
    const int ng = min(MAXP, n - g0);
    float acc[RW][MATS][MAXP];
#pragma unroll
    for (int rw = 0; rw < RW; ++rw)
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int p = 0; p < MAXP; ++p) acc[rw][m][p] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CHUNK) {
      const int cw = min(CHUNK, C - c0);
      const int vec_row = cw / 8;
      __syncthreads();  // the previous chunk's readers are done with v
      for (int i = threadIdx.x; i < ng * vec_row; i += THREADS) {
        const int p = i / vec_row, cv = i - p * vec_row;
        const size_t src_row = (size_t)(pairs[g0 + p] / in_div);
        reinterpret_cast<uint4*>(v + p * CHUNK)[cv] =
            reinterpret_cast<const uint4*>(in + src_row * C + c0)[cv];
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int col = (it * 32 + lane) * EPL;
        if (col >= cw) continue;
        uint4 raw[RW][MATS];
#pragma unroll
        for (int rw = 0; rw < RW; ++rw)
#pragma unroll
          for (int m = 0; m < MATS; ++m) {
            raw[rw][m] = make_uint4(0, 0, 0, 0);
            if (row0 + rw < R)
              raw[rw][m] = __ldg(reinterpret_cast<const uint4*>(
                  wb[m] + (((size_t)e * R + row0 + rw) * C + c0 + col) * WBYTES));
          }
#pragma unroll
        for (int rw = 0; rw < RW; ++rw)
#pragma unroll
          for (int m = 0; m < MATS; ++m) {
            float w[EPL];
            dequant<FMT>(raw[rw][m], scale[rw][m], w);
#pragma unroll
            for (int p = 0; p < MAXP; ++p) {
              if (p < ng) {
                const uint4* xs = reinterpret_cast<const uint4*>(v + p * CHUNK + col);
                float a = acc[rw][m][p];
#pragma unroll
                for (int q = 0; q < EPL / 8; ++q) {
                  const uint4 xr = xs[q];
                  const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const float2 xf = __bfloat1622float2(xb[i]);
                    a = fmaf(w[8 * q + 2 * i], xf.x, a);
                    a = fmaf(w[8 * q + 2 * i + 1], xf.y, a);
                  }
                }
                acc[rw][m][p] = a;
              }
            }
          }
      }
    }

#pragma unroll
    for (int rw = 0; rw < RW; ++rw) {
      const int r = row0 + rw;
#pragma unroll
      for (int p = 0; p < MAXP; ++p) {
        const float a0 = warp_sum(acc[rw][0][p]);
        const float a1 = MATS == 2 ? warp_sum(acc[rw][MATS - 1][p]) : 0.f;
        if (lane == 0 && p < ng && r < R) {
          float o;
          if constexpr (MATS == 2) {
            const float g = bf16r(a0), u = bf16r(a1);
            const float s = bf16r(g / (1.f + expf(-g)));
            o = s * u;
          } else {
            o = a0;
          }
          out[(size_t)pairs[g0 + p] * R + r] = __float2bfloat16_rn(o);
        }
      }
    }
  }
}

// out[t, c] = bf16(sum_j bf16(w[t, j]) * y[t * k + j, c]), the slots summed
// in order in f32: a thread a token's 8 columns.
__global__ void __launch_bounds__(THREADS) moe_combine_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ top_w, long long T, int k,
    int H, __nv_bfloat16* __restrict__ out) {
  const long long vecs = H / 8;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= T * vecs) return;
  const long long t = i / vecs, c = (i - t * vecs) * 8;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const float w = bf16r(top_w[t * k + j]);
    const uint4 raw = *reinterpret_cast<const uint4*>(y + (t * k + j) * H + c);
    const __nv_bfloat162* yb = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(yb[q]);
      acc[2 * q] = fmaf(w, f.x, acc[2 * q]);
      acc[2 * q + 1] = fmaf(w, f.y, acc[2 * q + 1]);
    }
  }
  uint4 o;
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int q = 0; q < 4; ++q) ob[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
  *reinterpret_cast<uint4*>(out + t * H + c) = o;
}

// the rows a warp keeps sums for: at most 32 f32 sums a lane
constexpr int rows_a_warp(int mats, int maxp) {
  return 32 / (mats * maxp) >= 4 ? 4 : (32 / (mats * maxp) >= 1 ? 32 / (mats * maxp) : 1);
}

template <int FMT, int MATS, int MAXP>
void launch_rows(const __nv_bfloat16* in, int in_div, const int* pe, int n_all, const void* w0,
                 const void* w1, const float* s0, const float* s1, int E, int R, int C,
                 __nv_bfloat16* out, cudaStream_t st) {
  constexpr int RW = rows_a_warp(MATS, MAXP);
  const dim3 grid((R + WARPS * RW - 1) / (WARPS * RW), E);
  routed_rows_kernel<FMT, MATS, MAXP, RW><<<grid, THREADS, 0, st>>>(
      in, in_div, pe, n_all, w0, w1, s0, s1, R, C, out);
}

template <int FMT, int MAXP>
void launch_all(const __nv_bfloat16* x, const int* pe, const float* top_w, const void* gate,
                const void* up, const void* down, const float* gs, const float* us,
                const float* ds, __nv_bfloat16* act, __nv_bfloat16* y, __nv_bfloat16* out,
                long long T, int k, int E, int H, int I, cudaStream_t st) {
  const int n_all = (int)(T * k);
  launch_rows<FMT, 2, MAXP>(x, k, pe, n_all, gate, up, gs, us, E, I, H, act, st);
  launch_rows<FMT, 1, MAXP>(act, 1, pe, n_all, down, nullptr, ds, nullptr, E, H, I, y, st);
  const long long threads = T * (H / 8);
  moe_combine_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      y, top_w, T, k, H, out);
}

// One pair a pass for a single token, else up to 8 pairs of an expert share
// a pass over its weights (a token routes to an expert at most once under
// top-k: more than 8 pairs of one expert take further passes).
template <int FMT>
void launch_fmt(const __nv_bfloat16* x, const int* pe, const float* top_w, const void* gate,
                const void* up, const void* down, const float* gs, const float* us,
                const float* ds, __nv_bfloat16* act, __nv_bfloat16* y, __nv_bfloat16* out,
                long long T, int k, int E, int H, int I, cudaStream_t st) {
  if (T <= 1)
    launch_all<FMT, 1>(x, pe, top_w, gate, up, down, gs, us, ds, act, y, out, T, k, E, H, I, st);
  else
    launch_all<FMT, 8>(x, pe, top_w, gate, up, down, gs, us, ds, act, y, out, T, k, E, H, I, st);
}

}  // namespace

// x (T, H) bf16; pair_expert (T * k,) int32, the expert of pair t * k + j;
// top_w (T * k,) f32; gate, up (E, I, H) and down (E, H, I), contiguous and
// 16-byte aligned, bf16 (fmt 0), int8 (1) or fp8 e4m3 (2) codes with f32
// scales gate_s, up_s (E, I) and down_s (E, H) (ignored for bf16); act (T *
// k, I) and y (T * k, H) bf16 scratch; out (T, H) bf16. H and I multiples of
// 16, T * k <= 256. Returns cudaGetLastError() after the launches.
extern "C" int nxd_moe_experts_fwd(const void* x, const void* pair_expert, const void* top_w,
                                   const void* gate, const void* up, const void* down,
                                   const void* gate_s, const void* up_s, const void* down_s,
                                   void* act, void* y, void* out, long long T, int k, int E,
                                   int H, int I, int fmt, void* stream) {
  if (T == 0) return 0;
  if (T * k > MAX_PAIRS || H % 16 || I % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xv = static_cast<const __nv_bfloat16*>(x);
  const int* pe = static_cast<const int*>(pair_expert);
  const float* tw = static_cast<const float*>(top_w);
  const float *gs = static_cast<const float*>(gate_s), *us = static_cast<const float*>(up_s),
              *ds = static_cast<const float*>(down_s);
  __nv_bfloat16 *av = static_cast<__nv_bfloat16*>(act), *yv = static_cast<__nv_bfloat16*>(y),
                *ov = static_cast<__nv_bfloat16*>(out);
  if (fmt == FMT_BF16)
    launch_fmt<FMT_BF16>(xv, pe, tw, gate, up, down, gs, us, ds, av, yv, ov, T, k, E, H, I, st);
  else if (fmt == FMT_INT8)
    launch_fmt<FMT_INT8>(xv, pe, tw, gate, up, down, gs, us, ds, av, yv, ov, T, k, E, H, I, st);
  else
    launch_fmt<FMT_FP8>(xv, pe, tw, gate, up, down, gs, us, ds, av, yv, ov, T, k, E, H, I, st);
  return (int)cudaGetLastError();
}

extern "C" int nxd_moe_experts_max_pairs() { return MAX_PAIRS; }
