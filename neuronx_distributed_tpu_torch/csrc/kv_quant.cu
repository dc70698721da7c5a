// The int8 page pool's write for Hopper (sm_90a): QW.
//
// It computes what the JAX package runs when a decode chunk writes into a
// quantized pool: `scatter_cache_window` (neuronx_distributed_tpu/modules/
// attention.py:544) re-quantizes every page of the chunk's write window
// with `quantize_page_block` (neuronx_distributed_tpu/kernels/
// flash_decode.py:187), elementwise code XLA fuses into the donated chunk.
// The port writes the window at every decode step and prefill
// (`PagedKVCache.decode_write`), one launch a layer for K and V together;
// the plain version (`kernels/kv_quant.py window_requantize_plain`) is the
// same arithmetic as torch ops, five passes a leaf.
//
// One block takes one (row b, window page j, kv-head h, leaf) and:
//  1. reads the page's page_size x D codes and its bf16 scale,
//  2. dequantizes each element as bf16_rn(float(q) * float(scale)),
//  3. puts in the rows of x whose window columns fall in page j (window
//     column w0 + t is x's token t),
//  4. takes amax |.| in f32 over (page_size, D),
//  5. scale' = bf16_rn(fmaxf(amax, 1e-12) / 127),
//  6. codes = clamp(rint(value / float(scale')), -127, 127) (`rintf` rounds
//     half to even, as `torch.round`; both divisions correctly rounded),
//  7. writes the codes and scale'.
// So it equals the plain version bit for bit on every page but the null
// page 0, which rows whose window runs past their table share: both write
// it in any order, and nothing reads it.
//
// What bounds it on an H100: bytes. A page's codes are written once and
// read once in the rows x does not replace, its scale read and written
// once, and the x rows read once: at Llama-3-8B decode (16 rows, one page
// a row and kv-head) about 1.1 MB a layer for K and V, 0.3 us at 3.35
// TB/s, so a launch costs more than its traffic. The design keeps each
// page's values in shared memory between the two passes (page_size x D
// bf16, 4 KB at page_size 16), each thread moving 16 codes (16 bytes) at a
// time, and needs no host value: the pages and w0 are device tensors, so a
// captured decode step replays it at every cursor.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int D = 128;             // head dim (every Llama preset)
constexpr int VEC = 16;            // elements a thread moves at a time
constexpr int ROW_VECS = D / VEC;  // 16-element pieces of a page row
constexpr float QMAX = 127.f;

// One pool leaf: int8 pages (P, page_size, Hkv, D) with strides (sp, sr,
// sh), bf16 scales (P, 1, Hkv, 1) with page and kv-head strides (ssp, ssh),
// and the rows x (B, s, Hkv, D) bf16 with strides (sxb, sxs, sxh).
struct Leaf {
  int8_t* pool; bf16* scale; const bf16* x;
  long long sp, sr, sh, ssp, ssh, sxb, sxs, sxh;
};

struct Params {
  Leaf k, v;
  const long long* pages;  // (B, n_win) pool pages of the window, row stride spb
  const long long* w0;     // the window column of x's first token
  long long spb;
  int B, n_win, Hkv, s, ps;
};

__global__ void __launch_bounds__(THREADS) window_requantize_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* vals = reinterpret_cast<bf16*>(smem);  // [page_size][D]: the page's new values
  __shared__ float wmax[THREADS / 32];
  const int tid = threadIdx.x;
  int item = blockIdx.x;
  const int h = item % p.Hkv;
  item /= p.Hkv;
  const int j = item % p.n_win;
  item /= p.n_win;
  const int b = item % p.B;
  const Leaf L = item / p.B ? p.v : p.k;

  const long long page = p.pages[b * p.spb + j];
  const long long first = (long long)j * p.ps - *p.w0;  // x's token at the page's row 0
  int8_t* codes = L.pool + page * L.sp + h * L.sh;
  bf16* scale = L.scale + page * L.ssp + h * L.ssh;
  const float sc = __bfloat162float(*scale);

  // steps 1-4: the page's values, x's rows in place of the old ones
  float amax = 0.f;
  for (int i = tid; i < p.ps * ROW_VECS; i += THREADS) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
    const long long t = first + r;
    uint4 o[2];
    if (t >= 0 && t < p.s) {
      const uint4* src = reinterpret_cast<const uint4*>(L.x + b * L.sxb + t * L.sxs + h * L.sxh + c);
      o[0] = src[0];
      o[1] = src[1];
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(codes + r * L.sr + c);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
#pragma unroll
      for (int e = 0; e < VEC / 2; ++e)
        o2[e] = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn((float)q[2 * e], sc)),
                                   __float2bfloat16_rn(__fmul_rn((float)q[2 * e + 1], sc)));
    }
    const bf16* v = reinterpret_cast<const bf16*>(o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(__bfloat162float(v[e])));
    uint4* dst = reinterpret_cast<uint4*>(vals + r * D + c);
    dst[0] = o[0];
    dst[1] = o[1];
  }
#pragma unroll
  for (int x = 16; x; x >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, x));
  if ((tid & 31) == 0) wmax[tid >> 5] = amax;
  __syncthreads();  // the values and the warps' maxima; every old code is read
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);

  // steps 5-7
  const bf16 s_new = __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-12f), QMAX));
  const float sf = __bfloat162float(s_new);
  for (int i = tid; i < p.ps * ROW_VECS; i += THREADS) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
    const uint4* src = reinterpret_cast<const uint4*>(vals + r * D + c);
    uint4 in[2] = {src[0], src[1]};
    const bf16* v = reinterpret_cast<const bf16*>(in);
    uint4 out;
    int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      q[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(v[e]), sf)), -QMAX), QMAX);
    *reinterpret_cast<uint4*>(codes + r * L.sr + c) = out;
  }
  if (tid == 0) *scale = s_new;
}

}  // namespace

// Re-quantize the write window of both leaves of one layer of an int8
// pool: k_pool/v_pool int8, k_scale/v_scale bf16, xk/xv bf16 (B, s, Hkv,
// D), pages (B, n_win) int64, w0 one int64, all on the device. strides:
// pool (page, row, kv-head) of k then v, scale (page, kv-head) of k then
// v, x (b, token, kv-head) of k then v, then the pages' row stride (17
// values). Returns cudaGetLastError() after the launch.
extern "C" int nxd_window_requantize_fwd(void* k_pool, void* v_pool, void* k_scale,
                                         void* v_scale, const void* xk, const void* xv,
                                         const void* pages, const void* w0, int B, int n_win,
                                         int Hkv, int s, int ps, const long long* st,
                                         void* stream) {
  Params p = {};
  p.k = {static_cast<int8_t*>(k_pool), static_cast<bf16*>(k_scale), static_cast<const bf16*>(xk),
         st[0], st[1], st[2], st[6], st[7], st[10], st[11], st[12]};
  p.v = {static_cast<int8_t*>(v_pool), static_cast<bf16*>(v_scale), static_cast<const bf16*>(xv),
         st[3], st[4], st[5], st[8], st[9], st[13], st[14], st[15]};
  p.pages = static_cast<const long long*>(pages);
  p.w0 = static_cast<const long long*>(w0);
  p.spb = st[16];
  p.B = B; p.n_win = n_win; p.Hkv = Hkv; p.s = s; p.ps = ps;
  const long long blocks = 2LL * B * n_win * Hkv;
  if (blocks == 0) return 0;
  window_requantize_kernel<<<(unsigned)blocks, THREADS, ps * D * sizeof(bf16),
                             static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int nxd_window_requantize_head_dim() { return D; }
