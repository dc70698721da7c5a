// Per-page KV pool fingerprints for Hopper (sm_90a): PF.
//
// It computes what the JAX package's serving engine runs to validate a
// paged prefix hit: `pool_pages_fingerprint` (neuronx_distributed_tpu/
// utils/fingerprint.py:158), which XLA fuses into one jitted program
// (serving/engine.py:3026); there is no pallas_call to port. The plain
// version (`kernels/page_fingerprint.py pool_pages_fingerprint_plain`) is
// the same arithmetic in int64 torch ops, several passes a leaf.
//
// For page id n and one page-carrying leaf of one layer, the page's
// elements x_i (i its position in the page flattened as (page_size, Hkv,
// D)) reduce to the wrapping uint32 sum of bits(x_i) * ((i << 1) | 1),
// bits the element's pattern zero-extended (bf16 16 bits, int8 8, f32 32).
// A page's leaves then combine, from SEED, as total = total * PRIME +
// leaf_fp, walking the layers in the order given (the JAX package's sorted
// `layers_<i>` keys) and the leaves in the order given (K, K scale, V, V
// scale). Sums mod 2^32 do not depend on their order, so this equals the
// plain version bit for bit.
//
// What bounds it on an H100: bytes. A Llama-3-8B page of 16 tokens is 32
// layers x K and V x 16 x 8 x 128 bf16 = 2 MiB, so a 100-page prefix hit
// reads 200 MiB: 63 us at 3.35 TB/s, and each element costs two integer
// operations. Design:
//  1. one block a (page, layer, leaf): 256 threads walk the page's bytes in
//     16-byte vector loads (a 32 KiB bf16 page is 2048 loads, 8 a thread),
//     unpack the elements in registers and sum, then a warp-shuffle and a
//     shared-memory reduction; the block writes its uint32 to a scratch
//     (N, L, leaves) array. A slice whose bytes or address are not 16-byte
//     multiples (a scale page of another head count) takes a scalar loop.
//  2. one thread a page combines its L x leaves values in order and
//     writes the fingerprint, zero-extended to int64.
// The page ids and the layer order are device arrays: nothing is read on
// the host, so the wrapper's caller reads the result when it chooses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 128;
constexpr unsigned SEED = 0x9E3779B9u;
constexpr unsigned PRIME = 0x01000193u;

struct Leaf {
  const uint8_t* base;
  long long layer_stride;  // bytes between layers
  long long page_stride;   // bytes between pages
  int n_elem;              // elements in one page of the leaf
  int esize;               // bytes an element: 1, 2 or 4
};

struct Params {
  Leaf leaf[4];
  int n_leaves;
  const long long* page_ids;  // (N,)
  int N, L;
  const int* order;           // (L,) layer order of the combine
  unsigned* partial;          // (N, L, n_leaves)
  long long* out;             // (N,)
};

__device__ __forceinline__ unsigned word_sum(unsigned w, unsigned e0, int esize) {
  // the elements packed in one little-endian 32-bit word, e0 the position
  // of its lowest element
  if (esize == 4) return w * ((e0 << 1) | 1u);
  if (esize == 2) return (w & 0xFFFFu) * ((e0 << 1) | 1u) + (w >> 16) * (((e0 + 1) << 1) | 1u);
  unsigned s = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s += ((w >> (8 * b)) & 0xFFu) * (((e0 + b) << 1) | 1u);
  return s;
}

__device__ __forceinline__ unsigned load_bits(const uint8_t* p, int esize) {
  if (esize == 4) return *reinterpret_cast<const unsigned*>(p);
  if (esize == 2) return *reinterpret_cast<const unsigned short*>(p);
  return *p;
}

__global__ void __launch_bounds__(THREADS) page_leaf_kernel(Params p) {
  const int n = blockIdx.x, layer = blockIdx.y, j = blockIdx.z;
  // a constant index per branch keeps the leaf in the parameter bank
  const Leaf lf = j == 0 ? p.leaf[0] : j == 1 ? p.leaf[1] : j == 2 ? p.leaf[2] : p.leaf[3];
  const long long pid = p.page_ids[n];
  const uint8_t* page = lf.base + layer * lf.layer_stride + pid * lf.page_stride;
  const long long nbytes = (long long)lf.n_elem * lf.esize;
  unsigned acc = 0;
  if ((nbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(page) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(page);
    const int per_vec = 16 / lf.esize;  // elements a 16-byte load holds
    const int per_word = 4 / lf.esize;
    const long long nvec = nbytes >> 4;
    for (long long c = threadIdx.x; c < nvec; c += THREADS) {
      const uint4 q = __ldg(v + c);
      const unsigned e0 = (unsigned)(c * per_vec);
      acc += word_sum(q.x, e0, lf.esize);
      acc += word_sum(q.y, e0 + per_word, lf.esize);
      acc += word_sum(q.z, e0 + 2 * per_word, lf.esize);
      acc += word_sum(q.w, e0 + 3 * per_word, lf.esize);
    }
  } else {
    for (int e = threadIdx.x; e < lf.n_elem; e += THREADS)
      acc += load_bits(page + (long long)e * lf.esize, lf.esize) * (((unsigned)e << 1) | 1u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ unsigned warp_sums[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    p.partial[((long long)n * p.L + layer) * p.n_leaves + j] = total;
  }
}

__global__ void combine_kernel(Params p) {
  const int n = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (n >= p.N) return;
  const unsigned* row = p.partial + (long long)n * p.L * p.n_leaves;
  unsigned total = SEED;
  for (int t = 0; t < p.L; ++t) {
    const unsigned* vals = row + (long long)p.order[t] * p.n_leaves;
    for (int j = 0; j < p.n_leaves; ++j) total = total * PRIME + vals[j];
  }
  p.out[n] = (long long)total;
}

}  // namespace

// meta: for each of 4 leaves (layer stride bytes, page stride bytes,
// elements a page, bytes an element); leaves past n_leaves are ignored.
extern "C" int nxd_page_fingerprint_fwd(const void* l0, const void* l1, const void* l2,
                                        const void* l3, const long long* meta,
                                        const void* page_ids, const void* order, void* partial,
                                        void* out, int n_leaves, int N, int L, void* stream) {
  Params p = {};
  const void* bases[4] = {l0, l1, l2, l3};
  for (int j = 0; j < n_leaves; ++j)
    p.leaf[j] = {static_cast<const uint8_t*>(bases[j]), meta[4 * j], meta[4 * j + 1],
                 (int)meta[4 * j + 2], (int)meta[4 * j + 3]};
  p.n_leaves = n_leaves;
  p.page_ids = static_cast<const long long*>(page_ids);
  p.N = N; p.L = L;
  p.order = static_cast<const int*>(order);
  p.partial = static_cast<unsigned*>(partial);
  p.out = static_cast<long long*>(out);
  if (N == 0 || L == 0 || n_leaves == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  page_leaf_kernel<<<dim3((unsigned)N, (unsigned)L, (unsigned)n_leaves), THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(unsigned)((N + COMBINE_THREADS - 1) / COMBINE_THREADS), COMBINE_THREADS, 0,
                   s>>>(p);
  return (int)cudaGetLastError();
}
