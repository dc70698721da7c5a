// One fingerprint over a whole tensor tree for Hopper (sm_90a): TF.
//
// It computes what the JAX package runs to fingerprint a replica's weights
// for the router's cross-replica vote: `tree_fingerprint`
// (neuronx_distributed_tpu/utils/fingerprint.py:119), which XLA fuses into
// one jitted program (serving/engine.py:1865); there is no pallas_call to
// port. The plain version (`kernels/tree_fingerprint.py
// tree_fingerprint_plain`) is the same arithmetic in int64 torch ops, a
// chunk of a leaf at a time.
//
// For each leaf, its elements x_i (i the element's position in the leaf
// flattened in C order) reduce to the wrapping uint32 sum of
// bits(x_i) * ((i << 1) | 1), bits the element's pattern zero-extended
// (8-bit codes and fp8 8 bits, bf16 16, f32 32; a 64-bit element folds its
// high and low words with xor). The leaves then combine in the order given,
// from SEED, as total = total * PRIME + leaf_fp. Sums mod 2^32 do not depend
// on their order, so this equals the plain version bit for bit.
//
// What bounds it on an H100: bytes. Llama-3-8B's bf16 weights are 16.06 GB,
// 4.8 ms at 3.35 TB/s; its int8 engine's codes, scales, embedding and norms
// 8.56 GB, 2.6 ms. An element costs two or three integer operations, far
// under the card's integer rate. Design:
//  1. the tree is cut into work items of ITEM_BYTES of one leaf (the last
//     item of a leaf is shorter); a device table of (leaf, first element)
//     names each, and a table of (address, elements, element bytes, end
//     item) names each leaf. Both are built once by the caller, whose
//     tensors keep their addresses (the serving engine writes weights in
//     place). One block an item: 256 threads walk its bytes in 16-byte
//     loads, unpack the elements in registers and sum, then a warp shuffle
//     and a shared-memory sum; the block writes its uint32 to a scratch
//     (items,) array. An item whose address is not 16-byte aligned (a view
//     into a storage at an odd offset) takes a scalar loop.
//  2. one block of 1024 threads: each warp sums the items of its leaves
//     (lanes stride, a shuffle), then one thread folds the leaves in order
//     and writes the fingerprint, zero-extended to int64: a probe reads 8
//     bytes back.
// Element positions fit in 32 bits: the largest leaf the port serves
// (Llama-3-8B's embedding, 128256 x 4096 = 525,336,576 elements) keeps
// (i << 1) | 1 under 2^31; larger leaves wrap as the JAX uint32 arange does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 1024;
constexpr long long ITEM_BYTES = 1 << 20;
constexpr unsigned SEED = 0x9E3779B9u;
constexpr unsigned PRIME = 0x01000193u;

struct Leaf {
  long long base;     // the leaf's address
  long long n_elem;   // its elements
  long long esize;    // bytes an element: 1, 2, 4 or 8
  long long item_end; // one past its last work item
};

struct Item {
  long long leaf;
  long long e0;  // the item's first element
};

__device__ __forceinline__ unsigned weight(unsigned e) { return (e << 1) | 1u; }

__device__ __forceinline__ unsigned word_sum(unsigned w, unsigned e0, int esize) {
  // the elements packed in one little-endian 32-bit word (8-, 16- or 32-bit
  // elements), e0 the position of its lowest element
  if (esize == 4) return w * weight(e0);
  if (esize == 2) return (w & 0xFFFFu) * weight(e0) + (w >> 16) * weight(e0 + 1);
  unsigned s = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) s += ((w >> (8 * b)) & 0xFFu) * weight(e0 + b);
  return s;
}

__device__ __forceinline__ unsigned elem_bits(const uint8_t* p, int esize) {
  if (esize == 8) {
    const unsigned long long u = *reinterpret_cast<const unsigned long long*>(p);
    return (unsigned)(u >> 32) ^ (unsigned)u;
  }
  if (esize == 4) return *reinterpret_cast<const unsigned*>(p);
  if (esize == 2) return *reinterpret_cast<const unsigned short*>(p);
  return *p;
}

__global__ void __launch_bounds__(THREADS)
tree_items_kernel(const Leaf* __restrict__ leaves, const Item* __restrict__ items,
                  unsigned* __restrict__ partial) {
  const long long it = blockIdx.x;
  const Item item = items[it];
  const Leaf lf = leaves[item.leaf];
  const int esize = (int)lf.esize;
  const long long per_item = ITEM_BYTES / esize;
  const long long n = min(per_item, lf.n_elem - item.e0);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(lf.base) + item.e0 * esize;
  const unsigned e_first = (unsigned)item.e0;  // positions wrap mod 2^32, as the weights do
  unsigned acc = 0;
  long long done = 0;  // elements the vector loop covered
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    const long long nvec = (n * esize) >> 4;
    const int per_vec = 16 / esize;
    if (esize == 8) {
      for (long long c = threadIdx.x; c < nvec; c += THREADS) {
        const uint4 q = __ldg(v + c);
        const unsigned e0 = e_first + (unsigned)(c * 2);
        acc += (q.x ^ q.y) * weight(e0) + (q.z ^ q.w) * weight(e0 + 1);
      }
    } else {
      const int per_word = 4 / esize;
      for (long long c = threadIdx.x; c < nvec; c += THREADS) {
        const uint4 q = __ldg(v + c);
        const unsigned e0 = e_first + (unsigned)(c * per_vec);
        acc += word_sum(q.x, e0, esize);
        acc += word_sum(q.y, e0 + per_word, esize);
        acc += word_sum(q.z, e0 + 2 * per_word, esize);
        acc += word_sum(q.w, e0 + 3 * per_word, esize);
      }
    }
    done = nvec * per_vec;
  }
  for (long long e = done + threadIdx.x; e < n; e += THREADS)
    acc += elem_bits(p + e * esize, esize) * weight(e_first + (unsigned)e);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ unsigned warp_sums[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    partial[it] = total;
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS)
tree_combine_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                    const unsigned* __restrict__ partial, unsigned* __restrict__ leaf_fp,
                    long long* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < n_leaves; l += COMBINE_THREADS / 32) {
    const long long begin = l == 0 ? 0 : leaves[l - 1].item_end;
    const long long end = leaves[l].item_end;
    unsigned s = 0;
    for (long long i = begin + lane; i < end; i += 32) s += partial[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) leaf_fp[l] = s;
  }
  __syncthreads();  // the block's global writes are visible to its threads after this
  if (threadIdx.x == 0) {
    unsigned total = SEED;
    for (int l = 0; l < n_leaves; ++l) total = total * PRIME + leaf_fp[l];
    out[0] = (long long)total;
  }
}

}  // namespace

// leaves: (n_leaves, 4) int64 rows (address, elements, element bytes, end
// item); items: (n_items, 2) int64 rows (leaf, first element); partial:
// (n_items,) and leaf_fp: (n_leaves,) uint32 scratch; out: one int64.
extern "C" int nxd_tree_fingerprint_fwd(const void* leaves, const void* items, void* partial,
                                        void* leaf_fp, void* out, int n_leaves, long long n_items,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    tree_items_kernel<<<(unsigned)n_items, THREADS, 0, s>>>(
        static_cast<const Leaf*>(leaves), static_cast<const Item*>(items),
        static_cast<unsigned*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tree_combine_kernel<<<1, COMBINE_THREADS, 0, s>>>(
      static_cast<const Leaf*>(leaves), n_leaves, static_cast<const unsigned*>(partial),
      static_cast<unsigned*>(leaf_fp), static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" long long nxd_tree_fingerprint_item_bytes() { return ITEM_BYTES; }
