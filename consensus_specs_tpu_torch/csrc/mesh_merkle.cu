// K18 merkle_levels (see parallel/mesh_merkle.py, which holds its wrapper
// and plain version).
//
// Replaces consensus_specs_tpu/parallel/mesh_merkle.py:62 _program: per
// power-of-two span of leaf chunks, local_depth levels of 64-byte
// SHA-256 (ops/sha256.py:54 _compress twice per pair: the message block,
// then the pad block), every level returned.  The compression is K5's
// (sha256.cuh).
//
// Bound: 32-bit integer operations, as K5 (1,688 integer-ALU
// instructions per node against 96 bytes moved), and below that the
// chain: a span's depth in dependent hashes.  Design: one launch a tree,
// in tiers (mesh_merkle.tiers, packed into `plan`).  A CTA of T threads
// takes a tier's input nodes (at most 2T), each thread hashing one pair,
// then folds the next levels out of shared memory with half the threads
// each, every level written once.  The first tier's CTAs cover the
// leaves; a later tier's CTA is the last of its group of sibling CTAs to
// finish (an arrival counter per group, released and acquired; the
// siblings' nodes read with __ldcg), so no CTA waits on another and the tree's top
// needs no second launch.  The last tier ends at each span's root (a CTA
// never crosses a span: the spans are aligned power-of-two subtrees).
// The counters (one per CTA of every tier after the first) are zero
// before a launch and after it: each group's last CTA resets its own, so
// the wrapper zeroes a buffer once and keeps it.
#include "sha256.cuh"

#define MERKLE_MAX_THREADS 512
#define MERKLE_MIN_BLOCKS 2      // CTAs of MERKLE_MAX_THREADS resident on an SM

// a node's 64-byte pair (four 16-byte words) -> 16 big-endian words
template <bool L2>
__device__ __forceinline__ void pair_words(const uint4* src, uint32_t w[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = L2 ? __ldcg(src + q) : src[q];
    w[4 * q + 0] = bswap32(v.x);
    w[4 * q + 1] = bswap32(v.y);
    w[4 * q + 2] = bswap32(v.z);
    w[4 * q + 3] = bswap32(v.w);
  }
}

__device__ __forceinline__ void store_node(uint4* dst, const uint32_t st[8]) {
  dst[0] = make_uint4(bswap32(st[0]), bswap32(st[1]), bswap32(st[2]), bswap32(st[3]));
  dst[1] = make_uint4(bswap32(st[4]), bswap32(st[5]), bswap32(st[6]), bswap32(st[7]));
}

// One CTA's arrival on its group's counter (by its thread 0, after a
// barrier): a release of the CTA's nodes and an acquire of the siblings'
// that arrived before (the barriers around it carry both to the CTA's
// other threads, as in CUTLASS's semaphores), lighter than
// __threadfence's sequentially consistent fence.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// in: the leaf level (in_nodes chunks, at most 2^30); out: level 1, then
// level 2, ..., up to the spans' roots, each level's nodes in order;
// arrived: the later tiers' counters, zero (each group's last CTA sets its
// counter back to zero, so they stay zero between launches); plan: a byte
// a tier, first tier lowest, each the levels it folds (low 4 bits) and
// log2 of a CTA's input nodes (high 4 bits), 0 after the last.  Shared
// memory: two buffers of T digests as state words (a digest's words are
// the next level's message words), two 16-byte words a digest.
__global__ void __launch_bounds__(MERKLE_MAX_THREADS, MERKLE_MIN_BLOCKS)
k_merkle_tree(const uint4* __restrict__ in, uint4* __restrict__ out,
              int* __restrict__ arrived, int in_nodes, unsigned long long plan) {
  extern __shared__ uint4 sm[];
  __shared__ int last;
  const int T = blockDim.x, t = threadIdx.x;
  int g = blockIdx.x;                  // this CTA's place among its tier's CTAs
  int n = in_nodes;                    // nodes of the tier's input level (all spans)
  int off = 0;                         // where the level above it starts in out (nodes)
  uint32_t w[16], st[8];
  for (bool first = true;; first = false) {
    const int fold = (int)(plan & 15), width = 1 << ((plan >> 4) & 15);
    plan >>= 8;
    int at = off, nodes = n >> 1;      // the level written
    int active = width >> 1;
    if (t < active) {
      const int pair = g * width + 2 * t;
      if (first)
        pair_words<false>(in + 2 * (size_t)pair, w);
      else
        pair_words<true>(out + 2 * (size_t)(off - n + pair), w);   // written by the siblings
      hash64_words(st, w);
      store_node(out + 2 * (size_t)(at + g * active + t), st);
      sm[2 * t] = make_uint4(st[0], st[1], st[2], st[3]);
      sm[2 * t + 1] = make_uint4(st[4], st[5], st[6], st[7]);
    }
    for (int l = 1; l < fold; ++l) {
      __syncthreads();
      const uint4* from = sm + ((l - 1) & 1) * 2 * T;
      uint4* to = sm + (l & 1) * 2 * T;
      at += nodes;
      nodes >>= 1;
      active >>= 1;
      if (t < active) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 v = from[4 * t + q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
        hash64_words(st, w);
        store_node(out + 2 * (size_t)(at + g * active + t), st);
        to[2 * t] = make_uint4(st[0], st[1], st[2], st[3]);
        to[2 * t + 1] = make_uint4(st[4], st[5], st[6], st[7]);
      }
    }
    if (plan == 0) return;                                      // the spans' roots
    // arrive on the group's counter; the last sibling resets it and goes on up
    const int next = 1 << ((plan >> 4) & 15);
    const int group = next / active;
    __syncthreads();
    if (t == 0) {
      last = arrive(arrived + g / group) == group - 1;
      if (last) arrived[g / group] = 0;
    }
    __syncthreads();
    if (!last) return;
    arrived += nodes / next;                                    // the next tier's counters
    g /= group;
    n = nodes;
    off = at + nodes;
  }
}

// depth: levels above the leaf level (a span's depth), in_nodes a
// multiple of 2^depth, at most 2^30; threads a power of two up to
// MERKLE_MAX_THREADS, at least half of every tier's width; plan and
// arrived as above.
extern "C" int merkle_levels(const void* in, void* out, void* arrived, long long in_nodes,
                             int depth, int threads, unsigned long long plan, void* stream) {
  if (depth < 1 || depth > 30 || in_nodes < (1LL << depth) || in_nodes > (1LL << 30)
      || in_nodes % (1LL << depth) || threads < 1 || threads > MERKLE_MAX_THREADS
      || (threads & (threads - 1)))
    return cudaErrorInvalidValue;
  int levels = 0, outputs = 1;                 // nodes a CTA of the tier before leaves
  for (unsigned long long p = plan; p; p >>= 8) {
    const int fold = (int)(p & 15), log_width = (int)((p >> 4) & 15);
    if (fold < 1 || fold > log_width || (1LL << log_width) > 2LL * threads
        || (1 << log_width) < outputs)
      return cudaErrorInvalidValue;
    levels += fold;
    outputs = 1 << (log_width - fold);
  }
  if (levels != depth) return cudaErrorInvalidValue;
  const long long blocks = in_nodes >> ((plan >> 4) & 15);
  k_merkle_tree<<<(unsigned)blocks, threads, 2 * 2 * threads * sizeof(uint4),
                  (cudaStream_t)stream>>>((const uint4*)in, (uint4*)out, (int*)arrived,
                                          (int)in_nodes, plan);
  return (int)cudaGetLastError();
}
