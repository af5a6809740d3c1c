// K5 hash64 and K6 sha256_blocks (see ops/sha256.py).  The compression
// itself is in sha256.cuh, shared with K18 (mesh_merkle.cu).
//
// K5 replaces consensus_specs_tpu/ops/sha256.py:104 _hash64_words (with
// :54 _compress): n independent 64-byte messages -> n SHA-256 digests,
// two compressions each, the second on the constant pad block.  K6
// replaces :141 sha256_blocks: sequential compression of pre-padded
// blocks, one message per thread.  Written from FIPS 180-4, not from the
// lax.scan form.
//
// Bound: 32-bit integer operations.  Per message K5 needs 2 x 64 rounds
// plus one 48-step message schedule (the pad block's schedule is the
// constant table SHA_PAD_KW, K[i] + W[i] folded together): 1,688 funnel
// shifts, shifts, LOP3s and PRMTs that only the integer ALU executes,
// plus 624 adds, against 96 bytes moved (64 in, 32 out).  At the card's
// integer rate that is several times the memory time, so the design
// keeps everything in registers and spends nothing on data movement:
// one thread per message, the 8 working variables and the 16-word
// schedule window in registers (the round loop is unrolled, so every
// window index is a constant), four 16-byte loads per row, big-endian
// words by __byte_perm, rotations by __funnelshift_r, and the digest
// byte-swapped back and stored as two 16-byte writes.
//
// K6 runs one message a thread through nb compressions.  The chain of a
// message's nb x 64 rounds is its floor (sha256_blocks_chain_ops), and
// one CTA of 256 threads at the test's 256 messages left 131 SMs idle and
// waited on each block's scalar loads after the previous compression.
// So a CTA is one warp (ceil(m / 32) CTAs: each warp alone on its SM at
// 256 messages, the card filled from 4,224), and each thread loads its
// next block's 16 words (four 16-byte loads) into registers before it
// compresses the current one, so that no load waits on a compression.
// (Staging a warp's blocks in shared memory by cp.async first was slower
// at every shape measured: PERF.md.)  Where the words do not start on 16
// bytes (a view into its storage), each 16-byte load becomes four 4-byte
// ones, chosen per launch on the host.  The rounds stay unrolled, the
// round constants as constant-bank operands.
//
// k_sha256_chain is a measurement aid and replaces no TPU program: one
// thread runs reps x 64 dependent rounds (kw = K[i], the feed-forward
// after every 64), so that CUDA events turn the chain floors of K5 and
// K6 from dependent instructions into time.
#include "sha256.cuh"

#define SHA_THREADS 256

__global__ void __launch_bounds__(SHA_THREADS)
k_hash64(const uint4* __restrict__ rows, uint4* __restrict__ out, int n) {
  const int i = blockIdx.x * SHA_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = rows[(size_t)i * 4 + q];
    w[4 * q + 0] = bswap32(v.x);
    w[4 * q + 1] = bswap32(v.y);
    w[4 * q + 2] = bswap32(v.z);
    w[4 * q + 3] = bswap32(v.w);
  }
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = c_H0[k];
  compress(st, w);
  compress_pad64(st);
  out[(size_t)i * 2 + 0] = make_uint4(bswap32(st[0]), bswap32(st[1]),
                                      bswap32(st[2]), bswap32(st[3]));
  out[(size_t)i * 2 + 1] = make_uint4(bswap32(st[4]), bswap32(st[5]),
                                      bswap32(st[6]), bswap32(st[7]));
}

#define K6_WARP 32          // one warp a CTA

__device__ __forceinline__ void unpack4(uint32_t* w, uint4 v) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// 16 bytes of words at p: one 16-byte load, or four 4-byte loads where the
// words do not start on 16 bytes
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint32_t* p) {
  if (VEC) return __ldg((const uint4*)p);
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Words arrive as host-order values (the JAX program's uint32 lanes).
// The next block's words are in flight while the current one is
// compressed.
template <bool VEC>
__global__ void __launch_bounds__(K6_WARP)
k_sha256_blocks(const uint32_t* __restrict__ words, uint4* __restrict__ out, int m, int nb) {
  const int i = blockIdx.x * K6_WARP + threadIdx.x;
  if (i >= m) return;
  const uint32_t* src = words + (size_t)i * nb * 16;
  uint4 next[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) next[k] = load16<VEC>(src + 4 * k);
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = c_H0[k];
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) unpack4(w + 4 * k, next[k]);
    if (blk + 1 < nb) {
#pragma unroll
      for (int k = 0; k < 4; ++k) next[k] = load16<VEC>(src + (blk + 1) * 16 + 4 * k);
    }
    compress(st, w);
  }
  out[2 * i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

__global__ void __launch_bounds__(32) k_sha256_chain(uint32_t* __restrict__ out, int reps) {
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = c_H0[k];
  for (int r = 0; r < reps; ++r) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int i = 0; i < 64; ++i) SHA_ROUND(a, b, c, d, e, f, g, h, c_K[i]);
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = st[k];
}

extern "C" int hash64(const void* rows, void* out, int n, void* stream) {
  int nblk = (n + SHA_THREADS - 1) / SHA_THREADS;
  k_hash64<<<nblk, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (uint4*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int sha256_blocks(const void* words, void* out, int m, int nb, void* stream) {
  const int ctas = (m + K6_WARP - 1) / K6_WARP;
  const uint32_t* w = (const uint32_t*)words;
  if (((uintptr_t)words & 15) == 0)
    k_sha256_blocks<true><<<ctas, K6_WARP, 0, (cudaStream_t)stream>>>(w, (uint4*)out, m, nb);
  else
    k_sha256_blocks<false><<<ctas, K6_WARP, 0, (cudaStream_t)stream>>>(w, (uint4*)out, m, nb);
  return (int)cudaGetLastError();
}

extern "C" int sha256_chain(void* out, int reps, void* stream) {
  k_sha256_chain<<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)out, reps);
  return (int)cudaGetLastError();
}
