// K5 hash64 and K6 sha256_blocks (see ops/sha256.py).
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
#include <cuda_runtime.h>
#include <stdint.h>
#include "sha256_constants.cuh"

#define SHA_THREADS 256

__constant__ uint32_t c_K[64] = SHA_K;
__constant__ uint32_t c_H0[8] = SHA_H0;
__constant__ uint32_t c_PAD_KW[64] = SHA_PAD_KW;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One round; kw is K[i] + W[i].
#define SHA_ROUND(a, b, c, d, e, f, g, h, kw)                                \
  do {                                                                       \
    uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25))               \
                  + ((e & f) ^ (~e & g)) + (kw);                             \
    uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22))                   \
                  + ((a & b) ^ (a & c) ^ (b & c));                           \
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;       \
  } while (0)

// Compress one message block w (16 big-endian words, overwritten by the
// schedule) into st.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    SHA_ROUND(a, b, c, d, e, f, g, h, c_K[i] + wi);
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Compress the constant pad block of a 64-byte message into st.
__device__ __forceinline__ void compress_pad64(uint32_t st[8]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) SHA_ROUND(a, b, c, d, e, f, g, h, c_PAD_KW[i]);
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

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

// Words arrive as host-order values (the JAX program's uint32 lanes).
__global__ void __launch_bounds__(SHA_THREADS)
k_sha256_blocks(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                int m, int nb) {
  const int i = blockIdx.x * SHA_THREADS + threadIdx.x;
  if (i >= m) return;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = c_H0[k];
  const uint32_t* src = words + (size_t)i * nb * 16;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = src[blk * 16 + k];
    compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[(size_t)i * 8 + k] = st[k];
}

extern "C" int hash64(const void* rows, void* out, int n, void* stream) {
  int nblk = (n + SHA_THREADS - 1) / SHA_THREADS;
  k_hash64<<<nblk, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (uint4*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int sha256_blocks(const void* words, void* out, int m, int nb,
                             void* stream) {
  int nblk = (m + SHA_THREADS - 1) / SHA_THREADS;
  k_sha256_blocks<<<nblk, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)out, m, nb);
  return (int)cudaGetLastError();
}
