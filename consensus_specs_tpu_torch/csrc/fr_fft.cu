// K9 fr_butterfly (see ops/fr_fft.py).
//
// Replaces ops/jax_bls/fr_fft.py:211 _butterfly with its stage loop
// :216 fft_batch (gather tables, the argsort reorder, one dispatch per
// stage).  One launch per radix-2 stage, one thread per butterfly, in
// place on a (rows, n, 8) word array held in bit-reversed order.  Each
// thread derives its pair and twiddle from the stage's half h alone:
// k -> group k / h, offset j = k % h, pair (2h (k / h) + j, + h),
// twiddle j * (n / 2h) of the domain's first n/2 roots, which the
// wrapper keeps on the card in Montgomery form.  The data stay canonical:
// mont_mul(b, w R) = b w, so no entry to or exit from Montgomery form is
// needed.  Bound: bytes (each stage reads and writes the whole array,
// 64 B per butterfly against one Fr product of 264 multiply-adds).
#include <cuda_runtime.h>
#include "fr.cuh"

#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS)
k_fr_butterfly(uint32_t* __restrict__ vals, const uint32_t* __restrict__ tw, int n,
               int half, long long total) {
  const long long t = (long long)blockIdx.x * K9_THREADS + threadIdx.x;
  if (t >= total) return;
  const int nh = n >> 1;
  const long long row = t / nh;
  const int k = (int)(t - row * nh);
  const int j = k & (half - 1);
  const int lo = ((k - j) << 1) + j;
  uint32_t* base = vals + row * (long long)n * RW;
  Fr a, b, w, s, d;
  fr_load(a, base + (size_t)lo * RW);
  fr_load(b, base + (size_t)(lo + half) * RW);
  fr_load(w, tw + (size_t)j * (nh / half) * RW);
  fr_mul(b, b, w);
  fr_add(s, a, b);
  fr_sub(d, a, b);
  fr_store(base + (size_t)lo * RW, s);
  fr_store(base + (size_t)(lo + half) * RW, d);
}

extern "C" int fr_butterfly(void* vals, const void* tw, int rows, int n, int half,
                            void* stream) {
  const long long total = (long long)rows * (n >> 1);
  const int blocks = (int)((total + K9_THREADS - 1) / K9_THREADS);
  k_fr_butterfly<<<blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)vals, (const uint32_t*)tw, n, half, total);
  return (int)cudaGetLastError();
}
