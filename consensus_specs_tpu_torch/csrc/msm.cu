// K7 expand_windows and K8 g1_msm (see ops/msm.py).
//
// K7 replaces ops/jax_bls/msm.py:38 _expand_windows (a lax.scan of 8
// complete additions P + P per window); K8 replaces msm.py:48 _msm_core
// (points.py:244 g1_scalar_mul over 8-bit digits, :252 g1_tree_sum,
// :306 g1_normalize) together with the host digit planes of :55
// _digits_msb_bits, which K8 reads straight from the scalar words.
//
// The MSM is digit-parallel, as in the JAX package: with the window
// multiples W[w][i] = [2^(8w)] P_i, sum_i [k_i] P_i = sum_{w,i}
// [d_{w,i}] W[w][i] for the 32 bytes d_{w,i} of k_i.  Bound: integer
// multiply-adds (Fq products at 588 each: a doubling 9, an addition 14),
// not bytes: a window entry is 144 B against ~100 Fq products of work.
// Design: K7 gives each point one thread that doubles it 8 times per
// window and writes the 32 projective multiples window-major,
// (32, N, 3, 12) words.  K8 gives each (window, point) lane one thread
// for its 8-step double-and-add, sums each block's lanes in a
// shared-memory tree into a partial, and a second, one-block launch sums
// the partials and normalizes, as K2 does.  No buckets: simple first.
#include <cuda_runtime.h>
#include "points.cuh"

#define N_WINDOWS 32
#define WINDOW_BITS 8
#define K7_THREADS 64
#define K8_THREADS 128

__global__ void __launch_bounds__(K7_THREADS)
k_expand_windows(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ inf,
                 uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * K7_THREADS + threadIdx.x;
  if (i >= n) return;
  Pt<Fq> p;
  if (inf[i]) {
    pt_identity(p);
  } else {
    g1_load_affine(p, pts + (size_t)i * 2 * NW);
  }
  for (int w = 0; w < N_WINDOWS; w++) {
    g1_store_proj(out + ((size_t)w * n + i) * 3 * NW, p);
    if (w + 1 < N_WINDOWS) {
      for (int b = 0; b < WINDOW_BITS; b++) pt_dbl(p, p);
    }
  }
}

// lane = w * n + i: [d] W[w][i] with d byte w of scalar i, MSB first from
// the digit's top set bit; each block's sum goes to partial[blockIdx.x]
__global__ void __launch_bounds__(K8_THREADS)
k_msm_lanes(const uint32_t* __restrict__ windows, const uint32_t* __restrict__ scalars,
            uint32_t* __restrict__ partial, int n) {
  __shared__ Pt<Fq> sh[K8_THREADS];
  const long long lane = (long long)blockIdx.x * K8_THREADS + threadIdx.x;
  Pt<Fq> acc;
  pt_identity(acc);
  if (lane < (long long)N_WINDOWS * n) {
    const int w = (int)(lane / n), i = (int)(lane % n);
    const uint32_t d = (scalars[(size_t)i * 8 + w / 4] >> (8 * (w % 4))) & 0xFFu;
    if (d) {
      Pt<Fq> base;
      g1_load_proj(base, windows + (size_t)lane * 3 * NW);
      int b = WINDOW_BITS - 1;
      while (!((d >> b) & 1u)) b--;
      acc = base;
      for (b--; b >= 0; b--) {
        pt_dbl(acc, acc);
        if ((d >> b) & 1u) pt_add(acc, acc, base);
      }
    }
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree_sum<Fq, K8_THREADS>(sh);
  if (threadIdx.x == 0) g1_store_proj(partial + (size_t)blockIdx.x * 3 * NW, sh[0]);
}

__global__ void __launch_bounds__(K8_THREADS)
k_msm_sum_normalize(const uint32_t* __restrict__ partial, int n_partial,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ out_inf) {
  __shared__ Pt<Fq> sh[K8_THREADS];
  Pt<Fq> acc, q;
  pt_identity(acc);
  for (int j = threadIdx.x; j < n_partial; j += K8_THREADS) {
    g1_load_proj(q, partial + (size_t)j * 3 * NW);
    pt_add(acc, acc, q);
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree_sum<Fq, K8_THREADS>(sh);
  if (threadIdx.x == 0) {
    Fq x, y;
    bool inf;
    pt_normalize(x, y, inf, sh[0]);
    fq_store(out, x);
    fq_store(out + NW, y);
    out_inf[0] = inf ? 1 : 0;
  }
}

extern "C" int expand_windows(const void* pts, const void* inf, void* out, int n,
                              void* stream) {
  k_expand_windows<<<(n + K7_THREADS - 1) / K7_THREADS, K7_THREADS, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)pts, (const uint8_t*)inf,
                                             (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int g1_msm(const void* windows, const void* scalars, void* partial, void* out,
                      void* out_inf, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(((long long)N_WINDOWS * n + K8_THREADS - 1) / K8_THREADS);
  k_msm_lanes<<<blocks, K8_THREADS, 0, s>>>((const uint32_t*)windows,
                                           (const uint32_t*)scalars, (uint32_t*)partial, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  k_msm_sum_normalize<<<1, K8_THREADS, 0, s>>>((const uint32_t*)partial, blocks,
                                              (uint32_t*)out, (uint8_t*)out_inf);
  return (int)cudaGetLastError();
}
