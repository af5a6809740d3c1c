// K1 g1_aggregate_scale and K2 g2_scale_sum (see ops/torch_bls/points.py).
//
// K1 replaces bls_jax.py:196 _j_tree_sum (points.py:256
// g1_tree_sum_batched), bls_jax.py:491 _j_g1_scale (points.py:244,140)
// and points.py:335 _j_g1_norm_post with the limbs.py:308 inverse.
// K2 replaces bls_jax.py:498 _j_g2_scale_sum (points.py:248,286),
// points.py:353 _j_g2_norm_post and tower.py:154,160 _j_f2_norm /
// _j_f2_inv_post.
//
// Bound: integer multiply-adds (a complete G1 add is 14 Fq products of
// 288 multiply-adds each).  The inputs are read once; the work per byte
// is in the thousands, so memory does not bound either kernel.  Design:
// K1 gives each row a block whose threads sum strided key subsets, then a
// shared-memory tree; the scale and the inversion are one thread's
// sequential work per row.  K2 gives each lane a one-thread block for its 128-step
// double-and-add, and a second, one-block launch sums the lane results
// (strided, then a shared-memory tree) and normalizes.
#include <cuda_runtime.h>
#include "points.cuh"

#define K1_THREADS 128
#define K2_THREADS 64

__global__ void __launch_bounds__(K1_THREADS)
k_g1_aggregate_scale(const uint32_t* __restrict__ pk, const int32_t* __restrict__ counts,
                     const uint32_t* __restrict__ scalars, uint32_t* __restrict__ out,
                     uint8_t* __restrict__ out_inf, int N) {
  __shared__ Pt<Fq> sh[K1_THREADS];
  const int row = blockIdx.x;
  const int cnt = counts[row];
  Pt<Fq> acc, q;
  pt_identity(acc);
  for (int j = threadIdx.x; j < cnt; j += K1_THREADS) {
    g1_load_affine(q, pk + ((size_t)row * N + j) * 2 * NW);
    pt_add(acc, acc, q);
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree_sum<Fq, K1_THREADS>(sh);
  if (threadIdx.x == 0) {
    Pt<Fq> total = sh[0];
    if (scalars != nullptr) pt_scalar_mul(total, total, scalars + (size_t)row * 4, 128);
    Fq x, y;
    bool inf;
    pt_normalize(x, y, inf, total);
    fq_store(out + (size_t)row * 2 * NW, x);
    fq_store(out + (size_t)row * 2 * NW + NW, y);
    out_inf[row] = inf ? 1 : 0;
  }
}

// one lane per block: the double-and-add branches on the lane's own bits,
// so lanes sharing a warp would serialize; spreading lanes over SMs also
// gives the latency-bound ladders the whole card
__global__ void __launch_bounds__(1)
k_g2_scale_lane(const uint32_t* __restrict__ sig, const uint8_t* __restrict__ sig_inf,
                const uint32_t* __restrict__ scalars, uint32_t* __restrict__ partial) {
  const int lane = blockIdx.x;
  Pt<Fq2> acc;
  pt_identity(acc);
  if (!sig_inf[lane]) {
    Pt<Fq2> p;
    g2_load_affine(p, sig + (size_t)lane * 4 * NW);
    pt_scalar_mul(acc, p, scalars + (size_t)lane * 4, 128);
  }
  uint32_t* dst = partial + (size_t)lane * 6 * NW;
  f2_store(dst, acc.x);
  f2_store(dst + 2 * NW, acc.y);
  f2_store(dst + 4 * NW, acc.z);
}

__global__ void __launch_bounds__(K2_THREADS)
k_g2_sum_normalize(const uint32_t* __restrict__ partial, int n, uint32_t* __restrict__ out,
                   uint8_t* __restrict__ out_inf) {
  __shared__ Pt<Fq2> sh[K2_THREADS];
  Pt<Fq2> acc, q;
  pt_identity(acc);
  for (int j = threadIdx.x; j < n; j += K2_THREADS) {
    const uint32_t* src = partial + (size_t)j * 6 * NW;
    f2_load(q.x, src);
    f2_load(q.y, src + 2 * NW);
    f2_load(q.z, src + 4 * NW);
    pt_add(acc, acc, q);
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree_sum<Fq2, K2_THREADS>(sh);
  if (threadIdx.x == 0) {
    Fq2 x, y;
    bool inf;
    pt_normalize(x, y, inf, sh[0]);
    f2_store(out, x);
    f2_store(out + 2 * NW, y);
    out_inf[0] = inf ? 1 : 0;
  }
}

extern "C" int g1_aggregate_scale(const void* pk, const void* counts, const void* scalars,
                                  void* out, void* out_inf, int B, int N, void* stream) {
  k_g1_aggregate_scale<<<B, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pk, (const int32_t*)counts, (const uint32_t*)scalars,
      (uint32_t*)out, (uint8_t*)out_inf, N);
  return (int)cudaGetLastError();
}

extern "C" int g2_scale_sum(const void* sig, const void* sig_inf, const void* scalars,
                            void* partial, void* out, void* out_inf, int B, void* stream) {
  k_g2_scale_lane<<<B, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sig, (const uint8_t*)sig_inf, (const uint32_t*)scalars,
      (uint32_t*)partial);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  k_g2_sum_normalize<<<1, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, B, (uint32_t*)out, (uint8_t*)out_inf);
  return (int)cudaGetLastError();
}
