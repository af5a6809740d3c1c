// K1 g1_aggregate_scale and K2 g2_scale_sum (see ops/torch_bls/points.py).
//
// K1 replaces bls_jax.py:196 _j_tree_sum (points.py:256
// g1_tree_sum_batched), bls_jax.py:491 _j_g1_scale (points.py:244,140)
// and points.py:335 _j_g1_norm_post with the limbs.py:308 inverse.
// K2 replaces bls_jax.py:498 _j_g2_scale_sum (points.py:248,286),
// points.py:353 _j_g2_norm_post and tower.py:154,160 _j_f2_norm /
// _j_f2_inv_post.
//
// Bound: integer multiply-adds (a complete G1 add is 12 Fq products of
// 588 multiply-adds each).  The inputs are read once; the work per byte
// is in the thousands, so memory does not bound either kernel.  K1 gives
// each row a block whose threads sum strided key subsets, then a
// shared-memory tree; the scale and the inversion are one thread's
// sequential work per row.
//
// K2 is latency-bound: at a block's ~131 lanes each lane's 128-bit
// double-and-add is a chain of ~190 G2 steps, and the card's rate is
// far from reached.  So each lane is one warp (a team) running every
// step laid out over its lanes (g2_team.cuh g2_step: a doubling or an
// addition is two waves of Fq products), its scalar's bits uniform across
// the team; 4-bit sliding windows over a table of P's odd multiples cut
// the ~64 additions of double-and-add to ~26 (and 8 to build it).  One
// launch: the lane partials are summed by a tree of team additions in
// the same kernel, a pair's second finisher adding the first's partial
// (an arrival counter per pair, so no block waits on another and no
// second launch waits for the slowest lane), and the block that ends
// with the root normalizes it with one binary-Euclid inversion.  No
// GLS split: the plain version computes [r]P for any curve point.
#include <cuda_runtime.h>
#include "points.cuh"
#include "g2_team.cuh"

#define K1_THREADS 128

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

// shared Fq slots of a K2 block: constants, the window table (the odd
// multiples P, 3P, ..., 15P), the running point, a sibling's partial, N(Z)
// and its inverse, the affine point, the steps' scratch (also the
// programs' temporaries); K2_WIN comes with the generated tables
// (team_programs.K2_WIN, which K2's chain floor reads too)
#define K2_TAB (1 << (K2_WIN - 1))
#define K2_TMP G2_MAX(G2_STEP_FQ, G2_MAX(PP_TMP_G2_NORM, PP_TMP_G2_AFFINE))
#define K2_FQ (G2_N_CONSTS + 6 * K2_TAB + 2 * 6 + 2 + 4 + K2_TMP)

DEV uint32_t scalar_bit(const uint32_t* k, int i) { return (k[i >> 5] >> (i & 31)) & 1u; }

__global__ void __launch_bounds__(G2_TEAM)
k_g2_scale_sum(const uint32_t* __restrict__ sig, const uint8_t* __restrict__ sig_inf,
               const uint32_t* __restrict__ scalars, uint32_t* __restrict__ partial,
               int32_t* __restrict__ arrived, uint32_t* __restrict__ out,
               uint8_t* __restrict__ out_inf, int B) {
  extern __shared__ Fq sm[];
  Fq *k = sm, *tab = k + G2_N_CONSTS, *acc = tab + 6 * K2_TAB, *c = acc + 6, *nz = c + 6,
     *aff = nz + 2, *tmp = aff + 4;
  const int lane = threadIdx.x;
  int idx = blockIdx.x;
  g2_load_consts(k, lane);
  if (lane < 4) fq_load(tab[lane], sig + ((size_t)idx * 4 + lane) * NW);
  if (lane == 4) fq_set(tab[4], FQ_ONE);
  if (lane == 5) fq_zero(tab[5]);
  const uint32_t* sc = scalars + (size_t)idx * 4;
  int top = sig_inf[idx] ? -1 : 127;                 // the scalar's leading bit
  while (top >= 0 && !scalar_bit(sc, top)) top--;
  if (lane < 6 && top < 0) {                         // r = 0 or P at infinity: the identity
    if (lane == 2) fq_set(acc[2], FQ_ONE); else fq_zero(acc[lane]);
  }
  __syncwarp();
  // [r]P by 4-bit sliding windows, MSB first, over the odd multiples
  if (top >= 0) {
    g2_dbl_step(c, tab, tmp);                        // 2P
    for (int j = 1; j < K2_TAB; j++) g2_add_step(tab + 6 * j, tab + 6 * (j - 1), c, tmp);
  }
  for (int i = top, first = 1; i >= 0;) {
    if (!scalar_bit(sc, i)) {
      g2_dbl_step(acc, acc, tmp);
      i--;
      continue;
    }
    int j = i - K2_WIN + 1 > 0 ? i - K2_WIN + 1 : 0;   // the window [i, j], j's bit set
    while (!scalar_bit(sc, j)) j++;
    int d = 0;
    for (int b = i; b >= j; b--) d = 2 * d + (int)scalar_bit(sc, b);
    const Fq* t = tab + 6 * (d >> 1);
    if (first) {
      if (lane < 6) fq_set(acc[lane], t[lane]);
      __syncwarp();
      first = 0;
    } else {
      for (int b = i; b >= j; b--) g2_dbl_step(acc, acc, tmp);
      g2_add_step(acc, acc, t, tmp);
    }
    i = j - 1;
  }
  // the tree: at span s the partial of lane idx (a multiple of s) pairs
  // with idx ^ s; the pair's arrival counter is arrived[right], right =
  // (idx | s) having s as its lowest set bit, so every pair of every level
  // has its own.  Each child publishes its partial and arrives; the first
  // to arrive is done, the second adds left + right and goes on up.
  for (int span = 1; span < B; span <<= 1) {
    const bool right = idx & span;
    if (!right && idx + span >= B) continue;         // no right sibling here
    uint32_t* mine = partial + (size_t)idx * 6 * NW;
    for (int w = lane; w < 6 * NW; w += G2_TEAM) mine[w] = acc[w / NW].v[w % NW];
    __threadfence();
    __syncwarp();
    int first = 0;
    if (lane == 0) first = atomicAdd(arrived + (idx | span), 1) == 0;
    if (__shfl_sync(0xffffffffu, first, 0)) return;
    __threadfence();
    const uint32_t* other = partial + (size_t)(idx ^ span) * 6 * NW;
    for (int w = lane; w < 6 * NW; w += G2_TEAM) c[w / NW].v[w % NW] = __ldcg(other + w);
    __syncwarp();
    if (right) g2_add_step(acc, c, acc, tmp); else g2_add_step(acc, acc, c, tmp);
    idx &= ~span;
  }
  g2_store_affine(out, out_inf, acc, nz, aff, k, tmp);   // idx = 0: the whole sum
}

extern "C" int g1_aggregate_scale(const void* pk, const void* counts, const void* scalars,
                                  void* out, void* out_inf, int B, int N, void* stream) {
  k_g1_aggregate_scale<<<B, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pk, (const int32_t*)counts, (const uint32_t*)scalars,
      (uint32_t*)out, (uint8_t*)out_inf, N);
  return (int)cudaGetLastError();
}

extern "C" int g2_scale_sum(const void* sig, const void* sig_inf, const void* scalars,
                            void* partial, void* arrived, void* out, void* out_inf, int B,
                            void* stream) {
  k_g2_scale_sum<<<B, G2_TEAM, K2_FQ * sizeof(Fq), (cudaStream_t)stream>>>(
      (const uint32_t*)sig, (const uint8_t*)sig_inf, (const uint32_t*)scalars,
      (uint32_t*)partial, (int32_t*)arrived, (uint32_t*)out, (uint8_t*)out_inf, B);
  return (int)cudaGetLastError();
}
