// K1 g1_aggregate_scale and K2 g2_scale_sum (see ops/torch_bls/points.py).
//
// K1 replaces bls_jax.py:196 _j_tree_sum (points.py:256
// g1_tree_sum_batched), bls_jax.py:491 _j_g1_scale (points.py:244,140)
// and points.py:335 _j_g1_norm_post with the limbs.py:308 inverse.
// K2 replaces bls_jax.py:498 _j_g2_scale_sum (points.py:248,286),
// points.py:353 _j_g2_norm_post and tower.py:154,160 _j_f2_norm /
// _j_f2_inv_post.
//
// Both are latency-bound: their work is a few thousand Fq products per
// row or lane (588 multiply-adds each), far from the card's rate, but a
// 128-bit scale is a chain of ~158 dependent point steps.  So every point
// step is made by a team, its scalar's bits uniform across the team, and
// 4-bit sliding windows over a table of the base's odd multiples cut the
// ~64 additions of double-and-add to ~26 (and 8 to build the table).  No
// GLV or GLS split: the plain versions compute [r]P for any curve point.
//
// K1: one block of K1_WARPS warps a row, 40 teams of six (team.cuh
// team_add, team_dbl: two waves of Fq products a step).  Team t sums keys
// t, t + 40, ..., a tree of team additions in shared memory joins the 40
// partials, then team 0 scales the sum and normalizes it with one
// binary-Euclid inversion (fq_inv.cuh).  At 512 keys that is ~12 + 6
// additions before a scale of ~158 steps: ~355 product waves against the
// ~2,900 dependent products of one thread's chain.  Any order of
// additions and any correct inversion give the one affine output, so the
// result is byte-identical to the plain version's; the complete formulas
// keep an empty row, a repeated key and P + (-P) exact.
//
// K2: each lane is one warp (a team) running every step laid out over its
// lanes (g2_team.cuh g2_step: a doubling or an addition is two waves of Fq
// products).  One launch: the lane partials are summed by a tree of team
// additions in the same kernel, a pair's second finisher adding the
// first's partial (an arrival counter per pair, so no block waits on
// another and no second launch waits for the slowest lane), and the block
// that ends with the root normalizes it with one binary-Euclid inversion.
#include <cuda_runtime.h>
#include "points.cuh"
#include "g2_team.cuh"
#include "team.cuh"

#define K1_WARPS 8
#define K1_THREADS (32 * K1_WARPS)
#define K1_TEAMS (G1_TEAMS_PER_WARP * K1_WARPS)   // 40
#define K1_WIN 4                                   // the scale's window bits
#define K1_TAB (1 << (K1_WIN - 1))                 // S, 3S, ..., 15S

DEV uint32_t scalar_bit(const uint32_t* k, int i) { return (k[i >> 5] >> (i & 31)) & 1u; }

// K1's steps, each one out-of-line copy over one out-of-line product, so
// the kernel's code stays in the SM's instruction cache (see fq_mul_out)
DEVNI void k1_add(Pt<Fq>* r, const Pt<Fq>* p, const Pt<Fq>* q, Fq* slot, int k,
                  unsigned mask) {
  team_add<true>(r, p, q, slot, k, mask);
}

DEVNI void k1_dbl(Pt<Fq>* r, const Pt<Fq>* p, Fq* slot, int k, unsigned mask) {
  team_dbl<true>(r, p, slot, k, mask);
}

__global__ void __launch_bounds__(K1_THREADS)
k_g1_aggregate_scale(const uint32_t* __restrict__ pk, const int32_t* __restrict__ counts,
                     const uint32_t* __restrict__ scalars, uint32_t* __restrict__ out,
                     uint8_t* __restrict__ out_inf, int N) {
  __shared__ Pt<Fq> acc[K1_TEAMS], key[K1_TEAMS], tab[K1_TAB], two;
  __shared__ Fq slot[K1_TEAMS][G1_TEAM];
  int k;
  unsigned mask;
  const int team = team_of(k, mask);
  const int row = blockIdx.x, cnt = counts[row];
  const uint32_t* keys = pk + (size_t)row * N * 2 * NW;
  // team t's partial starts at key t (the identity where the row has
  // none); key[t] stages each further key, the one after it prefetched
  if (team >= 0) {
    if (k < 3) {
      Fq& a = coord(&acc[team], k);
      if (team < cnt) {
        if (k < 2) fq_load(a, keys + (size_t)team * 2 * NW + k * NW); else fq_set(a, FQ_ONE);
      } else if (k == 1) {
        fq_set(a, FQ_ONE);
      } else {
        fq_zero(a);
      }
      if (k == 2) fq_set(key[team].z, FQ_ONE);
    }
    Fq next;
    int j = team + K1_TEAMS;
    if (k < 2 && j < cnt) fq_load(next, keys + (size_t)j * 2 * NW + k * NW);
    for (; j < cnt; j += K1_TEAMS) {
      if (k < 2) fq_set(coord(&key[team], k), next);
      __syncwarp(mask);
      if (k < 2 && j + K1_TEAMS < cnt)
        fq_load(next, keys + (size_t)(j + K1_TEAMS) * 2 * NW + k * NW);
      k1_add(&acc[team], &acc[team], &key[team], slot[team], k, mask);
    }
  }
  // the tree: at each level the upper half's partials join the lower's
  for (int n = K1_TEAMS; n > 1;) {
    const int h = (n + 1) >> 1;
    __syncthreads();
    if (team >= 0 && team < n - h)
      k1_add(&acc[team], &acc[team], &acc[team + h], slot[team], k, mask);
    n = h;
  }
  __syncthreads();
  if (team != 0) return;
  Pt<Fq>* s = &acc[0];
  Fq* sl = slot[0];
  if (scalars != nullptr) {
    // [r]S by 4-bit sliding windows, MSB first, over the odd multiples
    const uint32_t* sc = scalars + (size_t)row * 4;
    int top = 127;                                   // the scalar's leading bit
    while (top >= 0 && !scalar_bit(sc, top)) top--;
    if (top < 0) {                                   // r = 0: the identity
      if (k < 3) {
        if (k == 1) fq_set(s->y, FQ_ONE); else fq_zero(coord(s, k));
      }
      __syncwarp(mask);
    } else {
      copy_coord(&tab[0], s, k);
      __syncwarp(mask);
      k1_dbl(&two, &tab[0], sl, k, mask);
      for (int j = 1; j < K1_TAB; j++) k1_add(&tab[j], &tab[j - 1], &two, sl, k, mask);
    }
    for (int i = top, first = 1; i >= 0;) {
      if (!scalar_bit(sc, i)) {
        k1_dbl(s, s, sl, k, mask);
        i--;
        continue;
      }
      int j = i - K1_WIN + 1 > 0 ? i - K1_WIN + 1 : 0;   // the window [i, j], j's bit set
      while (!scalar_bit(sc, j)) j++;
      int d = 0;
      for (int b = i; b >= j; b--) d = 2 * d + (int)scalar_bit(sc, b);
      const Pt<Fq>* t = &tab[d >> 1];
      if (first) {
        copy_coord(s, t, k);
        __syncwarp(mask);
        first = 0;
      } else {
        for (int b = i; b >= j; b--) k1_dbl(s, s, sl, k, mask);
        k1_add(s, s, t, sl, k, mask);
      }
      i = j - 1;
    }
  }
  // affine: thread 0 inverts Z, threads 0 and 1 make x and y
  const bool inf = fq_is_zero(s->z);
  if (k == 0 && !inf) fq_inv_binary(sl[0], s->z);
  __syncwarp(mask);
  if (k < 2) {
    Fq v;
    if (inf) fq_zero(v); else fq_mul(v, coord(s, k), sl[0]);
    fq_store(out + (size_t)row * 2 * NW + k * NW, v);
  }
  if (k == 0) out_inf[row] = inf ? 1 : 0;
}

// shared Fq slots of a K2 block: constants, the window table (the odd
// multiples P, 3P, ..., 15P), the running point, a sibling's partial, N(Z)
// and its inverse, the affine point, the steps' scratch (also the
// programs' temporaries); K2_WIN comes with the generated tables
// (team_programs.K2_WIN, which K2's chain floor reads too)
#define K2_TAB (1 << (K2_WIN - 1))
#define K2_TMP G2_MAX(G2_STEP_FQ, G2_MAX(PP_TMP_G2_NORM, PP_TMP_G2_AFFINE))
#define K2_FQ (G2_N_CONSTS + 6 * K2_TAB + 2 * 6 + 2 + 4 + K2_TMP)

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
