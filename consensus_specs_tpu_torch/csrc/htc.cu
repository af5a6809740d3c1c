// K3 hash_to_g2 (see ops/torch_bls/htc.py).
//
// Replaces htc.py:150,158,173,181 _j_sswu_*, :196,202 _j_iso_*,
// :225,231,237,242,248 (affine add, double runs, cofactor combine),
// tower.py:173,184,193 _j_sqrt_* and the limbs.py:308 ladders they
// dispatch.
//
// Bound: latency.  A message is a chain: its two maps' square roots, then
// Q0 + Q1 and the cofactor chain's 126 doublings and 12 additions, then
// one inversion.  At a block's ~131 messages the card runs one block per
// message, so what binds is that chain's dependent products, not the
// card's multiply-add rate.  The design shortens it:
//   - a block of three warps per message: warps 0 and 1 run the maps of
//     u0 and u1 side by side, warp 2 their inversions;
//   - each map's steps are team programs (g2_team.cuh), one Fq product a
//     lane; x1 stays a fraction N / D, so no inversion precedes the roots,
//     and g(x_i) = U_i / D^3 is a square exactly when W_i = U_i D is;
//   - the square test is folded into the root: for the norm n of W
//     (W is a square exactly when n is), c = n^((p - 3) / 4) gives
//     alpha = n c, and alpha^2 = n says n is a square.  Lanes 0 and 1
//     take both candidates' norms at once, then both (a +- alpha) / 2
//     at once: two ladders (461 dependent products each) per map in
//     place of a Legendre ladder and two to three root ladders, and the
//     root's y = b / (2 x0) is b c / 2 with no inversion (1 / x0 = c);
//   - N(D)'s inversion (binary extended Euclid) runs on warp 2 beside
//     the ladders; the isogeny ends projective, so the only inversion on
//     the chain is the final one;
//   - warp 0 then runs Q0 + Q1 and the cofactor chain's 126 doublings and
//     12 additions as laid-out team steps (g2_team.cuh g2_step: two
//     product waves each), its end as a team program.
// Every value the block writes is the canonical affine point: x is fixed
// by the square test, y by sgn0, so the output equals the plain version's
// byte for byte whatever root or representative the chain carries.
#include <cuda_runtime.h>
#include "g2_team.cuh"

#define K3_WARPS 3
#define K3_THREADS (32 * K3_WARPS)
#define K3_TMP                                                                      \
  G2_MAX(G2_MAX(G2_MAX(PP_TMP_H2C_FRONT, PP_TMP_H2C_GX), G2_MAX(PP_TMP_H2C_XY,         \
         PP_TMP_H2C_ISO)), G2_MAX(PP_TMP_H2C_TAIL,                                     \
         G2_MAX(G2_MAX(PP_TMP_G2_NORM, PP_TMP_G2_AFFINE), G2_STEP_FQ)))
// a map's slots: u, the front's outputs (zu2, tv, N, D, u canonical), gx's
// (W1, W2, their norms, N(D), N2), the first ladders, alpha, the
// candidates, the second ladders, the roots x0, y0, the chosen root,
// N(D)^-1, (x, y, y canonical), the isogeny's point
enum {
  MAP_U = 0, MAP_FR = 2, MAP_GX = 12, MAP_T1 = 21, MAP_AL = 23, MAP_C = 25, MAP_T2 = 27,
  MAP_X = 29, MAP_Y0 = 31, MAP_S = 33, MAP_NDI = 35, MAP_XY = 36, MAP_Q = 42, MAP_FQ = 48
};
// the chain's: Q, [|x|] of Q or R, R, the chain's end, N(Z) and its
// inverse, the affine point
#define CHAIN_FQ 30
#define K3_FQ (G2_N_CONSTS + ISO_N_COEFS + 2 * MAP_FQ + CHAIN_FQ + 2 * K3_TMP)
static_assert(K3_FQ * sizeof(Fq) <= 48 * 1024, "a block's state fits the default shared memory");

__global__ void __launch_bounds__(K3_THREADS)
k_hash_to_g2(const uint32_t* __restrict__ u, uint32_t* __restrict__ out,
             uint8_t* __restrict__ out_inf) {
  extern __shared__ Fq sm[];
  __shared__ int square[2][2], plus[2];
  Fq *k = sm, *iso = k + G2_N_CONSTS, *maps = iso + ISO_N_COEFS, *chain = maps + 2 * MAP_FQ;
  const int i = blockIdx.x, t = threadIdx.x, w = t >> 5, lane = t & 31;
  Fq* tmp = chain + CHAIN_FQ + (w & 1) * K3_TMP;
  Fq* m = maps + (w & 1) * MAP_FQ;
  Fq *uu = m + MAP_U, *fr = m + MAP_FR, *gx = m + MAP_GX, *t1 = m + MAP_T1, *al = m + MAP_AL,
     *cc = m + MAP_C, *t2 = m + MAP_T2, *xx = m + MAP_X, *y0 = m + MAP_Y0, *s = m + MAP_S,
     *ndi = m + MAP_NDI, *xy = m + MAP_XY, *q = m + MAP_Q;
  g2_load_consts(k, t);
  if (t >= 32 && t < 32 + ISO_N_COEFS) fq_load(iso[t - 32], ISO_COEFS + NW * (t - 32));
  if (w < 2 && lane < 2) fq_load(uu[lane], u + ((size_t)i * 4 + 2 * w + lane) * NW);
  __syncthreads();

  // 1. the front: zu2, tv, x1 = N / D; then W_i, their norms and N(D)
  if (w < 2) {
    g2_run(PROG_H2C_FRONT, g2_bind(k, uu, fr), tmp);
    if (fq_is_zero(fr[2]) && fq_is_zero(fr[3]) && lane < 2) {   // tv = 0: x1 = B / (Z A)
      fq_set(fr[4 + lane], k[G2_K_B + lane]);
      fq_set(fr[6 + lane], k[G2_K_ZA + lane]);
    }
    __syncwarp();
    g2_run(PROG_H2C_GX, g2_bind(k, fr + 4, fr + 6, fr, gx), tmp);
  }
  __syncthreads();

  // 2. the roots (warps 0, 1) beside N(D)^-1 (warp 2; D != 0)
  if (w < 2) {
    if (lane < 2) {                    // both candidates' norms at once
      Fq a2;
      fq_ladder(t1[lane], gx[4 + lane]);
      fq_mul(al[lane], gx[4 + lane], t1[lane]);
      fq_sqr(a2, al[lane]);
      square[w][lane] = fq_eq(a2, gx[4 + lane]);
    }
    __syncwarp();
    const int sel = square[w][0] ? 0 : 1;              // g(x1) a square: x1
    const Fq* W = gx + 2 * sel;
    const bool real = fq_is_zero(W[1]);
    if (lane < 2) {                    // both (a +- alpha) / 2 at once (a, -a for b = 0)
      Fq c;
      if (real) {
        if (lane) fq_neg(c, W[0]); else fq_set(c, W[0]);
      } else {
        if (lane) fq_sub(c, W[0], al[sel]); else fq_add(c, W[0], al[sel]);
        fqi_half(c.v);
      }
      fq_set(cc[lane], c);
      fq_ladder(t2[lane], c);
      fq_mul(xx[lane], c, t2[lane]);
    }
    __syncwarp();
    if (lane < 2) {
      Fq x2;
      fq_sqr(x2, xx[lane]);
      if (lane == 0) plus[w] = fq_eq(x2, cc[0]);
    } else if (lane < 4) {             // y0 = b / (2 x0) = (b / 2) c
      Fq b2;
      fq_half(b2, W[1]);
      fq_mul(y0[lane - 2], b2, t2[lane - 2]);
    }
    __syncwarp();
    if (lane < 2) {
      const int j = plus[w] ? 0 : 1;
      if (real) {                      // sqrt(a) or sqrt(-a) u
        if (lane == j) fq_set(s[lane], xx[j]); else fq_zero(s[lane]);
      } else {
        fq_set(s[lane], lane ? y0[j] : xx[j]);
      }
    }
  } else if (lane < 2) {
    Fq* mm = maps + lane * MAP_FQ;   // map `lane`'s N(D)
    fq_inv_binary(mm[MAP_NDI], mm[MAP_GX + 6]);
  }
  __syncthreads();

  // 3. the affine point, its sign, the isogeny
  if (w < 2) {
    g2_run(PROG_H2C_XY, g2_bind(k, s, square[w][0] ? fr + 4 : gx + 7, fr + 6, ndi, xy), tmp);
    if (sgn0_canon(fr[8], fr[9]) != sgn0_canon(xy[4], xy[5]) && lane < 2)
      fq_neg(xy[2 + lane], xy[2 + lane]);
    __syncwarp();
    g2_run(PROG_H2C_ISO, g2_bind(k, xy, xy + 2, iso, iso + 16, q), tmp);
    const bool den0 = fq_is_zero(q[4]) && fq_is_zero(q[5]);
    __syncwarp();
    if (den0 && lane < 5) {            // x_den y_den = 0: the plain version's (0, 0) with Z = 1
      if (lane == 4) fq_set(q[4], FQ_ONE); else fq_zero(q[lane]);
    }
  }
  __syncthreads();
  if (w != 0) return;

  // 4. Q0 + Q1 and the cofactor chain: [x]R - Q + psi(R) + psi^2([2]Q)
  //    with R = [x]Q - Q (x < 0), then the affine point; the steps' scratch
  //    is the programs' temporaries
  Fq *qq = chain, *a = chain + 6, *r = chain + 12, *o = chain + 18, *nz = chain + 24,
     *aff = chain + 26;
  g2_add_step(qq, maps + MAP_Q, maps + MAP_FQ + MAP_Q, tmp);
  g2_mul_abs_x(a, qq, tmp);
  g2_add_neg_step(r, a, qq, tmp);
  g2_mul_abs_x(a, r, tmp);
  g2_run(PROG_H2C_TAIL, g2_bind(k, a, r, qq, o), tmp);
  g2_store_affine(out + (size_t)i * 4 * NW, out_inf + i, o, nz, aff, k, tmp);
}

extern "C" int hash_to_g2(const void* u, void* out, void* out_inf, int B, void* stream) {
  k_hash_to_g2<<<B, K3_THREADS, K3_FQ * sizeof(Fq), (cudaStream_t)stream>>>(
      (const uint32_t*)u, (uint32_t*)out, (uint8_t*)out_inf);
  return (int)cudaGetLastError();
}
