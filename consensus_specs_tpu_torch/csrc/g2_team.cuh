// G2 steps and the hash-to-curve map by a team of one warp: K2
// g2_scale_sum (points.cu) and K3 hash_to_g2 (htc.cu).
//
// The hot steps (a lane's double-and-add, the cofactor chain) are laid out
// by hand as four levels of a warp (g2_step): a wave of Fq products (the
// Karatsuba products of an RCB doubling's or addition's Fq2 products,
// one a lane), the second wave's operands as signed sums (one a lane),
// the second wave, the outputs.  Their sums are lazy (words accumulated
// in 64 bits, reduced once: pp_accumulate) with the coefficients of 3b =
// 12 (1 + u) folded in.  The tables are read off the team programs of
// the same formulas (team_programs.G2_STEPS, two product levels each), so
// a step's point is the plain version's complete_add / complete_dbl, word
// for word.  A step is two dependent products and three sums of fixed
// shape, without the program interpreter's per-op decoding and per-term
// binding lookups.  K3's one-off steps (SSWU's front, the candidates, the
// affine point, the isogeny, the chain's end) and the normalization are
// team programs of the G2_PROGRAMS family, run by g2_run.  Beside them:
// K3's square-root ladder and the binary extended-Euclid inversion, each
// in one thread.
#pragma once
#include "pairing_team.cuh"

#define G2_MAX(a, b) ((a) > (b) ? (a) : (b))

// a^((p - 3) / 4) by 4-bit sliding windows (team_programs.ladder): 461
// dependent products against fq_pow's 606.  For a non-zero square a,
// c = a^((p - 3) / 4) gives the root a c and its inverse c.
DEVNI void fq_ladder(Fq& r, const Fq& a) {
  Fq tab[1 << (LADDER_W - 1)], a2, acc;
  fq_set(tab[0], a);
  fq_sqr(a2, a);
  for (int i = 1; i < (1 << (LADDER_W - 1)); i++) fq_mul(tab[i], tab[i - 1], a2);
  fq_set(acc, tab[LADDER_FIRST >> 1]);
  for (int s = 0; s < LADDER_N_STEPS; s++) {
    for (int j = LADDER_SQ[s]; j > 0; j--) fq_sqr(acc, acc);
    fq_mul(acc, acc, tab[LADDER_DIGIT[s] >> 1]);
  }
  for (int j = 0; j < LADDER_TAIL; j++) fq_sqr(acc, acc);
  fq_set(r, acc);
}

DEV void fq_half(Fq& r, const Fq& a) {
  fq_set(r, a);
  fqi_half(r.v);
}

// RFC 9380 sgn0 of an Fq2 from its canonical (non-Montgomery) words
DEV uint32_t sgn0_canon(const Fq& a, const Fq& b) {
  return fq_is_zero(a) ? (b.v[0] & 1u) : (a.v[0] & 1u);
}

DEV void g2_load_consts(Fq* k, int t) {
  if (t < G2_N_CONSTS) fq_load(k[t], G2_CONSTS + NW * t);
}

// a program's arguments: its inputs, then its outputs; k the constants
DEV PPBind g2_bind(Fq* k, Fq* a0, Fq* a1 = nullptr, Fq* a2 = nullptr, Fq* a3 = nullptr,
                   Fq* a4 = nullptr) {
  PPBind b;
  b.arg[0] = a0;
  b.arg[1] = a1;
  b.arg[2] = a2;
  b.arg[3] = a3;
  b.arg[4] = a4;
  b.arg[5] = nullptr;
  b.arg[6] = nullptr;
  b.arg[PP_CONST_BIND] = k;
  return b;
}

// The steps' product (fq.cuh fq_mul_out) and sum, each out of line: one
// copy of each serves every step, so the double-and-add loop's code stays
// in the SM's instruction cache.  Inlined at every site (six products,
// nine sums) it did not, and with every SM refilling it from L2 at once
// K2 slowed with the number of live lanes.

// r = the sum of n terms (slot | coefficient << 8) of slots x (the slots
// from `split` on: y + (slot - split)), fully reduced (pp_accumulate)
DEVNI void team_lin(Fq& r, const uint16_t* terms, int n, const Fq* x, const Fq* y, int split) {
  pp_accumulate(r, n, [&](int j, int64_t& c) -> const Fq* {
    const uint32_t t = terms[j];
    c = (int8_t)(uint8_t)(t >> 8);
    const int slot = t & 0xFF;
    return slot < split ? x + slot : y + (slot - split);
  });
}

#ifdef __CUDACC__
// One G2 step by the calling warp (every lane calls): r = 2p, p + q or
// -(p + q) from the step's tables (team_programs.g2_step); r may alias p
// or q.  Sizes: wave 1's products, the operands, wave 2's products, and
// the terms of a wave-1 operand, of an operand, of an output; s holds
// G2_STEP_FQ slots of scratch (wave 1's products, the operands, wave 2's).
template <int N1, int NM, int N2, int T1, int TM, int TO>
__device__ void g2_step(Fq* r, const Fq* p, const Fq* q, Fq* s, const uint16_t* w1,
                        const uint16_t* mid, const uint8_t* w2, const uint16_t* out) {
  static_assert(N1 + NM + N2 <= G2_STEP_FQ && N1 <= G2_TEAM && NM <= G2_TEAM && N2 <= G2_TEAM,
                "a step fits its warp and scratch");
  const int lane = threadIdx.x & (G2_TEAM - 1);
  Fq *s1 = s, *sm = s + N1, *s2 = sm + NM;
  if (lane < N1) {
    Fq a, b;
    team_lin(a, w1 + 2 * lane * T1, T1, p, q, 6);
    team_lin(b, w1 + (2 * lane + 1) * T1, T1, p, q, 6);
    fq_mul_out(s1[lane], a, b);
  }
  __syncwarp();
  if (lane < NM) team_lin(sm[lane], mid + lane * TM, TM, s1, s1, N1);
  __syncwarp();
  if (lane < N2) fq_mul_out(s2[lane], sm[w2[2 * lane]], sm[w2[2 * lane + 1]]);
  __syncwarp();
  if (lane < 6) team_lin(r[lane], out + lane * TO, TO, s2, s2, N2);
  __syncwarp();
}

__device__ void g2_dbl_step(Fq* r, const Fq* p, Fq* s) {
  g2_step<G2S_DBL_SIZES>(r, p, p, s, G2S_DBL_W1, G2S_DBL_MID, G2S_DBL_W2, G2S_DBL_OUT);
}

__device__ void g2_add_step(Fq* r, const Fq* p, const Fq* q, Fq* s) {
  g2_step<G2S_ADD_SIZES>(r, p, q, s, G2S_ADD_W1, G2S_ADD_MID, G2S_ADD_W2, G2S_ADD_OUT);
}

__device__ void g2_add_neg_step(Fq* r, const Fq* p, const Fq* q, Fq* s) {
  g2_step<G2S_ADD_NEG_SIZES>(r, p, q, s, G2S_ADD_NEG_W1, G2S_ADD_NEG_MID, G2S_ADD_NEG_W2,
                             G2S_ADD_NEG_OUT);
}

// one program by the calling warp (every lane calls); ends at a barrier
__device__ void g2_run(int prog, const PPBind& b, Fq* tmp) {
  const int lane = threadIdx.x & (G2_TEAM - 1);
  for (int l = (int)PP_PROGS[prog]; l < (int)PP_PROGS[prog + 1]; l++) {
    pp_run_level<G2_TEAM>(l, b, tmp, lane);
    __syncwarp();
  }
}

// r = [|x|]P for the BLS parameter x, MSB first from P for the leading bit,
// in place in r (r != p)
__device__ void g2_mul_abs_x(Fq* r, const Fq* p, Fq* s) {
  const int lane = threadIdx.x & (G2_TEAM - 1);
  if (lane < 6) fq_set(r[lane], p[lane]);
  __syncwarp();
  for (int i = 62; i >= 0; i--) {
    g2_dbl_step(r, r, s);
    if ((BLS_ABS_X >> i) & 1ull) g2_add_step(r, r, p, s);
  }
}

// The affine words (x, y) of the projective point p and its infinity
// flag (x = y = 0 then), by the calling warp: N(Z) by a program, its
// inverse by one lane's binary Euclid, then (X / Z, Y / Z).  n: 2 slots,
// aff: 4.
__device__ void g2_store_affine(uint32_t* out, uint8_t* out_inf, Fq* p, Fq* n, Fq* aff, Fq* k,
                                Fq* tmp) {
  const int lane = threadIdx.x & (G2_TEAM - 1);
  g2_run(PROG_G2_NORM, g2_bind(k, p, n), tmp);
  const bool inf = fq_is_zero(n[0]);           // Z = 0: N(Z) = 0 exactly then
  if (lane == 0 && !inf) fq_inv_binary(n[1], n[0]);
  __syncwarp();
  if (!inf) g2_run(PROG_G2_AFFINE, g2_bind(k, p, n + 1, aff), tmp);
  for (int w = lane; w < 4 * NW; w += G2_TEAM) out[w] = inf ? 0u : aff[w / NW].v[w % NW];
  if (lane == 0) *out_inf = inf ? 1 : 0;
}
#endif
