// The interpreter of K4's team programs: the pairing's Fq12 steps as
// straight-line Fq programs (ops/torch_bls/team_programs.py), scheduled
// for a team of PP_TEAM threads and written as tables into the generated
// pairing_programs.cuh.  A program is a list of levels; a level's ops
// read nothing another op of the level writes, and none but one product
// falls on a thread, so the team runs op i of a level on thread i mod
// PP_TEAM and then meets at a barrier.  An op is a product of two signed
// sums, or a signed sum, of Fq slots (terms: slot | coefficient << 16).
// Slots below PP_TMP0 are bound (argument b of a run, slot PP_BIND b + i;
// the constants at PP_CONST_BIND), the others the team's temporaries.
// Every value is fully reduced, so a program's outputs are the canonical
// residues the plain version computes.  K4 runs teams of PP_TEAM threads
// (a block); K2 and K3 teams of one warp (g2_team.cuh).
#pragma once
#include "fq_inv.cuh"
#include "pairing_programs.cuh"

#ifndef __CUDACC__
struct uint4 {
  uint32_t x, y, z, w;
};
#endif

struct PPBind {
  Fq* arg[PP_CONST_BIND + 1];
};

DEV Fq* pp_slot(uint32_t v, const PPBind& b, Fq* tmp) {
  return v < PP_TMP0 ? b.arg[v / PP_BIND] + v % PP_BIND : tmp + (v - PP_TMP0);
}

// The words of a sum accumulated from WEIGHT p (PP_WEIGHT_P, which keeps
// it non-negative) -> its residue, fully reduced: one carry pass, one
// quotient estimate from the top 64 bits (q = floor(T / (p_11 + 1)) for T
// the words above 2^352; the remainder is below 2p) and one conditional
// subtraction.
DEV void pp_reduce(Fq& r, const int64_t* acc) {
  uint32_t w[NW];
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const int64_t s = acc[i] + carry;
    w[i] = (uint32_t)s;
    carry = s >> 32;
  }
  const uint64_t top = (uint64_t)(carry + PP_WEIGHT_P[NW]);
  const uint64_t q = ((top << 32) | w[NW - 1]) / PP_QDIV;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const uint64_t m = q * FQ_P[i] + borrow;
    const uint64_t d = (uint64_t)w[i] - (uint32_t)m;
    w[i] = (uint32_t)d;
    borrow = (m >> 32) + (d >> 63);
  }
  fq_reduce_once(r, w, 0);
}

// r = sum of n terms c_j x_j (x_j < p, |c_j| < 128, sum |c_j| < 2^10),
// fully reduced; term(j, c) returns x_j (16-byte aligned) and sets c_j.
// The words accumulate apart, in 64 bits, with no carry chain per term,
// then pp_reduce.  A term costs 12 independent multiply-adds, against
// fq_add's dependent carry chain.  K4's ops and K2's and K3's steps
// (g2_team.cuh team_lin) differ only in how a term is encoded.
template <class Term>
DEV void pp_accumulate(Fq& r, int n, Term term) {
  int64_t acc[NW];
#pragma unroll
  for (int i = 0; i < NW; i++) acc[i] = PP_WEIGHT_P[i];
  for (int j = 0; j < n; j++) {
    int64_t c;
    const uint4* x = (const uint4*)term(j, c);
#pragma unroll
    for (int k = 0; k < NW / 4; k++) {
      const uint4 u = x[k];
      acc[4 * k] += c * (int64_t)u.x;
      acc[4 * k + 1] += c * (int64_t)u.y;
      acc[4 * k + 2] += c * (int64_t)u.z;
      acc[4 * k + 3] += c * (int64_t)u.w;
    }
  }
  pp_reduce(r, acc);
}

// a term: slot | (coefficient & 0xff) << 16
DEV void pp_sum(Fq& r, const uint32_t* terms, int n, const PPBind& b, Fq* tmp) {
  pp_accumulate(r, n, [&](int j, int64_t& c) -> const Fq* {
    const uint32_t t = terms[j];
    c = (int8_t)(uint8_t)(t >> 16);
    return pp_slot(t & 0xFFFFu, b, tmp);
  });
}

DEV void pp_exec(int i, const PPBind& b, Fq* tmp) {
  const uint32_t w0 = PP_OPS[2 * i], first = PP_OPS[2 * i + 1];
  const int kind = (w0 >> 16) & 0xF;
  if (kind == PP_NOP) return;
  const int nx = (w0 >> 20) & 63, ny = (w0 >> 26) & 63;
  Fq x;
  pp_sum(x, PP_TERMS + first, nx, b, tmp);
  if (kind == PP_MUL) {
    Fq y;
    pp_sum(y, PP_TERMS + first + nx, ny, b, tmp);
    fq_mul(x, x, y);
  }
  fq_set(*pp_slot(w0 & 0xFFFFu, b, tmp), x);
}

// thread tid's ops of one level, for a team of TEAM threads
template <int TEAM = PP_TEAM>
DEV void pp_run_level(int level, const PPBind& b, Fq* tmp, int tid) {
  const int end = (int)PP_LEVELS[level + 1];
  for (int i = (int)PP_LEVELS[level] + tid; i < end; i += TEAM) pp_exec(i, b, tmp);
}

#ifdef __CUDACC__
// one program by the block (a team of PP_TEAM threads); ends at a barrier
__device__ void pp_run(int prog, const PPBind& b, Fq* tmp) {
  for (int l = (int)PP_PROGS[prog]; l < (int)PP_PROGS[prog + 1]; l++) {
    pp_run_level(l, b, tmp, threadIdx.x);
    __syncthreads();
  }
}
#endif
