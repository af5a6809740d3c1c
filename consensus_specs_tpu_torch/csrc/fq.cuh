// Fq, the BLS12-381 base field: 12 x 32-bit little-endian limbs in
// Montgomery form (R = 2^384) and CIOS multiplication on 32x32->64
// multiply-adds (the kernels invert by fq_inv.cuh's binary extended
// Euclid).  Every input and output is fully reduced (< p).
//
// Replaces the JAX package's ops/jax_bls/limbs.py, whose 24 x 16-bit limbs
// with f32 column sums exist only because the TPU lacks a 64-bit integer
// multiply; Hopper has one.  Constants come from the generated
// bls_constants.cuh (written from the python oracle by _build.py).
#pragma once
#include "common.cuh"
#include "bls_constants.cuh"

#define NW 12

struct Fq {
  uint32_t v[NW];
};

DCONST uint32_t FQ_P[NW] = BLS_P_WORDS;
DCONST Fq FQ_ONE = {BLS_ONE_WORDS};
DCONST Fq FQ_B3 = {BLS_B3_G1_WORDS};

DEV void fq_zero(Fq& r) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = 0;
}

DEV void fq_set(Fq& r, const Fq& a) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = a.v[i];
}

DEV bool fq_is_zero(const Fq& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) acc |= a.v[i];
  return acc == 0;
}

DEV bool fq_eq(const Fq& a, const Fq& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = t - p if (carry or t >= p) else t, for t + carry * 2^384 < 2p.
DEV void fq_reduce_once(Fq& r, const uint32_t* t, uint32_t carry) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t s = (uint64_t)t[i] - FQ_P[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool use_d = carry || !borrow;
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = use_d ? d[i] : t[i];
}

DEV void fq_add(Fq& r, const Fq& a, const Fq& b) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fq_reduce_once(r, t, (uint32_t)c);
}

DEV void fq_sub(Fq& r, const Fq& a, const Fq& b) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint64_t c = 0;
  uint32_t mask = 0u - borrow;  // add p back when the difference went negative
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)d[i] + (FQ_P[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

DEV void fq_neg(Fq& r, const Fq& a) {
  Fq z;
  fq_zero(z);
  fq_sub(r, z, a);
}

// CIOS Montgomery product a * b * 2^-384 mod p: 2 * 12^2 multiply-adds.
DEV void fq_mul(Fq& r, const Fq& a, const Fq& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint32_t carry = 0;
    uint64_t s;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      s = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[NW] + carry;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * BLS_N0;
    s = (uint64_t)m * FQ_P[0] + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < NW; j++) {
      s = (uint64_t)m * FQ_P[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[NW] + carry;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  fq_reduce_once(r, t, t[NW]);
}

DEV void fq_sqr(Fq& r, const Fq& a) { fq_mul(r, a, a); }

// The product out of line: one copy serves every step of a kernel whose
// steps, each with its products inlined, would outgrow the SM's
// instruction cache (every SM then refills it from L2 at once, and the
// kernel slows with the number of live blocks).
DEVNI void fq_mul_out(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }

DEV void fq_load(Fq& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = src[i];
}

DEV void fq_store(uint32_t* dst, const Fq& a) {
#pragma unroll
  for (int i = 0; i < NW; i++) dst[i] = a.v[i];
}
