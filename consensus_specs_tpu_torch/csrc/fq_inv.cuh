// Fq inversion by the binary extended Euclidean algorithm (Guide to
// Elliptic Curve Cryptography, Algorithm 2.22): the one inversion of K1,
// K2, K3, K4 and K8 each.
//
// A Fermat ladder (a^(p - 2)) is 381 squarings and ~190 products in a
// chain: in one thread it was the longest serial stretch of a kernel.
// This loop takes ~1,100 shifts and subtractions of 12-word numbers
// instead, with no product but the final conversion.  Its running time
// depends on the value, which is public here (aggregates of public keys,
// signatures, commitments and proofs of public data); the result is the
// unique inverse.  a = 0 never ends: callers keep the identity out.
#pragma once
#include "fq.cuh"

DCONST Fq FQ_R3 = {BLS_R3_WORDS};   // R^3 mod p, raw

DEV bool fqi_is_one(const uint32_t* a) {
  uint32_t acc = a[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < NW; i++) acc |= a[i];
  return acc == 0;
}

// a >= b as 384-bit integers
DEV bool fqi_geq(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = NW - 1; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

// a -= b, for a >= b
DEV void fqi_sub(uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t s = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
}

// a = (a + top * 2^384) / 2
DEV void fqi_shr1(uint32_t* a, uint32_t top) {
#pragma unroll
  for (int i = 0; i < NW - 1; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[NW - 1] = (a[NW - 1] >> 1) | (top << 31);
}

// x = x / 2 mod p, for x < p
DEV void fqi_half(uint32_t* x) {
  uint32_t top = 0;
  if (x[0] & 1u) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; i++) {
      c += (uint64_t)x[i] + FQ_P[i];
      x[i] = (uint32_t)c;
      c >>= 32;
    }
    top = (uint32_t)c;
  }
  fqi_shr1(x, top);
}

// r = a^-1 in Montgomery form (a in Montgomery form, a != 0): the raw
// inverse of a R is a^-1 R^-1, and one product with R^3 makes it a^-1 R.
DEVNI void fq_inv_binary(Fq& r, const Fq& a) {
  Fq u, v, x1, x2;
  fq_set(u, a);
#pragma unroll
  for (int i = 0; i < NW; i++) {
    v.v[i] = FQ_P[i];
    x1.v[i] = 0;
    x2.v[i] = 0;
  }
  x1.v[0] = 1;
  while (!fqi_is_one(u.v) && !fqi_is_one(v.v)) {
    while (!(u.v[0] & 1u)) {
      fqi_shr1(u.v, 0);
      fqi_half(x1.v);
    }
    while (!(v.v[0] & 1u)) {
      fqi_shr1(v.v, 0);
      fqi_half(x2.v);
    }
    if (fqi_geq(u.v, v.v)) {
      fqi_sub(u.v, v.v);
      fq_sub(x1, x1, x2);
    } else {
      fqi_sub(v.v, u.v);
      fq_sub(x2, x2, x1);
    }
  }
  fq_mul(r, fqi_is_one(u.v) ? x1 : x2, FQ_R3);
}
