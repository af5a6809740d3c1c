// Fr, the BLS12-381 scalar field (r = R_ORDER): 8 x 32-bit little-endian
// limbs, CIOS Montgomery multiplication with R = 2^256 (the JAX package's
// radix, ops/jax_bls/fr_fft.py:34) on 32x32->64 multiply-adds.  Every
// input and output is fully reduced (< r).
//
// Replaces the field ops of the JAX package's ops/jax_bls/fr_fft.py:30-142,
// whose 16 x 16-bit limbs with f32 column sums exist only because the TPU
// lacks a 64-bit integer multiply.  Written as fq.cuh is; the constants
// come from the generated bls_constants.cuh (_build.constants_header()).
#pragma once
#include "common.cuh"
#include "bls_constants.cuh"

#define RW 8

struct Fr {
  uint32_t v[RW];
};

DCONST uint32_t FR_R[RW] = BLS_R_WORDS;

// r = t - R_ORDER if (carry or t >= R_ORDER) else t, for t + carry * 2^256 < 2r.
DEV void fr_reduce_once(Fr& r, const uint32_t* t, uint32_t carry) {
  uint32_t d[RW];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < RW; i++) {
    uint64_t s = (uint64_t)t[i] - FR_R[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool use_d = carry || !borrow;
#pragma unroll
  for (int i = 0; i < RW; i++) r.v[i] = use_d ? d[i] : t[i];
}

DEV void fr_add(Fr& r, const Fr& a, const Fr& b) {
  uint32_t t[RW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < RW; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fr_reduce_once(r, t, (uint32_t)c);
}

DEV void fr_sub(Fr& r, const Fr& a, const Fr& b) {
  uint32_t d[RW];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < RW; i++) {
    uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint64_t c = 0;
  uint32_t mask = 0u - borrow;  // add r back when the difference went negative
#pragma unroll
  for (int i = 0; i < RW; i++) {
    c += (uint64_t)d[i] + (FR_R[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

// CIOS Montgomery product a * b * 2^-256 mod r: 2 * 8^2 word products.
DEV void fr_mul(Fr& r, const Fr& a, const Fr& b) {
  uint32_t t[RW + 2];
#pragma unroll
  for (int i = 0; i < RW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < RW; i++) {
    uint32_t carry = 0;
    uint64_t s;
#pragma unroll
    for (int j = 0; j < RW; j++) {
      s = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[RW] + carry;
    t[RW] = (uint32_t)s;
    t[RW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * BLS_R_N0;
    s = (uint64_t)m * FR_R[0] + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < RW; j++) {
      s = (uint64_t)m * FR_R[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[RW] + carry;
    t[RW - 1] = (uint32_t)s;
    t[RW] = t[RW + 1] + (uint32_t)(s >> 32);
  }
  fr_reduce_once(r, t, t[RW]);
}

DEV void fr_load(Fr& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < RW; i++) r.v[i] = src[i];
}

DEV void fr_store(uint32_t* dst, const Fr& a) {
#pragma unroll
  for (int i = 0; i < RW; i++) dst[i] = a.v[i];
}
