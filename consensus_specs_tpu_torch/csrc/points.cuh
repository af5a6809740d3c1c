// Projective G1 arithmetic with the Renes-Costello-Batina complete
// formulas for a = 0 (addition: Algorithm 7, doubling: Algorithm 9), the
// formulas of the JAX package's ops/jax_bls/points.py.  Complete formulas
// keep a repeated key and an identity lane exact.  Templated over the
// coordinate field through the overloads below (G2's steps are team
// programs: g2_team.cuh).
#pragma once
#include "fq.cuh"

// ------------------------------------------------ field overload layer

DEV void fadd(Fq& r, const Fq& a, const Fq& b) { fq_add(r, a, b); }
DEV void fsub(Fq& r, const Fq& a, const Fq& b) { fq_sub(r, a, b); }
DEV void fmul(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }
DEV void fneg(Fq& r, const Fq& a) { fq_neg(r, a); }
DEV bool fis_zero(const Fq& a) { return fq_is_zero(a); }
DEV void fzero(Fq& r) { fq_zero(r); }
DEV void fone(Fq& r) { fq_set(r, FQ_ONE); }
DEV void finv(Fq& r, const Fq& a) { fq_inv(r, a); }
DEV void fb3(Fq& r) { fq_set(r, FQ_B3); }

template <typename F>
struct Pt {
  F x, y, z;
};

template <typename F>
DEV void pt_identity(Pt<F>& r) {
  fzero(r.x);
  fone(r.y);
  fzero(r.z);
}

template <typename F>
DEV void pt_neg(Pt<F>& r, const Pt<F>& p) {
  r.x = p.x;
  fneg(r.y, p.y);
  r.z = p.z;
}

// RCB Algorithm 7; r may alias p or q.
template <typename F>
DEVNI void pt_add(Pt<F>& r, const Pt<F>& p, const Pt<F>& q) {
  F b3, t0, t1, t2, t3, t4, s, u, x3, y3, z3;
  fb3(b3);
  fmul(t0, p.x, q.x);
  fmul(t1, p.y, q.y);
  fmul(t2, p.z, q.z);
  fadd(s, p.x, p.y);
  fadd(u, q.x, q.y);
  fmul(t3, s, u);
  fadd(u, t0, t1);
  fsub(t3, t3, u);                 // x1y2 + x2y1
  fadd(s, p.y, p.z);
  fadd(u, q.y, q.z);
  fmul(t4, s, u);
  fadd(u, t1, t2);
  fsub(t4, t4, u);                 // y1z2 + y2z1
  fadd(s, p.x, p.z);
  fadd(u, q.x, q.z);
  fmul(y3, s, u);
  fadd(u, t0, t2);
  fsub(y3, y3, u);                 // x1z2 + x2z1
  fadd(x3, t0, t0);
  fadd(x3, x3, t0);                // 3 x1x2
  fmul(t2, b3, t2);                // 3b z1z2
  fmul(y3, b3, y3);
  fadd(z3, t1, t2);                // y1y2 + 3b z1z2
  fsub(t1, t1, t2);                // y1y2 - 3b z1z2
  F p1, p2, p3, p4, p5, p6;
  fmul(p1, t3, t1);
  fmul(p2, t4, y3);
  fmul(p3, t1, z3);
  fmul(p4, y3, x3);
  fmul(p5, z3, t4);
  fmul(p6, x3, t3);
  fsub(r.x, p1, p2);
  fadd(r.y, p3, p4);
  fadd(r.z, p5, p6);
}

// RCB Algorithm 9; r may alias p.
template <typename F>
DEVNI void pt_dbl(Pt<F>& r, const Pt<F>& p) {
  F b3, t0, t1, xy, zz, t2, w, z3, y3, m1, m2, m3, m4;
  fb3(b3);
  fmul(t0, p.y, p.y);
  fmul(t1, p.y, p.z);
  fmul(xy, p.x, p.y);
  fmul(zz, p.z, p.z);
  fadd(w, t0, t0);
  fadd(w, w, w);
  fadd(z3, w, w);                  // 8 Y^2
  fmul(t2, b3, zz);                // 3b Z^2
  fadd(y3, t0, t2);
  fadd(w, t2, t2);
  fadd(w, w, t2);                  // 9b Z^2
  fsub(t0, t0, w);                 // Y^2 - 9b Z^2
  fmul(m1, t2, z3);
  fmul(m2, t1, z3);
  fmul(m3, t0, y3);
  fmul(m4, t0, xy);
  fadd(r.x, m4, m4);
  fadd(r.y, m1, m3);
  r.z = m2;
}

// [k]P, MSB-first double-and-add over nbits bits of little-endian words
template <typename F>
DEVNI void pt_scalar_mul(Pt<F>& r, const Pt<F>& p, const uint32_t* k, int nbits) {
  Pt<F> acc, base = p;
  pt_identity(acc);
  for (int i = nbits - 1; i >= 0; i--) {
    pt_dbl(acc, acc);
    if ((k[i >> 5] >> (i & 31)) & 1u) pt_add(acc, acc, base);
  }
  r = acc;
}

// projective -> affine words (x, y) + infinity flag (x = y = 0 then)
template <typename F>
DEVNI void pt_normalize(F& x, F& y, bool& inf, const Pt<F>& p) {
  inf = fis_zero(p.z);
  if (inf) {
    fzero(x);
    fzero(y);
    return;
  }
  F zi;
  finv(zi, p.z);
  fmul(x, p.x, zi);
  fmul(y, p.y, zi);
}

#ifdef __CUDACC__
// sum of a block's T points in shared memory into sh[0] (T a power of two)
template <typename F, int T>
__device__ void block_tree_sum(Pt<F>* sh) {
  for (int s = T / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) pt_add(sh[threadIdx.x], sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
}
#endif

DEV void g1_load_affine(Pt<Fq>& r, const uint32_t* src) {
  fq_load(r.x, src);
  fq_load(r.y, src + NW);
  fq_set(r.z, FQ_ONE);
}

DEV void g1_load_proj(Pt<Fq>& r, const uint32_t* src) {
  fq_load(r.x, src);
  fq_load(r.y, src + NW);
  fq_load(r.z, src + 2 * NW);
}

DEV void g1_store_proj(uint32_t* dst, const Pt<Fq>& p) {
  fq_store(dst, p.x);
  fq_store(dst + NW, p.y);
  fq_store(dst + 2 * NW, p.z);
}
