// Projective G1 points and one thread's complete addition (Renes-Costello-
// Batina, Algorithm 7 for a = 0, the formulas of the JAX package's
// ops/jax_bls/points.py), for K8's first level (msm.cu).  Complete
// formulas keep a repeated point and an identity lane exact.  The other
// point operations are made by teams: team.cuh (G1), g2_team.cuh (G2).
#pragma once
#include "fq.cuh"

// ------------------------------------------------ field overload layer

DEV void fadd(Fq& r, const Fq& a, const Fq& b) { fq_add(r, a, b); }
DEV void fsub(Fq& r, const Fq& a, const Fq& b) { fq_sub(r, a, b); }
DEV void fmul(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }
DEV void fzero(Fq& r) { fq_zero(r); }
DEV void fone(Fq& r) { fq_set(r, FQ_ONE); }
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
