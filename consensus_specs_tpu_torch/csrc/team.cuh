// Point operations by a team of threads of one warp, shared by K1
// g1_aggregate_scale (points.cu), K7 expand_windows and K8 g1_msm
// (msm.cu).
#pragma once
#include "points.cuh"

#define G1_TEAM 6              // threads of a team_add (team_dbl uses four)
#define G1_TEAMS_PER_WARP 5    // lanes 30 and 31 idle

// A point operation by a team of threads of one warp (k: the
// thread's place in its team, mask: the team's lanes): the formulas of
// points.cuh (RCB Algorithms 7 and 9) with their general products in two
// waves, one product a thread, and their products by b3 = 12 as four
// additions.  Every value is the canonical one the plain version's
// complete_add / complete_dbl compute.  One thread's complete addition is
// 14 dependent CIOS products; a team's is 2.  p, q, r: points anywhere (r may alias p or q); slot: one Fq of
// shared memory per team thread (team_add uses 6 threads, team_dbl 4).

DEV void fq_times12(Fq& r, const Fq& a) {
  Fq t;
  fq_add(t, a, a);
  fq_add(t, t, a);
  fq_add(t, t, t);
  fq_add(r, t, t);
}

// r = c ? a : b word by word (a select, not a branch: a and b may be
// registers without either going to local memory)
DEV void fq_pick(Fq& r, bool c, const Fq& a, const Fq& b) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = c ? a.v[i] : b.v[i];
}

DEV const Fq& coord(const Pt<Fq>* p, int i) { return i == 0 ? p->x : i == 1 ? p->y : p->z; }
DEV Fq& coord(Pt<Fq>* p, int i) { return i == 0 ? p->x : i == 1 ? p->y : p->z; }

// a wave's products: inline (K7, K8: out of line, K7 takes 7-8% and K8
// 2-3% longer on an H100, chip_smoke.py --probe), or one out-of-line copy
// for every step of a kernel whose steps would outgrow the instruction
// cache (K1: inline, it takes 2.2x as long at 131 rows)
template <bool OUT>
DEV void team_mul(Fq& r, const Fq& a, const Fq& b) {
  if (OUT) fq_mul_out(r, a, b); else fq_mul(r, a, b);
}

// wave 2's operand k of the addition from wave 1's products s = (t0, t1,
// t2, m1, m2, m3), m1 = (x1 + y1)(x2 + y2), m2 = (y1 + z1)(y2 + z2), m3 =
// (x1 + z1)(x2 + z2): 0 t3 = m1 - t0 - t1, 1 t4 = m2 - t1 - t2, 2 y3 = 12
// (m3 - t0 - t2), 3 x3 = t0 + t0 + t0, 4 z3 = t1 + 12 t2, 5 u = t1 - 12 t2.
// Each is x -+ y -+ z with its terms picked per thread, so the team runs
// one sequence of sums and not six (thread 2's product by 12 aside).
DEV void add_operand(Fq& r, const Fq* s, int k) {
  Fq t12, y, z;
  fq_times12(t12, s[2]);
  const Fq& x = s[k == 0 ? 3 : k == 1 ? 4 : k == 2 ? 5 : k == 3 ? 0 : 1];
  fq_pick(y, k >= 4, t12, s[k == 1 ? 1 : 0]);
  fq_set(z, s[k == 0 ? 1 : k == 3 ? 0 : 2]);
  if (k >= 4) fq_zero(z);
  if (k == 3 || k == 4) fq_add(r, x, y); else fq_sub(r, x, y);
  if (k == 3) fq_add(r, r, z); else fq_sub(r, r, z);
  if (k == 2) fq_times12(r, r);
}

template <bool OUT = false>
__device__ void team_add(Pt<Fq>* r, const Pt<Fq>* p, const Pt<Fq>* q, Fq* slot, int k,
                         unsigned mask) {
  Fq a, b;
  if (k < 3) {
    fq_set(a, coord(p, k));
    fq_set(b, coord(q, k));
  } else {
    const int i = k == 4 ? 1 : 0, j = k == 3 ? 1 : 2;
    fq_add(a, coord(p, i), coord(p, j));
    fq_add(b, coord(q, i), coord(q, j));
  }
  team_mul<OUT>(slot[k], a, b);
  __syncwarp(mask);
  add_operand(a, slot, k);
  __syncwarp(mask);
  fq_set(slot[k], a);                  // the operands replace the products
  __syncwarp(mask);
  // p1 = t3 u, p2 = t4 y3, p3 = u z3, p4 = y3 x3, p5 = z3 t4, p6 = x3 t3
  fq_set(a, slot[k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 5 : k == 3 ? 2 : k == 4 ? 4 : 3]);
  fq_set(b, slot[k == 0 ? 5 : k == 1 ? 2 : k == 2 ? 4 : k == 3 ? 3 : k == 4 ? 1 : 0]);
  __syncwarp(mask);
  team_mul<OUT>(slot[k], a, b);
  __syncwarp(mask);
  if (k == 0) fq_sub(r->x, slot[0], slot[1]);
  if (k == 1) fq_add(r->y, slot[2], slot[3]);
  if (k == 2) fq_add(r->z, slot[4], slot[5]);
  __syncwarp(mask);
}

// wave 1: t0 = y^2, t1 = y z, xy = x y, zz = z^2; with t2 = 12 zz,
// wave 2: m1 = t2 z3, m2 = t1 z3, m3 = w y3, m4 = w xy for z3 = 8 t0,
// y3 = t0 + t2, w = t0 - 3 t2; r = (2 m4, m1 + m3, m2)
template <bool OUT = false>
__device__ void team_dbl(Pt<Fq>* r, const Pt<Fq>* p, Fq* slot, int k, unsigned mask) {
  Fq a, b;
  if (k < 4) {
    fq_set(a, k == 2 ? p->x : k == 3 ? p->z : p->y);
    fq_set(b, k == 0 ? p->y : k == 1 || k == 3 ? p->z : p->y);
    team_mul<OUT>(slot[k], a, b);
  }
  __syncwarp(mask);
  if (k < 4) {
    Fq t2, t;
    fq_times12(t2, slot[3]);
    if (k < 2) {
      fq_add(b, slot[0], slot[0]);
      fq_add(b, b, b);
      fq_add(b, b, b);                 // z3
      fq_pick(a, k == 0, t2, slot[1]);
    } else {
      fq_add(t, t2, t2);
      fq_add(t, t, t2);
      fq_sub(a, slot[0], t);           // w
      if (k == 2) fq_add(b, slot[0], t2); else fq_set(b, slot[2]);
    }
  }
  __syncwarp(mask);
  if (k < 4) team_mul<OUT>(slot[k], a, b);
  __syncwarp(mask);
  if (k == 0) fq_add(r->x, slot[3], slot[3]);
  if (k == 1) fq_add(r->y, slot[0], slot[2]);
  if (k == 2) fq_set(r->z, slot[1]);
  __syncwarp(mask);
}

DEV void copy_coord(Pt<Fq>* r, const Pt<Fq>* p, int k) {
  if (k < 3) fq_set(k == 0 ? r->x : k == 1 ? r->y : r->z, coord(p, k));
}

// this thread's team among the block's (-1: an idle lane), its place k in
// the team and the team's lanes
DEV int team_of(int& k, unsigned& mask) {
  const int lane = threadIdx.x & 31, tw = lane / G1_TEAM;
  k = lane - tw * G1_TEAM;
  mask = ((1u << G1_TEAM) - 1u) << (tw * G1_TEAM);
  return tw < G1_TEAMS_PER_WARP ? (int)(threadIdx.x >> 5) * G1_TEAMS_PER_WARP + tw : -1;
}
