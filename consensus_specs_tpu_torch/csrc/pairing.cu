// K4 pairing_check (see ops/torch_bls/pairing.py).
//
// Replaces pairing.py:276,282,293,300 _j_miller_*, :307 _j_f12_mul,
// :316,334 the easy part, :349,355,360,366,374 the hard part, :486-491
// the product tree and the entry programs :452
// staged_product_pairing_check, :496 staged_pairing_check, :242
// pairing_check.
//
// Bound: integer multiply-adds, but latency holds it: a group's check is
// a chain of some 700 dependent Fq12 steps (63 Miller iterations, the
// fold, five x-powers of 63 cyclotomic squares) over a few hundred
// pairs at most.  So every step is made by a team of PP_TEAM threads
// (one block) running a team program (pairing_team.cuh): an Fq12 product
// is one wave of 54 Fq products and a few waves of sums, a Miller
// doubling with its line, f^2 and the sparse product f^2 * line four
// waves of products.  Launches:
//   1. k_miller: one team per pair runs its Miller loop (f = 1 for a
//      degenerate pair) into an (n, 12, 12) scratch;
//   2. k_fold, fold_levels times (ceil(log2) of the largest group): a log-
//      depth tree, level l multiplying value i by value i + 2^l where
//      i - offsets[g] is a multiple of 2^(l+1), so a group's product is
//      in its first pair's slot (the JAX program's tree);
//   3. k_final: one team per group runs the final exponentiation (the
//      easy part with one Fq inversion by the binary extended Euclid of
//      fq_inv.cuh, the hard part through 3h = (x - 1)^2 (x + p)(x^2 + p^2
//      - 1) + 3) and tests the result for one; with gt set it also
//      writes the result (the GT value), (n_groups, 12, 12) words.
// The state of a team (the Miller value, the twist point, the program's
// temporaries) lives in shared memory.  A program writes its outputs where
// it computes them, so every step writes into the other of two buffers.
#include <cuda_runtime.h>
#include "pairing_team.cuh"

#define PP_MAX(a, b) ((a) > (b) ? (a) : (b))
// shared Fq slots: the bound regions, the constants (one PP_BIND block), temporaries
#define MILLER_FQ (42 + PP_BIND + PP_MAX(PP_TMP_DBL, PP_MAX(PP_TMP_ADD, PP_TMP_CONJ)))
#define FOLD_FQ (36 + PP_BIND + PP_TMP_MUL)
#define FINAL_TMP                                                                   \
  PP_MAX(PP_MAX(PP_MAX(PP_TMP_EASY_A, PP_TMP_EASY_B), PP_MAX(PP_TMP_CYC, PP_TMP_MUL)), \
         PP_MAX(PP_MAX(PP_TMP_MULCONJ, PP_TMP_T3), PP_MAX(PP_TMP_T4, PP_TMP_FINAL)))
#define FINAL_FQ (8 * 12 + 2 * PP_BIND + FINAL_TMP)
static_assert(PP_MAX(MILLER_FQ, PP_MAX(FOLD_FQ, FINAL_FQ)) * sizeof(Fq) <= 48 * 1024,
              "a team's state fits the default shared memory");

DEV PPBind pp_bind(Fq* a0, Fq* a1, Fq* a2, Fq* a3, Fq* a4, Fq* a5, Fq* k) {
  PPBind b;
  b.arg[0] = a0;
  b.arg[1] = a1;
  b.arg[2] = a2;
  b.arg[3] = a3;
  b.arg[4] = a4;
  b.arg[5] = a5;
  b.arg[6] = nullptr;
  b.arg[PP_CONST_BIND] = k;
  return b;
}

__device__ void load_consts(Fq* k) {
  if (threadIdx.x < PP_N_CONSTS) fq_load(k[threadIdx.x], PP_CONSTS + NW * threadIdx.x);
}

// x = 1 in Fq12 (12 slots), by threads 0..11
__device__ void f12_set_one(Fq* x) {
  if (threadIdx.x < 12) {
    if (threadIdx.x == 0) {
      fq_set(x[0], FQ_ONE);
    } else {
      fq_zero(x[threadIdx.x]);
    }
  }
}

__device__ void f12_copy(Fq* dst, const Fq* src) {
  if (threadIdx.x < 12) fq_set(dst[threadIdx.x], src[threadIdx.x]);
  __syncthreads();
}

__global__ void __launch_bounds__(PP_TEAM)
k_miller(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
         const uint8_t* __restrict__ degenerate, uint32_t* __restrict__ fout) {
  extern __shared__ Fq sm[];
  Fq *f[2] = {sm, sm + 12}, *r[2] = {sm + 24, sm + 30};
  Fq *pp = sm + 36, *qq = sm + 38, *k = sm + 42, *tmp = k + PP_BIND;
  const int i = blockIdx.x, t = threadIdx.x;
  f12_set_one(f[0]);
  if (t < 2) fq_load(pp[t], p + ((size_t)i * 2 + t) * NW);
  if (t < 4) {
    fq_load(qq[t], q + ((size_t)i * 4 + t) * NW);
    fq_set(r[0][t], qq[t]);
  }
  if (t == 4) fq_set(r[0][4], FQ_ONE);
  if (t == 5) fq_zero(r[0][5]);
  load_consts(k);
  __syncthreads();
  int c = 0;
  if (!degenerate[i]) {
    for (int b = 62; b >= 0; b--) {
      pp_run(PROG_DBL, pp_bind(f[c], r[c], pp, f[c ^ 1], r[c ^ 1], nullptr, k), tmp);
      c ^= 1;
      if ((BLS_ABS_X >> b) & 1ull) {
        pp_run(PROG_ADD, pp_bind(f[c], r[c], pp, qq, f[c ^ 1], r[c ^ 1], k), tmp);
        c ^= 1;
      }
    }
    pp_run(PROG_CONJ, pp_bind(f[c], f[c ^ 1], nullptr, nullptr, nullptr, nullptr, k), tmp);
    c ^= 1;                            // x < 0
  }
  for (int w = t; w < 12 * NW; w += PP_TEAM) fout[(size_t)i * 12 * NW + w] = f[c][w / NW].v[w % NW];
}

// the group of pair i: offsets[g] <= i < offsets[g + 1]
__device__ int group_of(const int32_t* off, int n_groups, int i) {
  int lo = 0, hi = n_groups;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(PP_TEAM)
k_fold(uint32_t* __restrict__ fs, const int32_t* __restrict__ offsets, int n_groups,
       int stride) {
  extern __shared__ Fq sm[];
  Fq *x = sm, *y = sm + 12, *z = sm + 24, *k = sm + 36, *tmp = k + PP_BIND;
  const int i = blockIdx.x, t = threadIdx.x;
  const int g = group_of(offsets, n_groups, i);
  if ((i - offsets[g]) % (2 * stride) != 0 || i + stride >= offsets[g + 1]) return;
  if (t < 12) {
    fq_load(x[t], fs + ((size_t)i * 12 + t) * NW);
    fq_load(y[t], fs + ((size_t)(i + stride) * 12 + t) * NW);
  }
  load_consts(k);
  __syncthreads();
  pp_run(PROG_MUL, pp_bind(x, y, z, nullptr, nullptr, nullptr, k), tmp);
  for (int w = t; w < 12 * NW; w += PP_TEAM) fs[(size_t)i * 12 * NW + w] = z[w / NW].v[w % NW];
}

// acc = base^|x| for a cyclotomic base, the steps alternating between
// acc and w (neither may alias base)
__device__ void pow_x(Fq* acc, Fq* base, Fq* w, Fq* k, Fq* tmp) {
  Fq* cur = base;
  for (int b = 62; b >= 0; b--) {
    Fq* out = cur == w ? acc : w;
    pp_run(PROG_CYC, pp_bind(cur, out, nullptr, nullptr, nullptr, nullptr, k), tmp);
    cur = out;
    if ((BLS_ABS_X >> b) & 1ull) {
      out = cur == w ? acc : w;
      pp_run(PROG_MUL, pp_bind(cur, base, out, nullptr, nullptr, nullptr, k), tmp);
      cur = out;
    }
  }
  if (cur != acc) f12_copy(acc, cur);
}

__global__ void __launch_bounds__(PP_TEAM)
k_final(const uint32_t* __restrict__ fs, const int32_t* __restrict__ offsets,
        uint8_t* __restrict__ out, uint32_t* __restrict__ gt) {
  extern __shared__ Fq sm[];
  Fq *f = sm, *g = sm + 12, *t = sm + 24, *t1 = sm + 36, *t2 = sm + 48, *t3 = sm + 60,
     *v = sm + 72, *w = sm + 84, *e = sm + 96, *k = e + PP_BIND, *tmp = k + PP_BIND;
  const int gi = blockIdx.x, tid = threadIdx.x;
  const int begin = offsets[gi], end = offsets[gi + 1];
  if (begin < end) {
    if (tid < 12) fq_load(f[tid], fs + ((size_t)begin * 12 + tid) * NW);
  } else {
    f12_set_one(f);
  }
  load_consts(k);
  __syncthreads();
  // easy part: g = f^((p^6 - 1)(p^2 + 1)); e = f12_inv's front and its norm
  pp_run(PROG_EASY_A, pp_bind(f, e, nullptr, nullptr, nullptr, nullptr, k), tmp);
  if (tid == 0) {
    if (fq_is_zero(e[8])) {
      fq_zero(e[9]);                   // f = 0 (no valid input gives it): 0, as Fermat's
    } else {
      fq_inv_binary(e[9], e[8]);
    }
  }
  __syncthreads();
  pp_run(PROG_EASY_B, pp_bind(f, e, g, nullptr, nullptr, nullptr, k), tmp);
  // hard part, exponent 3h
  pow_x(t, g, w, k, tmp);
  pp_run(PROG_MULCONJ, pp_bind(t, g, t1, nullptr, nullptr, nullptr, k), tmp);   // g^(x-1)
  pow_x(t, t1, w, k, tmp);
  pp_run(PROG_MULCONJ, pp_bind(t, t1, t2, nullptr, nullptr, nullptr, k), tmp);  // t1^(x-1)
  pow_x(t, t2, w, k, tmp);
  pp_run(PROG_T3, pp_bind(t, t2, t3, nullptr, nullptr, nullptr, k), tmp);       // t2^(x+p)
  // t3^(x^2) = (t3^|x|)^|x|: conj(pow(conj(pow(t3)))) of the one-thread
  // chain, the same value (conj inverts a cyclotomic element)
  pow_x(t, t3, w, k, tmp);
  pow_x(v, t, w, k, tmp);
  pp_run(PROG_T4, pp_bind(v, t3, t, nullptr, nullptr, nullptr, k), tmp);        // t4
  pp_run(PROG_FINAL, pp_bind(t, g, f, nullptr, nullptr, nullptr, k), tmp);      // t4 g^3
  if (tid == 0) {
    bool one = fq_eq(f[0], FQ_ONE);
    for (int j = 1; j < 12; j++) one = one && fq_is_zero(f[j]);
    out[gi] = one ? 1 : 0;
  }
  if (gt) {
    for (int j = tid; j < 12 * NW; j += PP_TEAM) gt[(size_t)gi * 12 * NW + j] = f[j / NW].v[j % NW];
  }
}

extern "C" int pairing_check(const void* p, const void* q, const void* degenerate,
                             const void* offsets, void* scratch, void* out, void* gt, int n,
                             int n_groups, int fold_levels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (n > 0) {
    k_miller<<<n, PP_TEAM, MILLER_FQ * sizeof(Fq), s>>>(
        (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)degenerate, (uint32_t*)scratch);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  for (int l = 0; l < fold_levels; l++) {
    k_fold<<<n, PP_TEAM, FOLD_FQ * sizeof(Fq), s>>>((uint32_t*)scratch, (const int32_t*)offsets,
                                                     n_groups, 1 << l);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  k_final<<<n_groups, PP_TEAM, FINAL_FQ * sizeof(Fq), s>>>(
      (const uint32_t*)scratch, (const int32_t*)offsets, (uint8_t*)out, (uint32_t*)gt);
  return (int)cudaGetLastError();
}
