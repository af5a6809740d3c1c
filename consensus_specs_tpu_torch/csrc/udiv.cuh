// Exact unsigned 64-bit division by a divisor fixed for a whole launch,
// as a multiply-high and three shifts: division by invariant integers
// using multiplication (Granlund and Montgomery, PLDI 1994, figure 4.1).
//
// nvcc turns `uint64_t / uint64_t` with a divisor known only at run time
// into a software routine of several tens of instructions; this takes a
// 64 x 64 -> 128-bit high product, a subtraction, two shifts and an add.
// The host computes the reciprocal once per launch
// (ops/epoch_kernels.py `reciprocal`): for d = 2^k (d = 1 included) m = 0
// and l = k, a shift; for any other d, l = ceil(log2 d) and
// m = floor(2^64 (2^l - d) / d) + 1.  Then for every 64-bit n
//   t = mulhi(m, n),  n / d = (t + ((n - t) >> s1)) >> s2,
// s1 = min(l, 1), s2 = max(l - 1, 0): t <= n, so nothing wraps.
//
// Host C++ (no __CUDACC__) compiles it too, so the lane bodies that use
// it can be held against the plain versions with g++.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define UDIV_FN __device__ __forceinline__
#else
#define UDIV_FN static inline
#endif

struct UDiv {
  uint64_t m;          // the multiplier (0 for a power of two)
  unsigned s1, s2;     // min(l, 1), max(l - 1, 0)
};

// (m, l) as the host packs them -> the launch's divider
static inline UDiv udiv_make(uint64_t m, uint64_t l) {
  UDiv u;
  u.m = m;
  u.s1 = l ? 1u : 0u;
  u.s2 = l ? (unsigned)(l - 1) : 0u;
  return u;
}

UDIV_FN uint64_t udiv_hi(uint64_t a, uint64_t b) {
#ifdef __CUDACC__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

UDIV_FN uint64_t udiv(uint64_t n, const UDiv& d) {
  const uint64_t t = udiv_hi(d.m, n);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}
