// K10 phase0_deltas, K11 effective_balance, K12 slashings, K13
// altair_deltas, K14 inactivity_updates (see ops/epoch_kernels.py, which
// holds their wrappers and plain versions).
//
// Replace the O(validators) passes of consensus_specs_tpu/ops/
// epoch_kernels.py, fused as the mesh programs of parallel/mesh_epoch.py
// compose them per shard:
//   K10: phase0_component_kernel x3 (:205, source/target/head),
//        phase0_inactivity_kernel (:223, leak epochs) and
//        apply_deltas_kernel (:162), as in _p_phase0_deltas (:363-416);
//   K11: effective_balance_kernel (:240), as in _p_eff_balance (:473);
//   K12: slashing_penalty_kernel (:252) and the clamped decrease, as in
//        _p_slashings (:444-471);
//   K13: flag_deltas_kernel x3 (:169), inactivity_penalty_kernel (:185)
//        and apply_deltas_kernel (:162) four times, pair by pair, as in
//        _p_altair_deltas (:311-360);
//   K14: inactivity_updates_kernel (:192), as in _p_inactivity (:418-441).
// Columns arrive as int64 tensors holding uint64 bits and are read here
// as uint64_t, so every quotient truncates and every decrease clamps at
// zero exactly as the numpy version does; the engine's guards keep each
// lane product below 2^63 (ops/epoch_kernels.py _guard).  Masks are one
// byte per lane (torch.bool).
//
// Design: no shared memory; each pass reads its columns once and writes
// one.  Bound: bytes (K10 36, K11 24, K12 25, K13 35, K14 19 B per lane at
// most: 11.3, 7.5, 7.8, 11.0 and 6.0 us at 2^20 lanes and 3.35 TB/s).
// K10, K11 and K14: one thread per validator lane, grid-stride; each
// 64-bit division by a run-time divisor is nvcc's software routine of
// several tens of instructions.  K13 does up to six such divisions a lane
// (the increment, a reward per set flag, a penalty per missing source or
// target flag, the inactivity penalty), which held it at 38-40% of its
// bound on an H100, far from the memory time.  Its four divisors are
// fixed for the launch, so it divides by their exact reciprocals
// (udiv.cuh: a multiply-high and shifts; the host computes them), and it
// takes four lanes a thread (16-byte loads of the uint64 columns, 4-byte
// loads of the byte columns, the scores only where a lane needs one) on as
// many blocks as the card holds at once: 73% of its bound at the Altair
// epoch's leaking call, 57% at the other, whose three rewards add three
// reciprocal divisions a lane (PERF.md).  K13 applies its four (reward,
// penalty) pairs one after another with a clamp at zero between each, as
// the spec's loop over the deltas does: summing them first would give
// another balance wherever a clamp bites.  K12 took the same path: one
// lane a thread with two such divisions a target lane held it at 36% of
// its bound; both of its divisors (the increment and the total active
// balance, clamped below at the increment) are fixed for the launch, so
// it divides by their reciprocals too, in the spec's truncation order
// ((eff / inc) * adjusted, then / total, then * inc), and takes K13's
// layout: four lanes a thread, two 16-byte loads of the balances, one
// 4-byte load of the target bytes, the effective balance of a target
// lane only, two 16-byte stores, occupancy x SMs blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "udiv.cuh"

#define EPOCH_THREADS 256

static int grid_for(long long n) {
  long long b = (n + EPOCH_THREADS - 1) / EPOCH_THREADS;
  if (b > (1 << 20)) b = 1 << 20;
  return b < 1 ? 1 : (int)b;
}

// K10's scalars, in the order of the host parameter array
struct Phase0Params {
  uint64_t brf, sqrt_total, brpe, att_inc[3], total_inc, in_leak, prq,
      finality_delay, ipq;
};

__global__ void __launch_bounds__(EPOCH_THREADS)
k_phase0_deltas(const uint64_t* __restrict__ eff, const uint64_t* __restrict__ incl,
                const uint64_t* __restrict__ bal, const uint8_t* __restrict__ elig,
                const uint8_t* __restrict__ att, uint64_t* __restrict__ out,
                long long n, Phase0Params p) {
  for (long long i = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EPOCH_THREADS) {
    uint64_t rew = incl[i], pen = 0;
    if (elig[i]) {
      const uint64_t e = eff[i];
      const uint64_t br = e * p.brf / p.sqrt_total / p.brpe;
      for (int c = 0; c < 3; ++c) {
        if (att[c * n + i])
          rew += p.in_leak ? br : br * p.att_inc[c] / p.total_inc;
        else
          pen += br;
      }
      if (p.in_leak) {
        pen += p.brpe * br - br / p.prq;
        if (!att[n + i]) pen += e * p.finality_delay / p.ipq;
      }
    }
    const uint64_t up = bal[i] + rew;
    out[i] = pen > up ? 0 : up - pen;
  }
}

__global__ void __launch_bounds__(EPOCH_THREADS)
k_effective_balance(const uint64_t* __restrict__ bal, const uint64_t* __restrict__ eff,
                    uint64_t* __restrict__ out, long long n, uint64_t inc, uint64_t down,
                    uint64_t up, uint64_t max_eb) {
  for (long long i = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EPOCH_THREADS) {
    const uint64_t b = bal[i], e = eff[i];
    if (b + down < e || e + up < b) {
      const uint64_t capped = b - b % inc;
      out[i] = capped < max_eb ? capped : max_eb;
    } else {
      out[i] = e;
    }
  }
}

// K12's scalars.  The host array (ops/epoch_kernels.py slashings_params)
// holds inc, adjusted, total, then the reciprocal (m, l) of inc and of
// total (udiv.cuh); total is read only through its reciprocal.
#define SLASHINGS_PARAMS 7

struct SlashingsArgs {
  const uint64_t *eff, *bal;
  const uint8_t* target;
  uint64_t* out;
  long long n, v_hi;             // [0, v_hi): 4-lane groups; [v_hi, n) lane by lane
  UDiv inc_div, total_div;
  uint64_t inc, adjusted;
};

// one lane: the penalty (eff / inc) * adjusted / total * inc of a target
// lane, subtracted with a clamp at zero
__device__ __forceinline__ uint64_t slashings_lane(const SlashingsArgs& a, uint64_t b, uint64_t e,
                                                   unsigned target) {
  if (!target) return b;
  const uint64_t pen = udiv(udiv(e, a.inc_div) * a.adjusted, a.total_div) * a.inc;
  return pen > b ? 0 : b - pen;
}

// lanes i .. i + 3: two 16-byte loads of the balances, one 4-byte load of
// the target bytes, the effective balance of the target lanes alone, two
// 16-byte stores
__device__ __forceinline__ void slashings_vec4(const SlashingsArgs& a, long long i) {
  const ulonglong2 b0 = *(const ulonglong2*)(a.bal + i), b1 = *(const ulonglong2*)(a.bal + i + 2);
  const unsigned tg = *(const unsigned*)(a.target + i);
  const uint64_t b[4] = {b0.x, b0.y, b1.x, b1.y};
  uint64_t o[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const unsigned t = (tg >> (8 * l)) & 0xFFu;
    o[l] = slashings_lane(a, b[l], t ? a.eff[i + l] : 0, t);
  }
  *(ulonglong2*)(a.out + i) = make_ulonglong2(o[0], o[1]);
  *(ulonglong2*)(a.out + i + 2) = make_ulonglong2(o[2], o[3]);
}

// grid-stride over the 4-lane groups, then the tail lanes
__global__ void __launch_bounds__(EPOCH_THREADS) k_slashings(SlashingsArgs a) {
  const long long t = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * EPOCH_THREADS;
  for (long long i = 4 * t; i < a.v_hi; i += 4 * step) slashings_vec4(a, i);
  for (long long i = a.v_hi + t; i < a.n; i += step) {
    const unsigned tg = a.target[i];
    a.out[i] = slashings_lane(a, a.bal[i], tg ? a.eff[i] : 0, tg);
  }
}

// K13's scalars.  The host array (ops/epoch_kernels.py altair_deltas)
// holds inc, brpi, weight[3], part_inc[3], reward_den, weight_den,
// in_leak, inact_den, then the reciprocal (m, l) of inc, reward_den,
// weight_den and inact_den (udiv.cuh); the divisors themselves are read
// only through their reciprocals.  The flag indices are the spec's
// constants: 0 source, 1 target, 2 head (no head penalty); the inactivity
// penalty falls on lanes without the target flag.
#define ALTAIR_PARAMS 20

struct AltairParams {
  UDiv inc, reward, weight, inact;
  uint64_t brpi, weight_of[3], wp[3], in_leak;    // wp: weight x part_inc (mod 2^64)
};

struct AltairArgs {
  const uint64_t *eff, *bal, *scores;
  const uint8_t *part, *elig, *active;
  uint64_t* out;
  long long n, v_hi;             // [0, v_hi): 4-lane groups; [v_hi, n) lane by lane
  AltairParams p;
};

// the lanes whose score K13 reads: eligible and without the target flag
__device__ __forceinline__ bool altair_needs_score(unsigned elig, unsigned act, unsigned part) {
  return elig && !(act && ((part >> 1) & 1u));
}

// one lane: the three flag pairs and the inactivity penalty, each pair
// clamped at zero before the next applies.  The reward's product
// base x weight x part_inc is taken as base x (weight x part_inc): the
// same value mod 2^64, and the guards keep it below 2^63.
__device__ __forceinline__ uint64_t altair_lane(const AltairParams& p, uint64_t b, uint64_t e,
                                                uint64_t score, unsigned elig, unsigned act,
                                                unsigned part) {
  if (!elig) return b;
  const uint64_t base = udiv(e, p.inc) * p.brpi;
  const unsigned flags = act ? part : 0u;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    uint64_t rew = 0, pen = 0;
    if ((flags >> f) & 1u) {
      if (!p.in_leak) rew = udiv(base * p.wp[f], p.reward);
    } else if (f != 2) {
      pen = udiv(base * p.weight_of[f], p.weight);
    }
    const uint64_t up = b + rew;
    b = pen > up ? 0 : up - pen;
  }
  if (!((flags >> 1) & 1u)) {
    const uint64_t pen = udiv(e * score, p.inact);
    b = pen > b ? 0 : b - pen;
  }
  return b;
}

__device__ __forceinline__ void altair_scalar(const AltairArgs& a, long long i) {
  const unsigned el = a.elig[i], ac = a.active[i], pa = a.part[i];
  const uint64_t sc = altair_needs_score(el, ac, pa) ? a.scores[i] : 0;
  a.out[i] = altair_lane(a.p, a.bal[i], el ? a.eff[i] : 0, sc, el, ac, pa);
}

// lanes i .. i + 3: two 16-byte loads per uint64 column, one 4-byte load
// per byte column, the scores only in a half with a lane that needs one,
// two 16-byte stores
__device__ __forceinline__ void altair_vec4(const AltairArgs& a, long long i) {
  const ulonglong2 b0 = *(const ulonglong2*)(a.bal + i), b1 = *(const ulonglong2*)(a.bal + i + 2);
  const ulonglong2 e0 = *(const ulonglong2*)(a.eff + i), e1 = *(const ulonglong2*)(a.eff + i + 2);
  const unsigned el = *(const unsigned*)(a.elig + i), ac = *(const unsigned*)(a.active + i),
                 pa = *(const unsigned*)(a.part + i);
  unsigned need = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l)
    need |= (unsigned)altair_needs_score((el >> (8 * l)) & 0xFFu, (ac >> (8 * l)) & 0xFFu,
                                         (pa >> (8 * l)) & 0xFFu) << l;
  ulonglong2 s0 = make_ulonglong2(0, 0), s1 = make_ulonglong2(0, 0);
  if (need & 3u) s0 = *(const ulonglong2*)(a.scores + i);
  if (need & 12u) s1 = *(const ulonglong2*)(a.scores + i + 2);
  const uint64_t b[4] = {b0.x, b0.y, b1.x, b1.y}, e[4] = {e0.x, e0.y, e1.x, e1.y},
                 s[4] = {s0.x, s0.y, s1.x, s1.y};
  uint64_t o[4];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    o[l] = altair_lane(a.p, b[l], e[l], s[l], (el >> (8 * l)) & 0xFFu, (ac >> (8 * l)) & 0xFFu,
                       (pa >> (8 * l)) & 0xFFu);
  *(ulonglong2*)(a.out + i) = make_ulonglong2(o[0], o[1]);
  *(ulonglong2*)(a.out + i + 2) = make_ulonglong2(o[2], o[3]);
}

// grid-stride over the 4-lane groups, then the tail lanes
__global__ void __launch_bounds__(EPOCH_THREADS) k_altair_deltas(AltairArgs a) {
  const long long t = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * EPOCH_THREADS;
  for (long long i = 4 * t; i < a.v_hi; i += 4 * step) altair_vec4(a, i);
  for (long long i = a.v_hi + t; i < a.n; i += step) altair_scalar(a, i);
}

__global__ void __launch_bounds__(EPOCH_THREADS)
k_inactivity_updates(const uint64_t* __restrict__ scores, const uint8_t* __restrict__ part,
                     const uint8_t* __restrict__ elig, const uint8_t* __restrict__ active,
                     uint64_t* __restrict__ out, long long n, uint64_t bias,
                     uint64_t recovery, int in_leak) {
  for (long long i = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EPOCH_THREADS) {
    uint64_t s = scores[i];
    if (elig[i]) {
      if (active[i] && ((part[i] >> 1) & 1))
        s -= s < 1 ? s : 1;
      else
        s += bias;
      if (!in_leak) s -= recovery < s ? recovery : s;
    }
    out[i] = s;
  }
}

// params: a HOST array of 11 uint64 (Phase0Params' fields in order),
// read here before the launch
extern "C" int phase0_deltas(const void* eff, const void* incl, const void* bal,
                             const void* elig, const void* att, void* out, long long n,
                             const void* params, void* stream) {
  const uint64_t* h = (const uint64_t*)params;
  Phase0Params p;
  p.brf = h[0]; p.sqrt_total = h[1]; p.brpe = h[2];
  p.att_inc[0] = h[3]; p.att_inc[1] = h[4]; p.att_inc[2] = h[5];
  p.total_inc = h[6]; p.in_leak = h[7]; p.prq = h[8]; p.finality_delay = h[9];
  p.ipq = h[10];
  k_phase0_deltas<<<grid_for(n), EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)eff, (const uint64_t*)incl, (const uint64_t*)bal,
      (const uint8_t*)elig, (const uint8_t*)att, (uint64_t*)out, n, p);
  return (int)cudaGetLastError();
}

extern "C" int effective_balance(const void* bal, const void* eff, void* out, long long n,
                                 unsigned long long inc, unsigned long long down,
                                 unsigned long long up, unsigned long long max_eb,
                                 void* stream) {
  k_effective_balance<<<grid_for(n), EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)bal, (const uint64_t*)eff, (uint64_t*)out, n, inc, down, up, max_eb);
  return (int)cudaGetLastError();
}

// params: a HOST array of SLASHINGS_PARAMS uint64, read here before the
// launch.  The 4-lane groups start at lane 0 where the balances, the
// effective balances and the output start on 16 bytes and the target
// bytes on 4 (as altair_vec tests); else every lane goes one at a time.
// As many blocks as are resident at once, fewer where a group (or a
// lane, without groups) a thread covers the work.
extern "C" int slashings(const void* eff, const void* bal, const void* target, void* out,
                         long long n, const void* params, void* stream) {
  const uint64_t* h = (const uint64_t*)params;
  SlashingsArgs a;
  a.eff = (const uint64_t*)eff; a.bal = (const uint64_t*)bal;
  a.target = (const uint8_t*)target; a.out = (uint64_t*)out; a.n = n;
  a.inc = h[0]; a.adjusted = h[1];
  a.inc_div = udiv_make(h[3], h[4]);
  a.total_div = udiv_make(h[5], h[6]);
  const uintptr_t wide = (uintptr_t)eff | (uintptr_t)bal | (uintptr_t)out;
  a.v_hi = (wide & 15) == 0 && ((uintptr_t)target & 3) == 0 ? n & ~3LL : 0;
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_slashings, EPOCH_THREADS, 0);
    if (per_sm < 1) per_sm = 1;
  }
  long long work = a.v_hi / 4;
  if (n - a.v_hi > work) work = n - a.v_hi;
  long long blocks = (work + EPOCH_THREADS - 1) / EPOCH_THREADS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  k_slashings<<<(int)blocks, EPOCH_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether every column can be read 4 lanes at a time from lane 0: the
// uint64 columns (and the output) on 16 bytes, the byte columns on 4, as
// whole columns and the wrapper's allocations are; else every lane goes
// one at a time.
static bool altair_vec(const AltairArgs& a) {
  const uintptr_t wide = (uintptr_t)a.eff | (uintptr_t)a.bal | (uintptr_t)a.scores | (uintptr_t)a.out;
  const uintptr_t bytes = (uintptr_t)a.part | (uintptr_t)a.elig | (uintptr_t)a.active;
  return (wide & 15) == 0 && (bytes & 3) == 0;
}

// params: a HOST array of ALTAIR_PARAMS uint64 (see AltairParams), read
// here before the launch
extern "C" int altair_deltas(const void* eff, const void* bal, const void* scores,
                             const void* part, const void* elig, const void* active,
                             void* out, long long n, const void* params, void* stream) {
  const uint64_t* h = (const uint64_t*)params;
  AltairArgs a;
  a.eff = (const uint64_t*)eff; a.bal = (const uint64_t*)bal; a.scores = (const uint64_t*)scores;
  a.part = (const uint8_t*)part; a.elig = (const uint8_t*)elig; a.active = (const uint8_t*)active;
  a.out = (uint64_t*)out; a.n = n;
  AltairParams& p = a.p;
  p.brpi = h[1];
  for (int f = 0; f < 3; ++f) {
    p.weight_of[f] = h[2 + f];
    p.wp[f] = h[2 + f] * h[5 + f];
  }
  p.in_leak = h[10];
  p.inc = udiv_make(h[12], h[13]);
  p.reward = udiv_make(h[14], h[15]);
  p.weight = udiv_make(h[16], h[17]);
  p.inact = udiv_make(h[18], h[19]);
  a.v_hi = altair_vec(a) ? n & ~3LL : 0;
  // as many blocks as are resident at once, fewer where a group (or a
  // lane, without groups) a thread covers the work
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_altair_deltas, EPOCH_THREADS, 0);
    if (per_sm < 1) per_sm = 1;
  }
  long long work = a.v_hi / 4;
  if (n - a.v_hi > work) work = n - a.v_hi;
  long long blocks = (work + EPOCH_THREADS - 1) / EPOCH_THREADS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  k_altair_deltas<<<(int)blocks, EPOCH_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int inactivity_updates(const void* scores, const void* part, const void* elig,
                                  const void* active, void* out, long long n,
                                  unsigned long long bias, unsigned long long recovery,
                                  int in_leak, void* stream) {
  k_inactivity_updates<<<grid_for(n), EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)scores, (const uint8_t*)part, (const uint8_t*)elig,
      (const uint8_t*)active, (uint64_t*)out, n, bias, recovery, in_leak);
  return (int)cudaGetLastError();
}
