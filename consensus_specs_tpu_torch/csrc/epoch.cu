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
// Design: one thread per validator lane, grid-stride, no shared memory:
// each pass reads its columns once and writes one.  Bound: bytes (K10
// 36, K11 24, K12 25, K13 35, K14 19 B per lane at most: 11.3, 7.5, 7.8,
// 11.0 and 6.0 us at 2^20 lanes and 3.35 TB/s); the 64-bit divisions are
// emulated in a few tens of instructions but stay near the memory time.
// K13 applies its four (reward, penalty) pairs one after another with a
// clamp at zero between each, as the spec's loop over the deltas does:
// summing them first would give another balance wherever a clamp bites.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(EPOCH_THREADS)
k_slashings(const uint64_t* __restrict__ eff, const uint64_t* __restrict__ bal,
            const uint8_t* __restrict__ target, uint64_t* __restrict__ out, long long n,
            uint64_t inc, uint64_t adjusted, uint64_t total) {
  for (long long i = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EPOCH_THREADS) {
    const uint64_t b = bal[i];
    if (target[i]) {
      const uint64_t pen = eff[i] / inc * adjusted / total * inc;
      out[i] = pen > b ? 0 : b - pen;
    } else {
      out[i] = b;
    }
  }
}

// K13's scalars, in the order of the host parameter array.  The flag
// indices are the spec's constants: 0 source, 1 target, 2 head (no head
// penalty); the inactivity penalty falls on lanes without the target flag.
struct AltairParams {
  uint64_t inc, brpi, weight[3], part_inc[3], reward_den, weight_den, in_leak, inact_den;
};

__global__ void __launch_bounds__(EPOCH_THREADS)
k_altair_deltas(const uint64_t* __restrict__ eff, const uint64_t* __restrict__ bal,
                const uint64_t* __restrict__ scores, const uint8_t* __restrict__ part,
                const uint8_t* __restrict__ elig, const uint8_t* __restrict__ active,
                uint64_t* __restrict__ out, long long n, AltairParams p) {
  for (long long i = (long long)blockIdx.x * EPOCH_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * EPOCH_THREADS) {
    uint64_t b = bal[i];
    if (elig[i]) {
      const uint64_t e = eff[i];
      const uint64_t base = e / p.inc * p.brpi;
      const uint8_t flags = active[i] ? part[i] : 0;
      for (int f = 0; f < 3; ++f) {
        uint64_t rew = 0, pen = 0;
        if ((flags >> f) & 1) {
          if (!p.in_leak) rew = base * p.weight[f] * p.part_inc[f] / p.reward_den;
        } else if (f != 2) {
          pen = base * p.weight[f] / p.weight_den;
        }
        const uint64_t up = b + rew;
        b = pen > up ? 0 : up - pen;
      }
      if (!((flags >> 1) & 1)) {
        const uint64_t pen = e * scores[i] / p.inact_den;
        b = pen > b ? 0 : b - pen;
      }
    }
    out[i] = b;
  }
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

extern "C" int slashings(const void* eff, const void* bal, const void* target, void* out,
                         long long n, unsigned long long inc, unsigned long long adjusted,
                         unsigned long long total, void* stream) {
  k_slashings<<<grid_for(n), EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)eff, (const uint64_t*)bal, (const uint8_t*)target, (uint64_t*)out, n,
      inc, adjusted, total);
  return (int)cudaGetLastError();
}

// params: a HOST array of 12 uint64 (AltairParams' fields in order), read
// here before the launch
extern "C" int altair_deltas(const void* eff, const void* bal, const void* scores,
                             const void* part, const void* elig, const void* active,
                             void* out, long long n, const void* params, void* stream) {
  const uint64_t* h = (const uint64_t*)params;
  AltairParams p;
  p.inc = h[0]; p.brpi = h[1];
  for (int f = 0; f < 3; ++f) {
    p.weight[f] = h[2 + f];
    p.part_inc[f] = h[5 + f];
  }
  p.reward_den = h[8]; p.weight_den = h[9]; p.in_leak = h[10]; p.inact_den = h[11];
  k_altair_deltas<<<grid_for(n), EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)eff, (const uint64_t*)bal, (const uint64_t*)scores,
      (const uint8_t*)part, (const uint8_t*)elig, (const uint8_t*)active, (uint64_t*)out, n,
      p);
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
