// K15 epoch_reduce, K16 incl_scan, K17 registry_scan (see
// parallel/mesh_epoch.py, which holds their wrappers and plain versions).
//
// Replace the shard_map programs of consensus_specs_tpu/parallel/
// mesh_epoch.py that one card can run, for S spans of n_local lanes:
//   K15: :151 _p_altair_sums, :179 _p_masked_sums and :204
//        _p_active_sums (masked sums of the effective balances under the
//        active-at-current mask, the per-flag unslashed-participating
//        masks or k given mask rows, then one psum: here the cross-span
//        sum), and :239 _p_shard_stats (per-span maxima of k columns).
//        Optionally it writes the byte columns the epoch kernels read
//        (eligible, active-and-unslashed, the slashings target), so that
//        no mask built on the host crosses to the card;
//   K16: :279 _p_incl_scan (a scatter-min of delay << 32 | ordinal keys
//        into a per-lane column, sentinel 2^64 - 1);
//   K17: :504 _p_registry_scan (the activation-queue, ejection and
//        dequeue-eligible families compacted ascending into cap slots
//        per span, their true counts and the active count, the program's
//        one psum).  With fill set, the slots past a family's count hold
//        base + n_local as in the JAX program; without it they are left
//        unwritten (the epoch engine reads only the counted prefix).
// Columns arrive as int64 tensors holding uint64 bits and are read here
// as uint64_t, so every compare is unsigned: FAR_FUTURE_EPOCH (2^64 - 1)
// is the largest epoch, not -1.  Pad lanes are zero (act = ext = aee =
// 0), which keeps them out of every family, sum and maximum.
//
// Bound: bytes.  K15 reads each column it needs once (8 B per uint64
// column, 1 B per mask or flag byte) and writes its masks once; K16
// reads 16 B per entry and writes 8 B per lane; K17 reads 32 B per lane
// and writes 8 B per candidate slot (and per fill slot with fill set).
// K15's design: one instantiation per mode, and the modes are the epoch
// engine's five calls (K15_MODES: Altair rewards, phase0 rewards,
// inactivity updates, slashings, effective balances; any other call is
// cudaErrorInvalidValue), so sums and maxima are registers and no lane
// tests a pointer; 4 lanes a thread step (two 16-byte loads per uint64 column,
// 4-byte loads and stores per byte column), with lane-by-lane heads and
// tails where a span starts or ends off a multiple of 4; as many blocks
// as the card holds at once (occupancy x SMs), fewer where a group a
// thread covers the span; one launch and no memset: each block folds
// all its sums and maxima at once (warp shuffles, one barrier) into a
// row of the wrapper's scratch, and the last block to take a ticket
// (__threadfence, an atomic on a module counter it resets) folds every
// row in one pass (unsigned 64-bit sums: exact in any order; the host
// guards n x max < 2^63 before it reads a sum).  K16 and K17 are
// grid-stride, reduced by warp shuffles and atomics per block.  K17's
// compaction keeps index order: per-block family counts (first launch),
// then each block sums the counts before it, scans its threads' counts
// (three 21-bit fields in one 64-bit scan) and writes its candidates in
// lane order (second launch).
#include <cuda_runtime.h>
#include <stdint.h>

#define MESH_THREADS 256
#define MESH_WARPS (MESH_THREADS / 32)

typedef unsigned long long u64;

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_down_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Reduce v[0..nv) over the block (sums, or maxima with MAX); thread 0
// holds the results.  sm: [nv][MESH_WARPS].
template <bool MAX>
__device__ __forceinline__ void block_reduce(u64* v, int nv, u64 (*sm)[MESH_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < nv; ++j) {
    const u64 r = MAX ? warp_max(v[j]) : warp_sum(v[j]);
    if (lane == 0) sm[j][warp] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < nv; ++j) {
      u64 r = sm[j][0];
      for (int w = 1; w < MESH_WARPS; ++w) r = MAX ? (sm[j][w] > r ? sm[j][w] : r) : r + sm[j][w];
      v[j] = r;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K15 epoch_reduce
// ---------------------------------------------------------------------------

// A mode is what a call asks for: max columns (0-3), sums (none, the
// active balance alone, or it and NSUM flag sums or row sums) and which
// byte masks it writes.  Each is its own instantiation, so every
// accumulator is a register and no lane tests a pointer.
enum { SUMS_NONE = 0, SUMS_ACTIVE = 1, SUMS_FLAGS = 2, SUMS_ROWS = 3 };
#define MASK_ELIG 1
#define MASK_ACTIVE 2
#define MASK_TARGET 4
#define REDUCE_MODE(nmax, kind, nsum, masks) ((nmax) | ((kind) << 2) | ((nsum) << 4) | ((masks) << 6))
// The dispatch set: the epoch engine's calls (parallel/mesh_epoch.py
// try_rewards_and_penalties on each fork, try_inactivity_updates,
// try_slashings, try_effective_balance_updates).
#define K15_MODES(X)                                                    \
  X(3, SUMS_FLAGS, 3, MASK_ELIG | MASK_ACTIVE) /* Altair rewards */     \
  X(2, SUMS_ROWS, 3, MASK_ELIG)                /* phase0 rewards */     \
  X(1, SUMS_NONE, 0, MASK_ELIG | MASK_ACTIVE)  /* inactivity */         \
  X(1, SUMS_ACTIVE, 0, MASK_TARGET)            /* slashings */          \
  X(2, SUMS_NONE, 0, 0)                        /* effective balances */

#define REDUCE_THREADS 512
#define REDUCE_WARPS (REDUCE_THREADS / 32)
#define REDUCE_ROW 7                   // u64 per block partial: 4 sums, 3 maxima
#define REDUCE_MAX_BLOCKS 4096         // rows of the wrapper's scratch

struct ReduceArgs {
  const uint64_t *eff, *act, *ext, *wd;
  const uint8_t *sl, *part, *rows;      // rows: (n_sum, spans * n_local) masks
  const uint64_t* cols[3];              // max columns
  u64 *sums, *maxes;                    // (1 + n_sum,), (n_max, spans)
  uint8_t *elig, *active, *target;      // byte masks
  u64* scratch;                         // (blocks, REDUCE_ROW) partials
  long long n_local, n_total;
  int spans, vec;                       // vec: every column aligned for 4-lane loads
  uint64_t prev, cur, tgt;
};

// the last block of a launch to finish folds every block's partial; it
// resets the ticket for the next launch (launches on one stream run in turn)
__device__ unsigned int k15_ticket = 0;

template <int NMAX, int KIND, int NSUM, int MASKS>
struct K15 {
  static constexpr bool SUMS = KIND != SUMS_NONE;
  static constexpr int NACC = SUMS ? 1 + NSUM : 0;
  static constexpr bool ACT = SUMS || MASKS != 0;                  // act, ext
  static constexpr bool SL = KIND == SUMS_FLAGS || MASKS != 0;
  static constexpr bool WD = (MASKS & (MASK_ELIG | MASK_TARGET)) != 0;
  static constexpr bool PART = KIND == SUMS_FLAGS && NSUM > 0;
  static constexpr bool ROWS = KIND == SUMS_ROWS && NSUM > 0;

  // one lane: its sums and maxima into acc and mx, its masks as bytes
  __device__ static __forceinline__ void lane(const ReduceArgs& a, u64 eff, u64 act, u64 ext,
                                              u64 wd, unsigned sl, unsigned part,
                                              const unsigned* row, const u64* col, u64* acc,
                                              u64* mx, unsigned* masks) {
    const bool active_prev = ACT && act <= a.prev && a.prev < ext;
    if (SUMS && act <= a.cur && a.cur < ext) acc[0] += eff;
#pragma unroll
    for (int j = 0; j < NSUM; ++j) {
      const bool on = KIND == SUMS_FLAGS ? active_prev && !sl && ((part >> j) & 1u) : row[j] != 0;
      if (on) acc[1 + j] += eff;
    }
#pragma unroll
    for (int c = 0; c < NMAX; ++c) mx[c] = col[c] > mx[c] ? col[c] : mx[c];
    masks[0] = active_prev || (sl && a.prev + 1 < wd);
    masks[1] = active_prev && !sl;
    masks[2] = sl && wd == a.tgt;
  }

  __device__ static __forceinline__ void scalar(const ReduceArgs& a, long long i, u64* acc,
                                                u64* mx) {
    unsigned row[NSUM > 0 ? NSUM : 1], masks[3];
    u64 col[NMAX > 0 ? NMAX : 1];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) row[j] = ROWS ? a.rows[(long long)j * a.n_total + i] : 0u;
#pragma unroll
    for (int c = 0; c < NMAX; ++c) col[c] = a.cols[c][i];
    lane(a, SUMS ? a.eff[i] : 0, ACT ? a.act[i] : 0, ACT ? a.ext[i] : 0, WD ? a.wd[i] : 0,
         SL ? a.sl[i] : 0u, PART ? a.part[i] : 0u, row, col, acc, mx, masks);
    if (MASKS & MASK_ELIG) a.elig[i] = (uint8_t)masks[0];
    if (MASKS & MASK_ACTIVE) a.active[i] = (uint8_t)masks[1];
    if (MASKS & MASK_TARGET) a.target[i] = (uint8_t)masks[2];
  }

  // lanes i .. i + 3, i a multiple of 4: two 16-byte loads per uint64
  // column, one 4-byte load per byte column, one 4-byte store per mask
  __device__ static __forceinline__ void load4(const uint64_t* p, long long i, u64* v) {
    const ulonglong2 x = *(const ulonglong2*)(p + i), y = *(const ulonglong2*)(p + i + 2);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }

  __device__ static __forceinline__ void vec4(const ReduceArgs& a, long long i, u64* acc,
                                              u64* mx) {
    u64 eff[4] = {0, 0, 0, 0}, act[4] = {0, 0, 0, 0}, ext[4] = {0, 0, 0, 0},
        wd[4] = {0, 0, 0, 0}, col[NMAX > 0 ? NMAX : 1][4];
    unsigned sl = 0, part = 0, row[NSUM > 0 ? NSUM : 1], out[3] = {0, 0, 0};
    if (SUMS) load4(a.eff, i, eff);
    if (ACT) {
      load4(a.act, i, act);
      load4(a.ext, i, ext);
    }
    if (WD) load4(a.wd, i, wd);
#pragma unroll
    for (int c = 0; c < NMAX; ++c) load4(a.cols[c], i, col[c]);
    if (SL) sl = *(const unsigned*)(a.sl + i);
    if (PART) part = *(const unsigned*)(a.part + i);
#pragma unroll
    for (int j = 0; j < NSUM; ++j)
      row[j] = ROWS ? *(const unsigned*)(a.rows + (long long)j * a.n_total + i) : 0u;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      unsigned r[NSUM > 0 ? NSUM : 1], m[3];
      u64 c[NMAX > 0 ? NMAX : 1];
#pragma unroll
      for (int j = 0; j < NSUM; ++j) r[j] = (row[j] >> (8 * l)) & 0xFFu;
#pragma unroll
      for (int k = 0; k < NMAX; ++k) c[k] = col[k][l];
      lane(a, eff[l], act[l], ext[l], wd[l], (sl >> (8 * l)) & 0xFFu, (part >> (8 * l)) & 0xFFu,
           r, c, acc, mx, m);
#pragma unroll
      for (int k = 0; k < 3; ++k) out[k] |= m[k] << (8 * l);
    }
    if (MASKS & MASK_ELIG) *(unsigned*)(a.elig + i) = out[0];
    if (MASKS & MASK_ACTIVE) *(unsigned*)(a.active + i) = out[1];
    if (MASKS & MASK_TARGET) *(unsigned*)(a.target + i) = out[2];
  }
};

// v[0..NACC) summed and v[NACC..NACC + NMAX) maxed over the block in one
// barrier: each warp reduces every value, then thread j folds value j
// across the warps into out[j] (j < NACC + NMAX; the others return 0)
template <int NACC, int NMAX>
__device__ __forceinline__ u64 fold_block(const u64* v, u64 (*sm)[REDUCE_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NACC + NMAX; ++j) {
    const u64 r = j < NACC ? warp_sum(v[j]) : warp_max(v[j]);
    if (lane == 0) sm[j][warp] = r;
  }
  __syncthreads();
  u64 out = 0;
  const int j = threadIdx.x;
  if (j < NACC + NMAX) {
    out = sm[j][0];
    for (int w = 1; w < REDUCE_WARPS; ++w) {
      const u64 x = sm[j][w];
      out = j < NACC ? out + x : (x > out ? x : out);
    }
  }
  __syncthreads();
  return out;
}

// grid (blocks per span, spans): block (b, s) takes a share of span s;
// the vector range [v_lo, v_hi) holds 4-lane groups, the rest (at most 3
// lanes at each end, or the whole span without vec) goes lane by lane
template <int NMAX, int KIND, int NSUM, int MASKS>
__global__ void __launch_bounds__(REDUCE_THREADS) k_epoch_reduce(ReduceArgs a) {
  typedef K15<NMAX, KIND, NSUM, MASKS> M;
  constexpr int NACC = M::NACC, NV = NACC + NMAX;
  __shared__ u64 sm[NV > 0 ? NV : 1][REDUCE_WARPS];
  __shared__ bool last;
  u64 v[NV > 0 ? NV : 1];              // NACC sums, then NMAX maxima
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0;
  const int s = blockIdx.y;
  const long long lo = (long long)s * a.n_local, hi = lo + a.n_local;
  long long v_lo = hi, v_hi = hi;
  if (a.vec) {
    v_lo = (lo + 3) & ~3LL;
    v_lo = v_lo < hi ? v_lo : hi;
    v_hi = hi & ~3LL;
    v_hi = v_hi > v_lo ? v_hi : v_lo;
  }
  const long long t = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * REDUCE_THREADS;
  for (long long i = v_lo + 4 * t; i < v_hi; i += 4 * step) M::vec4(a, i, v, v + NACC);
  const long long head = v_lo - lo, n_scalar = head + (hi - v_hi);
  for (long long q = t; q < n_scalar; q += step)
    M::scalar(a, q < head ? lo + q : v_hi + (q - head), v, v + NACC);
  if (NV == 0) return;
  // this block's partial (row: NACC sums at 0.., NMAX maxima at 4..), then
  // the ticket; every writer fences its own store before the barrier
  const long long row = (long long)s * gridDim.x + blockIdx.x;
  const int j = threadIdx.x;
  u64 r = fold_block<NACC, NMAX>(v, sm);
  if (j < NV) {
    a.scratch[row * REDUCE_ROW + (j < NACC ? j : 4 + j - NACC)] = r;
    __threadfence();
  }
  __syncthreads();
  if (j == 0) last = atomicAdd(&k15_ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every row once, its sums over all spans, its maxima
  // per span
  u64 tot = 0;
  for (int sp = 0; sp < a.spans; ++sp) {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0;
    for (long long b = threadIdx.x; b < gridDim.x; b += REDUCE_THREADS) {
      const u64* p = a.scratch + ((long long)sp * gridDim.x + b) * REDUCE_ROW;
#pragma unroll
      for (int k = 0; k < NACC; ++k) v[k] += __ldcg(p + k);
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        const u64 x = __ldcg(p + 4 + c);
        v[NACC + c] = x > v[NACC + c] ? x : v[NACC + c];
      }
    }
    r = fold_block<NACC, NMAX>(v, sm);
    if (j < NACC) {
      tot += r;
    } else if (j < NV) {
      a.maxes[(j - NACC) * a.spans + sp] = r;
    }
  }
  if (j < NACC) a.sums[j] = tot;
  if (j == 0) k15_ticket = 0;
}

template <int NMAX, int KIND, int NSUM, int MASKS>
static int launch_reduce(ReduceArgs& a, long long scratch_words, cudaStream_t st) {
  typedef K15<NMAX, KIND, NSUM, MASKS> M;
  if ((M::SUMS && (!a.eff || !a.sums)) || (M::ACT && (!a.act || !a.ext)) || (M::SL && !a.sl) ||
      (M::WD && !a.wd) || (M::PART && !a.part) || (M::ROWS && !a.rows) || (NMAX && !a.maxes))
    return cudaErrorInvalidValue;
  for (int c = 0; c < NMAX; ++c)
    if (!a.cols[c]) return cudaErrorInvalidValue;
  // 4-lane groups need 16-byte uint64 columns and 4-byte byte columns
  bool vec = true;
  const void* wide[] = {a.eff, a.act, a.ext, a.wd, a.cols[0], a.cols[1], a.cols[2]};
  for (const void* p : wide) vec = vec && ((uintptr_t)p & 15) == 0;
  const void* narrow[] = {a.sl, a.part, a.elig, a.active, a.target};
  for (const void* p : narrow) vec = vec && ((uintptr_t)p & 3) == 0;
  for (int j = 0; M::ROWS && j < NSUM; ++j) vec = vec && ((uintptr_t)(a.rows + j * a.n_total) & 3) == 0;
  a.vec = vec;
  // as many blocks as are resident at once, fewer where a 4-lane group a
  // thread covers the span
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_epoch_reduce<NMAX, KIND, NSUM, MASKS>,
                                                  REDUCE_THREADS, 0);
    if (per_sm < 1) per_sm = 1;
  }
  long long per_span = ((a.n_local + 3) / 4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  long long cap = (long long)per_sm * sms / a.spans;
  if (cap > REDUCE_MAX_BLOCKS / a.spans) cap = REDUCE_MAX_BLOCKS / a.spans;
  if (per_span > cap) per_span = cap;
  if (per_span < 1) per_span = 1;
  if (per_span * a.spans * REDUCE_ROW > scratch_words) return cudaErrorInvalidValue;
  dim3 grid((unsigned)per_span, a.spans);
  k_epoch_reduce<NMAX, KIND, NSUM, MASKS><<<grid, REDUCE_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int epoch_reduce(const void* eff, const void* act, const void* ext, const void* wd,
                            const void* sl, const void* part, const void* rows, const void* c0,
                            const void* c1, const void* c2, void* sums, void* maxes, void* elig,
                            void* active, void* target, void* scratch, long long scratch_words,
                            long long n_local, int spans, int n_sum, int flags, int n_max,
                            unsigned long long prev, unsigned long long cur,
                            unsigned long long tgt, void* stream) {
  if (spans < 1 || spans > REDUCE_MAX_BLOCKS || n_local < 0 || n_sum < 0 || n_sum > 3 ||
      n_max < 0 || n_max > 3 || !scratch)
    return cudaErrorInvalidValue;
  ReduceArgs a;
  a.eff = (const uint64_t*)eff; a.act = (const uint64_t*)act; a.ext = (const uint64_t*)ext;
  a.wd = (const uint64_t*)wd; a.sl = (const uint8_t*)sl; a.part = (const uint8_t*)part;
  a.rows = (const uint8_t*)rows;
  a.cols[0] = (const uint64_t*)c0; a.cols[1] = (const uint64_t*)c1; a.cols[2] = (const uint64_t*)c2;
  a.sums = (u64*)sums; a.maxes = (u64*)maxes;
  a.elig = (uint8_t*)elig; a.active = (uint8_t*)active; a.target = (uint8_t*)target;
  a.scratch = (u64*)scratch;
  a.n_local = n_local; a.n_total = n_local * spans; a.spans = spans; a.vec = 0;
  a.prev = prev; a.cur = cur; a.tgt = tgt;
  const int kind = !sums ? SUMS_NONE : n_sum == 0 ? SUMS_ACTIVE : flags ? SUMS_FLAGS : SUMS_ROWS;
  const int masks = (elig ? MASK_ELIG : 0) | (active ? MASK_ACTIVE : 0) | (target ? MASK_TARGET : 0);
  const int mode = REDUCE_MODE(n_max, kind, kind >= SUMS_FLAGS ? n_sum : 0, masks);
  cudaStream_t st = (cudaStream_t)stream;
#define K15_CASE(nmax, k, nsum, m) \
  if (mode == REDUCE_MODE(nmax, k, nsum, m)) return launch_reduce<nmax, k, nsum, m>(a, scratch_words, st);
  K15_MODES(K15_CASE)
#undef K15_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K16 incl_scan
// ---------------------------------------------------------------------------

// Every index in [0, spans x n_local) lies on exactly one span, so the
// JAX program's per-span drop of off-span entries is this range test.
__global__ void __launch_bounds__(MESH_THREADS)
k_incl_scan(const long long* __restrict__ idx, const u64* __restrict__ keys, long long m,
            u64* __restrict__ out, long long n_total) {
  for (long long e = (long long)blockIdx.x * MESH_THREADS + threadIdx.x; e < m;
       e += (long long)gridDim.x * MESH_THREADS) {
    const long long i = idx[e];
    if (i >= 0 && i < n_total) atomicMin(&out[i], keys[e]);
  }
}

extern "C" int incl_scan(const void* idx, const void* keys, long long m, void* out,
                         long long n_local, int spans, void* stream) {
  if (spans < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_total = n_local * spans;
  if (n_total) cudaMemsetAsync(out, 0xFF, sizeof(u64) * n_total, st);   // the sentinel
  if (m > 0 && n_total > 0) {
    long long b = (m + MESH_THREADS - 1) / MESH_THREADS;
    if (b > 4096) b = 4096;
    k_incl_scan<<<(int)b, MESH_THREADS, 0, st>>>((const long long*)idx, (const u64*)keys, m,
                                                 (u64*)out, n_total);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K17 registry_scan
// ---------------------------------------------------------------------------

#define SCAN_LANES 8                          // consecutive lanes per thread
#define SCAN_CHUNK (MESH_THREADS * SCAN_LANES)  // lanes per block
#define FIELD 21                              // bits per family in a packed count

struct ScanArgs {
  const uint64_t *aee, *act, *ext, *eff;
  long long n_local, cap;
  int spans, blocks, fill;
  uint64_t cur, fin, far, max_eb, ejection;
  long long* bufs;       // (3, spans * cap)
  long long* counts;     // (3, spans)
  u64* active;           // (1,)
  long long* scratch;    // (3, spans, blocks): per-block family counts
};

// bit f: family f (0 queue, 1 eject, 2 eligible); bit 3: active at cur
__device__ __forceinline__ unsigned scan_bits(const ScanArgs& a, long long i) {
  const uint64_t aee = a.aee[i], act = a.act[i], ext = a.ext[i], eff = a.eff[i];
  const bool active = act <= a.cur && a.cur < ext;
  return (unsigned)(aee == a.far && eff == a.max_eb) | ((unsigned)(active && eff <= a.ejection) << 1)
         | ((unsigned)(aee <= a.fin && act == a.far) << 2) | ((unsigned)active << 3);
}

__global__ void __launch_bounds__(MESH_THREADS) k_scan_count(ScanArgs a) {
  __shared__ u64 sm[4][MESH_WARPS];
  const int s = blockIdx.y, b = blockIdx.x;
  const long long base = (long long)s * a.n_local;
  u64 c[4] = {0, 0, 0, 0};
  const long long l0 = (long long)b * SCAN_CHUNK + (long long)threadIdx.x * SCAN_LANES;
  for (int k = 0; k < SCAN_LANES; ++k) {
    if (l0 + k >= a.n_local) break;
    const unsigned bits = scan_bits(a, base + l0 + k);
    for (int f = 0; f < 4; ++f) c[f] += (bits >> f) & 1;
  }
  block_reduce<false>(c, 4, sm);
  if (threadIdx.x == 0) {
    for (int f = 0; f < 3; ++f) a.scratch[((long long)f * a.spans + s) * a.blocks + b] = (long long)c[f];
    atomicAdd(a.active, c[3]);
  }
}

__global__ void __launch_bounds__(MESH_THREADS) k_scan_write(ScanArgs a) {
  __shared__ u64 sm[6][MESH_WARPS];
  __shared__ u64 wsum[MESH_WARPS];
  __shared__ long long off[3], total[3];
  const int s = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long base = (long long)s * a.n_local;
  // this block's offset in its span and the span's total, per family
  u64 v[6] = {0, 0, 0, 0, 0, 0};
  for (int j = t; j < a.blocks; j += MESH_THREADS)
    for (int f = 0; f < 3; ++f) {
      const u64 c = (u64)a.scratch[((long long)f * a.spans + s) * a.blocks + j];
      v[3 + f] += c;
      if (j < b) v[f] += c;
    }
  block_reduce<false>(v, 6, sm);
  if (t == 0)
    for (int f = 0; f < 3; ++f) {
      off[f] = (long long)v[f];
      total[f] = (long long)v[3 + f];
      if (b == 0) a.counts[f * a.spans + s] = total[f];
    }
  __syncthreads();
  // the fill slots [min(total, cap), cap), shared out over the span's blocks
  const long long fill = base + a.n_local;
  for (int f = 0; a.fill && f < 3; ++f) {
    long long* buf = a.bufs + (long long)f * a.spans * a.cap + (long long)s * a.cap;
    const long long from = total[f] < a.cap ? total[f] : a.cap;
    for (long long j = from + (long long)b * MESH_THREADS + t; j < a.cap;
         j += (long long)a.blocks * MESH_THREADS)
      buf[j] = fill;
  }
  // the candidates in lane order: scan the threads' packed counts
  const long long l0 = (long long)b * SCAN_CHUNK + (long long)t * SCAN_LANES;
  unsigned bits[SCAN_LANES];
  u64 mine = 0;
#pragma unroll
  for (int k = 0; k < SCAN_LANES; ++k) {
    bits[k] = l0 + k < a.n_local ? scan_bits(a, base + l0 + k) : 0u;
    mine += (u64)(bits[k] & 1) | ((u64)((bits[k] >> 1) & 1) << FIELD)
            | ((u64)((bits[k] >> 2) & 1) << (2 * FIELD));
  }
  u64 incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (t == 0)
    for (int w = 1; w < MESH_WARPS; ++w) wsum[w] += wsum[w - 1];
  __syncthreads();
  const u64 excl = incl - mine + (warp ? wsum[warp - 1] : 0);
  long long pos[3];
  for (int f = 0; f < 3; ++f)
    pos[f] = off[f] + (long long)((excl >> (f * FIELD)) & ((1ull << FIELD) - 1));
#pragma unroll
  for (int k = 0; k < SCAN_LANES; ++k)
    for (int f = 0; f < 3; ++f)
      if ((bits[k] >> f) & 1) {
        if (pos[f] < a.cap)
          a.bufs[(long long)f * a.spans * a.cap + (long long)s * a.cap + pos[f]] = base + l0 + k;
        ++pos[f];
      }
}

extern "C" int registry_scan(const void* aee, const void* act, const void* ext, const void* eff,
                             long long n_local, int spans, unsigned long long cur,
                             unsigned long long fin, unsigned long long far,
                             unsigned long long max_eb, unsigned long long ejection,
                             long long cap, int blocks, int fill, void* bufs, void* counts,
                             void* active, void* scratch, void* stream) {
  if (spans < 1 || cap < 1 || blocks < 1 || (long long)blocks * SCAN_CHUNK < n_local)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ScanArgs a;
  a.aee = (const uint64_t*)aee; a.act = (const uint64_t*)act; a.ext = (const uint64_t*)ext;
  a.eff = (const uint64_t*)eff;
  a.n_local = n_local; a.cap = cap; a.spans = spans; a.blocks = blocks; a.fill = fill;
  a.cur = cur; a.fin = fin; a.far = far; a.max_eb = max_eb; a.ejection = ejection;
  a.bufs = (long long*)bufs; a.counts = (long long*)counts; a.active = (u64*)active;
  a.scratch = (long long*)scratch;
  cudaMemsetAsync(active, 0, sizeof(u64), st);
  dim3 grid(blocks, spans);
  k_scan_count<<<grid, MESH_THREADS, 0, st>>>(a);
  k_scan_write<<<grid, MESH_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
