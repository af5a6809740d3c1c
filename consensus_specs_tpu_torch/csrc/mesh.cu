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
// guards n x max < 2^63 before it reads a sum).  K16 is one cooperative
// launch that writes its sentinel fill, syncs the grid and makes one
// atomic per entry (see its section).  K17 is one launch over tiles of
// 2048 lanes, its compaction in lane order from warp ballots and a
// decoupled look-back across tiles (see its section).
#include <cooperative_groups.h>
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

// One cooperative launch and no memset, on one CTA of 1024 threads an SM
// (a grid barrier costs an arrival per CTA).  Each thread first loads its
// first pair of entries (one 16-byte load of idx and one of keys), then
// writes the sentinel over its share of the lanes with 16-byte stores, so
// that the entries' reads overlap the fill; a grid-wide barrier
// (cooperative_groups this_grid().sync(), so the launch is cooperative and
// its grid at most what the card holds at once) orders every fill before
// any atomic; then it makes one atomicMin per entry in range: the loaded
// pair, the pairs past it, then a head and a tail entry one at a time
// where idx and keys start off 16 bytes or m is odd.  A minimum does not
// depend on the order of the atomics, so the result is exact.  The
// atomics bind: one per entry at scattered lanes, each a read-modify-write
// in L2 (PERF.md).  Every index in [0, spans x n_local) lies on exactly
// one span, so the JAX program's per-span drop of off-span entries is the
// range test (unsigned: pad entries are -1).
#define INCL_THREADS 1024

struct InclArgs {
  const long long* idx;
  const u64* keys;
  u64* out;
  long long m, n_total;
  long long e_lo;      // entries before the first 16-byte pair (m: no pairs)
};

__device__ __forceinline__ void incl_entry(const InclArgs& a, long long i, u64 key) {
  if ((u64)i < (u64)a.n_total) atomicMin(a.out + i, key);
}

__global__ void __launch_bounds__(INCL_THREADS, 1) k_incl_scan(InclArgs a) {
  const long long t = (long long)blockIdx.x * INCL_THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * INCL_THREADS;
  const u64 S = ~0ull;
  // the first pair of entries, loaded ahead of the fill
  const long long e_pairs = (a.m - a.e_lo) >> 1;
  longlong2 i0 = make_longlong2(0, 0);
  ulonglong2 k0 = make_ulonglong2(0, 0);
  if (t < e_pairs) {
    i0 = *(const longlong2*)(a.idx + a.e_lo + 2 * t);
    k0 = *(const ulonglong2*)(a.keys + a.e_lo + 2 * t);
  }
  // the fill: lane pairs, then the last lane where n_total is odd
  for (long long p = t; p < a.n_total >> 1; p += step)
    *(ulonglong2*)(a.out + 2 * p) = make_ulonglong2(S, S);
  if (t == 0 && (a.n_total & 1)) a.out[a.n_total - 1] = S;
  cooperative_groups::this_grid().sync();
  // the entries: the loaded pair, the pairs past it, then the head and
  // tail entries
  if (t < e_pairs) {
    incl_entry(a, i0.x, k0.x);
    incl_entry(a, i0.y, k0.y);
  }
  for (long long p = t + step; p < e_pairs; p += step) {
    const long long e = a.e_lo + 2 * p;
    const longlong2 i2 = *(const longlong2*)(a.idx + e);
    const ulonglong2 k2 = *(const ulonglong2*)(a.keys + e);
    incl_entry(a, i2.x, k2.x);
    incl_entry(a, i2.y, k2.y);
  }
  const long long e_hi = a.e_lo + 2 * e_pairs, n_scalar = a.e_lo + (a.m - e_hi);
  for (long long q = t; q < n_scalar; q += step) {
    const long long e = q < a.e_lo ? q : e_hi + (q - a.e_lo);
    incl_entry(a, a.idx[e], a.keys[e]);
  }
}

extern "C" int incl_scan(const void* idx, const void* keys, long long m, void* out,
                         long long n_local, int spans, void* stream) {
  // out: the wrapper's allocation, on 16 bytes
  if (spans < 1 || m < 0 || n_local < 0 || ((uintptr_t)out & 15)) return cudaErrorInvalidValue;
  InclArgs a;
  a.idx = (const long long*)idx; a.keys = (const u64*)keys; a.out = (u64*)out;
  a.m = m; a.n_total = n_local * spans;
  const uintptr_t pi = (uintptr_t)idx, pk = (uintptr_t)keys;
  // a common head where idx and keys start on the same 16-byte phase
  a.e_lo = m;
  if (m > 0 && (pi & 7) == 0 && (pk & 7) == 0 && (pi & 15) == (pk & 15))
    a.e_lo = (pi & 15) ? 1 : 0;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // one CTA an SM at most (the card holds one of 1024 threads on each, and
  // a cooperative launch refuses more than it holds), fewer where a pair
  // a thread covers the longer phase
  long long work = (a.n_total + 1) / 2;
  const long long entry_work = a.e_lo + (m - a.e_lo + 1) / 2;
  if (entry_work > work) work = entry_work;
  long long blocks = (work + INCL_THREADS - 1) / INCL_THREADS;
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k_incl_scan, dim3((unsigned)blocks),
                                          dim3(INCL_THREADS), args, 0, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K17 registry_scan
// ---------------------------------------------------------------------------
//
// One launch and one pass over the four columns.  A CTA takes a tile of
// SCAN_TILE lanes of one span, warp w the tile's w-th run of SCAN_RUN
// lanes, 32 V at a time: lane i reads lanes V i .. V i + V - 1 of each
// column (V = 2: one 16-byte load a column, where the span length is even
// and the columns start on 16 bytes; else V = 1).  A family's members in
// a step come from one ballot per element, and a member's place among
// them from __popc of the ballots below it.  The tile's offset in its
// span comes from a decoupled look-back: a tile publishes its aggregate,
// then its inclusive prefix, in one flag word per family (the status in
// the top two bits), and warps 0-2 each walk one family back over 32
// predecessors at a time to the nearest inclusive prefix.  Tiles are
// taken in blockIdx order, which the card dispatches in order (as CUB's
// single-pass scan assumes), so a tile waits only on tiles already
// running.  The active count takes one atomic per CTA.  The flags and the
// tally (the active lanes so far, the CTAs done) are zero between calls:
// the last CTA to finish writes the active count and zeroes them, so no
// memset precedes the launch.  With fill, a second kernel writes the
// slots past each span's count.

#define SCAN_TILE 2048                        // lanes per CTA
#define SCAN_RUN (SCAN_TILE / MESH_WARPS)     // lanes per warp
#define FLAG_AGG (1ull << 62)                 // status: the tile's aggregate
#define FLAG_PRE (2ull << 62)                 // status: the inclusive prefix
#define FLAG_VAL (FLAG_AGG - 1)

struct ScanArgs {
  const uint64_t *aee, *act, *ext, *eff;
  long long n_local, cap;
  int spans, tiles;
  uint64_t cur, fin, far, max_eb, ejection;
  long long* bufs;       // (3, spans * cap)
  long long* counts;     // (3, spans)
  u64* active;           // (1,)
  u64* state;            // [0] active lanes, [1] CTAs done, [2..] (3, spans, tiles) flags
};

// bit f: family f (0 queue, 1 eject, 2 eligible); bit 3: active at cur
__device__ __forceinline__ unsigned scan_bits(const ScanArgs& a, uint64_t aee, uint64_t act,
                                              uint64_t ext, uint64_t eff) {
  const bool active = act <= a.cur && a.cur < ext;
  return (unsigned)(aee == a.far && eff == a.max_eb) | ((unsigned)(active && eff <= a.ejection) << 1)
         | ((unsigned)(aee <= a.fin && act == a.far) << 2) | ((unsigned)active << 3);
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <int V>
__global__ void __launch_bounds__(MESH_THREADS) k_registry_scan(ScanArgs a) {
  constexpr int K = SCAN_RUN / (32 * V);                 // steps of a warp's run
  __shared__ u64 wcount[4][MESH_WARPS];
  __shared__ u64 excl[3];
  __shared__ int last;
  const int tile = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)s * a.n_local;
  // this thread's first lane in its span; step k adds 32 V k
  const long long first = (long long)tile * SCAN_TILE + warp * SCAN_RUN + lane * V;
  // the family bits of the thread's V lanes at each step (4 bits a lane)
  unsigned bits[K];
  if constexpr (V == 2) {
    ulonglong2 c[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + first + 64 * k;
      if (first + 64 * k < a.n_local) {
        c[k][0] = *reinterpret_cast<const ulonglong2*>(a.aee + i);
        c[k][1] = *reinterpret_cast<const ulonglong2*>(a.act + i);
        c[k][2] = *reinterpret_cast<const ulonglong2*>(a.ext + i);
        c[k][3] = *reinterpret_cast<const ulonglong2*>(a.eff + i);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      bits[k] = first + 64 * k < a.n_local
                    ? scan_bits(a, c[k][0].x, c[k][1].x, c[k][2].x, c[k][3].x)
                          | scan_bits(a, c[k][0].y, c[k][1].y, c[k][2].y, c[k][3].y) << 4
                    : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + first + 32 * k;
      bits[k] = first + 32 * k < a.n_local ? scan_bits(a, a.aee[i], a.act[i], a.ext[i], a.eff[i])
                                           : 0u;
    }
  }
  // the warp's members per family (and its active lanes): warp-uniform
  u64 cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int v = 0; v < V; ++v)
        cnt[f] += __popc(__ballot_sync(0xffffffffu, (bits[k] >> (4 * v + f)) & 1));
  if (lane == 0)
    for (int f = 0; f < 4; ++f) wcount[f][warp] = cnt[f];
  __syncthreads();
  // warp f < 3: family f's aggregate, published at once by lane 0 (tile
  // 0's is its inclusive prefix); thread 0 also adds the active lanes
  u64 agg = 0;
  if (warp < 3)
    for (int w = 0; w < MESH_WARPS; ++w) agg += wcount[warp][w];
  u64* flags = a.state + 2 + ((long long)(warp < 3 ? warp : 0) * a.spans + s) * a.tiles;
  if (warp < 3 && lane == 0) st_release(flags + tile, (tile == 0 ? FLAG_PRE : FLAG_AGG) | agg);
  if (threadIdx.x == 0) {
    u64 act = 0;
    for (int w = 0; w < MESH_WARPS; ++w) act += wcount[3][w];
    atomicAdd(a.state, act);
  }
  // warp f < 3: family f's look-back to the nearest inclusive prefix
  if (warp < 3) {
    u64 sum = 0;
    if (tile > 0) {
      for (long long end = tile - 1;; end -= 32) {
        const long long i = end - lane;           // the predecessor this lane reads
        u64 flag;
        unsigned pre, none, upto;
        do {
          flag = i >= 0 ? ld_acquire(flags + i) : FLAG_PRE;
          pre = __ballot_sync(0xffffffffu, (flag >> 62) == 2);
          none = __ballot_sync(0xffffffffu, (flag >> 62) == 0);
          upto = pre ? ((pre & (0u - pre)) << 1) - 1 : 0xffffffffu;   // lanes to the nearest prefix
        } while (none & upto);
        sum += warp_sum((upto >> lane) & 1 ? flag & FLAG_VAL : 0);
        if (pre) break;
      }
    }
    if (lane == 0) {
      excl[warp] = sum;
      if (tile > 0) st_release(flags + tile, FLAG_PRE | (sum + agg));
      if (tile == a.tiles - 1) a.counts[(long long)warp * a.spans + s] = (long long)(sum + agg);
    }
  }
  __syncthreads();
  // the members in lane order: the tile's offset, the warps before, the
  // steps before, the lanes below
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    u64 pos = excl[f];
    for (int w = 0; w < warp; ++w) pos += wcount[f][w];
    long long* buf = a.bufs + (long long)f * a.spans * a.cap + (long long)s * a.cap;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned mine = 0, total = 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const unsigned b = __ballot_sync(0xffffffffu, (bits[k] >> (4 * v + f)) & 1);
        mine += __popc(b & below);
        total += __popc(b);
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        if ((bits[k] >> (4 * v + f)) & 1) {
          if (pos + mine < (u64)a.cap) buf[pos + mine] = base + first + 32 * V * k + v;
          ++mine;
        }
      pos += total;
    }
  }
  // the last CTA to finish writes the active count and zeroes the state
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.state + 1, 1ull) == (u64)a.tiles * a.spans - 1;
  }
  __syncthreads();
  if (last) {
    if (threadIdx.x == 0) {
      a.active[0] = atomicExch(a.state, 0ull);
      a.state[1] = 0;
    }
    for (long long i = threadIdx.x; i < 3ll * a.spans * a.tiles; i += MESH_THREADS)
      a.state[2 + i] = 0;
  }
}

// fill: slot j of (family, span) past the span's count holds the span's end
__global__ void __launch_bounds__(MESH_THREADS) k_scan_fill(ScanArgs a) {
  const long long per = (long long)a.spans * a.cap;
  for (long long i = (long long)blockIdx.x * MESH_THREADS + threadIdx.x; i < 3 * per;
       i += (long long)gridDim.x * MESH_THREADS) {
    const long long f = i / per, s = (i - f * per) / a.cap, j = i - f * per - s * a.cap;
    if (j >= a.counts[f * a.spans + s]) a.bufs[i] = (s + 1) * a.n_local;
  }
}

extern "C" int registry_scan(const void* aee, const void* act, const void* ext, const void* eff,
                             long long n_local, int spans, unsigned long long cur,
                             unsigned long long fin, unsigned long long far,
                             unsigned long long max_eb, unsigned long long ejection,
                             long long cap, int tiles, int fill, void* bufs, void* counts,
                             void* active, void* state, void* stream) {
  if (spans < 1 || cap < 1 || tiles < 1 || (long long)tiles * SCAN_TILE < n_local)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ScanArgs a;
  a.aee = (const uint64_t*)aee; a.act = (const uint64_t*)act; a.ext = (const uint64_t*)ext;
  a.eff = (const uint64_t*)eff;
  a.n_local = n_local; a.cap = cap; a.spans = spans; a.tiles = tiles;
  a.cur = cur; a.fin = fin; a.far = far; a.max_eb = max_eb; a.ejection = ejection;
  a.bufs = (long long*)bufs; a.counts = (long long*)counts; a.active = (u64*)active;
  a.state = (u64*)state;
  const bool wide = n_local % 2 == 0
                    && ((uintptr_t)aee | (uintptr_t)act | (uintptr_t)ext | (uintptr_t)eff) % 16 == 0;
  dim3 grid(tiles, spans);
  if (wide)
    k_registry_scan<2><<<grid, MESH_THREADS, 0, st>>>(a);
  else
    k_registry_scan<1><<<grid, MESH_THREADS, 0, st>>>(a);
  if (fill) {
    long long b = (3ll * spans * cap + MESH_THREADS - 1) / MESH_THREADS;
    if (b > 4096) b = 4096;
    k_scan_fill<<<(int)b, MESH_THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
