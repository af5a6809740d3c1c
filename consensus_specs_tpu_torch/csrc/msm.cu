// K7 expand_windows and K8 g1_msm (see ops/msm.py).
//
// K7 replaces ops/jax_bls/msm.py:38 _expand_windows (a lax.scan of 8
// complete additions P + P per window); K8 replaces msm.py:48 _msm_core
// (points.py:244 g1_scalar_mul over 8-bit digits, :252 g1_tree_sum,
// :306 g1_normalize) together with the host digit planes of :55
// _digits_msb_bits, which K8 reads straight from the scalar words.
//
// With the window multiples W[w][i] = [2^(8w)] P_i, sum_i [k_i] P_i =
// sum_{w,i} [d_{w,i}] W[w][i] for the 32 bytes d_{w,i} of k_i.  Bound:
// integer multiply-adds (Fq products at 588 each: a doubling 9, an
// addition 14), not bytes: a window entry is 144 B against 14 products.
//
// K7 is a chain of 248 complete doublings per point, which no number of
// points shortens: its time is the chain's latency.  A team of K7_TEAM = 4
// threads makes each doubling (team_dbl, team.cuh: two waves of four
// products), eight teams a warp; the running point stays in shared memory,
// and each warp writes its eight points' window entry (8 x 36 contiguous
// words) as one coalesced store of 32 lanes.  The projective output is the
// one the plain version's complete_dbl computes (the same formulas, every
// value fully reduced), so the table is byte-identical to the plain one.
// A team of four, not K8's six: team_dbl has four products a wave.
//
// K8 is Pippenger's bucket method over that table.  Every (window, point)
// lane shares one set of 255 buckets (the table already carries the
// window's weight), and the result is sum_{d=1}^{255} d B_d with no
// per-window combination.  Stages, all on the wrapper's stream, with no
// synchronization and no allocation (the wrapper passes one scratch
// buffer sized from N, ops/msm.py msm_plan):
//   1. k_msm_hist: each block's histogram of the digits of its 1,024
//      lanes in shared memory, warp-aggregated (__match_any_sync, so a
//      warp whose lanes share one digit makes one atomic), written per
//      block; digit 0 and infinite window points are skipped;
//   2. k_msm_scan (one block): each digit's count and start, every
//      block's offset per digit, and the chunk schedule below;
//   3. k_msm_scatter: each live lane's index into bucket order (int32,
//      4 x 32 N bytes); order inside a bucket is free, since the sum is
//      a group element and the output is normalized to affine;
//   4. L level launches: level 0 (k_msm_level0) cuts every bucket's run
//      of lanes into chunks of FIRST_CHUNK window points, one thread
//      summing each chunk into one partial; each later level
//      (k_msm_level) cuts every bucket's run of partials into chunks of
//      CHUNK.  Chunks never cross a bucket, so each chunk's output lands
//      in its bucket's next run, at offsets the scan computed from the
//      counts alone (m -> ceil(m / chunk)).  No chunk adds more than
//      FIRST_CHUNK points whatever the digits: a bucket holding every
//      lane (every scalar one repeated byte) takes log2 levels, not one
//      thread's serial sum.  L = 1 + ceil(log2(ceil(32 N / FIRST_CHUNK)))
//      levels reduce the largest possible run to one point, B_d;
//   5. the combine, sum_d d B_d as sum_b 2^b G_b, G_b the sum of the
//      buckets whose digit has bit b set: k_msm_gather puts the B_d in
//      256 slots, 8 launches of k_msm_zeta run an in-place superset-sum
//      transform over the 8 digit bits (128 additions a round, spread
//      over 26 one-warp blocks) and leave G_b at slot 2^b, k_msm_weigh
//      doubles G_b b times and adds the eight;
//   6. k_msm_normalize: one thread makes the sum affine with one binary
//      extended-Euclid inversion (fq_inv.cuh).
// Level 0 is bound by the card's product rate; the later levels and the
// combine run few point operations at once, so their time is the chain
// of each: a complete addition in one thread is 14 dependent products.
// There every point operation is made by a team of 6 threads (team_add,
// team_dbl), a chain of 2 products.
// CUDA launches per call: L + 14 (30 at N = 4096 and at N = 4032, 21 at
// N = 6).  With marks (an array of MSM_MARKS events, or null) the entry
// records an event before stage 1 and after stages 1, 2, 3, level 0, the
// other levels, 5 and 6, for per-stage times.
#include <cuda_runtime.h>
#include "team.cuh"
#include "fq_inv.cuh"

#define N_WINDOWS 32
#define WINDOW_BITS 8
#define K7_TEAM 4              // threads per doubling
#define K7_TEAMS_PER_WARP 8
#define K7_WARPS 4
#define K7_THREADS (32 * K7_WARPS)
#define K7_POINTS (K7_TEAMS_PER_WARP * K7_WARPS)   // points per block
#define N_BUCKETS 256          // digit values; bucket 0 stays empty
#define DIGIT_BITS 8
#define HIST_THREADS 256       // == N_BUCKETS: one thread per digit in a block
#define HIST_LANES 4           // lanes per thread in stages 1 and 3
#define TEAM G1_TEAM           // threads per point operation
#define TEAMS_PER_WARP G1_TEAMS_PER_WARP
#define LEVEL_WARPS 4
#define LEVEL_THREADS (32 * LEVEL_WARPS)
#define LEVEL_TEAMS (TEAMS_PER_WARP * LEVEL_WARPS)
#define LEVEL0_THREADS 128
#define ZETA_TEAMS (N_BUCKETS / 2)      // one per addition of a superset-sum round
#define ZETA_BLOCKS ((ZETA_TEAMS + TEAMS_PER_WARP - 1) / TEAMS_PER_WARP)   // one warp each
#define FIRST_CHUNK 4          // window points per chunk at level 0
#define CHUNK 2                // partials per chunk at later levels
#define PT_WORDS (3 * NW)
#define MAX_LEVELS 40
#define MSM_MARKS 8

static_assert(HIST_THREADS == N_BUCKETS, "one histogram slot per thread");

__global__ void __launch_bounds__(K7_THREADS)
k_expand_windows(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ inf,
                 uint32_t* __restrict__ out, int n) {
  __shared__ Pt<Fq> cur[K7_POINTS];
  __shared__ Fq slot[K7_POINTS][K7_TEAM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tw = lane / K7_TEAM, k = lane - tw * K7_TEAM;
  const int team = warp * K7_TEAMS_PER_WARP + tw;
  const int first = blockIdx.x * K7_POINTS + warp * K7_TEAMS_PER_WARP;   // the warp's first point
  const int live = min(K7_TEAMS_PER_WARP, n - first);                    // its points
  if (live <= 0) return;                                                  // the whole warp
  const unsigned all = 0xffffffffu;
  uint32_t* mine = (uint32_t*)&cur[warp * K7_TEAMS_PER_WARP];            // 8 x 36 words
  // the warp's affine points, 24 contiguous words each, into x and y
  for (int j = lane; j < live * 2 * NW; j += 32)
    mine[(j / (2 * NW)) * 3 * NW + j % (2 * NW)] = pts[(size_t)first * 2 * NW + j];
  __syncwarp(all);
  if (k == 0) {
    Pt<Fq>& p = cur[team];
    if (tw >= live || inf[first + tw]) {
      pt_identity(p);                  // a team past the end doubles the identity, unstored
    } else {
      fq_set(p.z, FQ_ONE);
    }
  }
  __syncwarp(all);
  const int words = live * 3 * NW;
  for (int w = 0; w < N_WINDOWS; w++) {
    uint32_t* dst = out + ((size_t)w * n + first) * 3 * NW;
    for (int j = lane; j < words; j += 32) dst[j] = mine[j];
    __syncwarp(all);
    if (w + 1 < N_WINDOWS) {
      for (int b = 0; b < WINDOW_BITS; b++) team_dbl(&cur[team], &cur[team], slot[team], k, all);
    }
  }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// Scratch layout in 32-bit words, the same arithmetic as ops/msm.py
// msm_plan: per-block histograms (then offsets), the level schedule
// ((levels + 1) x 257 offsets, the last entry of a row its total), the
// sorted lane indices, two partial buffers of 36 words per point, the
// 256 buckets of the combine, the projective sum.
struct MsmPlan {
  int lanes, hist_blocks, levels;
  long long bound[MAX_LEVELS + 1];     // upper bound of each level's run total
  long long hist, sched, sorted, part_a, part_b, buckets, sum, words;
};

static int msm_plan(int n, MsmPlan& p) {
  if (n < 1 || n > (1 << 25) / N_WINDOWS) return 0;
  p.lanes = N_WINDOWS * n;
  p.hist_blocks = (p.lanes + HIST_THREADS * HIST_LANES - 1) / (HIST_THREADS * HIST_LANES);
  long long m = (p.lanes + FIRST_CHUNK - 1) / FIRST_CHUNK;
  p.levels = 1;
  while (m > 1) {
    m = (m + CHUNK - 1) / CHUNK;
    p.levels++;
  }
  if (p.levels > MAX_LEVELS) return 0;
  // sum_d ceil(m_d / c) <= floor(M / c) + 255 over at most 255 filled buckets
  long long b = p.lanes, most = 1;
  p.bound[0] = b;
  for (int k = 0; k < p.levels; k++) {
    const long long c = k ? CHUNK : FIRST_CHUNK;
    const long long nb = b / c + (N_BUCKETS - 1);
    b = nb < b ? nb : b;
    p.bound[k + 1] = b;
    if (b > most) most = b;
  }
  p.hist = 0;
  p.sched = p.hist + (long long)p.hist_blocks * N_BUCKETS;
  p.sorted = p.sched + (long long)(p.levels + 1) * (N_BUCKETS + 1);
  p.part_a = (p.sorted + p.lanes + 3) / 4 * 4;      // 16-byte aligned points
  p.part_b = p.part_a + most * PT_WORDS;
  p.buckets = p.part_b + most * PT_WORDS;
  p.sum = p.buckets + N_BUCKETS * PT_WORDS;
  p.words = p.sum + PT_WORDS;
  return 1;
}

// the bucket d of output j of a level: off[d] <= j < off[d + 1], for
// 0 <= j < off[N_BUCKETS] (empty buckets have equal offsets)
DEV int bucket_of(const int* off, int j) {
  int lo = 0, hi = N_BUCKETS;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------- stages

// lane = w * n + i: the digit (byte w of scalar i) if the lane is live (a
// non-zero digit on a finite window point), else 0
__device__ __forceinline__ int lane_digit(const uint32_t* __restrict__ windows,
                                          const uint32_t* __restrict__ scalars, int n, int lane) {
  const int w = lane / n, i = lane - w * n;
  const uint32_t d = (scalars[(size_t)i * 8 + (w >> 2)] >> (8 * (w & 3))) & 0xFFu;
  if (!d) return 0;
  const uint4* z = (const uint4*)(windows + (size_t)lane * PT_WORDS + 2 * NW);
  const uint4 a = z[0], b = z[1], c = z[2];
  const uint32_t any = a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w | c.x | c.y | c.z | c.w;
  return any ? (int)d : 0;
}

__global__ void __launch_bounds__(HIST_THREADS)
k_msm_hist(const uint32_t* __restrict__ windows, const uint32_t* __restrict__ scalars,
           int* __restrict__ bhist, int n) {
  __shared__ int hist[N_BUCKETS];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int lanes = N_WINDOWS * n, me = threadIdx.x & 31;
  const int base = blockIdx.x * HIST_THREADS * HIST_LANES;
  for (int k = 0; k < HIST_LANES; k++) {
    const int lane = base + k * HIST_THREADS + threadIdx.x;
    const int d = lane < lanes ? lane_digit(windows, scalars, n, lane) : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d && me == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  bhist[(size_t)blockIdx.x * N_BUCKETS + threadIdx.x] = hist[threadIdx.x];
}

// exclusive prefix of v over the block's N_BUCKETS threads; *total: the sum
__device__ int bucket_scan(int v, int* total) {
  __shared__ int warp_sum[N_BUCKETS / 32 + 1];
  const int me = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, x, o);
    if (me >= o) x += u;
  }
  if (me == 31) warp_sum[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < N_BUCKETS / 32; w++) {
      const int s = warp_sum[w];
      warp_sum[w] = run;
      run += s;
    }
    warp_sum[N_BUCKETS / 32] = run;
  }
  __syncthreads();
  const int excl = x - v + warp_sum[warp];
  *total = warp_sum[N_BUCKETS / 32];
  __syncthreads();
  return excl;
}

// one block, thread d = digit d: counts, per-block offsets (in place of
// the histograms) and the level schedule sched[k][0..256]
__global__ void __launch_bounds__(N_BUCKETS)
k_msm_scan(int* __restrict__ bhist, int* __restrict__ sched, int hist_blocks, int levels) {
  const int d = threadIdx.x;
  int count = 0;
  for (int b = 0; b < hist_blocks; b++) count += bhist[(size_t)b * N_BUCKETS + d];
  int total;
  int run = bucket_scan(count, &total);
  for (int b = 0; b < hist_blocks; b++) {
    const int c = bhist[(size_t)b * N_BUCKETS + d];
    bhist[(size_t)b * N_BUCKETS + d] = run;
    run += c;
  }
  int m = count;
  for (int k = 0; k <= levels; k++) {
    const int off = bucket_scan(m, &total);
    sched[k * (N_BUCKETS + 1) + d] = off;
    if (d == 0) sched[k * (N_BUCKETS + 1) + N_BUCKETS] = total;
    const int c = k ? CHUNK : FIRST_CHUNK;
    m = (m + c - 1) / c;
  }
}

__global__ void __launch_bounds__(HIST_THREADS)
k_msm_scatter(const uint32_t* __restrict__ windows, const uint32_t* __restrict__ scalars,
              const int* __restrict__ boff, int* __restrict__ sorted, int n) {
  __shared__ int off[N_BUCKETS];
  off[threadIdx.x] = boff[(size_t)blockIdx.x * N_BUCKETS + threadIdx.x];
  __syncthreads();
  const int lanes = N_WINDOWS * n, me = threadIdx.x & 31;
  const int base = blockIdx.x * HIST_THREADS * HIST_LANES;
  for (int k = 0; k < HIST_LANES; k++) {
    const int lane = base + k * HIST_THREADS + threadIdx.x;
    const int d = lane < lanes ? lane_digit(windows, scalars, n, lane) : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d) {
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (me == leader) pos = atomicAdd(&off[d], __popc(peers));
      pos = __shfl_sync(peers, pos, leader);
      sorted[pos + __popc(peers & ((1u << me) - 1u))] = lane;
    }
  }
}

// level 0: thread j sums one chunk of FIRST_CHUNK window points of its
// bucket, through the sorted lane indices (this level is bound by the
// card's product rate, not by a chain, so one thread per chunk)
__global__ void __launch_bounds__(LEVEL0_THREADS)
k_msm_level0(const uint32_t* __restrict__ windows, const int* __restrict__ sorted,
             uint32_t* __restrict__ dst, const int* __restrict__ sched) {
  __shared__ int out_off[N_BUCKETS + 1];
  for (int t = threadIdx.x; t <= N_BUCKETS; t += LEVEL0_THREADS)
    out_off[t] = sched[(N_BUCKETS + 1) + t];
  __syncthreads();
  const int j = blockIdx.x * LEVEL0_THREADS + threadIdx.x;
  if (j >= out_off[N_BUCKETS]) return;
  const int d = bucket_of(out_off, j);
  const int s = sched[d] + (j - out_off[d]) * FIRST_CHUNK;
  const int e = min(s + FIRST_CHUNK, sched[d + 1]);
  const Pt<Fq>* pts = (const Pt<Fq>*)windows;
  Pt<Fq> acc = pts[sorted[s]];
  for (int t = s + 1; t < e; t++) pt_add(acc, acc, pts[sorted[t]]);
  ((Pt<Fq>*)dst)[j] = acc;
}

// a later level: output j sums one chunk of CHUNK partials of its bucket,
// by one team
__global__ void __launch_bounds__(LEVEL_THREADS)
k_msm_level(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
            const int* __restrict__ sched, int level) {
  __shared__ int out_off[N_BUCKETS + 1];
  __shared__ Pt<Fq> acc[LEVEL_TEAMS];
  __shared__ Fq slot[LEVEL_TEAMS][TEAM];
  const int* in_off = sched + level * (N_BUCKETS + 1);
  for (int t = threadIdx.x; t <= N_BUCKETS; t += LEVEL_THREADS)
    out_off[t] = sched[(level + 1) * (N_BUCKETS + 1) + t];
  __syncthreads();
  int k;
  unsigned mask;
  const int team = team_of(k, mask);
  const int j = blockIdx.x * LEVEL_TEAMS + team;
  if (team < 0 || j >= out_off[N_BUCKETS]) return;
  const int d = bucket_of(out_off, j);
  const int s = in_off[d] + (j - out_off[d]) * CHUNK;
  const int e = min(s + CHUNK, in_off[d + 1]);
  const Pt<Fq>* pts = (const Pt<Fq>*)src;
  copy_coord(&acc[team], pts + s, k);
  __syncwarp(mask);
  for (int t = s + 1; t < e; t++) team_add(&acc[team], &acc[team], pts + t, slot[team], k, mask);
  copy_coord((Pt<Fq>*)dst + j, &acc[team], k);
}

// sum_d d B_d = sum_b 2^b G_b, G_b the sum of the buckets whose digit
// has bit b set.  The buckets B_d (identity where empty; fin: the last
// level's offsets) go to 256 slots, then 8 launches of an in-place
// superset-sum transform (round b: 128 team additions sh[d] += sh[d + 2^b]
// for d without bit b, one warp a block, so no SM runs more than 5 of
// them) leave G_b in slot 2^b; one block doubles G_b b times and adds the
// eight.
__global__ void __launch_bounds__(N_BUCKETS)
k_msm_gather(const uint32_t* __restrict__ parts, const int* __restrict__ fin,
             uint32_t* __restrict__ buckets) {
  const int d = threadIdx.x;
  Pt<Fq>* out = (Pt<Fq>*)buckets + d;
  if (d && fin[d + 1] > fin[d]) {
    *out = ((const Pt<Fq>*)parts)[fin[d]];
  } else {
    pt_identity(*out);
  }
}

__global__ void __launch_bounds__(32) k_msm_zeta(uint32_t* __restrict__ buckets, int b) {
  __shared__ Fq slot[TEAMS_PER_WARP][TEAM];
  int k;
  unsigned mask;
  const int tw = team_of(k, mask), team = blockIdx.x * TEAMS_PER_WARP + tw;
  if (tw < 0 || team >= ZETA_TEAMS) return;
  const int m = 1 << b, d = ((team >> b) << (b + 1)) | (team & (m - 1));   // bit b clear
  Pt<Fq>* sh = (Pt<Fq>*)buckets;
  team_add(&sh[d], &sh[d], &sh[d | m], slot[tw], k, mask);
}

__global__ void __launch_bounds__(64)
k_msm_weigh(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ sum) {
  __shared__ Pt<Fq> g[DIGIT_BITS];
  __shared__ Fq slot[2 * TEAMS_PER_WARP][TEAM];
  int k;
  unsigned mask;
  const int team = team_of(k, mask);
  if (team >= 0 && team < DIGIT_BITS) {
    copy_coord(&g[team], (const Pt<Fq>*)buckets + (1 << team), k);
    __syncwarp(mask);
    for (int i = 0; i < team; i++) team_dbl(&g[team], &g[team], slot[team], k, mask);
  }
  __syncthreads();
  for (int w = DIGIT_BITS / 2; w > 0; w >>= 1) {
    if (team >= 0 && team < w) team_add(&g[team], &g[team], &g[team + w], slot[team], k, mask);
    __syncthreads();
  }
  if (team == 0) copy_coord((Pt<Fq>*)sum, &g[0], k);
}

// the sum, affine, with one inversion
__global__ void k_msm_normalize(const uint32_t* __restrict__ sum, uint32_t* __restrict__ out,
                                uint8_t* __restrict__ out_inf) {
  if (threadIdx.x) return;
  const Pt<Fq> p = *(const Pt<Fq>*)sum;
  Fq x, y;
  const bool inf = fq_is_zero(p.z);
  if (inf) {
    fq_zero(x);
    fq_zero(y);
  } else {
    Fq zi;
    fq_inv_binary(zi, p.z);
    fq_mul(x, p.x, zi);
    fq_mul(y, p.y, zi);
  }
  fq_store(out, x);
  fq_store(out + NW, y);
  out_inf[0] = inf ? 1 : 0;
}

extern "C" int expand_windows(const void* pts, const void* inf, void* out, int n,
                              void* stream) {
  k_expand_windows<<<(n + K7_POINTS - 1) / K7_POINTS, K7_THREADS, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)pts, (const uint8_t*)inf,
                                             (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int g1_msm(const void* windows, const void* scalars, void* scratch,
                      long long scratch_words, void* out, void* out_inf, int n, void* marks,
                      void* stream) {
  MsmPlan p;
  if (!msm_plan(n, p) || scratch_words < p.words) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = (cudaEvent_t*)marks;
  int* base = (int*)scratch;
  int *bhist = base + p.hist, *sched = base + p.sched, *sorted = base + p.sorted;
  uint32_t* part[2] = {(uint32_t*)(base + p.part_a), (uint32_t*)(base + p.part_b)};
  const uint32_t* win = (const uint32_t*)windows;
  const uint32_t* sc = (const uint32_t*)scalars;
  int rc;
#define MSM_CHECK()                               \
  if ((rc = (int)cudaGetLastError()) != 0) return rc
  if (ev) cudaEventRecord(ev[0], s);
  k_msm_hist<<<p.hist_blocks, HIST_THREADS, 0, s>>>(win, sc, bhist, n);
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[1], s);
  k_msm_scan<<<1, N_BUCKETS, 0, s>>>(bhist, sched, p.hist_blocks, p.levels);
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[2], s);
  k_msm_scatter<<<p.hist_blocks, HIST_THREADS, 0, s>>>(win, sc, bhist, sorted, n);
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[3], s);
  k_msm_level0<<<(int)((p.bound[1] + LEVEL0_THREADS - 1) / LEVEL0_THREADS), LEVEL0_THREADS, 0, s>>>(
      win, sorted, part[0], sched);
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[4], s);
  for (int k = 1; k < p.levels; k++) {
    const int blocks = (int)((p.bound[k + 1] + LEVEL_TEAMS - 1) / LEVEL_TEAMS);
    k_msm_level<<<blocks, LEVEL_THREADS, 0, s>>>(part[(k + 1) & 1], part[k & 1], sched, k);
    MSM_CHECK();
  }
  if (ev) cudaEventRecord(ev[5], s);
  uint32_t* buckets = (uint32_t*)(base + p.buckets);
  k_msm_gather<<<1, N_BUCKETS, 0, s>>>(part[(p.levels - 1) & 1],
                                      sched + p.levels * (N_BUCKETS + 1), buckets);
  MSM_CHECK();
  for (int b = 0; b < DIGIT_BITS; b++) {
    k_msm_zeta<<<ZETA_BLOCKS, 32, 0, s>>>(buckets, b);
    MSM_CHECK();
  }
  k_msm_weigh<<<1, 64, 0, s>>>(buckets, (uint32_t*)(base + p.sum));
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[6], s);
  k_msm_normalize<<<1, 32, 0, s>>>((const uint32_t*)(base + p.sum), (uint32_t*)out,
                                   (uint8_t*)out_inf);
  MSM_CHECK();
  if (ev) cudaEventRecord(ev[7], s);
#undef MSM_CHECK
  return 0;
}
