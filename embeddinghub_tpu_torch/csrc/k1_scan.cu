// K1 for Hopper (sm_90a): exact k-NN over the f32 arena with a compensated
// TF32 product on the tensor cores, the arena by TMA, and its route for
// large k.
//
// Replaces the Pallas kernel fused_topk_search (_kernel, exact) of
// embeddinghub_tpu/ops/pallas_topk.py:124 -> ehtorch_fused_topk (running
// lists, k <= 512) and ehtorch_large_k (any k up to the capacity).  (K2,
// fused_topk_search_v2, is k2_scan.cu.)
//
// It computes, for every query b, the k smallest scores over the live rows
// of a row-major [cap, D] f32 arena without writing the [B, cap] score
// matrix to device memory.  The score is ||x||^2 - 2 q.x for l2 and -q.x
// for ip/cosine (cosine queries arrive normalized); dead rows and rows past
// cap score +inf.  exact=1 keeps f32-grade products (the twin of
// Precision.HIGHEST on the MXU, itself a multi-pass product); exact=0
// rounds both operands to bf16 first.
//
// Bound on an H100 at the main path's shape (1M x 128, B=4096, k=16):
// three TF32 passes are 3*2*B*cap*D = 3.3e12 flops, 6.66 ms at 495 TFLOP/s
// (the same product on f32 FMA: 16.4 ms at 67 TFLOP/s); the bytes (the
// 512 MiB arena once) take 0.16 ms, so the product bounds it.  At B <= 16
// the bytes do.
//
// Design:
//  1. The product.  Each f32 operand v is split into big = tf32(v) (round
//     to nearest) and small = tf32(v - big); q.x is taken as big.small +
//     small.big + big.big, the small terms first in each 8-deep step.
//     That keeps 22 mantissa bits of each operand; the dropped small.small
//     term is below 2^-22 |q||x|.  The tensor cores sum up to 128 columns
//     (48 products) in one chain; wider rows add those chains in f32
//     registers, because the tensor cores truncate every accumulation: one
//     chain over D = 600 read 4e-4 low at |q.x| = 110.  A bf16 value is
//     exact in TF32, so exact=0 is the same kernel with one pass.
//  2. Operands.  wgmma m64nNk8 takes the arena tile as A from registers and
//     the queries as B from shared memory, both K-major as stored.  A block
//     owns N queries for its whole scan, N in {8, 16, 32, 64, 128} as
//     narrow as the batch (pick_nq), split once into a q_big and a q_small
//     tile in the 128-byte swizzled layout wgmma reads.  Arena tiles of 128
//     rows (64 per consumer warpgroup) come through shared memory in boxes
//     of 32 columns; each consumer thread loads its A fragments of a box
//     (conflict-free 4-byte loads along the swizzle), splits them in
//     registers (no second copy of the arena anywhere) and frees the box.
//     Two sets of fragments take the boxes in turn, so one box is loaded
//     and split while the other's products run.  Tiles and ring by width
//     (shared memory is 227 KB): D <= 128 gets N up to 128 (its two query
//     tiles are 128 KB at D = 128) and a ring of 4 or 5 boxes, up to 8 at
//     N <= 64; wider rows narrow N until four boxes fit beside the query
//     tiles (D = 300: N = 32; D = 600: N = 16), so a wide arena is read
//     from L2 more often but never from a second layout.  Rows so wide that
//     not even N = 8 leaves room for four boxes (past about 2,400 columns,
//     twice that with bf16 operands) keep N = 8 and walk the width in
//     chunks (CHUNKED): the query tiles hold qb boxes of the width at a
//     time, and the consumers split the next qb boxes of their queries into
//     the tiles' place once the products on the last are done, so no width
//     is too large for the block's shared memory.
//  3. The stream.  One producer thread issues TMA loads (boxes of 128 rows
//     x 32 f32 columns, 16 KB, the 128-byte swizzle; zeros past D and past
//     cap) into a ring of full/empty mbarriers, and each tile's bias (x_sq
//     or 0 where live, +inf where dead or past cap: row_bias_kernel) into a
//     ring of its own, so a score is one FMA and a dead row never wins.  A
//     tiled map needs rows a multiple of 16 bytes apart: the index keeps
//     its arena in rows padded to 4 floats (ops/fused_topk.py arena_f32).
//  4. The epilogue on the accumulators (SCAN, LONG).  A thread compares
//     its scores, four at a time, with its queries' thresholds (thr, one
//     float a query in shared memory).  What passes goes as (score, row) to
//     the query's queue in shared memory (push_group, out of line); one
//     barrier with an OR per tile tells the block whether a queue was full,
//     and only then the consumer warps drain queues into the running lists
//     and the threads try again.  A last drain ends the scan.  After the
//     first tiles little passes: the epilogue is an FMA and a minimum per
//     score and one barrier per tile.  One accumulator per warpgroup: with
//     three passes the epilogue is a tenth of a tile's products.  Rows of a
//     tile do not arrive in order, so lists keep (score, row) keys: lower
//     row first on ties, whatever the order candidates come in.
//     - k <= 32 (SCAN): a warp per query, its list in registers (an entry
//       a lane) while the queue drains into it one candidate at a time;
//       the lists in shared memory when they fit, else in the [k] slot of
//       the partial output.
//     - 32 < k <= 512 (LONG, the graph engine's pools): the lists live in
//       the partial output, each sorted by key.  An insert into an unsorted
//       list in device memory cost a re-scan of the list (the 1M-row graph
//       pool took 33.6 ms, 18.7 of them in drains, on an H100), so a drain
//       now reads a list whole and coalesced (up to 16 keys a lane),
//       sorts 32 or 128 queued candidates in registers (warp bitonic sort),
//       merges them in one bitonic merge against the list's reversed tail
//       and writes the list back: O(k log k) a drain, not O(k) a candidate.
//       The queues are deeper (up to 128 slots, a ring of 4 boxes: deeper
//       rings measured slower), a queue drains once a quarter full, and any
//       free warp takes the next query.  The k-th best of one split bounds
//       the query's k best from above, but weakly (it has seen a split's
//       rows only), so the splits of a query share a bound in device memory:
//       each publishes its ceil(k / splits)-th best, and the largest of
//       those is a bound too (k rows lie at or below it) that falls as the
//       union's k-th best does.  A list's threshold is the lesser of its
//       own k-th best and that bound, which took the candidates a 1M-row
//       pool's list merges from 2,086 to 1,128.
//  5. STORE, the first pass of the large-k route, writes the biased scores
//     instead: staged per tile as [N queries][128 rows] in shared memory,
//     then 512 contiguous bytes a query to the [B, row_len] buffer.
//  6. Splits and the merge.  Blocks of N queries along x, slices of the
//     arena along y fill the SMs in one wave; merge_kernel sorts each
//     query's splits * k partial entries by (score, id) and applies the
//     epilogue of pallas_topk.py:187-192 (emit, topk_common.cuh).
//
// K1 past k = 512, and over few rows a k (ehtorch_large_k; the wrapper's
// k1_route picks it from the shape).  Lists past 16 keys a lane would not
// fit the registers beside the accumulators, and the merge sorts splits*k
// entries in shared memory, so a large k takes another route, with no
// bound on k but the arena's capacity; so does a pool whose list is a
// large share of its rows, where the lists lose to it (the graph build's
// routed pool, k = 257 over 32,768 rows; PERF.md has the times).  The
// wrapper takes the queries in groups whose [B, cap] scores fit a bounded
// buffer, which the scan (MODE STORE) fills.  Every (score, row) is one
// 64-bit key, the order of the merge's sort, and the k-th smallest key per
// query is found by radix select, 8 bits a pass: radix_buf_kernel (HIST)
// counts the keys that match the digits chosen so far into a 256-bin
// histogram per query, and radix_select_kernel picks the next digit.  The
// four score digits run for every query; the row digits are launched too,
// and their blocks return at once for a query whose k-th score does not
// tie (need = 0), so nothing is read back to the host between launches.  A
// last pass (COLLECT) writes each query's keys up to its k-th into a
// [B, slots] buffer; a bitonic sort and radix_emit_kernel apply the same
// epilogue as the merge.
//
// A kernel launches on the caller's stream and allocates nothing.  Each C
// entry returns 0, a CUDA error code, NO_LIBCUDA / ENCODE_FAILED + the
// CUresult when a tensor map cannot be made, or BAD_TILE.

#include <cuda_bf16.h>

#include "hopper_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int TILE = 128;                    // arena rows per tile, 64 a warpgroup
constexpr int BOXC = 32;                     // f32 columns per TMA box: the 128-byte swizzle span
constexpr int STAGE_BYTES = TILE * BOXC * 4; // one box: 16 KB
constexpr int THREADS = 384;                 // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 256;                // the thread that issues every TMA load
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;            // setmaxnreg: the producer gives up
constexpr int CONSUMER_REGS = 232;           // registers the consumers take
constexpr int BIAS_STAGES = 4;               // ring of per-tile bias
constexpr int BIAS_BYTES = TILE * 4;
constexpr int MAX_STAGES = 8;                // ring depth at most
constexpr int MIN_STAGES = 4;                // else the query tile narrows
constexpr int MIN_QUEUE = 8;                 // queue slots per query at least
constexpr int MAX_QUEUE = 32;
constexpr int LONG_QUEUE = 128;              // queue slots per query at most, long lists
constexpr int LONG_STAGES = 4;               // ring depth at most, long lists: the queues first
constexpr int MAX_LONG_K = 512;              // 16 keys a lane; larger k: the large-k route
constexpr int ST_STRIDE = TILE + 4;          // STORE staging row: conflict-free, 16-byte rows
constexpr int MAX_NQ = 128;
constexpr int CHAIN = 4;                     // boxes the tensor cores sum before a flush
constexpr int BAD_TILE = 9998;
constexpr int DRAIN = 1;                     // named barrier of the consumers
constexpr float ROOM = 3.4028234e38f;        // the largest finite score: a list with room takes any
constexpr unsigned ROOM_BOUND = 0xff7fffffu;  // pack(ROOM, id) >> 32

enum Mode { SCAN = 0, STORE = 1, LONG = 2 };  // LONG: SCAN for 32 < k <= MAX_LONG_K

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to TF32 (to nearest, ties away), as f32 bits with 13 low zeros.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Shared memory of the scan, from its 1024-byte aligned base: q_big (and
// q_small), the ring, the bias ring, the queues (SCAN) or the staged
// scores (STORE), the per-query state, the mbarriers.
struct Layout {
  int nb;      // boxes across the width: ceil(D / 32)
  int qb;      // boxes a query tile holds: nb, and a zero box after an odd count
               // (the products go box pair by box pair); fewer when the
               // width is walked in chunks, then a multiple of CHAIN
  int nq;      // queries per block (N)
  int split;   // 1: q_small follows q_big (exact); 0: one pass (bf16 operands)
  int stages;  // ring depth
  int qd;      // queue slots per query (SCAN, LONG)
  int store;
  int k;       // SCAN, LONG: the lists' length
  int lists;   // SCAN: the running lists sit in shared memory (else in pd/pi)
  __host__ __device__ int whole() const { return nb + (nb & 1); }
  __host__ __device__ int q_bytes() const { return qb * nq * 128; }
  __host__ __device__ int ring_off() const { return q_bytes() * (split ? 2 : 1); }
  __host__ __device__ int bias_off() const { return ring_off() + stages * STAGE_BYTES; }
  __host__ __device__ int work_off() const { return bias_off() + BIAS_STAGES * BIAS_BYTES; }
  __host__ __device__ int work_bytes() const {
    return store ? nq * ST_STRIDE * 4 : nq * qd * 8;
  }
  __host__ __device__ int list_off() const { return work_off() + work_bytes(); }
  __host__ __device__ int state_off() const { return list_off() + (lists ? nq * k * 8 : 0); }
  __host__ __device__ int bar_off() const { return state_off() + 2 * nq * 4 + 8; }
  __host__ __device__ int bytes() const {
    return bar_off() + (2 * stages + 2 * BIAS_STAGES) * 8 + 1024;  // + alignment slack
  }
};

// The deepest ring that fits beside everything else (0: nothing fits).
int ring_depth(Layout L) {
  L.stages = 0;
  const int room = SMEM_LIMIT - L.bytes();
  return room < 0 ? 0 : min(MAX_STAGES, room / (STAGE_BYTES + 16));
}

// k = 0 sizes the block without lists (pick_nq).  k <= 32 (SCAN): the
// lists go to shared memory when a ring of MIN_STAGES boxes still fits
// beside them (k <= 16 at N = 128 and D = 128; more at narrower tiles).
// k > 32 (LONG): the lists stay in pd/pi.  The ring takes what is left, up
// to MAX_STAGES boxes (LONG_STAGES for long lists: a drain costs a pass
// over the whole list, so their queues come first), then the queues grow
// to MAX_QUEUE (SCAN) or LONG_QUEUE slots.
Layout scan_layout(int D, int nq, int bf16, int mode, int k) {
  Layout L{};
  L.nb = (D + BOXC - 1) / BOXC;
  L.nq = nq;
  L.split = !bf16;
  L.store = mode == STORE;
  L.k = k;
  L.qd = MIN_QUEUE;
  L.qb = L.whole();
  if (nq == 8 && ring_depth(L) < MIN_STAGES) {
    // The narrowest tile of rows this wide leaves no room for the ring:
    // the query tiles take what a ring of MIN_STAGES boxes leaves.
    L.qb = 0;
    const int room = SMEM_LIMIT - L.bytes() - MIN_STAGES * (STAGE_BYTES + 16);
    L.qb = room / (nq * 128 * (L.split ? 2 : 1)) / CHAIN * CHAIN;
  }
  if (mode == SCAN && k > 0) {
    L.lists = 1;
    if (ring_depth(L) < MIN_STAGES) L.lists = 0;
  }
  L.stages = ring_depth(L);
  if (mode == LONG) L.stages = min(L.stages, LONG_STAGES);
  if (mode != STORE && L.stages > 0)
    L.qd = min(mode == LONG ? LONG_QUEUE : MAX_QUEUE,
               MIN_QUEUE + (SMEM_LIMIT - L.bytes()) / (nq * 8));
  return L;
}

// The query tile's width for a batch: the narrowest of 8 .. 128 (64 for
// STORE, whose staged scores take the queues' place) that holds B,
// narrowed while the ring would be under MIN_STAGES boxes.
int pick_nq(int B, int D, int bf16, int store) {
  // 128 queries only beside rows of one chain (k1_scan_kernel, WIDE)
  const int most = store || D > CHAIN * BOXC ? 64 : MAX_NQ;
  int nq = 8;
  while (nq < most && nq < B) nq *= 2;
  while (nq > 8 && scan_layout(D, nq, bf16, store ? STORE : SCAN, 0).stages < MIN_STAGES)
    nq /= 2;
  return nq;
}

// Keeps the compiler from moving reads of the accumulators above the wait.
template <int NA>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bar.red.or over the consumers: true when any of them passes true.
__device__ __forceinline__ bool consumers_any(bool mine) {
  uint32_t any;
  asm volatile(
      "{\n"
      ".reg .pred p, r;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred r, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, r;\n"
      "}\n"
      : "=r"(any)
      : "r"((uint32_t)mine), "n"(DRAIN), "n"(CONSUMERS)
      : "memory");
  return any != 0;
}

// The per-query state of a block's running lists, in shared memory.  A list
// entry is a (score, row) pair, ordered as its packed key; an empty slot is
// (+inf, -1), the largest key but the padding's.
struct Lists {
  float* thr;   // [N] the score a candidate must not exceed: the k-th best, ROOM
                //     while the list has room, -inf for a query past B
  int* qcnt;    // [N] candidates queued since the last drain (may pass qd)
  int* next;    // LONG: the next query a warp takes in a drain
  float* qs;    // [N][qd] queued scores
  int* qr;      // [N][qd] ... and rows
  int qd;
  unsigned* bound;  // LONG: [B][splits] each split's m-th best so far, as the
                    // high half of its key (shared_bound)
};

// The largest of the lanes' keys and the first lane that holds it.
__device__ __forceinline__ void warp_max(unsigned long long key, unsigned long long& m,
                                         int& at) {
  m = key;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, m, off);
    m = o > m ? o : m;
  }
  at = __ffs(__ballot_sync(FULL, key == m)) - 1;
}

// MODE SCAN (k <= 32): one warp empties query qq's queue into its list
// ld/li [k], held in registers meanwhile, an entry a lane: a candidate
// whose key is smaller than the worst entry's replaces it.
__device__ __forceinline__ void drain_query(const Lists& s, int qq, float* ld,
                                            int* li, int k, int lane) {
  const int cnt = min(s.qcnt[qq], s.qd);
  if (cnt == 0) return;
  unsigned long long worst;
  unsigned long long key = lane < k ? pack(ld[lane], li[lane]) : 0ull;
  int at;
  warp_max(key, worst, at);
  for (int e = 0; e < cnt; ++e) {
    const unsigned long long c = pack(s.qs[qq * s.qd + e], s.qr[qq * s.qd + e]);
    if (c < worst) {
      if (lane == at) key = c;
      warp_max(key, worst, at);
    }
  }
  if (lane < k) {
    ld[lane] = unpack_score(key);
    li[lane] = (int)(unsigned)key;
  }
  __syncwarp();
  if (lane == 0) {
    s.thr[qq] = fminf(unpack_score(worst), ROOM);
    s.qcnt[qq] = 0;
  }
}

// Keys held striped across a warp: element m * 32 + lane of a sequence in
// register m of that lane.
__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long kmax(unsigned long long a, unsigned long long b) {
  return a < b ? b : a;
}

// Ascending bitonic sort of the warp's 32 * M striped keys.
template <int M>
__device__ __forceinline__ void warp_sort(unsigned long long (&c)[M], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * M; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // pairs within a lane: registers m and m + stride / 32
        const int ms = stride >> 5;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (m & ms) continue;
          const bool up = ((m << 5) & size) == 0;
          const unsigned long long a = c[m], b = c[m | ms];
          c[m] = up ? kmin(a, b) : kmax(a, b);
          c[m | ms] = up ? kmax(a, b) : kmin(a, b);
        }
      } else {  // pairs across lanes lane, lane ^ stride
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const unsigned long long o = __shfl_xor_sync(FULL, c[m], stride);
          const bool up = (((m << 5) | lane) & size) == 0;
          c[m] = (((lane & stride) == 0) == up) ? kmin(c[m], o) : kmax(c[m], o);
        }
      }
    }
  }
}

// Ascending bitonic merge of the warp's 32 * E striped keys, a bitonic
// sequence.
template <int E>
__device__ __forceinline__ void warp_merge(unsigned long long (&a)[E], int lane) {
#pragma unroll
  for (int js = E >> 1; js > 0; js >>= 1)
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j & js) continue;
      const unsigned long long lo = kmin(a[j], a[j | js]), hi = kmax(a[j], a[j | js]);
      a[j] = lo;
      a[j | js] = hi;
    }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const unsigned long long o = __shfl_xor_sync(FULL, a[j], stride);
      a[j] = (lane & stride) ? kmax(a[j], o) : kmin(a[j], o);
    }
}

// One batch of the warp's long-list drain: the queue's candidates p0 ..
// p0 + 32 M - 1 (padding past cnt) sorted, set against the tail of the
// sorted list a (32 E keys) reversed, the smaller of each pair kept (a
// bitonic sequence that holds the 32 E smallest of both), and merged.
template <int E, int M>
__device__ __forceinline__ void merge_batch(unsigned long long (&a)[E], const float* qs,
                                            const int* qr, int p0, int cnt, int lane) {
  unsigned long long c[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int p = p0 + (m << 5) + lane;
    c[m] = p < cnt ? pack(qs[p], qr[p]) : ~0ull;
  }
  warp_sort<M>(c, lane);
#pragma unroll
  for (int m = 0; m < M; ++m)
    a[E - 1 - m] = kmin(a[E - 1 - m], __shfl_xor_sync(FULL, c[m], 31));
  warp_merge<E>(a, lane);
}

// The bound a split may prune query q's candidates with, from what every
// split of the query has published (bound [B][splits]: the high half of
// the key of each split's m-th best, m = ceil(k / splits)): the largest.
// Every split holds m rows at or below its own, so k rows lie at or below
// the largest, and so does the query's k-th best.  ROOM until every split
// has m rows.
__device__ __forceinline__ float shared_bound(const unsigned* bound, int q, int lane) {
  const int splits = gridDim.y;
  unsigned v = 0;
  for (int sp = lane; sp < splits; sp += 32) v = max(v, __ldcg(bound + (size_t)q * splits + sp));
#pragma unroll
  for (int off = 16; off; off >>= 1) v = max(v, __shfl_xor_sync(FULL, v, off));
  return unpack_score((unsigned long long)v << 32);
}

// MODE LONG (32 < k <= 512): one warp merges query qq's queue into its
// sorted list ld/li [k] (ascending by key) when its queue holds at least
// `least` candidates.  The list comes in whole, coalesced, as 32 * E keys
// (E = next_pow2(k) / 32; padding past k), the queue 32 candidates at a
// time, or 128 for lists of 129 to 256 (merge_batch); the first k go back.
// The threshold is the lesser of the list's k-th score and the splits'
// shared bound (shared_bound; this split publishes its m-th best), which
// falls with all the rows the query's splits have seen, not only this
// split's: a split prunes as if it scanned them all.  A query that is not
// drained takes the bound the splits have reached.
template <int E>
__device__ __forceinline__ void drain_long(const Lists& s, int qq, int q, float* ld,
                                           int* li, int k, int lane, int least) {
  const int cnt = min(s.qcnt[qq], s.qd);
  if (cnt < least) {
    const float shared = shared_bound(s.bound, q, lane);
    if (lane == 0) s.thr[qq] = fminf(s.thr[qq], shared);
    return;
  }
  unsigned long long a[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = (j << 5) | lane;
    a[j] = i < k ? pack(ld[i], li[i]) : ~0ull;
  }
  const float* qs = s.qs + qq * s.qd;
  const int* qr = s.qr + qq * s.qd;
  for (int p0 = 0; p0 < cnt;) {
    if (E == 8 && cnt - p0 > 64) {  // the graph pools' lists (k = 129 .. 256)
      merge_batch<E, E == 8 ? 4 : 1>(a, qs, qr, p0, cnt, lane);
      p0 += 128;
    } else {
      merge_batch<E, 1>(a, qs, qr, p0, cnt, lane);
      p0 += 32;
    }
  }
  const int splits = gridDim.y;
  const int m = (k + splits - 1) / splits;
  unsigned long long kth = a[0], mth = a[0];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = (j << 5) | lane;
    if (i < k) {
      ld[i] = unpack_score(a[j]);
      li[i] = (int)(unsigned)a[j];
    }
    if (j == (k - 1) >> 5) kth = a[j];
    if (j == (m - 1) >> 5) mth = a[j];
  }
  kth = __shfl_sync(FULL, kth, (k - 1) & 31);
  mth = __shfl_sync(FULL, mth, (m - 1) & 31);
  if (lane == 0) s.bound[(size_t)q * splits + blockIdx.y] = (unsigned)(mth >> 32);
  __syncwarp();
  const float shared = shared_bound(s.bound, q, lane);
  if (lane == 0) {
    s.thr[qq] = fminf(fminf(unpack_score(kth), shared), ROOM);
    s.qcnt[qq] = 0;
  }
}

// The four scores a thread holds for one pair of queries (qc, qc + 1) and
// its two rows (row, row + 8), in the accumulator's order (row, qc),
// (row, qc + 1), (row + 8, qc), (row + 8, qc + 1): each one at most its
// query's threshold goes to that query's queue.  Returns a bit per score
// that found its queue full.  Out of line on purpose: inlined, ptxas
// predicates this rare path into every score's common path (a tile's
// epilogue took 3,600 cycles instead of a few hundred).
__device__ __noinline__ unsigned push_group(const Lists s, float thx, float thy,
                                            float s0, float s1, float s2, float s3,
                                            int qc, int row) {
  const float sc[4] = {s0, s1, s2, s3};
  const uint32_t qcnt = smem_u32(s.qcnt);
  unsigned full = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (sc[f] <= ((f & 1) ? thy : thx)) {
      const int q = qc + (f & 1);
      int pos;
      asm volatile("atom.shared.add.u32 %0, [%1], 1;"
                   : "=r"(pos)
                   : "r"(qcnt + 4 * q)
                   : "memory");
      if (pos < s.qd) {
        s.qs[q * s.qd + pos] = sc[f];
        s.qr[q * s.qd + pos] = row + ((f & 2) ? 8 : 0);
      } else {
        full |= 1u << f;
      }
    }
  }
  return full;
}

// MODE SCAN and LONG are K1: pd/pi [B, splits, k] take each block's running
// lists (LONG: sorted by key, from the first drain on).
// MODE STORE, the first pass of the large-k route, leaves them alone and
// writes every score to scores [B][row_len], row_len = n_tiles * 128 (+inf
// for dead rows and rows past cap).
//
// Warp w of a consumer warpgroup holds arena rows 16w + g and 16w + g + 8
// of the warpgroup's 64 (g = lane / 4), at queries 8j + 2t + {0, 1} of the
// block's N (t = lane % 4): acc[4j + h] and acc[4j + 2 + h].
//
// CHUNKED (N = 8 only): the query tiles hold L.qb boxes of the width at a
// time, reloaded by the consumers as the products walk the width.
template <int N, bool BF16, int MODE, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1)
k1_scan_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap bmap,
               const float* __restrict__ q, float* pd, int* pi, unsigned* bound,
               float* scores, int B, int D, int k, int n_tiles, int tiles_per_split,
               int l2, int row_len, Layout L) {
  constexpr int NA = N / 2;  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off());
  uint64_t* empty = full + L.stages;
  uint64_t* tfull = empty + L.stages;
  uint64_t* tempty = tfull + BIAS_STAGES;
  Lists s;
  s.thr = reinterpret_cast<float*>(smem + L.state_off());
  s.qcnt = reinterpret_cast<int*>(s.thr + N);
  s.next = s.qcnt + N;
  s.qd = L.qd;
  s.qs = reinterpret_cast<float*>(smem + L.work_off());
  s.qr = reinterpret_cast<int*>(s.qs + N * L.qd);
  s.bound = bound;
  float* staged = reinterpret_cast<float*>(smem + L.work_off());  // STORE
  float* list_v = reinterpret_cast<float*>(smem + L.list_off());  // [N][k], when L.lists
  int* list_i = reinterpret_cast<int*>(list_v + N * k);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int q0 = blockIdx.x * N;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (tid == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < BIAS_STAGES; ++i) {
      mbar_init(tfull + i, 1);
      mbar_init(tempty + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The block's queries from box box0 of the width on, split into the
  // query tiles by the threads first, first + step, ..: element (n, col) of
  // a tile sits in box col / 32 at row n, 16-byte chunk (col % 32) / 4 ^
  // (n % 8).  Zeros past D.  wgmma reads the tiles through the async proxy.
  auto load_queries = [&](int box0, int first, int step) {
    const int width = L.qb * BOXC;
    for (int e = first; e < N * width; e += step) {
      const int n = e / width;
      const int at = e - n * width;
      const int col = box0 * BOXC + at;
      float v = (q0 + n < B && col < D) ? q[(size_t)(q0 + n) * D + col] : 0.f;
      const int c = at & (BOXC - 1);
      const int off = (at / BOXC) * (N * 128) + n * 128 +
                      (((c >> 2) ^ (n & 7)) << 4) + ((c & 3) << 2);
      if constexpr (BF16) {
        *reinterpret_cast<float*>(smem + off) = round_bf16(v);
      } else {
        const uint32_t big = to_tf32(v);
        *reinterpret_cast<uint32_t*>(smem + off) = big;
        *reinterpret_cast<uint32_t*>(smem + L.q_bytes() + off) =
            to_tf32(v - __uint_as_float(big));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  if constexpr (!CHUNKED) load_queries(0, tid, THREADS);  // once for the whole scan
  if constexpr (MODE != STORE) {
    // Every list starts as k empty slots, (+inf, -1).
    for (int e = tid; e < N * k; e += THREADS) {
      const int n = e / k;
      if (L.lists) {
        list_v[e] = INF;
        list_i[e] = -1;
      } else if (q0 + n < B) {
        const size_t o = ((size_t)(q0 + n) * splits + split) * k + (e - n * k);
        pd[o] = INF;
        pi[o] = -1;
      }
    }
    for (int n = tid; n < N; n += THREADS) {
      s.thr[n] = q0 + n < B ? ROOM : -INF;
      s.qcnt[n] = 0;
    }
    if (tid == 0) *s.next = 0;
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid != PRODUCER) return;
    int st = 0, ph = 0, ts = 0, tph = 0;
    for (int t = t_begin; t < t_end; ++t) {
      mbar_wait(tempty + ts, tph ^ 1);
      mbar_expect_tx(tfull + ts, BIAS_BYTES);
      tma_1d(smem + L.bias_off() + ts * BIAS_BYTES, &bmap, t * TILE, tfull + ts);
      if (++ts == BIAS_STAGES) {
        ts = 0;
        tph ^= 1;
      }
      for (int j = 0; j < L.nb; ++j) {
        mbar_wait(empty + st, ph ^ 1);
        mbar_expect_tx(full + st, STAGE_BYTES);
        tma_2d(smem + L.ring_off() + st * STAGE_BYTES, &xmap, j * BOXC, t * TILE,
               full + st);
        if (++st == L.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int warp = (tid >> 5) & 3;
  const int warp8 = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r_lo = wg * 64 + warp * 16 + g;  // this thread's rows of a tile: r_lo, r_lo + 8
  const float scale = l2 ? -2.f : -1.f;
  const uint32_t qbig = smem_u32(smem);
  const uint32_t qsmall = qbig + L.q_bytes();
  const uint8_t* ring = smem + L.ring_off();
  int st = 0, ph = 0, ts = 0, tph = 0;

  // The drain of every queue that holds at least `least` candidates into
  // its list, by the consumers' 8 warps: a query a warp (SCAN: the same
  // warp for the whole scan; LONG: the next query any warp is free for,
  // since a long drain costs a pass over the list; the barrier after a
  // drain orders the lists' stores before the next drain's loads).
  const int e_long = max(64, 1 << (32 - __clz(max(k - 1, 1)))) >> 5;  // LONG: keys a lane
  auto drain_all = [&](int least) {
    if constexpr (MODE == LONG) {
      const int n = min(N, B - q0);
      for (;;) {
        int qq = 0;
        if (lane == 0) qq = atomicAdd(s.next, 1);
        qq = __shfl_sync(FULL, qq, 0);
        if (qq >= n) break;
        const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
        float* ld = pd + base;
        int* li = pi + base;
        switch (e_long) {
          case 2: drain_long<2>(s, qq, q0 + qq, ld, li, k, lane, least); break;
          case 4: drain_long<4>(s, qq, q0 + qq, ld, li, k, lane, least); break;
          case 8: drain_long<8>(s, qq, q0 + qq, ld, li, k, lane, least); break;
          default: drain_long<16>(s, qq, q0 + qq, ld, li, k, lane, least); break;
        }
      }
    } else {
      for (int qq = warp8; qq < N && q0 + qq < B; qq += CONSUMER_WARPS) {
        const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
        drain_query(s, qq, L.lists ? list_v + qq * k : pd + base,
                    L.lists ? list_i + qq * k : pi + base, k, lane);
      }
    }
  };
  // While scanning, a long list takes its queue when a quarter full: a
  // drain costs a pass over the list, and the full queues must go.
  const int least = MODE == LONG ? (L.qd + 3) / 4 : 1;

  // acc: the tensor cores' sums; sum: the chains before the last, for rows
  // wider than one chain (WIDE: every tile but the widest, which only
  // fits rows of one chain).
  constexpr bool WIDE = N < 128;
  static_assert(WIDE || !CHUNKED, "a chunk ends where a chain is flushed");
  float acc[NA], sum[WIDE ? NA : 1];
  uint32_t big_a[4][4], small_a[4][4], big_b[4][4], small_b[4][4];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) big_b[kk][f] = small_b[kk][f] = 0u;

  // One box of the ring into a set of A fragments: this thread's values of
  // the box's four k8 steps (chunk c of row r sits at chunk c ^ (r % 8), and
  // r % 8 = g for both of its rows), split in registers.  The box is then
  // free for the producer.
  auto load_box = [&](uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
    mbar_wait(full + st, ph);
    const uint8_t* rows = ring + st * STAGE_BYTES + r_lo * 128 + (tq << 2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float v = *reinterpret_cast<const float*>(
            rows + ((f & 1) ? 8 * 128 : 0) + (((2 * kk + (f >> 1)) ^ g) << 4));
        if constexpr (BF16) {
          big[kk][f] = __float_as_uint(round_bf16(v));
        } else {
          big[kk][f] = to_tf32(v);
          small[kk][f] = to_tf32(v - __uint_as_float(big[kk][f]));
        }
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (++st == L.stages) {
      st = 0;
      ph ^= 1;
    }
  };
  // The products of one box, one commit group: the small terms first in
  // each k8 step.  fresh: the first product overwrites acc.
  auto issue_box = [&](const uint32_t (&big)[4][4], const uint32_t (&small)[4][4], int box,
                       int fresh) {
    const uint32_t boff = box * (N * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int keep = kk != 0 || !fresh;
      if constexpr (!BF16) {
        Mma<N>::rs(acc, big[kk], sw128_desc(qsmall + boff + 32 * kk), keep);
        Mma<N>::rs(acc, small[kk], sw128_desc(qbig + boff + 32 * kk), 1);
        Mma<N>::rs(acc, big[kk], sw128_desc(qbig + boff + 32 * kk), 1);
      } else {
        Mma<N>::rs(acc, big[kk], sw128_desc(qbig + boff + 32 * kk), keep);
      }
    }
    wgmma_commit();
  };
  for (int t = t_begin; t < t_end; ++t) {
    // Boxes two by two, each pair on its own set of fragments: while one
    // box's products run, the next box is loaded and split, so a warpgroup
    // keeps the tensor cores fed by itself (the two warpgroups fall into
    // step and do not cover each other's gaps).  An odd count multiplies
    // set B's stale values by the zero query box once more: no wgmma sits
    // under a branch.  The tensor cores sum CHAIN boxes (128 columns, 48
    // products) in acc; wider rows add those chains in f32 registers,
    // because the tensor cores truncate each accumulation: one chain over D
    // = 600 (225 products) read 4e-4 low at |q.x| = 110.
    load_box(big_a, small_a);
    for (int j = 0; j < L.nb; j += 2) {
      const int fresh = j % CHAIN == 0;
      if constexpr (WIDE) {
        if (fresh && j > 0) {
          wgmma_wait<0>();
          fence_acc<NA>(acc);
#pragma unroll
          for (int i = 0; i < NA; ++i) sum[i] = j == CHAIN ? acc[i] : sum[i] + acc[i];
        }
      }
      int base = 0;  // the box of the width at the head of the query tiles
      if constexpr (CHUNKED) {
        base = j / L.qb * L.qb;
        if (j == base) {
          // Every consumer has waited for its products on the last chunk
          // (a chunk is whole chains; a tile ends with a wait).
          named_sync(DRAIN, CONSUMERS);
          load_queries(base, tid, CONSUMERS);
          named_sync(DRAIN, CONSUMERS);
        }
      }
      issue_box(big_a, small_a, j - base, fresh);
      wgmma_wait<1>();  // set B's last products are done
      if (j + 1 < L.nb) load_box(big_b, small_b);
      issue_box(big_b, small_b, min(j + 1, L.nb) - base, 0);
      wgmma_wait<1>();  // set A's are
      if (j + 2 < L.nb) load_box(big_a, small_a);
    }
    wgmma_wait<0>();
    fence_acc<NA>(acc);
    if constexpr (WIDE) {
      if (L.nb > CHAIN) {
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] += sum[i];
      }
    }

    mbar_wait(tfull + ts, tph);
    const float* bias = reinterpret_cast<const float*>(smem + L.bias_off() + ts * BIAS_BYTES);
    const float b_lo = bias[r_lo], b_hi = bias[r_lo + 8];
    __syncwarp();
    if (lane == 0) mbar_arrive(tempty + ts);
    if (++ts == BIAS_STAGES) {
      ts = 0;
      tph ^= 1;
    }

    if constexpr (MODE == STORE) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int qc = 8 * (i >> 2) + 2 * tq + (i & 1);
        const bool hi = (i & 2) != 0;
        staged[qc * ST_STRIDE + r_lo + (hi ? 8 : 0)] = fmaf(scale, acc[i], hi ? b_hi : b_lo);
      }
      named_sync(DRAIN, CONSUMERS);
      for (int qq = warp8; qq < N && q0 + qq < B; qq += CONSUMER_WARPS)
        *reinterpret_cast<float4*>(scores + (size_t)(q0 + qq) * row_len + t * TILE + 4 * lane) =
            *reinterpret_cast<const float4*>(staged + qq * ST_STRIDE + 4 * lane);
      named_sync(DRAIN, CONSUMERS);
    } else {
      // Scores against thresholds, four at a time (two queries, two
      // rows): the common path is an FMA and a minimum per score and one
      // branch per four.  A score at most its query's threshold is queued
      // (thr is finite, so a dead row's +inf never is); bit i of failed:
      // acc[i]'s found its queue full.
      unsigned long long failed = 0;
      const int row = t * TILE + r_lo;
#pragma unroll
      for (int jj = 0; jj < NA / 4; ++jj) {
        const float2 th = *reinterpret_cast<const float2*>(s.thr + 8 * jj + 2 * tq);
        const float s0 = fmaf(scale, acc[4 * jj], b_lo), s1 = fmaf(scale, acc[4 * jj + 1], b_lo);
        const float s2 = fmaf(scale, acc[4 * jj + 2], b_hi), s3 = fmaf(scale, acc[4 * jj + 3], b_hi);
        if (fminf(fminf(s0, s2) - th.x, fminf(s1, s3) - th.y) <= 0.f)
          failed |= (unsigned long long)push_group(s, th.x, th.y, s0, s1, s2, s3,
                                                   8 * jj + 2 * tq, row) << (4 * jj);
      }
      // The queues are drained only when one of them was full (thr stays as
      // it was until then, so a few more pass): then every thread tries
      // again what it still holds, against the thresholds the drain has
      // lowered.
      while (consumers_any(failed != 0)) {
        drain_all(least);
        named_sync(DRAIN, CONSUMERS);
        if (MODE == LONG && tid == 0) *s.next = 0;  // before the next drain's barrier
        if (failed != 0) {
#pragma unroll
          for (int jj = 0; jj < NA / 4; ++jj) {
            const unsigned again = (unsigned)(failed >> (4 * jj)) & 15u;
            if (again != 0) {
              const float2 th = *reinterpret_cast<const float2*>(s.thr + 8 * jj + 2 * tq);
              const unsigned full = push_group(
                  s, th.x, th.y,
                  (again & 1) ? fmaf(scale, acc[4 * jj], b_lo) : INF,
                  (again & 2) ? fmaf(scale, acc[4 * jj + 1], b_lo) : INF,
                  (again & 4) ? fmaf(scale, acc[4 * jj + 2], b_hi) : INF,
                  (again & 8) ? fmaf(scale, acc[4 * jj + 3], b_hi) : INF, 8 * jj + 2 * tq, row);
              failed = (failed & ~(15ull << (4 * jj))) | ((unsigned long long)full << (4 * jj));
            }
          }
        }
      }
    }
  }
  if constexpr (MODE != STORE) {
    named_sync(DRAIN, CONSUMERS);  // every candidate is queued
    drain_all(1);
    if (L.lists) {
      named_sync(DRAIN, CONSUMERS);
      for (int e = tid; e < N * k; e += CONSUMERS) {
        const int n = e / k;
        if (q0 + n < B) {
          const size_t o = ((size_t)(q0 + n) * splits + split) * k + (e - n * k);
          pd[o] = list_v[e];
          pi[o] = list_i[e];
        }
      }
    }
  }
}

// ------------------------------------------------------------ merge pass

__global__ void fill_kernel(unsigned* out, int n, unsigned v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v;
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
             const float* __restrict__ q, float* __restrict__ od,
             int* __restrict__ oi, int D, int k, int n, int P, int l2) {
  extern __shared__ unsigned long long keys[];  // [P], P = pow2 >= n
  __shared__ float red[MERGE_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int e = tid; e < P; e += MERGE_THREADS)
    keys[e] = e < n ? pack(pd[(size_t)b * n + e], pi[(size_t)b * n + e])
                    : ~0ull;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int e = tid; e < P / 2; e += MERGE_THREADS) {
        const int lo = 2 * e - (e & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = keys[lo], c = keys[hi];
        if ((a > c) == up) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
    }
  }

  const float qsq = block_sqnorm(q + (size_t)b * D, D, l2, red);
  for (int j = tid; j < k; j += MERGE_THREADS)
    emit(keys[j], qsq, l2, od, oi, (size_t)b * k + j);
}

// ------------------------------------------------- large k: radix select

constexpr int RADIX_THREADS = 128;
constexpr int BINS = 256;  // one radix digit of 8 bits
enum RadixMode { HIST = 0, COLLECT = 1 };

// Per-query state of the radix select, on the device.
struct Radix {
  unsigned long long* prefix;  // [B] digits chosen so far
  unsigned long long* bound;   // [B] the largest key taken
  int* need;                   // [B] keys still to place; 0: settled
  int* taken;                  // [B] keys taken, min(k, live rows)
  unsigned* count;             // [B] keys written so far (COLLECT)
  unsigned* hist;              // [B][BINS]
  unsigned long long* keys;    // [B][slots] (COLLECT)
  int shift;                   // lowest bit of this pass's digit
  int first;                   // the pass of the top digit: every query is open
  int slots;
};

// state: one allocation of bytes(B), zeroed before the first pass.
__host__ __device__ inline size_t radix_state_bytes(int B) {
  return (size_t)B * (BINS * 4 + 8 + 8 + 4 + 4 + 4);
}

Radix radix_state(uint8_t* state, int B) {
  Radix r{};
  r.hist = reinterpret_cast<unsigned*>(state);
  r.prefix = reinterpret_cast<unsigned long long*>(state + (size_t)B * BINS * 4);
  r.bound = r.prefix + B;
  r.need = reinterpret_cast<int*>(r.bound + B);
  r.taken = r.need + B;
  r.count = reinterpret_cast<unsigned*>(r.taken + B);
  return r;
}

// HIST: count the live keys of one 128-score segment of a query's row (four
// consecutive scores a lane: rows r0 + 4 lane ..) whose bits above the
// digit match its prefix.  Lanes with one digit add once, by their lowest.
__device__ __forceinline__ void radix_hist_row(float4 seg, const Radix& r,
                                               unsigned long long p, int r0,
                                               int lane, unsigned* h) {
  const unsigned long long hi = r.shift >= 56 ? 0ull : ~0ull << (r.shift + 8);
  const float vv[4] = {seg.x, seg.y, seg.z, seg.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = vv[j];
    const unsigned long long key = pack(v, r0 + 4 * lane + j);
    const bool in = v < INF && ((key ^ p) & hi) == 0;
    const unsigned digit = (unsigned)(key >> r.shift) & (BINS - 1);
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
      const unsigned peers = __match_any_sync(act, digit);
      if ((peers & ((1u << lane) - 1)) == 0) atomicAdd(&h[digit], __popc(peers));
    }
  }
}

// COLLECT: append one segment's live keys up to the query's bound lim to
// its slots.
__device__ __forceinline__ void radix_collect_row(float4 seg, const Radix& r,
                                                  unsigned long long lim, int b,
                                                  int r0, int lane) {
  const float vv[4] = {seg.x, seg.y, seg.z, seg.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = vv[j];
    const unsigned long long key = pack(v, r0 + 4 * lane + j);
    const bool take = v < INF && key <= lim;
    const unsigned m = __ballot_sync(FULL, take);
    if (m == 0) continue;
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(&r.count[b], (unsigned)__popc(m));
    base = __shfl_sync(FULL, base, 0);
    const unsigned pos = base + __popc(m & ((1u << lane) - 1));
    if (take && pos < (unsigned)r.slots) r.keys[(size_t)b * r.slots + pos] = key;
  }
}

// HIST or COLLECT over one query's stored scores (blockIdx.y), a warp per
// 128-row segment, 16 bytes a lane, the next segment's load in flight while
// this one is counted.  HIST sums in shared memory, then into r.hist.  A
// block whose query is settled (HIST) or takes nothing (COLLECT) returns at
// once.
template <int MODE>
__global__ void __launch_bounds__(RADIX_THREADS)
radix_buf_kernel(const float* __restrict__ scores, int row_len, Radix r) {
  __shared__ unsigned h[BINS];
  const int b = blockIdx.y;
  if (MODE == HIST ? (!r.first && r.need[b] == 0) : r.taken[b] == 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float4* row = reinterpret_cast<const float4*>(scores + (size_t)b * row_len) + lane;
  if constexpr (MODE == HIST) {
    for (int e = tid; e < BINS; e += RADIX_THREADS) h[e] = 0;
    __syncthreads();
  }
  const unsigned long long mark = MODE == HIST ? r.prefix[b] : r.bound[b];
  const int segs = row_len / TILE;
  const int step = gridDim.x * (RADIX_THREADS / 32);
  int seg = blockIdx.x * (RADIX_THREADS / 32) + (tid >> 5);
  float4 cur = seg < segs ? row[seg * (TILE / 4)] : make_float4(INF, INF, INF, INF);
  for (; seg < segs; seg += step) {
    const float4 next = seg + step < segs ? row[(seg + step) * (TILE / 4)] : cur;
    if constexpr (MODE == HIST)
      radix_hist_row(cur, r, mark, seg * TILE, lane, h);
    else
      radix_collect_row(cur, r, mark, b, seg * TILE, lane);
    cur = next;
  }
  if constexpr (MODE == HIST) {
    __syncthreads();
    for (int e = tid; e < BINS; e += RADIX_THREADS)
      if (h[e] != 0) atomicAdd(&r.hist[(size_t)b * BINS + e], h[e]);
  }
}

// One warp per query: the digit whose bin holds the need-th smallest
// matching key (lane l scans bins 8l .. 8l + 7).  Keys in lower bins are
// all taken; when the bin holds exactly the keys still needed, all of it
// is, and the query is settled with bound = the bin's largest possible
// key.  The first pass starts from need = k, capped at the live rows.
// Every bin is cleared for the next pass.
__global__ void radix_select_kernel(Radix r, int B, int k) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  unsigned n = r.first ? (unsigned)k : (unsigned)r.need[b];
  if (!r.first && n == 0) return;  // settled: its histogram was not touched
  uint4* h = reinterpret_cast<uint4*>(r.hist + (size_t)b * BINS) + 2 * lane;
  const uint4 lo = h[0], hi = h[1];
  const unsigned hv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += hv[i];
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  if (r.first) {
    n = min(n, __shfl_sync(FULL, incl, 31));  // the live rows
    if (lane == 0) r.taken[b] = (int)n;
  }
  unsigned below = incl - sum;
  if (n == 0) {
    if (lane == 0) r.need[b] = 0;
  } else if (below < n && n <= incl) {  // one lane's bins hold the n-th key
    int d = -1;
    unsigned rest = 0, bin = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (d < 0) {
        if (below + hv[i] >= n) {
          d = i;
          rest = n - below;
          bin = hv[i];
        } else {
          below += hv[i];
        }
      }
    }
    const unsigned long long p =
        r.prefix[b] | ((unsigned long long)(8 * lane + d) << r.shift);
    r.prefix[b] = p;
    if (bin == rest) {
      r.bound[b] = p | ((1ull << r.shift) - 1);
      rest = 0;
    }
    r.need[b] = (int)rest;
  }
  h[0] = make_uint4(0, 0, 0, 0);
  h[1] = make_uint4(0, 0, 0, 0);
}

constexpr int SORT_TILE = 2048;  // keys a block sorts in shared memory

// Ascending bitonic sort of each query's [P] keys (P a power of two),
// steps with stride >= SORT_TILE in device memory, one launch each.
__global__ void bitonic_step_kernel(unsigned long long* keys, long long pairs,
                                    int P, int size, int stride) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long b = t / (P / 2);
  const int e = (int)(t - b * (P / 2));
  const int lo = 2 * e - (e & (stride - 1));
  const int hi = lo + stride;
  const bool up = (lo & size) == 0;
  unsigned long long* s = keys + b * P;
  const unsigned long long a = s[lo], c = s[hi];
  if ((a > c) == up) {
    s[lo] = c;
    s[hi] = a;
  }
}

// ... and for size in [size_lo, size_hi], the steps with stride < tile in
// shared memory: a block owns one tile of one query's keys.
__global__ void __launch_bounds__(MERGE_THREADS)
bitonic_tile_kernel(unsigned long long* keys, int P, int tile, int size_lo,
                    int size_hi) {
  __shared__ unsigned long long s[SORT_TILE];
  const long long base = (long long)blockIdx.x * tile;
  const int off = (int)(base % P);  // the tile's place in its query's keys
  const int tid = threadIdx.x;
  for (int e = tid; e < tile; e += MERGE_THREADS) s[e] = keys[base + e];
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, tile) >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int e = tid; e < tile / 2; e += MERGE_THREADS) {
        const int lo = 2 * e - (e & (stride - 1));
        const int hi = lo + stride;
        const bool up = ((off + lo) & size) == 0;
        const unsigned long long a = s[lo], c = s[hi];
        if ((a > c) == up) {
          s[lo] = c;
          s[hi] = a;
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < tile; e += MERGE_THREADS) keys[base + e] = s[e];
}

__global__ void __launch_bounds__(MERGE_THREADS)
radix_emit_kernel(const unsigned long long* __restrict__ keys,
                  const float* __restrict__ q, float* __restrict__ od,
                  int* __restrict__ oi, int D, int k, int P, int l2) {
  __shared__ float red[MERGE_THREADS / 32];
  const int b = blockIdx.x;
  const float qsq = block_sqnorm(q + (size_t)b * D, D, l2, red);
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS)
    emit(keys[(size_t)b * P + j], qsq, l2, od, oi, (size_t)b * k + j);
}

// ------------------------------------------------------------- the host

template <int N, bool BF16, int MODE, bool CHUNKED>
cudaError_t launch_scan(dim3 grid, const Layout& L, cudaStream_t s,
                        const CUtensorMap& xmap, const CUtensorMap& bmap,
                        const float* q, float* pd, int* pi, unsigned* bound,
                        float* scores, int B, int D, int k, int n_tiles, int per, int l2,
                        int row_len) {
  auto kernel = k1_scan_kernel<N, BF16, MODE, CHUNKED>;
  static unsigned opted = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((opted >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    if (dev < 32) opted |= 1u << dev;
  }
  kernel<<<grid, THREADS, L.bytes(), s>>>(xmap, bmap, q, pd, pi, bound, scores, B, D, k,
                                          n_tiles, per, l2, row_len, L);
  return cudaGetLastError();
}

template <bool BF16, int MODE>
cudaError_t launch_scan_nq(int nq, bool chunked, dim3 grid, const Layout& L, cudaStream_t s,
                           const CUtensorMap& xmap, const CUtensorMap& bmap, const float* q,
                           float* pd, int* pi, unsigned* bound, float* scores, int B,
                           int D, int k, int n_tiles, int per, int l2, int row_len) {
  auto launch = launch_scan<8, BF16, MODE, false>;
  switch (nq) {
    case 8:  // rows too wide for the query tiles are walked in chunks
      if (chunked) launch = launch_scan<8, BF16, MODE, true>;
      break;
    case 16: launch = launch_scan<16, BF16, MODE, false>; break;
    case 32: launch = launch_scan<32, BF16, MODE, false>; break;
    case 64: launch = launch_scan<64, BF16, MODE, false>; break;
    case 128: launch = launch_scan<128, BF16, MODE, false>; break;
    default: return cudaErrorInvalidValue;
  }
  return launch(grid, L, s, xmap, bmap, q, pd, pi, bound, scores, B, D, k, n_tiles, per, l2,
                row_len);
}

// LONG only at tiles of 64 and 128 queries (the wrapper routes narrower
// tiles to the large-k route): each instantiation is a minute of nvcc.
template <bool BF16>
cudaError_t launch_long(int nq, bool chunked, dim3 grid, const Layout& L, cudaStream_t s,
                        const CUtensorMap& xmap, const CUtensorMap& bmap, const float* q,
                        float* pd, int* pi, unsigned* bound, float* scores, int B, int D,
                        int k, int n_tiles, int per, int l2, int row_len) {
  if (chunked || (nq != 64 && nq != 128)) return cudaErrorInvalidValue;
  auto launch = launch_scan<128, BF16, LONG, false>;
  if (nq == 64) launch = launch_scan<64, BF16, LONG, false>;
  return launch(grid, L, s, xmap, bmap, q, pd, pi, bound, scores, B, D, k, n_tiles, per, l2,
                row_len);
}

// The bias and the product pass.  x: [cap, D] f32 with rows x_stride floats
// apart (a multiple of 4, 16-byte aligned); bias: [n_tiles * 128] scratch.
int scan(int mode, const float* q, const float* x, const uint8_t* valid,
         const float* x_sq, float* bias, float* pd, int* pi, unsigned* bound, float* scores,
         int B, int cap, int D, int x_stride, int k, int l2, int exact, int nq,
         int splits, int per, cudaStream_t s) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return NO_LIBCUDA;
  const int store = mode == STORE;
  const Layout L = scan_layout(D, nq, !exact, mode, k);
  if (L.stages < 2 || (x_stride & 3) || (store && nq > 64) || (nq == 128 && L.nb > 4))
    return BAD_TILE;
  const int n_tiles = (cap + TILE - 1) / TILE;
  CUtensorMap xmap, bmap;
  int err = encode_rows(enc, &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, D, cap,
                        (size_t)x_stride * 4, BOXC, TILE);
  if (!err) err = encode_bias(enc, &bmap, bias, n_tiles * TILE, TILE);
  if (err) return err;
  row_bias_kernel<<<(n_tiles * TILE + 255) / 256, 256, 0, s>>>(
      valid, x_sq, bias, cap, n_tiles * TILE, l2);
  if (mode == LONG)  // no split has published a bound yet
    fill_kernel<<<(B * splits + 255) / 256, 256, 0, s>>>(bound, B * splits, ROOM_BOUND);
  const dim3 grid((B + nq - 1) / nq, splits);
  const int row_len = n_tiles * TILE;
  const bool chunked = L.qb < L.whole();
  // one instantiation per (operands, mode); the tile width picks within it
  auto launch = exact ? launch_scan_nq<false, SCAN> : launch_scan_nq<true, SCAN>;
  if (mode == STORE) launch = exact ? launch_scan_nq<false, STORE> : launch_scan_nq<true, STORE>;
  if (mode == LONG) launch = exact ? launch_long<false> : launch_long<true>;
  const cudaError_t e = launch(nq, chunked, grid, L, s, xmap, bmap, q, pd, pi, bound, scores,
                               B, D, k,
                               n_tiles, per, l2, row_len);
  return (int)e;
}

}  // namespace

extern "C" {

// The queries a scan block owns for this batch and width: exact = 0 for
// bf16 operands, store = 1 for the large-k route.  The wrapper sizes its
// grid with it.
int ehtorch_k1_tile(int B, int D, int exact, int store) {
  return pick_nq(B, D, !exact, store);
}

// K1 for k <= 32, and for k <= MAX_LONG_K at nq 64 or 128.  pd/pi: [B,
// splits, k] scratch; bias: [ceil(cap / 128) * 128] f32 scratch; bound: [B,
// splits] u32 scratch (read for k > 32 only); od/oi: [B, k] results.  nq
// from ehtorch_k1_tile; splits slices of tiles_per_split 128-row tiles each.
int ehtorch_fused_topk(const float* q, const float* x, const uint8_t* valid,
                       const float* x_sq, float* bias, float* pd, int* pi, unsigned* bound,
                       float* od, int* oi, int B, int cap, int D, int x_stride,
                       int k, int l2, int exact, int nq, int splits,
                       int tiles_per_split, int merge_slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k > MAX_LONG_K || (k > 32 && nq < 64))  // the large-k route's
    return (int)cudaErrorInvalidValue;
  int err = scan(k > 32 ? LONG : SCAN, q, x, valid, x_sq, bias, pd, pi, bound, nullptr, B, cap,
                 D, x_stride, k, l2, exact, nq, splits, tiles_per_split, s);
  if (err) return err;
  const size_t smem = (size_t)merge_slots * sizeof(unsigned long long);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merge_kernel<<<B, MERGE_THREADS, smem, s>>>(pd, pi, q, od, oi, D, k, splits * k,
                                              merge_slots, l2);
  return (int)cudaGetLastError();
}

// Bytes of the large-k route's state scratch for B queries.
long long ehtorch_large_k_state_bytes(int B) { return (long long)radix_state_bytes(B); }

// K1 past k = 1024, every launch of one group of queries: the product into
// scores [B][row_len] (row_len = ceil(cap / 128) * 128), the radix digits
// (bits of the (score, row) key, high to low; the row digits below
// row_bits only), the collect of every query's keys up to its bound into
// keys [B][slots] (slots: a power of two >= k), their sort, and the first k
// through the epilogue into od/oi [B][k].  state: ehtorch_large_k_state_bytes
// of scratch; bias as for K1.  blocks_x blocks per query in the passes over
// the scores.
int ehtorch_large_k(const float* q, const float* x, const uint8_t* valid,
                    const float* x_sq, float* bias, float* scores, void* state,
                    unsigned long long* keys, float* od, int* oi, int B, int cap,
                    int D, int x_stride, int k, int l2, int exact, int nq,
                    int splits, int tiles_per_split, int slots, int row_bits,
                    int blocks_x, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = scan(STORE, q, x, valid, x_sq, bias, nullptr, nullptr, nullptr, scores, B, cap,
                 D, x_stride, 0, l2, exact, nq, splits, tiles_per_split, s);
  if (err) return err;
  const int row_len = (cap + TILE - 1) / TILE * TILE;
  cudaError_t e = cudaMemsetAsync(state, 0, radix_state_bytes(B), s);
  if (e == cudaSuccess)  // all ones: padding that sorts last
    e = cudaMemsetAsync(keys, 0xff, (size_t)B * slots * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  Radix r = radix_state(static_cast<uint8_t*>(state), B);
  r.keys = keys;
  r.slots = slots;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && shift >= row_bits) continue;  // zero bits of every row
    r.shift = shift;
    r.first = shift == 56;
    radix_buf_kernel<HIST><<<dim3(blocks_x, B), RADIX_THREADS, 0, s>>>(scores, row_len, r);
    radix_select_kernel<<<(B + 3) / 4, 128, 0, s>>>(r, B, k);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  radix_buf_kernel<COLLECT><<<dim3(blocks_x, B), RADIX_THREADS, 0, s>>>(scores, row_len, r);
  const int tile = slots < SORT_TILE ? slots : SORT_TILE;
  const long long tiles = (long long)B * (slots / tile);
  bitonic_tile_kernel<<<(unsigned)tiles, MERGE_THREADS, 0, s>>>(keys, slots, tile, 2, tile);
  const long long pairs = (long long)B * (slots / 2);
  for (int size = 2 * tile; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride >= tile; stride >>= 1)
      bitonic_step_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
          keys, pairs, slots, size, stride);
    bitonic_tile_kernel<<<(unsigned)tiles, MERGE_THREADS, 0, s>>>(keys, slots, tile, size,
                                                                 size);
  }
  radix_emit_kernel<<<B, MERGE_THREADS, 0, s>>>(keys, q, od, oi, D, k, slots, l2);
  return (int)cudaGetLastError();
}

}  // extern "C"
