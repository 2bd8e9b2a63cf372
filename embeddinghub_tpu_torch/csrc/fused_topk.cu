// Fused distance + running top-k for Hopper (sm_90a): K1.
//
// Replaces the Pallas kernel fused_topk_search (_kernel, exact) of
// embeddinghub_tpu/ops/pallas_topk.py:124 -> ehtorch_fused_topk.  (K2,
// fused_topk_search_v2, is k2_scan.cu.)
//
// It computes, for every query b, the k smallest scores over the live rows
// of a row-major [cap, D] f32 arena without writing the [B, cap] score
// matrix to device memory.  The score is ||x||^2 - 2 q.x for l2 and -q.x
// for ip/cosine (cosine queries arrive normalized); dead rows and rows past
// cap score +inf.
//
// Pass 1 (scan_kernel): a block owns BQ=64 queries and one slice ("split")
// of the arena, which it walks in tiles of BN=128 rows.  Each query keeps
// its running top-k in its [k] slot of the partial output, device memory
// the wrapper allocated.  One warp owns a query for the whole scan, caches
// the current worst (score, slot) in shared memory, and touches the list
// only when a candidate beats it.  Nothing carries between blocks: splits
// exist to fill 132 SMs.  The [64, 128] score tile comes from CUDA-core f32
// FMA out of shared memory, an 8x8 register tile per thread, and every row
// competes.  exact=1 keeps full f32 operands (the twin of
// Precision.HIGHEST); exact=0 rounds operands to bf16.
// Pass 2 (merge_kernel): one block per query sorts the splits*k partial
// entries by (score, id), keeps the first k, and applies the epilogue of
// pallas_topk.py:187-192 (emit, topk_common.cuh).
//
// K1 past k = 1024 (ehtorch_radix_*).  The running lists above cost O(k)
// per insert and the merge sorts splits*k entries in shared memory, so a
// large k takes another route, with no bound on k but the arena's
// capacity.  The wrapper takes the queries in groups whose [B, cap] scores
// fit a bounded buffer, which scan_kernel (MODE STORE) fills with the same
// product and masking as K1.  Every (score, row) is one 64-bit key, the
// order of the merge's sort, and the k-th smallest key per query is found
// by radix select, 8 bits a pass: radix_buf_kernel (MODE HIST) counts the
// keys that match the digits chosen so far into a 256-bin histogram per
// query, and radix_select_kernel picks the next digit.  The wrapper runs
// the four score digits, and the row digits only if a query's k-th score
// ties.  A last pass (MODE COLLECT) writes each query's keys up to its k-th
// into a [B, slots] buffer; a bitonic sort and radix_emit_kernel apply the
// same epilogue as the merge.
//
// What bounds it on an H100: CUDA-core f32 FMA (2*B*cap*D flops against
// about 67 TFLOP/s).  Exact f32 has no faster unit; this first version
// keeps scores out of memory and filters cheaply, and reaches a fraction of
// that peak.
//
// A kernel launches on the caller's stream and allocates nothing.  Each C
// entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 128;       // arena rows per tile
constexpr int DK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 128;  // 8 (ty) x 16 (tx)
constexpr int TM = 8;         // queries per thread: ty + 8*i
constexpr int TN = 8;         // rows per thread: tx + 16*j
constexpr int OP_STRIDE = DK + 4;   // float4-aligned, conflict-free rows
constexpr int SC_STRIDE = BN + 16;  // ty and ty+1 land 16 banks apart
constexpr int OP_FLOATS = (BQ + BN) * OP_STRIDE;
constexpr int SC_FLOATS = BQ * SC_STRIDE;
constexpr int SMEM_FLOATS = OP_FLOATS > SC_FLOATS ? OP_FLOATS : SC_FLOATS;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// What scan_kernel (SCAN, STORE) and radix_buf_kernel (HIST, COLLECT) do
// with each 128-score row segment.
enum Mode { SCAN = 0, STORE = 1, HIST = 2, COLLECT = 3 };
constexpr int BINS = 256;  // one radix digit of 8 bits

// Per-query state of the radix select, on the device.
struct Radix {
  const unsigned long long* prefix;  // [B] digits chosen so far (HIST)
  const unsigned long long* bound;   // [B] the largest key taken (COLLECT)
  const int* need;                   // [B] keys still to place; 0: settled
  const int* taken;                  // [B] keys taken, min(k, live rows)
  unsigned* hist;                    // [B][BINS] (HIST)
  unsigned* count;                   // [B] keys written so far (COLLECT)
  unsigned long long* keys;          // [B][slots] (COLLECT)
  int shift;                         // lowest bit of this pass's digit
  int slots;
};

// HIST: count the live keys of one query's score row whose bits above the
// digit match its prefix.  Lanes with one digit add once, by their lowest.
__device__ __forceinline__ void radix_hist_row(const float* srow,
                                               const Radix& r, int b, int r0,
                                               int lane, unsigned* h) {
  if (r.need[b] == 0) return;  // settled in an earlier pass
  const unsigned long long p = r.prefix[b];
  const unsigned long long hi = r.shift >= 56 ? 0ull : ~0ull << (r.shift + 8);
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    const float v = srow[lane + 32 * j];
    const unsigned long long key = pack(v, r0 + 32 * j + lane);
    const bool in = v < INF && ((key ^ p) & hi) == 0;
    const unsigned digit = (unsigned)(key >> r.shift) & (BINS - 1);
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
      const unsigned peers = __match_any_sync(act, digit);
      if ((peers & ((1u << lane) - 1)) == 0) atomicAdd(&h[digit], __popc(peers));
    }
  }
}

// COLLECT: append one query's live keys up to its bound to its slots.
__device__ __forceinline__ void radix_collect_row(const float* srow,
                                                  const Radix& r, int b,
                                                  int r0, int lane) {
  if (r.taken[b] == 0) return;
  const unsigned long long lim = r.bound[b];
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    const float v = srow[lane + 32 * j];
    const unsigned long long key = pack(v, r0 + 32 * j + lane);
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

// Lexicographic "a after b" on (score, id, slot): a total order, so a
// butterfly reduction leaves every lane with the same answer.
__device__ __forceinline__ bool after(float as, int ai, int ap, float bs,
                                      int bi, int bp) {
  if (as != bs) return as > bs;
  if (ai != bi) return ai > bi;
  return ap > bp;
}

// The worst entry of a k-slot list (slot -1 when k < 32 leaves a lane idle).
__device__ __forceinline__ void list_worst(const float* ld, const int* li,
                                           int k, int lane, float& wv,
                                           int& wp) {
  float bv = 0.f;
  int bi = 0, bp = -1;
  for (int j = lane; j < k; j += 32) {
    const float v = ld[j];
    const int id = li[j];
    if (bp < 0 || after(v, id, j, bv, bi, bp)) {
      bv = v;
      bi = id;
      bp = j;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    const int op = __shfl_xor_sync(FULL, bp, off);
    if (op >= 0 && (bp < 0 || after(ov, oi, op, bv, bi, bp))) {
      bv = ov;
      bi = oi;
      bp = op;
    }
  }
  wv = bv;
  wp = bp;
}

// Replace the worst slot with (s, id) and find the new worst.  Lane 0
// writes; __syncwarp orders that store before the other lanes' reads.
__device__ __forceinline__ void list_insert(float* ld, int* li, int k,
                                            int lane, float s, int id,
                                            float& wv, int& wp) {
  if (lane == 0) {
    ld[wp] = s;
    li[wp] = id;
  }
  __syncwarp();
  list_worst(ld, li, k, lane, wv, wp);
}

// Every list of this block starts as k empty slots, (+inf, -1); the worst
// slot is any of them.
__device__ __forceinline__ void init_lists(float* pd, int* pi, float* worst_v,
                                           int* worst_p, int B, int k, int q0,
                                           int split, int splits) {
  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {
    const int qq = e / k;
    if (q0 + qq < B) {
      const size_t o = ((size_t)(q0 + qq) * splits + split) * k + (e % k);
      pd[o] = INF;
      pi[o] = -1;
    }
  }
  if (threadIdx.x < BQ) {
    worst_v[threadIdx.x] = INF;
    worst_p[threadIdx.x] = 0;
  }
  __syncthreads();
}

// MODE SCAN is K1.  MODE STORE, the first pass of its large-k route,
// leaves pd/pi alone and writes every score tile to scores
// [B][n_tiles * BN] instead (+inf for dead rows and rows past cap).
template <bool BF16, int MODE>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
            const uint8_t* __restrict__ valid,
            const float* __restrict__ x_sq, float* pd, int* pi, int B,
            int cap, int D, int k, int l2, int splits, int tiles_per_split,
            float* scores) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  __shared__ float worst_v[BQ];
  __shared__ int worst_p[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_tiles = (cap + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if constexpr (MODE == SCAN)
    init_lists(pd, pi, worst_v, worst_p, B, k, q0, split, splits);

  float* qs = smem;                   // [BQ][OP_STRIDE]
  float* xs = smem + BQ * OP_STRIDE;  // [BN][OP_STRIDE]
  float* sc = smem;                   // [BQ][SC_STRIDE], after the product

  // One stage is a DK-deep slice of the query tile and of the row tile.
  // Thread tid carries column tid%32 of rows tid/32 + 4i: a warp reads 32
  // consecutive floats of one row (coalesced) and stores them conflict-free
  // into the d-contiguous shared layout.  The next stage's loads are issued
  // before this stage's product, so their latency hides behind it.
  const int lc = tid & 31;
  const int lr = tid >> 5;
  float stq[BQ / 4], stx[BN / 4];
  auto load_stage = [&](int tile, int d0) {
    const int dc = d0 + lc;
#pragma unroll
    for (int i = 0; i < BQ / 4; ++i) {
      const int qi = q0 + lr + 4 * i;
      stq[i] = (qi < B && dc < D) ? q[(size_t)qi * D + dc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const int xi = tile * BN + lr + 4 * i;
      stx[i] = (xi < cap && dc < D) ? x[(size_t)xi * D + dc] : 0.f;
    }
  };
  if (t_begin < t_end) load_stage(t_begin, 0);

  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // the last readers of qs/xs/sc are done
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i)
        qs[(lr + 4 * i) * OP_STRIDE + lc] = BF16 ? round_bf16(stq[i]) : stq[i];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i)
        xs[(lr + 4 * i) * OP_STRIDE + lc] = BF16 ? round_bf16(stx[i]) : stx[i];
      __syncthreads();
      if (d0 + DK < D)
        load_stage(t, d0 + DK);
      else if (t + 1 < t_end)
        load_stage(t + 1, 0);
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float4 b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              &xs[(tx + 16 * j) * OP_STRIDE + kk]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              &qs[(ty + 8 * i) * OP_STRIDE + kk]);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
    }

    // The operand stages are dead once every warp is past its product:
    // the score tile takes their place.
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = r0 + tx + 16 * j;
      const bool live = row < cap && valid[row] != 0;
      const float sq = (l2 && row < cap) ? x_sq[row] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float s = l2 ? sq - 2.f * acc[i][j] : -acc[i][j];
        sc[(ty + 8 * i) * SC_STRIDE + tx + 16 * j] = live ? s : INF;
      }
    }
    __syncthreads();

    for (int qq = warp; qq < BQ && q0 + qq < B; qq += THREADS / 32) {
      const float* srow = sc + qq * SC_STRIDE;
      if constexpr (MODE == STORE) {
        float* out = scores + (size_t)(q0 + qq) * n_tiles * BN + r0;
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) out[lane + 32 * j] = srow[lane + 32 * j];
        continue;
      }
      const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
      float* ld = pd + base;
      int* li = pi + base;
      float wv = worst_v[qq];
      int wp = worst_p[qq];
      // Rows arrive in ascending order, so a later row that only ties
      // the worst entry never displaces it (lower id first, as top_k).
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const float v = srow[lane + 32 * j];
        unsigned m = __ballot_sync(FULL, v < wv);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(FULL, v, src);
          if (cv < wv)
            list_insert(ld, li, k, lane, cv, r0 + 32 * j + src, wv, wp);
        }
      }
      if (lane == 0) {
        worst_v[qq] = wv;
        worst_p[qq] = wp;
      }
    }
  }
}

// ------------------------------------------------------------ merge pass

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

int merge(const float* q, float* pd, int* pi, float* od, int* oi, int B,
          int D, int k, int l2, int splits, int merge_slots,
          cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();  // the scan's launch
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)merge_slots * sizeof(unsigned long long);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<B, MERGE_THREADS, smem, stream>>>(
      pd, pi, q, od, oi, D, k, splits * k, merge_slots, l2);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- large k: radix select

// One thread per query: the digit whose bin holds the need-th smallest
// matching key.  Keys in lower bins are all taken; when the bin holds
// exactly the keys still needed, all of it is, and the query is settled
// with bound = the bin's largest possible key.  The first pass caps k at
// the live rows.  Every bin is cleared for the next pass.
__global__ void radix_select_kernel(unsigned* hist,
                                    unsigned long long* prefix,
                                    unsigned long long* bound, int* need,
                                    int* taken, int B, int shift, int first) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned* h = hist + (size_t)b * BINS;
  unsigned n = (unsigned)need[b];
  if (first) {
    unsigned live = 0;
    for (int d = 0; d < BINS; ++d) live += h[d];
    n = min(n, live);
    taken[b] = (int)n;
  }
  if (n > 0) {
    unsigned below = 0;
    int d = 0;
    for (; d < BINS - 1 && below + h[d] < n; ++d) below += h[d];
    n -= below;
    const unsigned long long p =
        prefix[b] | ((unsigned long long)d << shift);
    prefix[b] = p;
    if (h[d] == n) {
      bound[b] = p | ((1ull << shift) - 1);
      n = 0;
    }
  }
  need[b] = (int)n;
  for (int d = 0; d < BINS; ++d) h[d] = 0;
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

// HIST or COLLECT over one query's stored scores (blockIdx.y), a warp per
// 128-row segment.  HIST sums in shared memory, then into r.hist.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
radix_buf_kernel(const float* __restrict__ scores, int row_len, Radix r) {
  __shared__ unsigned h[BINS];
  const int b = blockIdx.y;
  if (MODE == HIST ? r.need[b] == 0 : r.taken[b] == 0) return;  // whole block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* row = scores + (size_t)b * row_len;
  if constexpr (MODE == HIST) {
    for (int e = tid; e < BINS; e += THREADS) h[e] = 0;
    __syncthreads();
  }
  const int per_block = THREADS / 32;
  for (int seg = blockIdx.x * per_block + (tid >> 5); seg * BN < row_len;
       seg += gridDim.x * per_block) {
    if constexpr (MODE == HIST)
      radix_hist_row(row + seg * BN, r, b, seg * BN, lane, h);
    else
      radix_collect_row(row + seg * BN, r, b, seg * BN, lane);
  }
  if constexpr (MODE == HIST) {
    __syncthreads();
    for (int e = tid; e < BINS; e += THREADS)
      if (h[e] != 0) atomicAdd(&r.hist[(size_t)b * BINS + e], h[e]);
  }
}

}  // namespace

extern "C" {

// K1.  pd/pi: [B, splits, k] scratch; od/oi: [B, k] results.
int ehtorch_fused_topk(const float* q, const float* x, const uint8_t* valid,
                       const float* x_sq, float* pd, int* pi, float* od,
                       int* oi, int B, int cap, int D, int k, int l2,
                       int exact, int splits, int tiles_per_split,
                       int merge_slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  if (exact)
    scan_kernel<false, SCAN><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, pd, pi, B, cap, D, k, l2, splits, tiles_per_split,
        nullptr);
  else
    scan_kernel<true, SCAN><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, pd, pi, B, cap, D, k, l2, splits, tiles_per_split,
        nullptr);
  return merge(q, pd, pi, od, oi, B, D, k, l2, splits, merge_slots, s);
}

// K1 past k = 1024, the product: scores [B][n_tiles * BN], n_tiles =
// ceil(cap / 128).
int ehtorch_radix_store(const float* q, const float* x, const uint8_t* valid,
                        const float* x_sq, float* scores, int B, int cap,
                        int D, int l2, int exact, int splits,
                        int tiles_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  if (exact)
    scan_kernel<false, STORE><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, nullptr, nullptr, B, cap, D, 0, l2, splits,
        tiles_per_split, scores);
  else
    scan_kernel<true, STORE><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, nullptr, nullptr, B, cap, D, 0, l2, splits,
        tiles_per_split, scores);
  return (int)cudaGetLastError();
}

// K1 past k = 1024, one radix digit (bits shift..shift+7 of the key) over
// the stored scores, blocks_x blocks per query.  hist [B][256] zeros;
// prefix, bound [B] zeros; need [B] = k; taken [B].  first: the pass of the
// top digit, which also counts the live rows.
int ehtorch_radix_pass(const float* scores, unsigned* hist,
                       unsigned long long* prefix, unsigned long long* bound,
                       int* need, int* taken, int B, int row_len, int shift,
                       int first, int blocks_x, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Radix r{};
  r.prefix = prefix;
  r.need = need;
  r.hist = hist;
  r.shift = shift;
  radix_buf_kernel<HIST><<<dim3(blocks_x, B), THREADS, 0, s>>>(scores, row_len,
                                                               r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_select_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      hist, prefix, bound, need, taken, B, shift, first);
  return (int)cudaGetLastError();
}

// K1 past k = 1024, the end: every query's keys up to its bound into
// keys [B][slots] (all ones beforehand; count [B] zeros), sorted, then the
// first k through the epilogue into od/oi [B][k].  slots: a power of two
// >= k.
int ehtorch_radix_collect(const float* scores, const float* q,
                          const unsigned long long* bound, const int* taken,
                          unsigned* count, unsigned long long* keys,
                          float* od, int* oi, int B, int row_len, int D, int k,
                          int l2, int slots, int blocks_x, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Radix r{};
  r.bound = bound;
  r.taken = taken;
  r.count = count;
  r.keys = keys;
  r.slots = slots;
  radix_buf_kernel<COLLECT><<<dim3(blocks_x, B), THREADS, 0, s>>>(
      scores, row_len, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tile = slots < SORT_TILE ? slots : SORT_TILE;
  const long long tiles = (long long)B * (slots / tile);
  bitonic_tile_kernel<<<(unsigned)tiles, MERGE_THREADS, 0, s>>>(
      keys, slots, tile, 2, tile);
  const long long pairs = (long long)B * (slots / 2);
  for (int size = 2 * tile; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride >= tile; stride >>= 1)
      bitonic_step_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
          keys, pairs, slots, size, stride);
    bitonic_tile_kernel<<<(unsigned)tiles, MERGE_THREADS, 0, s>>>(
        keys, slots, tile, size, size);
  }
  radix_emit_kernel<<<B, MERGE_THREADS, 0, s>>>(keys, q, od, oi, D, k, slots,
                                                l2);
  return (int)cudaGetLastError();
}

}  // extern "C"
