// Fused distance + running top-k for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of embeddinghub_tpu/ops/pallas_topk.py:
//
//   K1  fused_topk_search     (_kernel, exact)       -> ehtorch_fused_topk
//   K2  fused_topk_search_v2  (_kernel_v2, approx)   -> ehtorch_fused_topk_v2
//
// Both compute, for every query b, the k smallest scores over the live rows
// of a row-major [cap, D] f32 arena without writing the [B, cap] score
// matrix to device memory.  The score is ||x||^2 - 2 q.x for l2 and -q.x
// for ip/cosine (cosine queries arrive normalized); dead rows and rows past
// cap score +inf.
//
// Pass 1 (a scan kernel): a block owns BQ=64 queries and one slice
// ("split") of the arena, which it walks in tiles of BN=128 rows.  Each
// query keeps its running top-k in its [k] slot of the partial output,
// device memory the wrapper allocated.  One warp owns a query for the whole
// scan, caches the current worst (score, slot) in shared memory, and
// touches the list only when a candidate beats it.  Nothing carries between
// blocks: splits exist to fill 132 SMs.
//   * K1 (scan_kernel): the [64, 128] score tile comes from CUDA-core f32
//     FMA out of shared memory, an 8x8 register tile per thread, and every
//     row competes.  exact=1 keeps full f32 operands (the twin of
//     Precision.HIGHEST); exact=0 rounds operands to bf16.
//   * K2 (scan_mma_kernel): operands are rounded to bf16 and multiplied on
//     the tensor cores (mma.sync m16n8k16, f32 accumulate); a warp owns 16
//     queries x 128 rows.  Each tile is one group of 128 consecutive rows
//     and gives only its (min, first argmin) per query, the group winner of
//     _kernel_v2 (pallas_topk.py:214-229), reduced in registers.
// Pass 2 (merge_kernel): one block per query sorts the splits*k partial
// entries by (score, id), keeps the first k, and applies the epilogue of
// pallas_topk.py:187-192: l2 adds ||q||^2 and clamps at 0, ip/cosine give
// 1 + score, slots without a row get id -1 and +inf.
//
// What bounds them on an H100:
//   * K1 is compute-bound on CUDA-core f32 FMA (2*B*cap*D flops against
//     about 67 TFLOP/s).  Exact f32 has no faster unit; this first version
//     keeps scores out of memory and filters cheaply, and reaches a fraction
//     of that peak.
//   * K2 would be bound by the arena stream (cap*D*4 bytes at 3.35 TB/s,
//     once per split of queries that share it in L2); this first version is
//     bound by the L2 -> shared-memory traffic of its f32 tiles (each block
//     re-reads its slice, 64 queries at a time) and by the running top-128,
//     which takes most group winners of a slice.  wgmma, a bf16 arena and
//     TMA are the next steps.
//
// A kernel launches on the caller's stream and allocates nothing.  Each C
// entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 128;       // arena rows per tile; K2's group width
constexpr int DK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 128;  // 8 (ty) x 16 (tx)
constexpr int TM = 8;         // queries per thread: ty + 8*i
constexpr int TN = 8;         // rows per thread: tx + 16*j
constexpr int OP_STRIDE = DK + 4;   // float4-aligned, conflict-free rows
constexpr int SC_STRIDE = BN + 16;  // ty and ty+1 land 16 banks apart
constexpr int OP_FLOATS = (BQ + BN) * OP_STRIDE;
constexpr int SC_FLOATS = BQ * SC_STRIDE;
constexpr int SMEM_FLOATS = OP_FLOATS > SC_FLOATS ? OP_FLOATS : SC_FLOATS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF = __builtin_huge_valf();
constexpr int MERGE_THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ x,
            const uint8_t* __restrict__ valid,
            const float* __restrict__ x_sq, float* pd, int* pi, int B,
            int cap, int D, int k, int l2, int splits, int tiles_per_split) {
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
      const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
      float* ld = pd + base;
      int* li = pi + base;
      float wv = worst_v[qq];
      int wp = worst_p[qq];
      const float* srow = sc + qq * SC_STRIDE;
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

// ---------------------------------------------------------------- K2 scan

constexpr int XS_WORDS = 20;  // a bf16 X row of DK=32 plus 8 pad, in words:
                              // conflict-free B-fragment loads

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp w owns queries q0+16w .. q0+16w+15 for both the product and the
// selection.  In the m16n8k16 layout lane (g = lane/4, t = lane%4) holds,
// for n-tile j, the scores of queries 16w+g and 16w+g+8 at rows
// r0 + 8j + 2t + {0, 1}.
__global__ void __launch_bounds__(THREADS)
scan_mma_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ x_sq, float* pd, int* pi, int B,
                int cap, int D, int k, int l2, int splits,
                int tiles_per_split) {
  __shared__ __align__(16) uint32_t xs[BN * XS_WORDS];  // [BN][DK] bf16
  __shared__ float worst_v[BQ];
  __shared__ int worst_p[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_tiles = (cap + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int qa = q0 + warp * 16 + g;  // this lane's A-fragment rows
  const int qb = qa + 8;

  init_lists(pd, pi, worst_v, worst_p, B, k, q0, split, splits);

  // One stage: a DK-deep slice of the 128-row tile (thread tid carries the
  // column pair tid%16 of rows tid/16 + 8i; a warp reads two rows' 32
  // consecutive floats) and of this lane's A fragments (rows qa/qb, columns
  // 2t, 2t+1 and 2t+8, 2t+9 of each k16 step, straight from global: the
  // block's 64 queries stay in L1).  The next stage's loads are issued
  // before this stage's product.
  const int lw = tid & 15;
  const int lr = tid >> 4;
  float stx[BN / 8][2], sta[DK / 16][4][2];
  auto load_stage = [&](int tile, int d0) {
    const int c = d0 + 2 * lw;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int xi = tile * BN + lr + 8 * i;
      const float* r = x + (size_t)xi * D;
      stx[i][0] = (xi < cap && c < D) ? r[c] : 0.f;
      stx[i][1] = (xi < cap && c + 1 < D) ? r[c + 1] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < DK / 16; ++s) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = (f & 1) ? qb : qa;
        const int cc = d0 + 16 * s + 2 * t + ((f & 2) ? 8 : 0);
        const float* r = q + (size_t)row * D;
        sta[s][f][0] = (row < B && cc < D) ? r[cc] : 0.f;
        sta[s][f][1] = (row < B && cc + 1 < D) ? r[cc + 1] : 0.f;
      }
    }
  };
  if (t_begin < t_end) load_stage(t_begin, 0);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int r0 = tile * BN;
    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();  // the last readers of xs are done
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        xs[(lr + 8 * i) * XS_WORDS + lw] = pack_bf16x2(stx[i][0], stx[i][1]);
      uint32_t a[DK / 16][4];
#pragma unroll
      for (int s = 0; s < DK / 16; ++s)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          a[s][f] = pack_bf16x2(sta[s][f][0], sta[s][f][1]);
      __syncthreads();
      if (d0 + DK < D)
        load_stage(tile, d0 + DK);
      else if (tile + 1 < t_end)
        load_stage(tile + 1, 0);
#pragma unroll
      for (int s = 0; s < DK / 16; ++s) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t* col = xs + (8 * j + g) * XS_WORDS + 8 * s + t;
          mma_bf16(acc[j], a[s], col[0], col[4]);
        }
      }
    }

    // Group winner per query, (score, column) lexicographic: columns are
    // visited in ascending order, so strict < keeps the first minimum.
    float va = INF, vb = INF;
    int ca = BN, cb = BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + 2 * t + h;
        const int row = r0 + col;
        const bool live = row < cap && valid[row] != 0;
        const float sq = (l2 && row < cap) ? x_sq[row] : 0.f;
        const float sa = l2 ? sq - 2.f * acc[j][h] : -acc[j][h];
        const float sb = l2 ? sq - 2.f * acc[j][2 + h] : -acc[j][2 + h];
        if (live && sa < va) {
          va = sa;
          ca = col;
        }
        if (live && sb < vb) {
          vb = sb;
          cb = col;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ova = __shfl_xor_sync(FULL, va, off);
      const int oca = __shfl_xor_sync(FULL, ca, off);
      const float ovb = __shfl_xor_sync(FULL, vb, off);
      const int ocb = __shfl_xor_sync(FULL, cb, off);
      if (ova < va || (ova == va && oca < ca)) {
        va = ova;
        ca = oca;
      }
      if (ovb < vb || (ovb == vb && ocb < cb)) {
        vb = ovb;
        cb = ocb;
      }
    }

    // Lane 4h holds the winners of queries 16w+h (va) and 16w+h+8 (vb).
    for (int h = 0; h < 16; ++h) {
      const int qq = warp * 16 + h;
      if (q0 + qq >= B) break;
      const float gv = __shfl_sync(FULL, h < 8 ? va : vb, (h & 7) << 2);
      const int gc = __shfl_sync(FULL, h < 8 ? ca : cb, (h & 7) << 2);
      float wv = worst_v[qq];
      if (gv < wv) {
        const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
        int wp = worst_p[qq];
        list_insert(pd + base, pi + base, k, lane, gv, r0 + gc, wv, wp);
        if (lane == 0) {
          worst_v[qq] = wv;
          worst_p[qq] = wp;
        }
        __syncwarp();
      }
    }
  }
}

// ------------------------------------------------------------ merge pass

// (score, id) as one unsigned key: sign-flipped float bits above the id.
// An empty slot is (+inf, -1); padding is all ones and sorts last.
__device__ __forceinline__ unsigned long long pack(float s, int id) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)id;
}

__device__ __forceinline__ float unpack_score(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
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

  float qsq = 0.f;
  if (l2) {
    float part = 0.f;
    for (int d = tid; d < D; d += MERGE_THREADS) {
      const float v = q[(size_t)b * D + d];
      part = fmaf(v, v, part);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
  }
  __syncthreads();
  if (l2)
    for (int w = 0; w < MERGE_THREADS / 32; ++w) qsq += red[w];

  for (int j = tid; j < k; j += MERGE_THREADS) {
    const unsigned long long key = keys[j];
    const int id = (int)(unsigned)(key & 0xffffffffu);
    const float s = unpack_score(key);
    float d = l2 ? fmaxf(s + qsq, 0.f) : 1.f + s;
    const bool hit = id >= 0 && isfinite(s);
    od[(size_t)b * k + j] = hit ? d : INF;
    oi[(size_t)b * k + j] = hit ? id : -1;
  }
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
    scan_kernel<false><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, pd, pi, B, cap, D, k, l2, splits, tiles_per_split);
  else
    scan_kernel<true><<<grid, THREADS, 0, s>>>(
        q, x, valid, x_sq, pd, pi, B, cap, D, k, l2, splits, tiles_per_split);
  return merge(q, pd, pi, od, oi, B, D, k, l2, splits, merge_slots, s);
}

// K2.  Same buffers; one candidate per 128-row group.
int ehtorch_fused_topk_v2(const float* q, const float* x,
                          const uint8_t* valid, const float* x_sq, float* pd,
                          int* pi, float* od, int* oi, int B, int cap, int D,
                          int k, int l2, int splits, int tiles_per_split,
                          int merge_slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  scan_mma_kernel<<<grid, THREADS, 0, s>>>(
      q, x, valid, x_sq, pd, pi, B, cap, D, k, l2, splits, tiles_per_split);
  return merge(q, pd, pi, od, oi, B, D, k, l2, splits, merge_slots, s);
}

}  // extern "C"
