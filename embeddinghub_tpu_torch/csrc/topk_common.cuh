// Helpers shared by the top-k kernels of k1_scan.cu (K1) and
// k2_scan.cu (K2): the (score, id) key, the epilogue of one result slot
// and the query norm the l2 epilogue adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float INF = __builtin_huge_valf();
constexpr int MERGE_THREADS = 256;  // threads of a block that owns one query

// (score, id) as one unsigned key: sign-flipped float bits above the id,
// so keys order as (score, id) do.  An empty slot is (+inf, -1); padding
// is all ones and sorts last.
__device__ __forceinline__ unsigned long long pack(float s, int id) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)id;
}

__device__ __forceinline__ float unpack_score(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// ||q_b||^2 for l2 (0 otherwise), summed by a block of MERGE_THREADS; a
// barrier.
__device__ __forceinline__ float block_sqnorm(const float* qb, int D, int l2,
                                              float* red) {
  const int tid = threadIdx.x;
  if (l2) {
    float part = 0.f;
    for (int d = tid; d < D; d += MERGE_THREADS) part = fmaf(qb[d], qb[d], part);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
  }
  __syncthreads();
  float qsq = 0.f;
  if (l2)
    for (int w = 0; w < MERGE_THREADS / 32; ++w) qsq += red[w];
  return qsq;
}

// The epilogue of one sorted key into result slot j, as
// pallas_topk.py:187-192 and :336-342: l2 adds ||q||^2 and clamps at 0,
// ip/cosine give 1 + score, a slot without a row gets id -1 and +inf.
__device__ __forceinline__ void emit(unsigned long long key, float qsq, int l2,
                                     float* od, int* oi, size_t j) {
  const int id = (int)(unsigned)(key & 0xffffffffu);
  const float s = unpack_score(key);
  const float d = l2 ? fmaxf(s + qsq, 0.f) : 1.f + s;
  const bool hit = id >= 0 && isfinite(s);
  od[j] = hit ? d : INF;
  oi[j] = hit ? id : -1;
}

}  // namespace
