// What the Hopper scans of k1_scan.cu (K1) and k2_scan.cu (K2) share:
// mbarriers and their bounded wait, TMA loads, the wgmma shared-memory
// descriptor and its fences, the per-row bias both scans add to a product,
// and the host's way to cuTensorMapEncodeTiled.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // 227 KB, a block's most
constexpr int NO_LIBCUDA = 9999;
constexpr int ENCODE_FAILED = 10000;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of the given parity has completed.  A phase that
// has not completed after 10 s of wall time (a copy that faulted, a bug)
// traps instead of holding the card.  The trap is a sticky error: it ends
// the process's CUDA context, so a server whose kernel stalls that long
// (a debugger, a card shared past all measure) must be restarted.  The
// timeout also shapes the code: without it ptxas moves each wait's retry
// loop out of line and then serializes every wgmma (ptxas -v: C7514), and
// K2's scan is about a fifth slower (tools/probe_k2_parts.py, PERF.md).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  unsigned polls = 0;
  uint64_t start = 0;
  do {
    if ((++polls & 1023u) == 0) {
      if (start == 0)
        start = now_ns();
      else if (now_ns() - start > 10000000000ull)
        __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map,
                                       int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// A wgmma operand of 8-row groups 1024 bytes apart, each row 128 bytes of
// K, swizzled in 128-byte spans: the layout a TMA box 128 bytes wide with
// CU_TENSOR_MAP_SWIZZLE_128B leaves.  One step of the product (k16 in
// bf16, k8 in TF32) starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)   // start address
         | ((uint64_t)1 << 16)               // leading offset: unused when swizzled
         | ((uint64_t)(1024 >> 4) << 32)     // stride offset: 8 rows
         | ((uint64_t)1 << 62);              // 128-byte swizzle
}

// Named barriers (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ the bias

// bias [n]: what a row adds to -2 q.x (l2) or -q.x: x_sq (l2) or 0 where
// live, +inf where dead and past cap, so a score is one FMA and a dead row
// never wins.
__global__ void row_bias_kernel(const uint8_t* __restrict__ valid,
                                const float* __restrict__ x_sq, float* __restrict__ bias,
                                int cap, int n, int l2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bias[i] = i < cap && valid[i] ? (l2 ? x_sq[i] : 0.f) : INF;
}

// ------------------------------------------------------ host: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the process has
// loaded already (PyTorch's CUDA context), so the library takes it from
// there and links nothing beyond the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// rows x cols of `type` (elem bytes each), rows row_bytes apart (a multiple
// of 16), in boxes of box_rows x box_cols (128 bytes wide), 128-byte
// swizzled; past the edges TMA fills zeros.
int encode_rows(EncodeTiled enc, CUtensorMap* m, CUtensorMapDataType type,
                const void* base, int cols, int rows, size_t row_bytes,
                int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, type, 2, const_cast<void*>(base), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// n f32 in boxes of one tile's rows.
int encode_bias(EncodeTiled enc, CUtensorMap* m, const float* base, int n,
                int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                         const_cast<float*>(base), dims, strides, boxes, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

}  // namespace
