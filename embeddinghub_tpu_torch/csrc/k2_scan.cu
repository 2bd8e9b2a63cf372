// K2 for Hopper (sm_90a): approximate k-NN candidates over a bf16 mirror
// of the arena, with TMA, mbarriers and wgmma.
//
// Replaces the Pallas kernel fused_topk_search_v2 (_kernel_v2) of
// embeddinghub_tpu/ops/pallas_topk.py:270 -> ehtorch_k2.  What it computes
// is the Pallas kernel's: operands rounded to bf16 (the mirror holds the
// rounded rows, k2_queries_kernel rounds the queries), products summed in
// f32;
// score x_sq - 2 q.x for l2, -q.x for ip/cosine; dead rows and rows past
// cap score +inf; one (min, first argmin) winner per group of 128
// consecutive rows; the k best winners per query, lower row first on ties;
// the epilogue of pallas_topk.py:336-342 (emit, topk_common.cuh).
//
// Bound on an H100 at the main path's shape (1M x 128 cosine, B=4096,
// k=128): 2*B*cap*D = 1.10e12 bf16 flops take 1.11 ms at 989 TFLOP/s; the
// bytes (bf16 mirror 268 MB, x_sq, valid, queries) take 0.08 ms at 3.35
// TB/s, so the product bounds it.  At B=1 the bytes do: 0.08 ms.
//
// Design, against what held back the mma.sync scan it replaces:
//  1. Tensor cores.  wgmma.mma_async m64n128k16 with the arena tile as B
//     from shared memory, K-major, 128-byte swizzled.  Two consumer
//     warpgroups own 64 queries each (128 per block).  At widths up to
//     192 columns the query fragments sit in registers for the whole scan
//     (A from registers), and each warpgroup keeps two accumulators of 64
//     f32 a thread, so it issues the next tile's products before it
//     reduces this one's: the tensor cores never wait for an epilogue
//     (setmaxnreg gives the consumers 232 registers, the producer 40).
//     Wider rows take both operands from shared memory, with one
//     accumulator per warpgroup.
//     The loop has no __syncthreads: mbarriers and named barriers only.
//  2. The arena stream.  The kernel reads the bf16 mirror that the index
//     keeps (index/flat.py), nothing is rounded in the loop.  One producer
//     thread issues TMA loads (cp.async.bulk.tensor) of 128-row x 64-column
//     boxes into a ring of stages, each with a full and an empty mbarrier,
//     and each 128-row tile's bias (x_sq or 0 where live, +inf where dead
//     or past cap, made by row_bias_kernel) into a ring of its own, so a
//     score is one FMA.  TMA zero-fills past cap and past B.  The block's
//     query tile is loaded once, in bf16, for the whole scan (widths past
//     576 columns stream it with each box instead: it does not fit beside
//     the ring).
//  3. Selection out of the product loop.  Per tile, each consumer thread
//     takes the in-thread min with first argmin over its 32 columns, then
//     two quad shuffles give each query's group winner, one 64-bit key
//     pack(score, row).  Each warpgroup stages its keys in shared memory
//     and writes them to a [B, G] buffer (G = ceil(cap/128)) with one TMA
//     store per 16 tiles, whole rows of 128 bytes instead of scattered
//     8-byte writes.  k2_select_kernel then takes each query's k best
//     keys: it finds the k-th key by counting (a search over the keys'
//     upper words held in registers, one block-wide sum a step), and a
//     bitonic sort of the chosen k.  Past SELECT_CHUNK groups it selects
//     per chunk and again over the chunks' winners.
//  4. The grid.  Blocks of 128 queries along x, slices of the arena along
//     y: the query tile varies fastest, so the blocks that share a slice
//     run together and read it from L2, and the slice count fills the SMs
//     at any B.
//
//
// The candidate pools of the quantized arenas take the same entry
// (ehtorch_k2) and scan with two changes, both template parameters:
//  * BIN, the rows a key stands for.  The main path keeps one winner per
//    128-row group (BIN = 128, the quad shuffle above).  A pool keeps one
//    per 32 strided rows: in the wgmma accumulator layout a consumer thread
//    holds columns 8j + 2t + {0, 1} (j < 16) of each of its two queries, so
//    its own minimum, with no shuffle, is one winner of the 32 rows
//    {8j + 2t + h} of the tile: four keys a tile (POOL_BIN).  On clustered
//    rows one winner per 128 rows drops a true neighbour whenever a
//    cluster mate shares its group; four bins a tile make that four times
//    rarer.
//  * I8, the operands.  The int8 arena's hi plane (index/flat.py) and the
//    queries quantized per row by the wrapper, qq = clip(round(q / qscale),
//    +-127), qscale = max|q| / 127 (embeddinghub_tpu/ops/topk.py:297-300),
//    multiply in wgmma.mma_async m64n128k32.s32.s8.s8, both operands from
//    shared memory, K-major (sm_90a takes 8-bit operands K-major only), in
//    128-byte boxes of 128 int8 columns, exact int32 sums.  Beside the bias
//    ring a ring of row scales: score = bias - c * f32(acc) with c = qs *
//    scale[row] (qs = 2 qscale for l2, qscale otherwise), each product and
//    the difference rounded on its own (no FMA), the order of the plain
//    version (ops/fused_topk.py pool_candidates_reference), so the two give
//    the same keys.  (f32(acc) compiles to I2FP.F32.S32, no slower than
//    the exact integer-add-and-subtract form on an H100: PERF.md.)
//    Replaces the XLA scans of
//    embeddinghub_tpu/ops/topk.py:301-313 (int8_oversample_search) and
//    :697-710 (quantized_chunked_exact's chunks).
//    Bound at the deep shape (10,000,000 live of 10,485,760 x 96, B=1024):
//    2*B*rows*D = 1.97e12 int8 operations take 0.99 ms at 1,979 TOPS; the
//    plane (0.96 GB) and the x_sq, scales and valid (9 bytes a row) take
//    0.31 ms at 3.35 TB/s: the operations bound it.  What bounds the scan
//    on the card is its epilogue, seven ALU instructions a score
//    (tools/probe_k2_parts.py: no_scores, no_products; PERF.md).
//  A pool's keys are selected per segment of `seg` keys (a deep arena's
//  chunk of rows, or the whole arena): the select below runs per (segment,
//  part) block and again over the parts' winners until one block a segment
//  is left, whose k best keys, ascending, it decodes into the output
//  (scores, rows) [B][segments][k].  The main path is the same select over
//  one segment, its last pass through the epilogue.  A pool scans and
//  selects only the tiles below `rows`, the arena's high-water mark (every
//  live row lies below it): a segment past it gets neither a scan nor a
//  select (the wrapper fills its slots empty), one that it cuts is selected
//  over its live tiles' keys, and the output is the same as over the whole
//  capacity, whose rows past the mark are dead.
//
// A kernel launches on the caller's stream and allocates nothing.  The C
// entry returns 0, a CUDA error code, or NO_LIBCUDA / ENCODE_FAILED + the
// CUresult when a tensor map cannot be made.

#include <cuda_bf16.h>

#include <type_traits>
#include <utility>

#include "hopper_common.cuh"

namespace {

constexpr int GROUP = 128;                   // rows per tile: K2's group
constexpr int BOX = 64;                      // bf16 columns per TMA box: the 128-byte swizzle span
constexpr int BOX_BYTES = GROUP * BOX * 2;   // one box of 128 rows (or queries): 16 KB
constexpr int WG_Q = 64;                     // queries per consumer warpgroup (wgmma M)
constexpr int BLOCK_Q = 2 * WG_Q;            // queries per block
constexpr int THREADS = 384;                 // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER = 256;                // the thread that issues every TMA load
constexpr int CONSUMER_WARPS = 8;            // arrivals that release a stage
constexpr int PRODUCER_REGS = 40;            // setmaxnreg: the producer gives up
constexpr int CONSUMER_REGS = 232;           // registers the consumers take
constexpr int TILE_STAGES = 4;               // ring of per-tile bias
constexpr int TILE_BYTES = GROUP * 4;        // f32 bias (and, I8, scales) of a tile's rows
constexpr int STORE_TILES = 16;              // keys of a query per TMA store
constexpr int STORE_BYTES = 2 * 2 * WG_Q * STORE_TILES * 8;  // 2 warpgroups x 2 buffers
constexpr int MAX_STAGES = 8;               // ring depth at most (more gained nothing)
constexpr int MIN_RESIDENT_STAGES = 4;       // else the query tile streams
constexpr int SELECT_CHUNK = 8192;           // keys one select block holds
constexpr int SELECT_THREADS = 512;          // threads of a select block
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_PER = SELECT_CHUNK / SELECT_THREADS;  // keys a select thread holds
constexpr int POOL_BIN = 32;                 // rows a pool's key stands for
constexpr int MAX_POOL_KP = 4096;            // a pool's k, rounded up to a power of two, at most

// Shared memory of the scan, from its 1024-byte aligned base: the query
// boxes (when resident), the ring, the staged keys, the tile ring, the
// mbarriers.
struct Layout {
  int nb;           // boxes across the padded width Dp (I8: 128-column boxes of D)
  int stages;       // ring depth
  int resident;     // query tile loaded once (1) or with each box (0)
  int stage_bytes;  // one arena box, plus its query box when streamed
  int tile_bytes;   // a tile ring stage: the bias, and for I8 the scales after it
  __host__ __device__ int ring_off() const { return resident ? nb * BOX_BYTES : 0; }
  __host__ __device__ int store_off() const { return ring_off() + stages * stage_bytes; }
  __host__ __device__ int tile_off() const { return store_off() + STORE_BYTES; }
  __host__ __device__ int bar_off() const { return tile_off() + TILE_STAGES * tile_bytes; }
  __host__ __device__ int bytes() const {
    return bar_off() + (2 * stages + 2 * TILE_STAGES + 1) * 8 + 1024;  // + alignment slack
  }
};

// Named barriers: warpgroup w syncs its own 128 threads on FLUSH + w around
// a store of its keys.
constexpr int FLUSH = 1;

// d[64] (+)= A[64 x 16] . B[16 x 128]^T, f32 sums of bf16 products; the
// first step of a tile (scale_d = 0) overwrites.
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers: a[0..3] the m64k16 fragment of this
// thread (rows g and g + 8 of its warp's 16, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9), as mma.sync m16n8k16 lays it out.
__device__ __forceinline__ void wgmma_128_rs(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64] (+)= A[64 x 32] . B[32 x 128]^T in int8 with exact int32 sums, both
// operands from shared memory, K-major; the first step of a tile
// (scale_d = 0) overwrites.
__device__ __forceinline__ void wgmma_128_i8(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads of the accumulators above the wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------------- the scan

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// (v, c) := the lexicographically smaller of (v, c) and (ov, oc).
__device__ __forceinline__ void take_min(float& v, int& c, float ov, int oc) {
  if (ov < v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

// What a consumer thread needs across tiles for its epilogues.
struct Epilogue {
  const uint8_t* tiles;  // the tile ring of biases (and scales)
  uint64_t* tempty;      // its empty barriers
  uint64_t* tfull;       // its full barriers
  uint64_t* staged;      // this warpgroup's two [64][STORE_TILES] key buffers
  const CUtensorMap* kmap;
  int wg, q_wg;          // the warpgroup, and its first query
  int row, tq, warp, lane;
  bool active;           // the warpgroup has a query below B
  float scale;           // score = bias + scale * q.x
  float qs0, qs1;        // I8: the multipliers of queries row and row + 8
  int tile_bytes;        // a tile ring stage
  int ts, tph, buf;      // tile ring stage and phase; key buffer
};

// The score of one product: bias + scale * acc (bf16), or I8 bias - (qs *
// scale[row]) * f32(acc), each operation rounded on its own, as the plain
// version computes it.
__device__ __forceinline__ float score_of(const Epilogue& e, float acc, float bias,
                                          float, float) {
  return fmaf(e.scale, acc, bias);
}
__device__ __forceinline__ float score_of(const Epilogue&, int acc, float bias,
                                          float qs, float sc) {
  return __fsub_rn(bias, __fmul_rn(__fmul_rn(qs, sc), __int2float_rn(acc)));
}

// One tile's epilogue, for the tile in acc: each query's bin winners into
// the staged keys, and every STORE_TILES keys (or at t_end) a TMA store of
// them.  write: t is a real tile (not the pad of an odd count).
//
// bias: x_sq (l2) or 0 for a live row, +inf for a dead one or one past
// cap, so a score is one FMA (I8: a product and a difference) and a dead
// row never wins.  Columns in
// ascending order within each of four chains (two rows, even and odd j)
// that the compiler can interleave; a chain keeps its minimum with fminf
// and its column (a constant of the unrolled loop, 2t added at the end)
// where the score is strictly below the minimum so far; the merges break
// ties by the lower column: the first minimum wins.  BIN = 128: two quad
// shuffles give the group winner, one key per query and tile; BIN = 32:
// each thread's own winner is its bin's, key 4 * tile + tq.  A bin with no
// live row keeps (+inf, its first row), a key that sorts last and leaves
// its slot empty.
template <int BIN, typename Acc>
__device__ __forceinline__ void tile_epilogue(Epilogue& e, const Acc* acc, int t,
                                              int t_end, bool write) {
  constexpr int KPT = GROUP / BIN;           // keys of a query per tile
  constexpr int TPS = STORE_TILES / KPT;     // tiles per store
  mbar_wait(e.tfull + e.ts, e.tph);
  if (e.active && write) {
    const float* bias = reinterpret_cast<const float*>(e.tiles + e.ts * e.tile_bytes);
    const float* scl = bias + GROUP;  // I8 only
    float v[4] = {INF, INF, INF, INF};
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < GROUP / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * e.tq);
      float2 ss = make_float2(0.f, 0.f);
      if constexpr (std::is_same<Acc, int>::value)
        ss = *reinterpret_cast<const float2*>(scl + 8 * j + 2 * e.tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float bh = h ? bb.y : bb.x;
        const float sh = h ? ss.y : ss.x;
        const float sa = score_of(e, acc[4 * j + h], bh, e.qs0, sh);
        const float sb = score_of(e, acc[4 * j + 2 + h], bh, e.qs1, sh);
        const int p = j & 1;
        c[p] = sa < v[p] ? 8 * j + h : c[p];
        v[p] = fminf(v[p], sa);
        c[2 + p] = sb < v[2 + p] ? 8 * j + h : c[2 + p];
        v[2 + p] = fminf(v[2 + p], sb);
      }
    }
    take_min(v[0], c[0], v[1], c[1]);
    take_min(v[2], c[2], v[3], c[3]);
    c[0] += 2 * e.tq;
    c[2] += 2 * e.tq;
    uint64_t* out = e.staged + e.buf * WG_Q * STORE_TILES;
    const int slot = t % TPS;
    if constexpr (BIN == GROUP) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ova = __shfl_xor_sync(FULL, v[0], off);
        const int oca = __shfl_xor_sync(FULL, c[0], off);
        const float ovb = __shfl_xor_sync(FULL, v[2], off);
        const int ocb = __shfl_xor_sync(FULL, c[2], off);
        take_min(v[0], c[0], ova, oca);
        take_min(v[2], c[2], ovb, ocb);
      }
      if (e.tq == 0) {
        out[e.row * STORE_TILES + slot] = pack(v[0], t * GROUP + c[0]);
        out[(e.row + 8) * STORE_TILES + slot] = pack(v[2], t * GROUP + c[2]);
      }
    } else {
      static_assert(BIN * 4 == GROUP, "a pool's bin is a thread's 32 columns");
      out[e.row * STORE_TILES + slot * KPT + e.tq] = pack(v[0], t * GROUP + c[0]);
      out[(e.row + 8) * STORE_TILES + slot * KPT + e.tq] = pack(v[2], t * GROUP + c[2]);
    }
    // Every STORE_TILES keys (slices start on a multiple of TPS tiles), one
    // TMA store writes the warpgroup's [64 x STORE_TILES] keys into the
    // [B, G * KPT] buffer; it clips rows past B and keys past the last tile.
    if (slot == TPS - 1 || t + 1 == t_end) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(FLUSH + e.wg, 128);
      if (e.warp == 0 && e.lane == 0) {
        tma_store_2d(e.kmap, out, (t - slot) * KPT, e.q_wg);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the store before this one has read the other buffer
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      }
      named_sync(FLUSH + e.wg, 128);
      e.buf ^= 1;
    }
  }
  __syncwarp();
  if (e.lane == 0) mbar_arrive(e.tempty + e.ts);
  if (++e.ts == TILE_STAGES) {
    e.ts = 0;
    e.tph ^= 1;
  }
}

// The products of one tile into acc, A from registers: RS boxes, each
// waited for in the ring and issued as four k16 steps, one commit group.
// Returns the tile's first stage.
template <int RS>
__device__ __forceinline__ int issue_rs(float* acc, const uint32_t (&afrag)[RS][BOX / 16][4],
                                        uint64_t* full, uint32_t ring, int stage_bytes,
                                        int stages, int& s, int& ph) {
  const int first = s;
#pragma unroll
  for (int j = 0; j < RS; ++j) {
    mbar_wait(full + s, ph);
    const uint32_t b_addr = ring + s * stage_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk)
      wgmma_128_rs(acc, afrag[j][kk], sw128_desc(b_addr + 32 * kk), (j | kk) != 0);
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_commit();
  return first;
}

// Warp w of a consumer warpgroup holds queries 16w + g and 16w + g + 8 of
// the warpgroup's 64 (g = lane / 4), at columns 8j + 2t + {0, 1} of the
// tile (t = lane % 4): d[4j + h] and d[4j + 2 + h].
//
// RS > 0: the query tile is resident and RS boxes wide (Dp = 64 RS), and
// the ring holds two tiles: each consumer thread loads its A fragments
// once, and the products take A from registers, so they read only the
// arena tile from shared memory (64 bytes a cycle at the tensor cores'
// rate, against 96 with both operands there).  Each warpgroup keeps two
// accumulators and issues tile t + 1's products before it reduces tile t,
// so the tensor cores always have the next tile while the epilogue runs.
// It issues one tile past its slice's end (the last tile again, when the
// count is odd, and once more at the end) to keep every product issue
// unconditional.  RS = 0: both operands from shared memory, any width, one
// accumulator, the two warpgroups side by side.  I8 (RS = 0 only): int8
// operands, int32 accumulators, and the scale ring (smap) beside the bias
// ring; qs [B] the queries' multipliers.  The int8 scan keeps one
// accumulator: its epilogue (seven ALU instructions a score) bounds it, and
// the two warpgroups already take turns at the tensor cores (two
// accumulators issuing tile t + 1's products first measured 9 % slower on
// an H100: PERF.md).  BIN: see tile_epilogue.
template <int RS, int BIN, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
k2_scan_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap smap,
               const __grid_constant__ CUtensorMap kmap, const float* __restrict__ qs,
               int B, int n_tiles, int tiles_per_split, int l2, Layout L) {
  static_assert(!I8 || RS == 0, "int8 operands come from shared memory");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off());
  uint64_t* empty = full + L.stages;
  uint64_t* tfull = empty + L.stages;
  uint64_t* tempty = tfull + TILE_STAGES;
  uint64_t* qbar = tempty + TILE_STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  // Tiles with an epilogue, and tiles whose products are issued (RS: an
  // even count, then one more).
  const int n_epi = RS > 0 ? (t_end - t_begin + 1) / 2 * 2 : t_end - t_begin;
  const int n_mma = RS > 0 ? n_epi + 1 : n_epi;

  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    for (int s = 0; s < TILE_STAGES; ++s) {
      mbar_init(tfull + s, 1);
      mbar_init(tempty + s, CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid != PRODUCER) return;
    constexpr int BOX_COLS = I8 ? 2 * BOX : BOX;  // a box is 128 bytes wide
    if (L.resident) {
      mbar_expect_tx(qbar, L.nb * BOX_BYTES);
      for (int j = 0; j < L.nb; ++j)
        tma_2d(smem + j * BOX_BYTES, &qmap, j * BOX_COLS, q0, qbar);
    }
    int s = 0, ph = 0, ts = 0, tph = 0;
    for (int i = 0; i < n_mma; ++i) {
      const int t = min(t_begin + i, t_end - 1);
      if (i < n_epi) {
        mbar_wait(tempty + ts, tph ^ 1);
        uint8_t* tile = smem + L.tile_off() + ts * L.tile_bytes;
        mbar_expect_tx(tfull + ts, L.tile_bytes);
        tma_1d(tile, &bmap, t * GROUP, tfull + ts);
        if constexpr (I8) tma_1d(tile + TILE_BYTES, &smap, t * GROUP, tfull + ts);
        if (++ts == TILE_STAGES) {
          ts = 0;
          tph ^= 1;
        }
      }
      for (int j = 0; j < L.nb; ++j) {
        mbar_wait(empty + s, ph ^ 1);
        uint8_t* st = smem + L.ring_off() + s * L.stage_bytes;
        mbar_expect_tx(full + s, L.stage_bytes);
        tma_2d(st, &xmap, j * BOX_COLS, t * GROUP, full + s);
        if (!L.resident) tma_2d(st + BOX_BYTES, &qmap, j * BOX_COLS, q0, full + s);
        if (++s == L.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  Epilogue e;
  e.tiles = smem + L.tile_off();
  e.tempty = tempty;
  e.tfull = tfull;
  // Two [64 queries][STORE_TILES] buffers of this warpgroup's winner keys.
  e.staged = reinterpret_cast<uint64_t*>(smem + L.store_off()) + wg * 2 * WG_Q * STORE_TILES;
  e.kmap = &kmap;
  e.wg = wg;
  e.q_wg = q0 + wg * WG_Q;
  e.warp = warp;
  e.lane = lane;
  e.tq = lane & 3;
  e.row = warp * 16 + (lane >> 2);  // this thread's queries: row, row + 8
  e.active = e.q_wg < B;
  e.scale = l2 ? -2.f : -1.f;
  e.qs0 = e.qs1 = 0.f;
  if constexpr (I8) {
    const int qa = e.q_wg + e.row;
    if (qa < B) e.qs0 = qs[qa];
    if (qa + 8 < B) e.qs1 = qs[qa + 8];
  }
  e.tile_bytes = L.tile_bytes;
  e.ts = e.tph = e.buf = 0;
  const uint32_t ring = smem_u32(smem + L.ring_off());
  if (L.resident) mbar_wait(qbar, 0);
  int s = 0, ph = 0;

  if constexpr (RS > 0) {
    // This thread's A fragments for every k16 step of every box: rows row
    // and row + 8 of the warpgroup's, in the 128-byte swizzle (16-byte
    // chunk c of row r sits at chunk c ^ (r % 8); r % 8 = g).
    uint32_t afrag[RS][BOX / 16][4];
    const uint8_t* rows = smem + (wg * WG_Q + e.row) * 128;
#pragma unroll
    for (int j = 0; j < RS; ++j)
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int col = 16 * kk + 2 * e.tq + ((f & 2) ? 8 : 0);
          const int off = (((col >> 3) ^ (lane >> 2)) << 4) + ((col & 7) << 1);
          afrag[j][kk][f] = *reinterpret_cast<const uint32_t*>(
              rows + j * BOX_BYTES + ((f & 1) ? 8 * 128 : 0) + off);
        }
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    auto release = [&](int first) {
      if (lane == 0)
        for (int j = 0, r = first; j < RS; ++j, r = r + 1 == L.stages ? 0 : r + 1)
          mbar_arrive(empty + r);
    };
    int s0 = issue_rs<RS>(acc0, afrag, full, ring, L.stage_bytes, L.stages, s, ph);
    for (int i = 0; i < n_epi; i += 2) {
      const int s1 = issue_rs<RS>(acc1, afrag, full, ring, L.stage_bytes, L.stages, s, ph);
      wgmma_wait<1>();
      fence_acc(acc0);
      release(s0);
      tile_epilogue<BIN>(e, acc0, t_begin + i, t_end, true);
      s0 = issue_rs<RS>(acc0, afrag, full, ring, L.stage_bytes, L.stages, s, ph);
      wgmma_wait<1>();
      fence_acc(acc1);
      release(s1);
      tile_epilogue<BIN>(e, acc1, t_begin + i + 1, t_end, t_begin + i + 1 < t_end);
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    release(s0);
  } else {
    using Acc = typename std::conditional<I8, int, float>::type;
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const uint32_t wg_rows = wg * WG_Q * 128;  // the warpgroup's 64 rows of a query box
    for (int t = t_begin; t < t_end; ++t) {
      // The products are issued on every path alike (a warpgroup past B
      // multiplies zeros): a wgmma under a branch is serialized.  The
      // padding columns of the mirror and the queries are zero.
      int prev = 0;
      for (int j = 0; j < L.nb; ++j) {
        mbar_wait(full + s, ph);
        const uint32_t b_addr = ring + s * L.stage_bytes;
        const uint32_t a_addr =
            (L.resident ? smem_u32(smem) + j * BOX_BYTES : b_addr + BOX_BYTES) + wg_rows;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk) {  // four steps of 32 bytes of K
          if constexpr (I8)
            wgmma_128_i8(acc, sw128_desc(a_addr + 32 * kk), sw128_desc(b_addr + 32 * kk),
                         (j | kk) != 0);
          else
            wgmma_128(acc, sw128_desc(a_addr + 32 * kk), sw128_desc(b_addr + 32 * kk),
                      (j | kk) != 0);
        }
        wgmma_commit();
        // The previous box's products are done: free its stage (a tile may
        // have more boxes than the ring has stages).
        wgmma_wait<1>();
        if (j > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
        if (++s == L.stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      tile_epilogue<BIN>(e, acc, t, t_end, true);
    }
  }
  if (e.active && warp == 0 && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------- the inputs

// The queries as K2 scores them, rounded to bf16 (to nearest even) into
// qb [B, Dp] with zero padding: a cosine query divided by its norm,
// floored at 1e-30 as ops/distance.normalize does.  One block per query.
__global__ void __launch_bounds__(MERGE_THREADS)
k2_queries_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ qb, int D,
                  int Dp, int cosine) {
  __shared__ float red[MERGE_THREADS / 32];
  const int b = blockIdx.x;
  const float* row = q + (size_t)b * D;
  const float norm = fmaxf(sqrtf(block_sqnorm(row, D, cosine, red)), 1e-30f);
  for (int d = threadIdx.x; d < Dp; d += MERGE_THREADS) {
    const float v = d < D ? (cosine ? row[d] / norm : row[d]) : 0.f;
    qb[(size_t)b * Dp + d] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------ selection

// What a select pass writes: the k best keys of each block (a pass that
// another follows), the main path's result slots through the epilogue
// (emit), or a pool's (score, row) pairs decoded from its keys.
enum SelectOut { TO_KEYS = 0, TO_EMIT = 1, TO_DECODE = 2 };

// The sum over the block of each thread's count; a barrier.  parity
// alternates the two arrays of warp sums, so that one barrier a count
// keeps a count's reads apart from the next count's writes.
__device__ __forceinline__ unsigned block_count(unsigned mine, unsigned (*sums)[SELECT_WARPS],
                                                int& parity) {
  const int lane = threadIdx.x & 31;
  mine = __reduce_add_sync(FULL, mine);
  if (lane == 0) sums[parity][threadIdx.x >> 5] = mine;
  __syncthreads();
  const unsigned total =
      __reduce_add_sync(FULL, lane < SELECT_WARPS ? sums[parity][lane] : 0u);
  parity ^= 1;
  return total;
}

// One block per (chunk, query): the k smallest of the chunk's keys (a
// query's n keys start every stride keys).  The keys fall in segments of
// seg keys, each cut in cps chunks of at most `chunk` keys: block x is
// chunk x % cps of segment x / cps, and a chunk never crosses a segment's
// end (the main path: one segment, seg = n).
//
// The block copies its keys into shared memory and keeps their upper words
// (the score's order bits) in registers, SELECT_PER a thread, strided so
// the loads coalesce.  It finds the take-th smallest key v by counting: a
// bisection over the upper words for the largest word H with fewer than
// take keys below it, then, where H's keys straddle the bound (equal
// scores, empty bins), a bisection over the row word among them.  Each
// step is one compare a key and one block-wide sum, and a step whose count
// is exactly take ends the search (two bounds a step, placed by
// interpolation, measured slower on an H100: PERF.md).  No histogram, no
// atomics on a shared bin: the radix select this replaces walked the keys
// in shared memory up to eight times with a ballot and a match_any a key.
// The keys below v,
// then copies of v up to take, are sorted (bitonic, in shared memory) and
// written out.  A chunk with fewer than k keys pads with all ones, which
// sorts last and reads as an empty slot.
template <int OUT>
__global__ void __launch_bounds__(SELECT_THREADS, 3)
k2_select_kernel(const unsigned long long* __restrict__ in, int n, int stride, int chunk,
                 int seg, int cps, int k, int kp, int out_segs,
                 unsigned long long* __restrict__ out, const float* __restrict__ q,
                 float* __restrict__ od, int* __restrict__ oi, int D, int l2) {
  extern __shared__ unsigned long long sk[];  // [chunk] keys, then [kp] chosen
  unsigned long long* sel = sk + chunk;
  __shared__ unsigned sums[2][SELECT_WARPS];
  __shared__ unsigned s_lo[SELECT_WARPS], s_hi[SELECT_WARPS];
  __shared__ int s_count;
  __shared__ float s_qsq;
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int sg = c / cps;
  const int seg_lo = sg * seg;
  const int part = c % cps * chunk;
  const int m = max(0, min(chunk, min(seg, n - seg_lo) - part));
  const int take = min(k, m);
  const unsigned long long* src = in + (size_t)b * stride + seg_lo + part;
  unsigned hi[SELECT_PER];  // upper words; all ones past the chunk's keys
#pragma unroll
  for (int i = 0; i < SELECT_PER; ++i) {
    const int e = tid + i * SELECT_THREADS;
    hi[i] = ~0u;
    if (e < m) {
      const unsigned long long key = src[e];
      sk[e] = key;
      hi[i] = (unsigned)(key >> 32);
    }
  }
  if (tid == 0) s_count = 0;
  int parity = 0;

  // v: the take-th smallest key, or a bound with exactly take keys below it
  // (all ones when the chunk has at most k).
  unsigned long long v = ~0ull;
  if (m > k) {
    unsigned lo_h = ~0u, hi_h = 0;
#pragma unroll
    for (int i = 0; i < SELECT_PER; ++i)
      if (tid + i * SELECT_THREADS < m) {
        lo_h = min(lo_h, hi[i]);
        hi_h = max(hi_h, hi[i]);
      }
    lo_h = __reduce_min_sync(FULL, lo_h);
    hi_h = __reduce_max_sync(FULL, hi_h);
    if (lane == 0) {
      s_lo[tid >> 5] = lo_h;
      s_hi[tid >> 5] = hi_h;
    }
    __syncthreads();
    lo_h = __reduce_min_sync(FULL, lane < SELECT_WARPS ? s_lo[lane] : ~0u);
    hi_h = __reduce_max_sync(FULL, lane < SELECT_WARPS ? s_hi[lane] : 0u);
    // #(upper word < L) = below < take < #(upper word < R); past the
    // chunk's keys the upper words are all ones, never below a mid < R.
    unsigned long long L = lo_h, R = (unsigned long long)hi_h + 1;
    unsigned below = 0;
    bool exact = false;
    while (R - L > 1) {
      const unsigned mid = (unsigned)((L + R) >> 1);
      unsigned mine = 0;
#pragma unroll
      for (int i = 0; i < SELECT_PER; ++i) mine += hi[i] < mid;
      const unsigned cnt = block_count(mine, sums, parity);
      if (cnt == (unsigned)take) {
        v = (unsigned long long)mid << 32;
        exact = true;
        break;
      }
      if (cnt < (unsigned)take) {
        L = mid;
        below = cnt;
      } else {
        R = mid;
      }
    }
    if (!exact) {
      // v's upper word is L; among L's keys, the bound on the row word
      const unsigned h = (unsigned)L;
      unsigned long long lb = 0, rb = 1ull << 32;
      while (rb - lb > 1) {
        const unsigned long long mid = (lb + rb) >> 1;
        unsigned mine = 0;
#pragma unroll
        for (int i = 0; i < SELECT_PER; ++i)
          mine += tid + i * SELECT_THREADS < m && hi[i] == h &&
                  (sk[tid + i * SELECT_THREADS] & 0xffffffffull) < mid;
        const unsigned cnt = below + block_count(mine, sums, parity);
        if (cnt == (unsigned)take) {
          lb = mid;
          exact = true;
          break;
        }
        if (cnt < (unsigned)take)
          lb = mid;
        else
          rb = mid;
      }
      v = ((unsigned long long)h << 32) | lb;
    }
  }

  // The keys below v, in any order, then copies of v up to take.
  __syncthreads();
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < SELECT_PER; ++i) {
    const int e = tid + i * SELECT_THREADS;
    mine += e < m && sk[e] < v;
  }
  unsigned incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  unsigned base = 0;
  if (lane == 31) base = atomicAdd(&s_count, (int)incl);
  unsigned pos = __shfl_sync(FULL, base, 31) + incl - mine;
#pragma unroll
  for (int i = 0; i < SELECT_PER; ++i) {
    const int e = tid + i * SELECT_THREADS;
    if (e < m && sk[e] < v) sel[pos++] = sk[e];
  }
  __syncthreads();
  for (int e = s_count + tid; e < take; e += SELECT_THREADS) sel[e] = v;
  for (int e = take + tid; e < kp; e += SELECT_THREADS) sel[e] = ~0ull;
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int e = tid; e < kp / 2; e += SELECT_THREADS) {
        const int a = 2 * e - (e & (stride - 1));
        const int z = a + stride;
        const bool up = (a & size) == 0;
        const unsigned long long x = sel[a], y = sel[z];
        if ((x > y) == up) {
          sel[a] = y;
          sel[z] = x;
        }
      }
    }
  }
  __syncthreads();
  if constexpr (OUT == TO_EMIT) {
    if (tid < 32) {
      const float* qb = q + (size_t)b * D;
      float part_sq = 0.f;
      if (l2)
        for (int d = lane; d < D; d += 32) part_sq = fmaf(qb[d], qb[d], part_sq);
#pragma unroll
      for (int off = 16; off; off >>= 1) part_sq += __shfl_xor_sync(FULL, part_sq, off);
      if (lane == 0) s_qsq = part_sq;
    }
    __syncthreads();
    for (int j = tid; j < k; j += SELECT_THREADS)
      emit(sel[j], s_qsq, l2, od, oi, (size_t)b * k + j);
  } else if constexpr (OUT == TO_DECODE) {
    const size_t at = ((size_t)b * out_segs + sg) * k;
    for (int j = tid; j < k; j += SELECT_THREADS) {
      const float s = unpack_score(sel[j]);
      const bool hit = isfinite(s);
      od[at + j] = hit ? s : INF;
      oi[at + j] = hit ? (int)(unsigned)(sel[j] & 0xffffffffu) : -1;
    }
  } else {
    unsigned long long* dst = out + ((size_t)b * gridDim.x + c) * k;
    for (int j = tid; j < k; j += SELECT_THREADS) dst[j] = sel[j];
  }
}

// ------------------------------------------------------ host: tensor maps

// The [rows, cols] u64 keys in rows of stride u64 (an even count: 16-byte
// rows), written in boxes of 64 queries x STORE_TILES tiles.
int encode_keys(EncodeTiled enc, CUtensorMap* m, void* base, int cols,
                int stride, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 8};
  const cuuint32_t box[2] = {STORE_TILES, WG_Q};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, base, dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// The scan's shared memory for rows of Dp bf16 columns, or (i8) of Dp int8
// columns in boxes of 128.
Layout scan_layout(int Dp, int i8) {
  Layout L{};
  L.nb = i8 ? (Dp + 2 * BOX - 1) / (2 * BOX) : Dp / BOX;
  L.tile_bytes = i8 ? 2 * TILE_BYTES : TILE_BYTES;
  const int fixed = STORE_BYTES + TILE_STAGES * L.tile_bytes +
                    (2 * MAX_STAGES + 2 * TILE_STAGES + 1) * 8 + 1024;
  int room = SMEM_LIMIT - fixed - L.nb * BOX_BYTES;
  L.resident = room >= MIN_RESIDENT_STAGES * BOX_BYTES;
  L.stage_bytes = L.resident ? BOX_BYTES : 2 * BOX_BYTES;
  if (!L.resident) room = SMEM_LIMIT - fixed;
  L.stages = min(MAX_STAGES, room / L.stage_bytes);
  return L;
}

// Lets the scan and the select kernels take more than 48 KB of shared
// memory, once per device.
cudaError_t opt_in_shared_memory() {
  static unsigned done = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done >> dev) & 1u)) return e;
  const void* scans[] = {
      (const void*)k2_scan_kernel<0, GROUP, false>, (const void*)k2_scan_kernel<1, GROUP, false>,
      (const void*)k2_scan_kernel<2, GROUP, false>, (const void*)k2_scan_kernel<3, GROUP, false>,
      (const void*)k2_scan_kernel<0, POOL_BIN, false>,
      (const void*)k2_scan_kernel<1, POOL_BIN, false>,
      (const void*)k2_scan_kernel<2, POOL_BIN, false>,
      (const void*)k2_scan_kernel<3, POOL_BIN, false>,
      (const void*)k2_scan_kernel<0, POOL_BIN, true>};
  for (const void* f : scans)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  const int select_most = (SELECT_CHUNK + MAX_POOL_KP) * (int)sizeof(unsigned long long);
  const void* selects[] = {(const void*)k2_select_kernel<TO_KEYS>,
                           (const void*)k2_select_kernel<TO_EMIT>,
                           (const void*)k2_select_kernel<TO_DECODE>};
  for (const void* f : selects)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, select_most);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

// sc [n]: the row scales of a pool's I8 scan, 0 past cap.
__global__ void row_scale_kernel(const float* __restrict__ scales, float* __restrict__ sc,
                                 int cap, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sc[i] = i < cap ? scales[i] : 0.f;
}

// Launches the scan over n_tiles tiles for B queries: slices of the arena
// start on a multiple of the tiles one TMA store of keys covers, so a store
// never crosses into another block's tiles.  bf16 operands take A from
// registers when the resident query tile is at most 3 boxes wide and the
// ring holds two tiles (at 4 boxes it holds 7 stages, not 8).
template <int BIN, bool I8>
cudaError_t launch_scan(const CUtensorMap& xmap, const CUtensorMap& qmap,
                        const CUtensorMap& bmap, const CUtensorMap& smap,
                        const CUtensorMap& kmap, const float* qs, int B, int n_tiles,
                        int splits, int l2, const Layout& L, cudaStream_t s) {
  constexpr int TPS = STORE_TILES * BIN / GROUP;
  int per = (n_tiles + splits - 1) / splits;
  per = (per + TPS - 1) / TPS * TPS;
  const dim3 grid((B + BLOCK_Q - 1) / BLOCK_Q, (n_tiles + per - 1) / per);
  const int rs = L.resident && L.nb <= 3 && L.stages >= 2 * L.nb ? L.nb : 0;
  auto scan = I8 ? k2_scan_kernel<0, BIN, I8>
            : rs == 1 ? k2_scan_kernel<1, BIN, false> : rs == 2 ? k2_scan_kernel<2, BIN, false>
            : rs == 3 ? k2_scan_kernel<3, BIN, false> : k2_scan_kernel<0, BIN, false>;
  scan<<<grid, THREADS, L.bytes(), s>>>(xmap, qmap, bmap, smap, kmap, qs, B, n_tiles, per,
                                        l2, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: the scan, then the k best keys (score, row) of every segment of seg
// keys, one key per bin of `bin` rows: GROUP (the main path's groups) or,
// for a quantized search's candidate pool, POOL_BIN.
// i8 = 0: q [B, D] f32, rounded to bf16 here into the scratch qb [B, Dp]
// (a cosine query divided by its norm first when cosine = 1; a pool's
// queries come normalized); plane: the [cap, Dp] bf16 mirror (Dp a
// multiple of 64, 16-byte aligned).  i8 = 1 (bin POOL_BIN): q the [B, D]
// int8 queries in rows of q_bytes bytes and qs [B] their multipliers (2
// qscale for l2, qscale otherwise); plane the [cap, D] int8 hi plane in
// rows of plane_bytes bytes (both multiples of 16, 16-byte aligned),
// scales [cap] f32.  valid [cap] u8, x_sq [cap] f32.  rows: every live row
// lies below it (the arena's high-water mark, at most cap): the scan and
// the selects cover the T = ceil(rows / 128) tiles below it, and a segment
// past them is left to the caller (rows > 0).  Scratch: bias and sc
// [T * 128] f32 (sc for i8 only); keys [B, stride], stride even, at
// least T * 128 / bin and, where a segment takes three select passes, the
// second pass's live segments * ceil(parts * k / SELECT_CHUNK) * k keys;
// part [B, live segments * parts * k] when a segment holds more than
// SELECT_CHUNK keys (parts = ceil(seg / SELECT_CHUNK)), else unused.
// emit = 1 (the main path: bf16, one segment, rows = cap): the epilogue
// writes od/oi [B, k]; emit = 0: od/oi [B, segments, k], each live
// segment's k best (score, row) ascending, (+inf, -1) past its live bins.
// k <= MAX_POOL_KP.  splits: arena slices along the scan grid's y.
int ehtorch_k2(const void* q, const float* qs, const uint8_t* valid, const float* x_sq,
               const float* scales, const void* plane, void* qb, float* bias, float* sc,
               unsigned long long* keys, unsigned long long* part, float* od, int* oi, int B,
               int cap, int rows, int D, int Dp, int q_bytes, int plane_bytes, int stride, int k,
               int seg, int bin, int l2, int cosine, int i8, int emit, int splits,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int kp = 1;
  while (kp < k) kp <<= 1;
  const int n_tiles = (cap + GROUP - 1) / GROUP;
  const int kpt = GROUP / max(bin, 1);
  const int nk = n_tiles * kpt;
  const int lt = (max(0, min(rows, cap)) + GROUP - 1) / GROUP;  // live tiles
  const int nk_live = lt * kpt;
  if (kp > MAX_POOL_KP || seg < 1 || lt < 1 || (bin != GROUP && bin != POOL_BIN) ||
      (i8 && bin != POOL_BIN) || (emit && (i8 || seg < nk || lt != n_tiles)) || stride < nk_live)
    return (int)cudaErrorInvalidValue;
  const int n_seg = (nk + seg - 1) / seg;
  const int n_live = (nk_live + seg - 1) / seg;  // segments with a live tile
  // The select passes below alternate keys -> part -> keys ...: the first
  // writes parts = ceil(seg / SELECT_CHUNK) chunks' k keys a live segment
  // into part, the second ceil(parts * k / SELECT_CHUNK) into keys, and
  // each later one fewer (k <= SELECT_CHUNK / 2), so these two bound them.
  const int parts = (seg + SELECT_CHUNK - 1) / SELECT_CHUNK;
  const int parts2 = (parts * k + SELECT_CHUNK - 1) / SELECT_CHUNK;
  if (parts > 1 && parts2 > 1 && (size_t)n_live * parts2 * k > (size_t)stride)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return NO_LIBCUDA;
  CUtensorMap xmap, qmap, bmap, smap, kmap;
  int err;
  if (i8) {
    const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    err = encode_rows(enc, &xmap, u8, plane, D, cap, (size_t)plane_bytes, 2 * BOX, GROUP);
    if (!err) err = encode_rows(enc, &qmap, u8, q, D, B, (size_t)q_bytes, 2 * BOX, GROUP);
    if (!err) err = encode_bias(enc, &smap, sc, lt * GROUP, GROUP);
  } else {
    const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    err = encode_rows(enc, &xmap, bf16, plane, Dp, cap, (size_t)Dp * 2, BOX, GROUP);
    if (!err) err = encode_rows(enc, &qmap, bf16, qb, Dp, B, (size_t)Dp * 2, BOX, GROUP);
  }
  if (!err) err = encode_bias(enc, &bmap, bias, lt * GROUP, GROUP);
  if (!err) err = encode_keys(enc, &kmap, keys, nk_live, stride, B);
  if (err) return err;
  if (!i8) smap = bmap;  // unread

  if (i8)
    row_scale_kernel<<<(lt * GROUP + 255) / 256, 256, 0, s>>>(scales, sc, cap, lt * GROUP);
  else
    k2_queries_kernel<<<B, MERGE_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<__nv_bfloat16*>(qb), D, Dp, cosine);
  row_bias_kernel<<<(lt * GROUP + 255) / 256, 256, 0, s>>>(valid, x_sq, bias, cap,
                                                           lt * GROUP, l2);
  cudaError_t e = opt_in_shared_memory();
  if (e != cudaSuccess) return (int)e;
  const Layout L = scan_layout(i8 ? D : Dp, i8);
  const float* qsp = i8 ? qs : nullptr;
  e = i8 ? launch_scan<POOL_BIN, true>(xmap, qmap, bmap, smap, kmap, qsp, B, lt, splits, l2,
                                       L, s)
      : bin == GROUP
          ? launch_scan<GROUP, false>(xmap, qmap, bmap, smap, kmap, qsp, B, lt, splits, l2,
                                      L, s)
          : launch_scan<POOL_BIN, false>(xmap, qmap, bmap, smap, kmap, qsp, B, lt, splits,
                                         l2, L, s);
  if (e != cudaSuccess) return (int)e;

  // Per live segment: chunks of at most SELECT_CHUNK keys down to k keys
  // each, until one chunk a segment is left; its k best are the output
  // (through the epilogue when emit).
  int n = nk_live, cur = seg, st = stride;
  unsigned long long* src = keys;
  unsigned long long* dst = part;
  while (true) {
    const int cps = (cur + SELECT_CHUNK - 1) / SELECT_CHUNK;
    const int chunk = (cur + cps - 1) / cps;
    const size_t smem = (size_t)(chunk + kp) * sizeof(unsigned long long);
    const dim3 grid(n_live * cps, B);
    if (cps == 1 && emit)
      k2_select_kernel<TO_EMIT><<<grid, SELECT_THREADS, smem, s>>>(
          src, n, st, chunk, cur, 1, k, kp, 1, nullptr, static_cast<const float*>(q), od, oi,
          D, l2);
    else if (cps == 1)
      k2_select_kernel<TO_DECODE><<<grid, SELECT_THREADS, smem, s>>>(
          src, n, st, chunk, cur, 1, k, kp, n_seg, nullptr, nullptr, od, oi, D, l2);
    else
      k2_select_kernel<TO_KEYS><<<grid, SELECT_THREADS, smem, s>>>(
          src, n, st, chunk, cur, cps, k, kp, 0, dst, nullptr, nullptr, nullptr, D, l2);
    e = cudaGetLastError();
    if (e != cudaSuccess || cps == 1) return (int)e;
    cur = cps * k;
    n = st = n_live * cur;
    std::swap(src, dst);
  }
}

}  // extern "C"
