// Hopper pieces shared by the wgmma kernels, and the persistent GEMM main
// loop that the encoder GEMMs (encoder_layer.cu), the bin top-k in its
// bf16 and int8 modes (bin_topk.cu), the score GEMM (score.cu) and the
// W8A8 encoder GEMMs (encoder_layer_q.cu) run on; int4_matmul.cu's prefill
// uses the pieces.
//
// The main loop, wg_gemm_kernel<BN, B_MN, Epi, T, PP, M_FAST>: C = A .
// B^T-or-B over 128 x BN output tiles (BN 128 or 256), one fixed k order
// per output element (no split-K, no atomics: runs repeat bit for bit), for
// element type T: WgBf16 (bf16 operands, f32 sums, m64nBNk16) or WgS8 (int8
// operands, exact s32 sums, m64nBNk32, both operands K-major).
// * One block per SM (grid = min(tiles, SMs)) walks the tiles t, t + grid,
//   ... in the order row tile = t / n_tiles, column tile = t % n_tiles, or
//   with M_FAST (score.cu) row tile = t % m_tiles, column tile = t /
//   m_tiles: the blocks in flight together then share a few column tiles,
//   so each B tile is read from device memory once and the rest from L2.
// * 384 threads: warpgroups 0 and 1 consume (rows 64 * wg .. + 63 of the
//   tile, wgmma with a register accumulator), warpgroup 2 produces;
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232), which the launcher checks the block was given.
// * The producer is one thread that keeps a ring of k stages in flight,
//   each one 128-byte row deep (64 bf16 or 128 int8 k; 4 stages at BN 256,
//   6 at BN 128: 192 KB) with TMA: each stage is one box of A [128
//   rows][128 bytes] and B's [64 k][BN] as BN / 64 boxes of [64 k][64 n]
//   (B_MN, bf16 only: B is [K, N] row-major, MN-major for wgmma) or one
//   box [BN n][128 bytes] (B is [N, K] row-major, K-major), all in the
//   128-byte swizzle that wgmma reads, arriving on the stage's mbarrier
//   with its byte count.  TMA rather than cp.async loader threads: one
//   thread moves a whole stage, the copy costs the consumers no
//   instruction slots, and rows, columns and k past the matrix read as
//   zeros, so a ragged M, N or K needs no predicate in the loop.  The
//   tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//   looked up through the CUDA runtime, so libcuda is not linked.
// * The consumers keep one wgmma group in flight behind the one they
//   start and give each stage back (256 arrivals on its empty barrier) as
//   soon as its products are done, so the producer runs up to a ring ahead:
//   while the consumers run one tile's epilogue, the next tile's first
//   stages load.
// * PP, the ping-pong variant (encoder_layer_q.cu's qkv, o and FFN-out;
//   bin_topk.cu's int8 modes):
//   each consumer warpgroup takes whole 128 x 128 tiles in turn, its
//   epilogue beside the other's products.
// * Epi is called by the 256 consumer threads with the tile's accumulator
//   (layout above wgmma_m64n128; s32 as f32) and Epi::SMEM bytes of shared
//   scratch (1024-aligned), which keeps its contents from tile to tile; it
//   may synchronise the consumers with consumer_sync().  Its
//   finish(consumer thread) is called after the last tile (an epilogue
//   that stores with TMA waits for its stores there).  The kernel takes
//   Epi as a __grid_constant__ parameter, so a tensor map inside it can be
//   handed to TMA.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked

#include <mutex>

#include "common.cuh"

// The output tile's rows, and the k elements of a bf16 stage.
constexpr int WG_BM = 128, WG_BK = 64;

// ---------------------------------------------------------------- host

// The element type of a TMA map (tma_encode's kind).
enum { TMA_BF16 = 0, TMA_F32 = 1, TMA_I8 = 2 };

inline int tma_elem_bytes(int kind) {
  return kind == TMA_F32 ? 4 : kind == TMA_I8 ? 1 : 2;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map of rank 2 or 3 over a bf16, f32 or int8 tensor (kind: TMA_*;
// true and false read as f32 and bf16), dims[0]
// contiguous (dims and box innermost first; strides[i] bytes between steps
// of dims[i + 1], multiples of 16), in the 128-byte swizzle (box[0]
// elements fill one 128-byte swizzle row at most); reads past the tensor
// return zeros and stores past it are dropped.  Returns a cudaError_t
// value.  Encoding a map costs the host microseconds, more than a small
// kernel takes on the card, so maps are kept in a cache keyed by all of
// their arguments (a map depends on nothing else, so a hit is exact): 64
// sets of 4, the set from a mix of every argument, so that operands whose
// bases lie a power of two apart (a kernel's q and out, k and v) do not
// evict each other, and a set's ways refilled in turn.
inline int tma_encode(CUtensorMap* map, const void* base, int kind, int rank,
                      const long long* dims, const long long* strides,
                      const int* box) {
  struct Entry {
    const void* base;
    int rank, kind;
    long long dims[3], strides[2];
    int box[3];
    CUtensorMap map;
  };
  constexpr int SETS = 64, WAYS = 4;
  static Entry cache[SETS][WAYS];
  static unsigned next_way[SETS];
  static std::mutex lock;
  uint64_t h = reinterpret_cast<uintptr_t>(base) * 0x9e3779b97f4a7c15ull +
               static_cast<uint64_t>(kind);
  for (int i = 0; i < rank; ++i) {
    h = (h ^ static_cast<uint64_t>(dims[i])) * 0x100000001b3ull;
    h = (h ^ static_cast<uint64_t>(box[i])) * 0x100000001b3ull;
    if (i) h = (h ^ static_cast<uint64_t>(strides[i - 1])) * 0x100000001b3ull;
  }
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  const int set = static_cast<int>(h % SETS);
  auto hit = [&](const Entry& e) {
    if (e.base != base || e.rank != rank || e.kind != kind) return false;
    for (int i = 0; i < rank; ++i)
      if (e.dims[i] != dims[i] || e.box[i] != box[i] ||
          (i && e.strides[i - 1] != strides[i - 1]))
        return false;
    return true;
  };
  {
    std::lock_guard<std::mutex> g(lock);
    for (int w = 0; w < WAYS; ++w)
      if (hit(cache[set][w])) {
        *map = cache[set][w].map;
        return 0;
      }
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3];
  const cuuint32_t elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    if (i) st[i - 1] = static_cast<cuuint64_t>(strides[i - 1]);
  }
  CUresult r = fn(map,
                  kind == TMA_F32  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : kind == TMA_I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  rank, const_cast<void*>(base), d, st, bx, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> g(lock);
  Entry& e = cache[set][next_way[set]++ % WAYS];
  e.base = base;
  e.rank = rank;
  e.kind = kind;
  for (int i = 0; i < rank; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
    if (i) e.strides[i - 1] = strides[i - 1];
  }
  e.map = *map;
  return 0;
}

// The map of the row-major matrix [rows, cols] (row stride ld elements,
// 16-byte rows) in boxes of [box_rows][box_cols].
inline int tma_map(CUtensorMap* map, const void* base, int kind,
                   long long rows, long long cols, long long ld, int box_rows,
                   int box_cols) {
  const long long dims[2] = {cols, rows},
                  strides[1] = {ld * tma_elem_bytes(kind)};
  const int box[2] = {box_cols, box_rows};
  return tma_encode(map, base, kind, 2, dims, strides, box);
}

// ------------------------------------------------------------ barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity; traps
// after about ten seconds instead of hanging the card.  The loop is inside
// the asm, so the compiler sees no divergent path around the wgmma.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 20000000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives once and expects `bytes` of asynchronous copies (TMA) to land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives on the barrier once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The box of `map` at element (c0 along the row, c1 rows down) into
// shared memory (1024-aligned), completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), 1024-aligned.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an MN-major tile as TMA lays out [64 k][64 n] boxes side by
// side: a k row of 64 n is 128 bytes, 8-row k atoms 1024 bytes apart
// (stride byte offset), 64-wide n chunks 8192 bytes apart (leading byte
// offset); advancing 16 k rows is 2048 bytes.
__device__ __forceinline__ uint64_t wg_desc_mn(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(8192 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[16 x 128], bf16 in shared memory, f32 sums; scale_d 0
// overwrites d.  TB 0: B is K-major (wg_desc); TB 1: B is MN-major
// (wg_desc_mn).  d[4j + e]: row 16 * (warp % 4) + lane / 4 + 8 (e >> 1),
// column 8j + 2 (lane % 4) + (e & 1).
template <int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (+)= A[64 x 16] . B[16 x 256], bf16 in shared memory, f32 sums; scale_d 0
// overwrites d.  TB 0: B is K-major (wg_desc); TB 1: B is MN-major
// (wg_desc_mn).  d[4j + e]: row 16 * (warp % 4) + lane / 4 + 8 (e >> 1),
// column 8j + 2 (lane % 4) + (e & 1).
template <int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (+)= A[64 x 32] . B[32 x 128], s8 in shared memory, both K-major
// (wg_desc), s32 sums; scale_d 0 overwrites d.  d[4j + e] as in
// wgmma_m64n128.
__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 32] . B[32 x 256], s8 in shared memory, both K-major
// (wg_desc), s32 sums; scale_d 0 overwrites d.  d[4j + e] as in
// wgmma_m64n256.
__device__ __forceinline__ void wgmma_s8_m64n256(int (&d)[128], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// Both operands K-major, 64 x 128 (int4_matmul.cu's prefill).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  wgmma_m64n128<0>(d, da, db, scale_d);
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256<TB>(d, da, db, scale_d);
  else
    wgmma_m64n128<TB>(d, da, db, scale_d);
}

// The element types of wg_gemm_kernel.  A wgmma k step reads 32 bytes of
// each operand row either way (16 bf16 or 32 int8), so a 64-deep bf16 or
// 128-deep int8 stage is one 128-byte swizzle row: the ring, its TMA boxes
// and the descriptors' k steps are the same bytes; only the instruction,
// the accumulator's type and the k elements a stage differ.
struct WgBf16 {
  using Acc = float;                   // f32 sums
  static constexpr int BK = WG_BK;  // k elements a stage
  static constexpr int TMA_KIND = TMA_BF16;
  template <int BN, int TB>
  __device__ static void mma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                             int scale_d) {
    wgmma_bn<BN, TB>(d, da, db, scale_d);
  }
};

// s8 x s8 with s32 sums (exact: |sum| <= K * 127 * 127 < 2^31 for K up to
// 133,000).  s8 wgmma has no transpose, so B is K-major ([N, K]) only.
struct WgS8 {
  using Acc = int;
  static constexpr int BK = 2 * WG_BK;
  static constexpr int TMA_KIND = TMA_I8;
  template <int BN, int TB>
  __device__ static void mma(int (&d)[BN / 2], uint64_t da, uint64_t db,
                             int scale_d) {
    static_assert(TB == 0, "s8 wgmma reads B K-major only");
    if constexpr (BN == 256)
      wgmma_s8_m64n256(d, da, db, scale_d);
    else
      wgmma_s8_m64n128(d, da, db, scale_d);
  }
};

// TMA store of the box of `map` at element (c0 along the row, c1 rows
// down) from shared memory (1024-aligned, written in the map's swizzle and
// made visible with fence_proxy_async), in this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk store groups are pending:
// pending in reading their shared memory (READ), or at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier 1 over the 256 consumer threads of wg_gemm_kernel.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ------------------------------------------------------ the GEMM main loop

constexpr int WG_THREADS = 384;
constexpr int WG_REGS_PRODUCER = 40, WG_REGS_CONSUMER = 232;

// The ring, and the shared memory of a block: the ring, the epilogue's
// scratch (one for each consumer warpgroup under ping-pong, which leaves
// room for five stages), the full and empty barriers and ping-pong's two
// order barriers.
template <int BN, bool PP = false>
struct WgRing {
  static constexpr int A_BYTES = WG_BM * 128;  // 128-byte k rows
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = PP ? 5 : BN == 256 ? 4 : 6;
  template <class Epi>
  static constexpr int smem() {
    return 1024 + STAGES * STAGE + (PP ? 2 : 1) * Epi::SMEM +
           (2 * STAGES + 2) * 8;
  }
};

// PP (ping-pong; BN 128): each consumer warpgroup takes
// whole 128 x BN tiles of its own, the block's tiles in turn (warpgroup 0
// the even ones), with two m64 accumulators, so that one warpgroup's
// epilogue runs while the other's products do.  An order barrier passes
// the turn: a warpgroup starts its products once the other has waited for
// all of its tile's stages, so their stages reach the ring, and each full
// barrier is waited for, in order (a parity wait cannot tell a phase from
// the one two later).  Each warpgroup has its own epilogue scratch and
// calls Epi::team(acc[2][BN / 2], mt, nt, wg, thread of the warpgroup,
// scratch).
template <int BN, bool B_MN, class Epi, class T, bool PP, bool M_FAST>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wg_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, int m_tiles,
                   int n_tiles, int k_stages,
                   const __grid_constant__ Epi epi) {
  static_assert(!PP || (BN == 128 && !B_MN && !M_FAST),
                "ping-pong: 128 x 128 tiles, K-major B, row-major walk");
  using R = WgRing<BN, PP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* scratch = smem + R::STAGES * R::STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(scratch + (PP ? 2 : 1) * Epi::SMEM);
  uint64_t* empty = full + R::STAGES;
  uint64_t* order = empty + R::STAGES;  // PP: warpgroup w's turn, order[w]
  const int tiles = m_tiles * n_tiles;
  // the role, warpgroup-uniform to the compiler (no divergent path around
  // the wgmma)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival with the bytes
      // every consumer thread (of the one warpgroup that used the stage
      // under ping-pong)
      mbar_init(&empty[s], PP ? 128 : 256);
    }
    mbar_init(&order[0], 128);
    mbar_init(&order[1], 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     WG_REGS_PRODUCER)
                 : "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (M_FAST ? tile % m_tiles : tile / n_tiles) * WG_BM,
                  n0 = (M_FAST ? tile / m_tiles : tile % n_tiles) * BN;
        for (int ks = 0; ks < k_stages; ++ks, ++it) {
          const int slot = it % R::STAGES;
          mbar_wait(&empty[slot], ((it / R::STAGES) & 1) ^ 1);
          unsigned char* st = smem + slot * R::STAGE;
          mbar_expect_tx(&full[slot], R::STAGE);
          tma_load_2d(st, &tma_a, &full[slot], ks * T::BK, m0);
          if constexpr (B_MN) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(st + R::A_BYTES + c * 8192, &tma_b, &full[slot],
                          n0 + 64 * c, ks * T::BK);
          } else {
            tma_load_2d(st + R::A_BYTES, &tma_b, &full[slot], ks * T::BK,
                        n0);
          }
        }
      }
    }
  } else if constexpr (PP) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     WG_REGS_CONSUMER)
                 : "memory");
    constexpr uint64_t B_STEP = 32 >> 4;  // K-major B
    constexpr int K_STEPS = 4;
    typename T::Acc acc[2][BN / 2];  // rows 0-63 and 64-127 of the tile
    const int ctid = threadIdx.x & 127;
    unsigned char* own = scratch + wg * Epi::SMEM;
    int it = 0, turns = 0;
    // a stage's products: A's rows 0-63 and 64-127 against the same B
#define WG_PP_STAGE(SCALE_D)                                                 \
  {                                                                          \
    unsigned char* st = smem + slot * R::STAGE;                              \
    const uint64_t da = wg_desc(st);                                         \
    const uint64_t db = wg_desc(st + R::A_BYTES);                            \
    _Pragma("unroll") for (int kk = 0; kk < K_STEPS; ++kk) {                 \
      T::template mma<BN, B_MN>(acc[0], da + 2 * kk, db + B_STEP * kk,       \
                                SCALE_D);                                    \
      T::template mma<BN, B_MN>(acc[1], da + (64 * 128 >> 4) + 2 * kk,       \
                                db + B_STEP * kk, SCALE_D);                  \
    }                                                                        \
  }
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      if ((i & 1) != wg) {  // the other warpgroup's tile
        it += k_stages;
        continue;
      }
      if (i > 0) mbar_wait(&order[wg], (turns++) & 1);
      {  // the tile's first stage overwrites the accumulators
        const int slot = it % R::STAGES;
        mbar_wait(&full[slot], (it / R::STAGES) & 1);
        wg_fence();
        WG_PP_STAGE(kk)
        wg_commit();
        ++it;
      }
      for (int ks = 1; ks < k_stages; ++ks, ++it) {
        const int slot = it % R::STAGES;
        mbar_wait(&full[slot], (it / R::STAGES) & 1);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wg_fence();
        WG_PP_STAGE(1)
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        mbar_arrive(&empty[(it - 1) % R::STAGES]);
      }
      mbar_arrive(&order[wg ^ 1]);  // the other warpgroup's turn
      wg_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      mbar_arrive(&empty[(it - 1) % R::STAGES]);
      epi.team(acc, tile / n_tiles, tile % n_tiles, wg, ctid, own);
    }
#undef WG_PP_STAGE
    epi.finish(ctid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     WG_REGS_CONSUMER)
                 : "memory");
    // a k step (16 bf16 or 32 int8) advances A by 32 bytes; B by 32 bytes
    // (K-major) or 16 k rows of 128 bytes (MN-major); descriptors count
    // 16-byte units; a stage's 128-byte rows hold four k steps
    constexpr uint64_t B_STEP = B_MN ? 2048 >> 4 : 32 >> 4;
    constexpr int K_STEPS = 4;
    typename T::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      {  // the tile's first stage overwrites the accumulator
        const int slot = it % R::STAGES;
        unsigned char* st = smem + slot * R::STAGE;
        mbar_wait(&full[slot], (it / R::STAGES) & 1);
        const uint64_t da = wg_desc(st + wg * 64 * 128);
        const uint64_t db = B_MN ? wg_desc_mn(st + R::A_BYTES)
                                 : wg_desc(st + R::A_BYTES);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < K_STEPS; ++kk)
          T::template mma<BN, B_MN>(acc, da + 2 * kk, db + B_STEP * kk, kk);
        wg_commit();
        ++it;
      }
      for (int ks = 1; ks < k_stages; ++ks, ++it) {
        const int slot = it % R::STAGES;
        unsigned char* st = smem + slot * R::STAGE;
        mbar_wait(&full[slot], (it / R::STAGES) & 1);
        const uint64_t da = wg_desc(st + wg * 64 * 128);
        const uint64_t db = B_MN ? wg_desc_mn(st + R::A_BYTES)
                                 : wg_desc(st + R::A_BYTES);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < K_STEPS; ++kk)
          T::template mma<BN, B_MN>(acc, da + 2 * kk, db + B_STEP * kk, 1);
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
        mbar_arrive(&empty[(it - 1) % R::STAGES]);
      }
      wg_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[(it - 1) % R::STAGES]);
      if constexpr (M_FAST)
        epi(acc, tile % m_tiles, tile / m_tiles, wg, threadIdx.x, scratch);
      else
        epi(acc, tile / n_tiles, tile % n_tiles, wg, threadIdx.x, scratch);
    }
    epi.finish(threadIdx.x);
  }
}

// Launches wg_gemm_kernel<BN, B_MN, Epi, T, PP, M_FAST> over m_tiles x
// n_tiles tiles of K = T::BK * k_stages (A's map in
// [128][T::BK] boxes; B's in [64][64] boxes when B_MN, else [BN][T::BK]).
// Returns a cudaError_t value: the launch's, or
// cudaErrorInvalidConfiguration when the block would not be given the
// registers that setmaxnreg moves (its consumers would wait for ever).
template <int BN, bool B_MN, class Epi, class T = WgBf16, bool PP = false,
          bool M_FAST = false>
int wg_gemm_launch(const CUtensorMap& tma_a, const CUtensorMap& tma_b,
                   int m_tiles, int n_tiles, int k_stages, const Epi& epi,
                   cudaStream_t st) {
  constexpr int SMEM = WgRing<BN, PP>::template smem<Epi>();
  static_assert(SMEM <= 232448, "the ring and scratch exceed shared memory");
  static int ready = 0;
  if (!ready) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(
        &attr, wg_gemm_kernel<BN, B_MN, Epi, T, PP, M_FAST>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((attr.numRegs + 7) / 8 * 8 * WG_THREADS <
        WG_REGS_CONSUMER * 256 + WG_REGS_PRODUCER * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaFuncSetAttribute(wg_gemm_kernel<BN, B_MN, Epi, T, PP, M_FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = 1;
  }
  const int tiles = m_tiles * n_tiles;
  if (tiles == 0) return 0;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  wg_gemm_kernel<BN, B_MN, Epi, T, PP, M_FAST>
      <<<grid, WG_THREADS, SMEM, st>>>(tma_a, tma_b, m_tiles, n_tiles,
                                       k_stages, epi);
  return static_cast<int>(cudaGetLastError());
}
