// Hopper pieces shared by the wgmma kernels, and the persistent bf16 GEMM
// main loop that the encoder GEMMs (encoder_layer.cu) and the bf16 bin
// top-k (bin_topk.cu) run on; int4_matmul.cu's prefill uses the pieces.
//
// The main loop, wg_gemm_kernel<BN, B_MN, Epi>: C = A . B^T-or-B over
// 128 x BN output tiles (BN 128 or 256), f32 sums, one fixed k order per
// output element (no split-K, no atomics: runs repeat bit for bit).
// * One block per SM (grid = min(tiles, SMs)) walks the tiles t, t + grid,
//   ... in the order row tile = t / n_tiles, column tile = t % n_tiles.
// * 384 threads: warpgroups 0 and 1 consume (rows 64 * wg .. + 63 of the
//   tile, m64nBNk16 wgmma with an f32 register accumulator), warpgroup 2
//   produces; setmaxnreg moves registers from the producer (40) to the
//   consumers (232), which the launcher checks the block was given.
// * The producer is one thread that keeps a ring of 64-deep k stages in
//   flight (4 stages at BN 256, 6 at BN 128: 192 KB) with TMA: each stage
//   is one box of A [128 rows][64 k] and B's [64 k][BN] as BN / 64 boxes
//   of [64 k][64 n] (B_MN: B is [K, N] row-major, MN-major for wgmma) or
//   one box [BN n][64 k] (B is [N, K] row-major, K-major), all in the
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
// * Epi is called by the 256 consumer threads with the tile's accumulator
//   (layout above wgmma_m64n128) and Epi::SMEM bytes of shared scratch
//   (1024-aligned); it may synchronise the consumers with consumer_sync().
//   Its finish(consumer thread) is called after the last tile (an
//   epilogue that stores with TMA waits for its stores there).
//   The kernel takes Epi as a __grid_constant__ parameter, so a tensor
//   map inside it can be handed to TMA.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked

#include <mutex>

#include "common.cuh"

// ---------------------------------------------------------------- host

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

// A TMA map of rank 2 or 3 over a bf16 or (f32) f32 tensor, dims[0]
// contiguous (dims and box innermost first; strides[i] bytes between steps
// of dims[i + 1], multiples of 16), in the 128-byte swizzle (box[0]
// elements fill one 128-byte swizzle row at most); reads past the tensor
// return zeros and stores past it are dropped.  Returns a cudaError_t
// value.  Encoding a map costs the host microseconds, more than a small
// kernel takes on the card, so maps are kept in a small direct-mapped
// cache keyed by all of their arguments (a map depends on nothing else, so
// a hit is exact).
inline int tma_encode(CUtensorMap* map, const void* base, bool f32, int rank,
                      const long long* dims, const long long* strides,
                      const int* box) {
  struct Entry {
    const void* base;
    int rank, f32;
    long long dims[3], strides[2];
    int box[3];
    CUtensorMap map;
  };
  static Entry cache[64];
  static std::mutex lock;
  size_t h = (reinterpret_cast<uintptr_t>(base) >> 8) + f32;
  for (int i = 0; i < rank; ++i)
    h = h * 31 + static_cast<size_t>(dims[i] * 7 + box[i] +
                                     (i ? strides[i - 1] : 0));
  Entry& e = cache[h % 64];
  auto hit = [&]() {
    if (e.base != base || e.rank != rank || e.f32 != f32) return false;
    for (int i = 0; i < rank; ++i)
      if (e.dims[i] != dims[i] || e.box[i] != box[i] ||
          (i && e.strides[i - 1] != strides[i - 1]))
        return false;
    return true;
  };
  {
    std::lock_guard<std::mutex> g(lock);
    if (hit()) {
      *map = e.map;
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
                  f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  rank, const_cast<void*>(base), d, st, bx, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> g(lock);
  e.base = base;
  e.rank = rank;
  e.f32 = f32;
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
inline int tma_map(CUtensorMap* map, const void* base, bool f32,
                   long long rows, long long cols, long long ld, int box_rows,
                   int box_cols) {
  const long long dims[2] = {cols, rows}, strides[1] = {ld * (f32 ? 4 : 2)};
  const int box[2] = {box_cols, box_rows};
  return tma_encode(map, base, f32, 2, dims, strides, box);
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

constexpr int WG_BM = 128, WG_BK = 64;
constexpr int WG_THREADS = 384;
constexpr int WG_REGS_PRODUCER = 40, WG_REGS_CONSUMER = 232;

template <int BN>
struct WgRing {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = BN * WG_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  template <class Epi>
  static constexpr int smem() {
    return 1024 + STAGES * STAGE + 2 * STAGES * 8 + Epi::SMEM;
  }
};

template <int BN, bool B_MN, class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wg_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, int m_tiles,
                   int n_tiles, int k_stages,
                   const __grid_constant__ Epi epi) {
  using R = WgRing<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* scratch = smem + R::STAGES * R::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch + Epi::SMEM);
  uint64_t* empty = full + R::STAGES;
  const int tiles = m_tiles * n_tiles;
  // the role, warpgroup-uniform to the compiler (no divergent path around
  // the wgmma)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival with the bytes
      mbar_init(&empty[s], 256);  // every consumer thread
    }
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
        const int m0 = tile / n_tiles * WG_BM, n0 = tile % n_tiles * BN;
        for (int ks = 0; ks < k_stages; ++ks, ++it) {
          const int slot = it % R::STAGES;
          mbar_wait(&empty[slot], ((it / R::STAGES) & 1) ^ 1);
          unsigned char* st = smem + slot * R::STAGE;
          mbar_expect_tx(&full[slot], R::STAGE);
          tma_load_2d(st, &tma_a, &full[slot], ks * WG_BK, m0);
          if constexpr (B_MN) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(st + R::A_BYTES + c * 8192, &tma_b, &full[slot],
                          n0 + 64 * c, ks * WG_BK);
          } else {
            tma_load_2d(st + R::A_BYTES, &tma_b, &full[slot], ks * WG_BK,
                        n0);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     WG_REGS_CONSUMER)
                 : "memory");
    // a k16 step advances A by 32 bytes; B by 32 bytes (K-major) or 16
    // k rows of 128 bytes (MN-major); descriptors count 16-byte units
    constexpr uint64_t B_STEP = B_MN ? 2048 >> 4 : 32 >> 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
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
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          wgmma_bn<BN, B_MN>(acc, da + 2 * kk, db + B_STEP * kk, kk);
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
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          wgmma_bn<BN, B_MN>(acc, da + 2 * kk, db + B_STEP * kk, 1);
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
        mbar_arrive(&empty[(it - 1) % R::STAGES]);
      }
      wg_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[(it - 1) % R::STAGES]);
      epi(acc, tile / n_tiles, tile % n_tiles, wg, threadIdx.x, scratch);
    }
    epi.finish(threadIdx.x);
  }
}

// Launches wg_gemm_kernel over m_tiles x n_tiles tiles of K = 64 *
// k_stages (A's map in [128][64] boxes; B's in [64][64] boxes when B_MN,
// else [BN][64]).  Returns a cudaError_t value: the launch's, or
// cudaErrorInvalidConfiguration when the block would not be given the
// registers that setmaxnreg moves (its consumers would wait for ever).
template <int BN, bool B_MN, class Epi>
int wg_gemm_launch(const CUtensorMap& tma_a, const CUtensorMap& tma_b,
                   int m_tiles, int n_tiles, int k_stages, const Epi& epi,
                   cudaStream_t st) {
  constexpr int SMEM = WgRing<BN>::template smem<Epi>();
  static_assert(SMEM <= 232448, "the ring and scratch exceed shared memory");
  static int ready = 0;
  if (!ready) {
    cudaFuncAttributes attr;
    cudaError_t e =
        cudaFuncGetAttributes(&attr, wg_gemm_kernel<BN, B_MN, Epi>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((attr.numRegs + 7) / 8 * 8 * WG_THREADS <
        WG_REGS_CONSUMER * 256 + WG_REGS_PRODUCER * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaFuncSetAttribute(wg_gemm_kernel<BN, B_MN, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = 1;
  }
  const int tiles = m_tiles * n_tiles;
  if (tiles == 0) return 0;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  wg_gemm_kernel<BN, B_MN, Epi><<<grid, WG_THREADS, SMEM, st>>>(
      tma_a, tma_b, m_tiles, n_tiles, k_stages, epi);
  return static_cast<int>(cudaGetLastError());
}
