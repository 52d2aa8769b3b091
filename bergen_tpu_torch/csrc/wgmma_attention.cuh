// The warp-specialised wgmma attention main loop that flash_attention.cu
// (causal GQA prefill), flash_band.cu (the chunked drain's band attention)
// and encoder_layer.cu (encoder_attention_qkv, the rope/ALiBi encoders'
// bidirectional attention) run on, built from wgmma.cuh's pieces
// (tensor-map cache, mbarriers, descriptors).
//
// The work is a list of units; a unit is one or more 128-row query tiles
// (of one sequence and head, or of two short ones), each attending n_kt
// consecutive key tiles of BK keys, from key tile 0 or (AttTile::k0) a
// later one.  One block per SM (grid = min(units,
// SMs)) walks the units u, u + grid, ...; the policy P orders them and
// says which rows see which keys.  384 threads:
// * Warpgroup 2 produces: setmaxnreg gives it 40 registers, and one thread
//   issues every TMA load, three-dimensional maps {row width, rows, batch}
//   in 64 x 64 boxes in the 128-byte swizzle, so rows past a sequence's
//   end read as zeros whatever lies behind them: the query tile into one
//   of P::QS slots, then K tile j and V tile j - 1 in turn into rings of
//   P::STAGES slots each, every slot with its own full and empty mbarrier.
//   K runs one tile ahead of V because a K slot is given back as soon as
//   its scores are done, a V slot only after its P.V products.  Up to
//   three more warps of the group read the key tiles' masks in turn into
//   bits beside their K slots (one ballot per 32 keys), each the K slot's
//   second arrival, so no consumer waits on a mask load.
// * Warpgroups 0 and 1 consume, 64 query rows each (setmaxnreg: 232
//   registers).  For key tile j a consumer issues S_j = Q.K_j^T (SS wgmma,
//   K K-major through wg_desc) and, in the same batch, O += P_{j-1}.V_{j-1}
//   (RS wgmma: P in registers as bf16 A fragments, V [key][dh] MN-major
//   through wg_desc_mn), then runs the online softmax of S_j while P.V
//   runs, waits for it, rescales O and packs P_j: FA3's intra-warpgroup
//   pipelining, carried across query tiles and units (a tile's first
//   scores run beside the previous tile's last P.V, whose output is then
//   stored).  The two warpgroups also take turns to issue their batches
//   (named barriers 2 and 3: ping-pong), so one's softmax runs while the
//   other's products occupy the tensor cores.
// * Softmax: the policy turns the raw score into y = x log2 e, with x the
//   TPU kernel's score (scale, mask, bias), a masked key at -1e30 and a key
//   past the visited ones at -inf in this domain as in the TPU kernel's;
//   then m' = max(m, rowmax y), p = 2^(y - m'), a = 2^(m - m'),
//   l' = l a + rowsum p (f32), O' = O a + bf16(p).V.  A row whose keys all
//   score -1e30 gets p = 2^0 = 1 for each, exactly, and averages V
//   uniformly as the TPU kernel's rows do.
#pragma once

#include "wgmma.cuh"

// ---------------------------------------------------------------- host

// The map of the bf16 (or f32) tensor [d2][d1][d0] (d0 contiguous; rows
// d1 and batches d2 s1 and s2 bytes apart) in boxes of [box1][box0] and
// one batch (tma_encode).
inline int tma_map_3d(CUtensorMap* map, const void* base, long long d0,
                      long long d1, long long d2, long long s1, long long s2,
                      int box0, int box1, bool f32 = false) {
  const long long dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const int box[3] = {box0, box1, 1};
  return tma_encode(map, base, f32, 3, dims, strides, box);
}

// ------------------------------------------------------------- device

// The box of `map` at (c0 along the row, c1 rows down, batch c2) into
// shared memory (1024-aligned), completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA store of the box of `map` at (c0 along the row, c1 rows down, batch
// c2) from shared memory (1024-aligned, in the map's swizzle, made visible
// with fence_proxy_async), in this thread's bulk group; parts of the box
// past the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Named barrier 4 + wg over one consumer warpgroup's 128 threads.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
}

// Named barriers over the 256 consumer threads: bar.sync waits for the
// barrier's 256 arrivals (its own 128 among them), bar.arrive adds 128.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// 2^x (MUFU; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from reusing or moving the A fragments of an RS wgmma
// that may still be reading them until after the wgmma wait.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

// d (+)= A[64 x 16] . B[16 x 64], both bf16 in shared memory, B K-major
// (wg_desc); f32 sums, scale_d 0 overwrites d.  Layout of d as wgmma_m64n128.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 64]: A bf16 in registers (a[0..3]: the
// m16n8k16 A fragment of the warp's 16 rows), B bf16 in shared memory,
// MN-major (wg_desc_mn); f32 sums, scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64_rs_mn(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 128]: A bf16 in registers (a[0..3]: the
// m16n8k16 A fragment of the warp's 16 rows), B bf16 in shared memory,
// MN-major (wg_desc_mn); f32 sums, scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128_rs_mn(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[16 x 256]: A bf16 in registers (a[0..3]: the
// m16n8k16 A fragment of the warp's 16 rows), B bf16 in shared memory,
// MN-major (wg_desc_mn: four 64-wide n chunks 8192 bytes apart); f32 sums,
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256_rs_mn(float (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// --------------------------------------------------------- the main loop

constexpr int AT_BQ = 128;  // query rows per tile: 64 per consumer warpgroup
constexpr int AT_THREADS = 384;
constexpr int AT_REGS_PRODUCER = 40, AT_REGS_CONSUMER = 232;
constexpr float AT_L2E = 1.4426950408889634f;  // log2(e)

// One query tile: batch b, query head qh (its column block in q and out),
// K/V head kvh, first row q0, and the n_kt >= 1 key tiles it attends,
// counted by the loop from 0.  k0 is the first of them, for a policy whose
// tiles start past key 0 (BandPolicy: its hooks add k0 to the loop's key
// tile); the other policies leave it out of their initialisers, so it is 0.
struct AttTile {
  int b, qh, kvh, q0, n_kt, k0;
};

// Whether P::tile() is collective over a whole warp (P::WARP_TILE, false
// where the policy does not say so): the producer's warp then walks the
// units together, and one lane issues the copies.
template <class P, class = void>
struct AttWarpTile {
  static constexpr bool value = false;
};
template <class P>
struct AttWarpTile<P, std::void_t<decltype(P::WARP_TILE)>> {
  static constexpr bool value = P::WARP_TILE;
};

// The head width the scores contract and the output holds (P::DK, P::DH
// where the policy does not say so).  A narrower DK than the tiles' DH
// (Phi-3's 96 in 128-wide tiles): the boxes past DK hold the next head's
// columns or zeros, the scores stop at DK (DK / 16 k16 steps), P . V
// computes DH columns of which the first DK are stored, from registers
// through P::o_row.
template <class P, class = void>
struct AttDK {
  static constexpr int value = P::DH;
};
template <class P>
struct AttDK<P, std::void_t<decltype(P::DK)>> {
  static constexpr int value = P::DK;
};

// Shared memory: QS query slots of [DH / 64][128 rows][64], STAGES K slots
// of [DH / 64][BK keys][64] (K-major rows for the scores) and STAGES V slots
// of [BK / 64][DH / 64][64 keys][64] (64-wide dh chunks 8,192 bytes apart,
// as wg_desc_mn reads them), all 64 x 64 TMA boxes in the 128-byte swizzle;
// then each consumer warpgroup's output staging box ([DH / 64][64][64]
// bf16, stored by TMA; none at head width 256, whose rows go straight from
// registers to the output: one 128 x 256 query slot, two stages of 64-key
// K and V and two 64 KiB staging boxes would need 256 KiB), the mbarriers
// and each K slot's key bits (bit i of word w: key 32 w + i of the tile
// attends).  A K slot may carry XB bytes
// more that the policy loads beside K and reads in its scores
// (encoder_attention's f32 bias tile).
template <int DH, int BK, int STAGES, int QS, int XB>
struct AttRing {
  static constexpr int Q_BYTES = AT_BQ * DH * 2;
  static constexpr int K_BYTES = BK * DH * 2;
  static constexpr int KS_BYTES = K_BYTES + XB;  // a K slot and its extra
  static constexpr int V_BYTES = BK * DH * 2;
  // a warpgroup's output staging box (none at head width 256)
  static constexpr int O_BYTES = DH > 128 ? 0 : 64 * DH * 2;
  static constexpr int SMEM = 1024 + QS * Q_BYTES +
                              STAGES * (KS_BYTES + V_BYTES) + 2 * O_BYTES +
                              (2 * QS + 4 * STAGES) * 8 +
                              STAGES * (BK / 32) * 4;
};

// S = Q . K^T over the first DK of the head width: Q [64 rows] of the
// consumer's warpgroup and K [BK keys], both K-major (64-wide dh chunks of
// 128 and BK rows), one wgmma group.
template <int DK, int BK>
__device__ __forceinline__ void att_mma_s(float (&s)[BK / 2],
                                          const unsigned char* qt,
                                          const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint64_t da = wg_desc(qt + (kk / 4) * AT_BQ * 128) + 2 * (kk % 4);
    const uint64_t db = wg_desc(kt + (kk / 4) * BK * 128) + 2 * (kk % 4);
    if constexpr (BK == 128)
      wgmma_m64n128<0>(s, da, db, kk);
    else
      wgmma_m64n64_ss(s, da, db, kk);
  }
  wg_commit();
}

// O += P . V: P [64 rows][BK keys] bf16 A fragments, V [BK keys][DH]
// MN-major in [BK / 64][DH / 64][64][64] boxes, one wgmma group.
template <int DH, int BK>
__device__ __forceinline__ void att_mma_pv(float (&o)[DH / 2],
                                           const uint32_t (&pa)[BK / 16][4],
                                           const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = wg_desc_mn(vt + (kk / 4) * (DH / 64) * 8192) +
                        (kk % 4) * (2048 >> 4);
    if constexpr (DH == 256)
      wgmma_m64n256_rs_mn(o, pa[kk], db, 1);
    else if constexpr (DH == 128)
      wgmma_m64n128_rs_mn(o, pa[kk], db, 1);
    else
      wgmma_m64n64_rs_mn(o, pa[kk], db, 1);
  }
  wg_commit();
}

// The online softmax of one key tile: y (in s, base-2 logits) becomes
// p = 2^(y - m') with m' the running row max, l the rescaled running sum,
// alpha the factor for O.  Each row's 4 threads share m'.
template <int BK>
__device__ __forceinline__ void att_softmax(float (&s)[BK / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * c], s[4 * c + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) {
    const float e = ex2(s[x] - m[(x >> 1) & 1]);
    s[x] = e;
    l[(x >> 1) & 1] += e;
  }
}

// p rounded to bf16 as the A fragments of P . V: the score accumulator's
// columns 16 kk .. 16 kk + 15 are fragment kk.
template <int BK>
__device__ __forceinline__ void att_pack(uint32_t (&pa)[BK / 16][4],
                                         const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A consumer's place in its block's work: unit u, its query tile i of nq
// (tile t), key tile j.
struct AttCursor {
  int u, i, nq, j;
  AttTile t;
};

// Moves c to the next key tile of the block's walk; false past its end.
template <class P>
__device__ __forceinline__ bool att_next(const P& p, AttCursor& c,
                                         int n_units) {
  if (++c.j < c.t.n_kt) return true;
  c.j = 0;
  if (++c.i == c.nq) {
    c.i = 0;
    c.u += gridDim.x;
    if (c.u >= n_units) return false;
    c.nq = p.n_qtiles(c.u);
  }
  c.t = p.tile(c.u, c.i);
  return true;
}

// O / l of a finished query tile (l summed over each row's 4 threads) in
// bf16, written into the warpgroup's staging box in the 128-byte swizzle
// (conflict-free: a warp's 32 pairs land in 32 banks) and stored by TMA
// at the policy's o_box, which clips rows past the sequence.  The box is
// rewritten once the previous store has read it.  At head width 256 (N
// 128) there is no box: the rows go to the policy's o_row directly, as do
// the first DK columns where the policy's DK is narrower than its tiles
// (a 64-wide box would write into the next head's columns).
template <class P, int N>
__device__ __forceinline__ void att_finish(const P& p, const float (&o)[N],
                                           float (&l)[2], const AttTile& t,
                                           unsigned char* box, int wg,
                                           int warp, int lane) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (P::CLAMP_L ? fmaxf(l[r], 1e-30f) : l[r]);
  }
  const int g = lane >> 2;
  constexpr int DK = AttDK<P>::value;
  if constexpr (N == 128 || DK < 2 * N) {
    // head width 256, or a DK narrower than the tiles: no staging box;
    // each thread stores its two rows' column pairs below DK straight to
    // the output (p.o_row: null past the end)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* dst = p.o_row(t, wg, 16 * warp + g + 8 * r);
      if (dst == nullptr) continue;
#pragma unroll
      for (int c = 0; c < DK / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c + 2 * (lane & 3)) =
            pack_bf16x2(o[4 * c + 2 * r] * inv[r],
                        o[4 * c + 2 * r + 1] * inv[r]);
    }
    return;
  }
  const bool leader = (threadIdx.x & 127) == 0;
  if (leader) bulk_wait<0, true>();
  wg_sync(wg);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      *reinterpret_cast<uint32_t*>(box + (c >> 3) * 8192 + row * 128 +
                                   (((c & 7) ^ g) << 4) + 4 * (lane & 3)) =
          pack_bf16x2(o[4 * c + 2 * r] * inv[r],
                      o[4 * c + 2 * r + 1] * inv[r]);
  }
  fence_proxy_async();
  wg_sync(wg);
  if (leader) {
    const int3 at = p.o_box(t, wg);
#pragma unroll
    for (int c = 0; c < N / 32; ++c)
      tma_store_3d(&p.to, box + c * 8192, at.x + 64 * c, at.y, at.z);
    bulk_commit();
  }
}

// The policy P (flash_attention.cu's FlashPolicy, encoder_layer.cu's
// EncPolicy and EncPairPolicy, flash_band.cu's BandPolicy) gives DH (64,
// 128 or 256), BK (64 or 128; 64 at DH 256, whose P . V is one n256 wgmma
// per 16 keys and whose O takes 128 registers a thread),
// STAGES (K and V slots), QS (query slots), SPLIT (each warpgroup attends
// its own half of a key tile: two short sequences in one tile), m_init()
// (the running max before the first key: -1e30 or -inf), CLAMP_L (divide
// by max(l, 1e-30) rather than l), the tensor maps tq, tk, tv (bf16,
// 64 x 64 boxes), and:
//   n_units(), n_qtiles(u), tile(u, i)            the schedule (WARP_TILE,
//       optional: tile() is called by whole warps only);
//   q_box(t, r), kv_box(t, j, h)                  the TMA coordinates
//       (column, row, batch) of a tile's 64-row boxes;
//   key_ok(t, key)                                the key's mask bit;
//   XB, load_extra(dst, bar, t, j)                bytes loaded beside K;
//   prefetch(pre, t, j, wg, warp, lane)           register loads for key
//       tile j's scores, issued a tile ahead;
//   scores(s, bits, xs, pre, t, j, wg, warp, lane)
//       raw q.k -> y in place (xs: the K slot's extra bytes);
//   to, o_box(t, wg)                              the output's bf16 map and
//       the warpgroup's box (column, first row, batch) of tile t;
//   o_row(t, wg, r) (DH 256, or DK < DH)          row r of the warpgroup's
//       64 in the output, or null past the sequence;
//   DK (optional)                                  the head width the
//       scores contract and the output holds, if narrower than DH.
// s[4c + e] and o[4c + e] hold row 16 * warp + lane / 4 + 8 (e >> 1) of the
// warpgroup's 64, column 8c + 2 (lane % 4) + (e & 1) of its keys.
template <class P>
__global__ void __launch_bounds__(AT_THREADS, 1)
    att_kernel(const __grid_constant__ P p) {
  constexpr int DH = P::DH, BK = P::BK, ST = P::STAGES, QS = P::QS;
  constexpr int DK = AttDK<P>::value;  // the scores' contraction
  static_assert(DK % 16 == 0 && DK <= DH && (DK == DH || DH <= 128),
                "DK is whole k16 steps of the tiles' width");
  constexpr int NMW = ST < 3 ? ST : 3;  // key-mask warps
  constexpr int BKW = P::SPLIT ? BK / 2 : BK;  // keys a warpgroup attends
  static_assert(!P::SPLIT || (DH == 64 && BK == 128),
                "split tiles are two 64-key halves of head width 64");
  using R = AttRing<DH, BK, ST, QS, P::XB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = qs + QS * R::Q_BYTES;
  unsigned char* vs = ks + ST * R::KS_BYTES;
  unsigned char* os = vs + ST * R::V_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(os + 2 * R::O_BYTES);
  uint64_t* q_empty = q_full + QS;
  uint64_t* k_full = q_empty + QS;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(v_empty + ST);
  const int n_units = p.n_units();
  // the role, warpgroup-uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(&q_full[i], 1);     // the producer's arrival with the bytes
      mbar_init(&q_empty[i], 256);  // every consumer thread
    }
    for (int i = 0; i < ST; ++i) {
      mbar_init(&k_full[i], 2);  // the bytes, and the key bits
      mbar_init(&k_empty[i], 256);
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     AT_REGS_PRODUCER)
                 : "memory");
    constexpr bool WT = AttWarpTile<P>::value;
    if (WT ? threadIdx.x < 288 : threadIdx.x == 256) {
      int qn = 0, kn = 0, vn = 0;  // slots filled so far, per ring
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int nq = p.n_qtiles(u);
        for (int i = 0; i < nq; ++i) {
          const AttTile t = p.tile(u, i);
          if (WT && threadIdx.x != 256) continue;  // thread 256 issues
          {
            const int slot = qn % QS;
            mbar_wait(&q_empty[slot], ((qn / QS) & 1) ^ 1);
            unsigned char* dst = qs + slot * R::Q_BYTES;
            mbar_expect_tx(&q_full[slot], R::Q_BYTES);
#pragma unroll
            for (int c = 0; c < DH / 64; ++c)
#pragma unroll
              for (int r = 0; r < AT_BQ / 64; ++r)
              {
                const int3 at = p.q_box(t, r);
                tma_load_3d(dst + c * AT_BQ * 128 + r * 8192, &p.tq,
                            &q_full[slot], at.x + 64 * c, at.y, at.z);
              }
            ++qn;
          }
          // K_0, then K_j beside V_{j-1}, then the last V
          for (int j = 0; j <= t.n_kt; ++j) {
            if (j < t.n_kt) {
              const int slot = kn % ST;
              mbar_wait(&k_empty[slot], ((kn / ST) & 1) ^ 1);
              unsigned char* dst = ks + slot * R::KS_BYTES;
              mbar_expect_tx(&k_full[slot], R::KS_BYTES);
#pragma unroll
              for (int c = 0; c < DH / 64; ++c)
#pragma unroll
                for (int h = 0; h < BK / 64; ++h)
                {
                  const int3 at = p.kv_box(t, j, h);
                  tma_load_3d(dst + c * BK * 128 + h * 8192, &p.tk,
                              &k_full[slot], at.x + 64 * c, at.y, at.z);
                }
              if constexpr (P::XB > 0)
                p.load_extra(dst + R::K_BYTES, &k_full[slot], t, j);
              ++kn;
            }
            if (j > 0) {
              const int slot = vn % ST;
              mbar_wait(&v_empty[slot], ((vn / ST) & 1) ^ 1);
              unsigned char* dst = vs + slot * R::V_BYTES;
              mbar_expect_tx(&v_full[slot], R::V_BYTES);
#pragma unroll
              for (int c = 0; c < DH / 64; ++c)
#pragma unroll
                for (int h = 0; h < BK / 64; ++h)
                {
                  const int3 at = p.kv_box(t, j - 1, h);
                  tma_load_3d(dst + h * (DH / 64) * 8192 + c * 8192, &p.tv,
                              &v_full[slot], at.x + 64 * c, at.y, at.z);
                }
              ++vn;
            }
          }
        }
      }
    } else if (threadIdx.x >= 288 && (threadIdx.x >> 5) - 9 < NMW) {
      // the key-mask warps: tile kn is warp 9 + kn % NMW's, so NMW tiles'
      // mask loads are in flight.  NMW <= STAGES keeps each warp within
      // one phase of the empty barrier it waits on (its previous tile's
      // wait saw the slot use before the one it now waits for released)
      const int lane = threadIdx.x & 31, mw = (threadIdx.x >> 5) - 9;
      int kn = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int nq = p.n_qtiles(u);
        for (int i = 0; i < nq; ++i) {
          const AttTile t = p.tile(u, i);
          for (int j = 0; j < t.n_kt; ++j, ++kn) {
            if (kn % NMW != mw) continue;
            const int slot = kn % ST;
            mbar_wait(&k_empty[slot], ((kn / ST) & 1) ^ 1);
#pragma unroll
            for (int w = 0; w < BK / 32; ++w) {
              const bool ok = p.key_ok(t, j * BK + 32 * w + lane);
              const uint32_t b = __ballot_sync(0xffffffffu, ok);
              if (lane == 0) kbits[slot * (BK / 32) + w] = b;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&k_full[slot]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     AT_REGS_CONSUMER)
                 : "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int mine = 2 + wg, other = 3 - wg;  // ping-pong barriers
    // the warpgroup's keys of a tile: all BK, or (SPLIT) its own half, at
    // these offsets into the K and V slots and the key bits
    const int koff = P::SPLIT ? wg * BKW * 128 : 0;
    const int voff = P::SPLIT ? wg * (BKW / 64) * (DH / 64) * 8192 : 0;
    const int boff = P::SPLIT ? wg * (BKW / 32) : 0;
    unsigned char* obox = os + wg * R::O_BYTES;
    float o[DH / 2], s[BKW / 2], m[2], l[2], alpha[2], lp[2];
    uint32_t pa[BKW / 16][4], bits[BKW / 32];
    int qn = 0, kn = 0, vn = 0;  // slots consumed so far, per ring
    typename P::Pre pre, pre_next;
    // c: this step's key tile; cn: the next step's; tp: the query tile
    // whose last P . V is still to come
    AttCursor c{(int)blockIdx.x, 0, p.n_qtiles(blockIdx.x), 0,
                p.tile(blockIdx.x, 0)};
    AttCursor cn = c;
    bool more = att_next(p, cn, n_units);
    AttTile tp = c.t;
    p.prefetch(pre, c.t, 0, wg, warp, lane);
    if (wg == 1) named_arrive(2);  // warpgroup 0 issues first

    // the block's first key tile: its scores alone
    int qslot = 0;
    mbar_wait(&q_full[0], 0);
    const unsigned char* qt = qs + wg * 8192;
    m[0] = m[1] = P::m_init();
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) o[x] = 0.f;
    mbar_wait(&k_full[0], 0);
#pragma unroll
    for (int w = 0; w < BKW / 32; ++w) bits[w] = kbits[boff + w];
    named_sync(mine);
    wg_fence();
    att_mma_s<DK, BKW>(s, qt, ks + koff);
    named_arrive(other);
    if (more) p.prefetch(pre_next, cn.t, cn.j, wg, warp, lane);
    wg_wait<0>();
    fence_acc(s);  // the scores are done: K goes back (and Q after the last)
    if constexpr (P::XB == 0) mbar_arrive(&k_empty[0]);
    if (c.t.n_kt == 1) {
      mbar_arrive(&q_empty[0]);
      ++qn;
    }
    p.scores(s, bits, ks + R::K_BYTES, pre, c.t, 0, wg, warp, lane);
    if constexpr (P::XB > 0) mbar_arrive(&k_empty[0]);  // its extra read
    ++kn;
    att_softmax<BKW>(s, m, l, alpha);
    att_pack<BKW>(pa, s);

    // every later key tile: its scores beside the previous tile's P . V,
    // across query tiles and units (a query tile's first scores run beside
    // the last P . V of the tile before it, whose output is then stored)
    while (more) {
      c = cn;
      more = att_next(p, cn, n_units);
      pre = pre_next;
      const bool new_tile = c.j == 0;
      if (new_tile) {
        qslot = qn % QS;
        mbar_wait(&q_full[qslot], (qn / QS) & 1);
        qt = qs + qslot * R::Q_BYTES + wg * 8192;
      }
      const int kslot = kn % ST, vslot = vn % ST;
      mbar_wait(&k_full[kslot], (kn / ST) & 1);
#pragma unroll
      for (int w = 0; w < BKW / 32; ++w)
        bits[w] = kbits[kslot * (BK / 32) + boff + w];
      mbar_wait(&v_full[vslot], (vn / ST) & 1);
      named_sync(mine);
      wg_fence();
      att_mma_s<DK, BKW>(s, qt, ks + kslot * R::KS_BYTES + koff);
      att_mma_pv<DH, BKW>(o, pa, vs + vslot * R::V_BYTES + voff);
      named_arrive(other);
      if (more) p.prefetch(pre_next, cn.t, cn.j, wg, warp, lane);
      wg_wait<1>();
      fence_acc(s);
      if constexpr (P::XB == 0) mbar_arrive(&k_empty[kslot]);
      if (c.j == c.t.n_kt - 1) {
        mbar_arrive(&q_empty[qslot]);
        ++qn;
      }
      if (new_tile) {
        lp[0] = l[0];
        lp[1] = l[1];
        m[0] = m[1] = P::m_init();
        l[0] = l[1] = 0.f;
      }
      p.scores(s, bits, ks + kslot * R::KS_BYTES + R::K_BYTES, pre, c.t,
               c.j, wg, warp, lane);
      if constexpr (P::XB > 0) mbar_arrive(&k_empty[kslot]);
      ++kn;
      att_softmax<BKW>(s, m, l, alpha);
      wg_wait<0>();  // the previous P . V is done: V goes back, O, P free
      fence_acc(o);
      fence_frag(pa);
      mbar_arrive(&v_empty[vslot]);
      ++vn;
      if (new_tile) {
        att_finish(p, o, lp, tp, obox, wg, warp, lane);
#pragma unroll
        for (int x = 0; x < DH / 2; ++x) o[x] = 0.f;
        tp = c.t;
      } else {
#pragma unroll
        for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
      }
      att_pack<BKW>(pa, s);
    }

    // the last key tile's P . V
    const int vslot = vn % ST;
    mbar_wait(&v_full[vslot], (vn / ST) & 1);
    named_sync(mine);
    wg_fence();
    att_mma_pv<DH, BKW>(o, pa, vs + vslot * R::V_BYTES + voff);
    // warpgroup 1's last turn passes to no one: each barrier then sees as
    // many arrivals as waits
    if (wg == 0) named_arrive(other);
    wg_wait<0>();
    fence_acc(o);
    fence_frag(pa);
    mbar_arrive(&v_empty[vslot]);
    att_finish(p, o, l, tp, obox, wg, warp, lane);
    if ((threadIdx.x & 127) == 0) bulk_wait<0, false>();
  }
}

// Launches att_kernel<P> over p's units.  Returns a cudaError_t value: the
// launch's, or cudaErrorInvalidConfiguration when the block would not be
// given the registers that setmaxnreg moves.
template <class P>
int att_launch(const P& p, cudaStream_t st) {
  constexpr int SMEM =
      AttRing<P::DH, P::BK, P::STAGES, P::QS, P::XB>::SMEM;
  static_assert(SMEM <= 232448, "the rings exceed shared memory");
  static int ready = 0;
  if (!ready) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, att_kernel<P>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((attr.numRegs + 7) / 8 * 8 * AT_THREADS <
        AT_REGS_CONSUMER * 256 + AT_REGS_PRODUCER * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaFuncSetAttribute(att_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = 1;
  }
  const int units = p.n_units();
  if (units == 0) return 0;
  const int grid = units < sm_count() ? units : sm_count();
  att_kernel<P><<<grid, AT_THREADS, SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
