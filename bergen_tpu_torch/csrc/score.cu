// Dense MIPS scores: S = Q . C^T with bf16 inputs and f32 outputs, the
// corpus given transposed.
//
// Replaces: bergen_tpu/ops/scoring.py::pallas_score (Pallas body
// _score_kernel): queries [Q, D] bf16 times corpus_t [D, N] bf16 (the
// corpus pre-transposed, docs along the rows' minor axis), f32 sums written
// as [Q, N] f32.
//
// What bounds it on the H100: at the retrieval shapes (Q 2,048, D 768,
// N 262,144) 2 * Q * D * N = 8.2e14 tensor-core operations, 0.83 ms at the
// bf16 peak, against 2.1 GB of f32 scores written (0.64 ms at the memory
// rate) and 0.4 GB of corpus read (0.12 ms): operations, barely, with the
// writes close behind.  Design: wgmma.cuh's persistent main loop,
// wg_gemm_kernel<256, B_MN, ScoreEpi, WgBf16, PP = false, M_FAST>:
// * A is the queries [Q, D] (K-major, [128][64] TMA boxes); B is corpus_t
//   as given, [D, N] row-major, read MN-major in [64 k][64 n] boxes, so the
//   corpus needs no transposed copy;
// * M_FAST walks the row (query) tiles of one column (corpus) tile
//   together: the 132 blocks in flight share a few corpus tiles, so each
//   is read from device memory once (0.4 GB) and the 3.1 MB of queries stay
//   in L2.  The row-major walk read the corpus once per query tile, 16
//   times (6.4 GB);
// * 128 x 256 tiles on both consumer warpgroups: on one H100 at 700 W
//   the products alone take 1.01 ms, where ping-pong's 128 x 128 tiles
//   take 1.40;
// * ScoreEpi stages each tile's f32 scores 32 columns at a time in one of
//   two [128][32] boxes in the 128-byte swizzle (conflict-free), and one
//   thread stores each box with TMA, whole 128-byte rows: 1.44 ms in all,
//   level with torch.mm.  Stores straight from the accumulator (8-byte
//   pieces of eight rows an instruction) took 1.71, ping-pong with each
//   warpgroup's stores beside the other's products 1.80 to 1.83, and
//   starting half the SMs half a tile late did not hide the 0.44 ms that
//   the 2.1 GB of stores add to the products; nor did a 2-CTA cluster
//   multicasting the corpus tile (PERF.md).
// Every product is the exact bf16 product, summed in f32 in one fixed k
// order per element (no split-K).  TMA reads zeros past Q, N and D, and
// drops the stores past Q and N, so any Q, any D % 8 == 0 and any
// N % 8 == 0 (TMA's 16-byte row strides) take the kernel as they are; the
// wrapper pads a corpus with N % 8 != 0 to the next multiple of 8.
#include "wgmma.cuh"

namespace {

constexpr int SCORE_BN = 256;

struct ScoreEpi {
  static constexpr int BOX = WG_BM * 128;  // bytes of one [128][32] f32 box
  static constexpr int SMEM = 2 * BOX;
  CUtensorMap tma_c;  // out [Q, N] f32 in [128][32] boxes

  __device__ __forceinline__ void finish(int ctid) const {
    if (ctid == 0) bulk_wait<0, false>();
  }

  __device__ __forceinline__ void operator()(const float (&acc)[SCORE_BN / 2],
                                             int mt, int nt, int wg, int ctid,
                                             unsigned char* stage) const {
    const int t = ctid & 3;
    const int r0 = wg * 64 + ((ctid >> 5) & 3) * 16 + ((ctid & 31) >> 2);
#pragma unroll
    for (int p = 0; p < SCORE_BN / 32; ++p) {  // passes of 32 columns
      unsigned char* box = stage + (p & 1) * BOX;
      // box p & 1 is free once the store of pass p - 2 has read it
      if (ctid == 0) bulk_wait<1, true>();
      consumer_sync();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // 8-column groups: two units each
        const int j = 4 * p + jj;
        const int u = 2 * jj + (t >> 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          *reinterpret_cast<float2*>(box + r * 128 + ((u ^ (r & 7)) << 4) +
                                     8 * (t & 1)) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
      fence_proxy_async();
      consumer_sync();
      if (ctid == 0) {
        tma_store_2d(&tma_c, box, nt * SCORE_BN + 32 * p, mt * WG_BM);
        bulk_commit();
      }
    }
  }
};

}  // namespace

extern "C" {

// queries [Q, D] bf16, corpus_t [D, N] bf16 (D % 8 == 0, N % 8 == 0), both
// contiguous -> out [Q, N] f32.
int pallas_score(const void* q, const void* ct, void* out, int Q, int D,
                 int N, void* stream) {
  if (Q < 0 || D <= 0 || D % 8 || N % 8 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0 || N == 0) return 0;
  CUtensorMap ta, tb;
  ScoreEpi epi{};
  int e = tma_map(&ta, q, TMA_BF16, Q, D, D, WG_BM, WG_BK);
  if (e == 0) e = tma_map(&tb, ct, TMA_BF16, D, N, N, WG_BK, 64);
  if (e == 0) e = tma_map(&epi.tma_c, out, TMA_F32, Q, N, N, WG_BM, 32);
  if (e != 0) return e;
  return wg_gemm_launch<SCORE_BN, /*B_MN=*/true, ScoreEpi, WgBf16,
                        /*PP=*/false, /*M_FAST=*/true>(
      ta, tb, (Q + WG_BM - 1) / WG_BM, (N + SCORE_BN - 1) / SCORE_BN,
      (D + WG_BK - 1) / WG_BK, epi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
