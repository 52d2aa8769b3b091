// Fused MIPS scoring + per-bin argmax (stage 1 of the bin top-k).
//
// Replaces: bergen_tpu/ops/fused_topk.py::bin_topk (Pallas body _kernel) in
// its three scale modes.  For every 128-doc bin and every query it computes
// the bin's best score and the LOWEST doc index among equal maxima, with
// docs at or past valid_n masked, and writes only the [n_bins, Q] winners:
// the [Q, N] score matrix never reaches device memory.  Stage 2 (top-k over
// the bins) stays in PyTorch, as the JAX package keeps it outside its kernel.
//   'none': a bf16 corpus, f32 scores, masked docs -inf;
//   'doc':  int8 codes, exact int32 sums, each converted to f32 and times
//           its doc's f32 scale before binning, masked docs -inf;
//   'bin':  int8 codes, int32 sums binned in int32 (a bin shares one scale,
//           so raw sums rank exactly within it), masked docs -2^31 + 1; only
//           the winner is converted to f32 and times its bin's scale, and a
//           bin whose winner is masked reports -inf.
// The f32 multiplies round to nearest (no fused multiply-add), in the TPU
// kernel's order, so values and indices equal the plain version's exactly.
//
// What bounds it on the H100: 2*N*Q*D operations (0.82 T at N 262,144,
// Q 2,048, D 768) against one read of the corpus (0.4 GB bf16, 0.2 GB
// int8), so it is compute-bound on the tensor cores: 0.83 ms at the bf16
// peak, 0.42 ms at the int8 peak.  All three modes run on wgmma.cuh's
// persistent main loop (TMA, two consumer warpgroups of wgmma, one bin of
// 128 docs a tile) with the argmax as its epilogue: mode 'none' on bf16
// 128 docs x 256 queries tiles (BinEpi), the int8 modes on the loop's s8
// instance in its ping-pong shape, 128 x 128 tiles (BinEpiI8).  Tiles walk
// (bin, query tile) with the query tile fastest, so the blocks that share a
// bin read its corpus rows from L2.
#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr int BD = 128;  // docs per tile = one bin
constexpr int I32_MASK = -2147483647;  // _I32_MIN of the TPU kernel

enum { MODE_DOC = 1, MODE_BIN = 2 };

template <typename T>
__device__ __forceinline__ void better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Mode 'none' on wg_gemm_kernel: the docs of one bin are the tile's 128
// rows (A, the corpus [N, D]), BN queries its columns (B, the queries
// [Q, D], K-major); tiles walk (bin, query tile) with the query tile
// fastest, so a bin's corpus rows are read from L2 by the blocks that take
// its query tiles together.  Each query column is reduced in registers:
// over the thread's two rows, then by shuffles over the 8 lanes that share
// the column, then over the 8 consumer warps through shared memory.  Docs
// at or past valid_n score -inf; the lowest doc wins among equal maxima.
template <int BN>
struct BinEpi {
  static constexpr int SMEM = 8 * BN * 8;  // (max, doc) per warp and column
  float* vals;
  int* idx;
  int Q, valid_n;

  __device__ __forceinline__ void finish(int) const {}

  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2],
                                             int bin, int qt, int wg,
                                             int ctid,
                                             unsigned char* scratch) const {
    float* red_v = reinterpret_cast<float*>(scratch);
    int* red_i = reinterpret_cast<int*>(scratch + 8 * BN * 4);
    const int lane = ctid & 31, warp = ctid >> 5, g = lane >> 2, t = lane & 3;
    const int d0 = bin * BD;
    const int r = wg * 64 + (warp & 3) * 16 + g;  // and r + 8
    const bool ok0 = d0 + r < valid_n, ok1 = d0 + r + 8 < valid_n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bv = ok0 ? acc[4 * j + h] : -INFINITY;
        int bi = r;
        better(bv, bi, ok1 ? acc[4 * j + 2 + h] : -INFINITY, r + 8);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
          better(bv, bi, v2, i2);
        }
        if (g == 0) {
          const int c = 8 * j + 2 * t + h;
          red_v[warp * BN + c] = bv;
          red_i[warp * BN + c] = bi;
        }
      }
    }
    consumer_sync();
    for (int c = ctid; c < BN; c += 256) {
      float bv = red_v[c];
      int bi = red_i[c];
#pragma unroll
      for (int w = 1; w < 8; ++w) better(bv, bi, red_v[w * BN + c],
                                         red_i[w * BN + c]);
      const int q = qt * BN + c;
      if (q < Q) {
        const size_t o = (size_t)bin * Q + q;
        vals[o] = bv;
        idx[o] = d0 + bi;
      }
    }
    consumer_sync();  // the scratch is free for the next tile
  }
};

template <int BN>
int launch_bins_bf16(const void* corpus, const void* queries, float* vals,
                     int* idx, int N, int Q, int D, int valid_n,
                     cudaStream_t st) {
  CUtensorMap ta, tb;
  int e = tma_map(&ta, corpus, false, N, D, D, WG_BM, WG_BK);
  if (e == 0) e = tma_map(&tb, queries, false, Q, D, D, BN, WG_BK);
  if (e != 0) return e;
  const BinEpi<BN> epi{vals, idx, Q, valid_n};
  return wg_gemm_launch<BN, false>(ta, tb, (N + BD - 1) / BD,
                                   (Q + BN - 1) / BN,
                                   (D + WG_BK - 1) / WG_BK, epi, st);
}

// Modes 'doc' and 'bin' on wg_gemm_kernel's s8 instance (WgS8: int8
// corpus rows as A, int8 query rows as K-major B, 128-deep int8 stages,
// exact s32 sums) in its ping-pong shape: each consumer warpgroup takes
// whole 128-doc x 128-query tiles (one bin a tile) in turn, so one's argmax
// runs beside the other's products; D 768 is only six stages, and the
// cooperative 128 x 256 loop, whose argmax stalls both warpgroups, took
// 0.92 ms of card time against 0.65 at N 262,144, Q 2,048, D 768 (H100
// 80GB HBM3, 700 W).
// Each query column of the tile is reduced to its best doc in registers
// (over the thread's four rows, then by shuffles over the 8 lanes that
// share the column), then over the warpgroup's 4 warps through shared
// memory (named barrier 2 + wg):
//   MODE_BIN: int32 sums compared exactly (a bin shares one scale), masked
//             docs I32_MASK; only the winner becomes f32 (round to
//             nearest) and is multiplied by its bin's scale (__fmul_rn), a
//             masked winner reporting -inf;
//   MODE_DOC: each sum rounded to f32 and multiplied by its doc's scale
//             (__fmul_rn, no FMA), masked docs -inf, then binned.
// Docs at or past min(valid_n, N) are masked (TMA reads rows past N as
// zeros); the lowest doc wins among equal maxima.  The accumulator comes as
// int, so no sum passes through an f32 by value before its cast.
template <int MODE>
struct BinEpiI8 {
  using Val = typename std::conditional<MODE == MODE_BIN, int, float>::type;
  static constexpr int BN = 128;            // queries a tile
  static constexpr int SMEM = 4 * BN * 8;  // (best, doc) per warp, column
  const float* scales;  // per bin [n_bins] (MODE_BIN) or per doc [N]
  float* vals;
  int* idx;
  int Q, n_valid;  // n_valid = min(valid_n, N)

  __device__ __forceinline__ void finish(int) const {}

  __device__ __forceinline__ void sync(int wg) const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  }

  // acc[h][4j + 2e + c]: doc row 64 h + 16 warp + lane / 4 + 8 e, query
  // column 8j + 2 (lane % 4) + c of the tile
  __device__ __forceinline__ void team(const int (&acc)[2][BN / 2], int bin,
                                       int qt, int wg, int ctid,
                                       unsigned char* scratch) const {
    Val* red_v = reinterpret_cast<Val*>(scratch);
    int* red_i = reinterpret_cast<int*>(scratch + 4 * BN * 4);
    const int lane = ctid & 31, warp = ctid >> 5, g = lane >> 2, t = lane & 3;
    const int row0 = 16 * warp + g, d0 = bin * BD;
    bool ok[2][2];
    float ds[2][2];  // MODE_DOC: the scales of this thread's docs
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + row0 + 64 * h + 8 * e;
        ok[h][e] = d < n_valid;
        ds[h][e] = MODE == MODE_DOC && ok[h][e] ? scales[d] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        Val bv;
        int bi = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = acc[h][4 * j + 2 * e + c];
            Val v;
            if constexpr (MODE == MODE_BIN)
              v = ok[h][e] ? a : I32_MASK;
            else
              v = ok[h][e] ? __fmul_rn(__int2float_rn(a), ds[h][e])
                           : -INFINITY;
            const int r = row0 + 64 * h + 8 * e;
            if (h == 0 && e == 0) {
              bv = v;
              bi = r;
            } else {
              better(bv, bi, v, r);
            }
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const Val v2 = __shfl_xor_sync(0xffffffffu, bv, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
          better(bv, bi, v2, i2);
        }
        if (g == 0) {
          const int col = 8 * j + 2 * t + c;
          red_v[warp * BN + col] = bv;
          red_i[warp * BN + col] = bi;
        }
      }
    }
    sync(wg);
    {
      const int col = ctid;  // BN == 128 threads: one column each
      Val bv = red_v[col];
      int bi = red_i[col];
#pragma unroll
      for (int w = 1; w < 4; ++w)
        better(bv, bi, red_v[w * BN + col], red_i[w * BN + col]);
      const int q = qt * BN + col;
      if (q < Q) {
        float out;
        if constexpr (MODE == MODE_BIN)
          out = bv == I32_MASK
                    ? -INFINITY
                    : __fmul_rn(__int2float_rn(bv), scales[bin]);
        else
          out = bv;
        const size_t o = (size_t)bin * Q + q;
        vals[o] = out;
        idx[o] = d0 + bi;
      }
    }
    sync(wg);  // the scratch is free for the warpgroup's next tile
  }
};

template <int MODE>
int launch_bins_i8(const void* corpus, const void* queries,
                   const float* scales, float* vals, int* idx, int N, int Q,
                   int D, int valid_n, cudaStream_t st) {
  constexpr int BN = BinEpiI8<MODE>::BN;
  CUtensorMap ta, tb;
  int e = tma_map(&ta, corpus, TMA_I8, N, D, D, WG_BM, WgS8::BK);
  if (e == 0) e = tma_map(&tb, queries, TMA_I8, Q, D, D, BN, WgS8::BK);
  if (e != 0) return e;
  const BinEpiI8<MODE> epi{scales, vals, idx, Q, valid_n < N ? valid_n : N};
  return wg_gemm_launch<BN, false, BinEpiI8<MODE>, WgS8, true>(
      ta, tb, (N + BD - 1) / BD, (Q + BN - 1) / BN,
      (D + WgS8::BK - 1) / WgS8::BK, epi, st);
}

}  // namespace

extern "C" {

// corpus [N, D] bf16, queries [Q, D] bf16 -> vals/idx [ceil(N/128), Q].
// Needs D % 8 == 0 (16-byte rows for TMA); queries in tiles of 128 up to
// Q 128, else of 256.
int bin_topk_bins(const void* corpus, const void* queries, void* vals,
                  void* idx, int N, int Q, int D, int valid_n, void* stream) {
  if (D % 8 || D < 1 || N < 0 || Q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  if (Q <= 128)
    return launch_bins_bf16<128>(corpus, queries, v, i, N, Q, D, valid_n, st);
  return launch_bins_bf16<256>(corpus, queries, v, i, N, Q, D, valid_n, st);
}

// corpus [N, D] int8, queries [Q, D] int8 (D % 16 == 0: 16-byte rows for
// TMA), scales [N] f32 (per_bin == 0) or [>= ceil(N/128)] f32 (per_bin ==
// 1) -> vals/idx [ceil(N/128), Q].
int bin_topk_bins_i8(const void* corpus, const void* queries,
                     const void* scales, void* vals, void* idx, int N, int Q,
                     int D, int valid_n, int per_bin, void* stream) {
  if (D % 16 || D < 1 || N < 0 || Q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  if (per_bin)
    return launch_bins_i8<MODE_BIN>(corpus, queries, s, v, i, N, Q, D,
                                    valid_n, st);
  return launch_bins_i8<MODE_DOC>(corpus, queries, s, v, i, N, Q, D, valid_n,
                                  st);
}

}  // extern "C"
