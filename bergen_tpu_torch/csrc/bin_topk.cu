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
// peak, 0.42 ms at the int8 peak.  Mode 'none' runs on wgmma.cuh's
// persistent main loop (TMA, two consumer warpgroups of wgmma, 128 docs x
// 256 queries a tile, one bin a tile) with the argmax as its epilogue
// (BinEpi below).  The int8 modes keep common.cuh's mma_tile: one block
// scores one bin (128 docs) against 128 queries with s8 m16n8k32 mma.sync
// (int32 sums; 8 warps of 64 docs x 32 queries, a two-stage cp.async ring
// over D), then reduces each query column in registers (within a thread,
// then across the 8 lanes that share a column by shuffles, then across the
// two warp rows through shared memory).  The query tile index is the
// fastest grid axis, so the blocks that share a bin run together and read
// its corpus rows from L2.
#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr int BD = MMA_TILE;  // docs per block = one bin
constexpr int BQ = MMA_TILE;  // queries per block
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

// Modes 'doc' and 'bin' (int8): one block scores one bin against 128
// queries with common.cuh's mma_tile (s8 m16n8k32, int32 sums), then
// reduces each query column as above, over the two warp rows of the tile.
// corpus [N, D] and queries [Q, D] int8; scales per doc [N] (MODE_DOC) or
// per bin [n_bins] (MODE_BIN).
template <int MODE>
__global__ void __launch_bounds__(256)
    bin_kernel(const void* __restrict__ corpus, const void* __restrict__ qry,
               const float* __restrict__ scales, float* __restrict__ vals,
               int* __restrict__ idx, int N, int Q, int D, int valid_n,
               int bin_off) {
  using Acc = int;
  using Val = typename std::conditional<MODE == MODE_BIN, int, float>::type;
  __shared__ Val red_v[2][BQ];
  __shared__ int red_i[2][BQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.x * BQ, bin = blockIdx.y + bin_off, d0 = bin * BD;

  Acc acc[4][4][4];
  // int8 rows read as bf16 pairs: K counted in pairs (common.cuh)
  const int8_t* c = static_cast<const int8_t*>(corpus);
  const int8_t* q = static_cast<const int8_t*>(qry);
  mma_tile<true, int>(reinterpret_cast<const bf16*>(c + (size_t)d0 * D),
                      N - d0,
                      reinterpret_cast<const bf16*>(q + (size_t)q0 * D),
                      Q - q0, 0, D / 2, acc);

  const int g = lane >> 2, t = lane & 3;
  float dscale[4][2];  // MODE_DOC: the scales of this thread's 8 docs
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + wm * 64 + mi * 16 + g + half * 8;
      dscale[mi][half] = MODE == MODE_DOC && d < valid_n ? scales[d] : 0.f;
    }

  // per query column: (max, lowest doc) over this warp's 64 docs
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Val bv;
      if constexpr (MODE == MODE_BIN)
        bv = I32_MASK;
      else
        bv = -INFINITY;
      int bi = 1 << 30;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 64 + mi * 16 + g + half * 8;
          const bool ok = d0 + r < valid_n;
          const Acc a = acc[mi][ni][half * 2 + j];
          Val v;
          if constexpr (MODE == MODE_BIN)
            v = ok ? a : I32_MASK;
          else
            v = ok ? __fmul_rn(static_cast<float>(a), dscale[mi][half])
                   : -INFINITY;
          better(bv, bi, v, r);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        Val v2 = __shfl_xor_sync(0xffffffffu, bv, off);
        int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
        better(bv, bi, v2, i2);
      }
      if (g == 0) {
        int c = wn * 32 + ni * 8 + t * 2 + j;
        red_v[wm][c] = bv;
        red_i[wm][c] = bi;
      }
    }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Q) {
    Val bv = red_v[0][tid];
    int bi = red_i[0][tid];
    better(bv, bi, red_v[1][tid], red_i[1][tid]);
    float out;
    if constexpr (MODE == MODE_BIN)
      out = bv == I32_MASK ? -INFINITY
                           : __fmul_rn(static_cast<float>(bv), scales[bin]);
    else
      out = bv;
    const size_t o = (size_t)bin * Q + q0 + tid;
    vals[o] = out;
    idx[o] = d0 + bi;
  }
}

template <int MODE>
void launch_bins(const void* corpus, const void* queries, const float* scales,
                 float* vals, int* idx, int N, int Q, int D, int valid_n,
                 cudaStream_t st) {
  const int n_bins = (N + BD - 1) / BD;
  for (int b0 = 0; b0 < n_bins; b0 += 65535) {  // gridDim.y limit
    int nb = n_bins - b0 < 65535 ? n_bins - b0 : 65535;
    dim3 grid((Q + BQ - 1) / BQ, nb);
    bin_kernel<MODE><<<grid, 256, 0, st>>>(corpus, queries, scales, vals, idx,
                                           N, Q, D, valid_n, b0);
  }
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

// corpus [N, D] int8, queries [Q, D] int8 (D % 64 == 0), scales [N] f32
// (per_bin == 0) or [ceil(N/128)] f32 (per_bin == 1) -> vals/idx
// [ceil(N/128), Q].
int bin_topk_bins_i8(const void* corpus, const void* queries,
                     const void* scales, void* vals, void* idx, int N, int Q,
                     int D, int valid_n, int per_bin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idx);
  if (per_bin)
    launch_bins<MODE_BIN>(corpus, queries, s, v, i, N, Q, D, valid_n, st);
  else
    launch_bins<MODE_DOC>(corpus, queries, s, v, i, N, Q, D, valid_n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
