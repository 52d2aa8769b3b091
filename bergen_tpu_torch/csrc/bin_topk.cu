// Fused MIPS scoring + per-bin argmax (stage 1 of the bin top-k).
//
// Replaces: bergen_tpu/ops/fused_topk.py::bin_topk (Pallas body _kernel,
// scale mode 'none', a bf16 corpus).  For every 128-doc bin and every query
// it computes the bin's best score and the LOWEST doc index among equal
// maxima, with docs at or past valid_n scored -inf, and writes only the
// [n_bins, Q] winners: the [Q, N] score matrix never reaches device memory.
// Stage 2 (top-k over the bins) stays in PyTorch, as the JAX package keeps
// it outside its kernel.
//
// What bounds it on the H100: 2*N*Q*D FLOPs (0.82 TFLOP at N 262,144,
// Q 2,048, D 768) against one 0.4 GB read of the corpus, so it is
// compute-bound on the tensor cores.  Design: one block scores one bin
// (128 docs) against 128 queries with bf16 mma.sync m16n8k16 (8 warps of
// 64 docs x 32 queries, two-stage cp.async ring over D in 32-wide slices:
// common.cuh's mma_tile, the encoder GEMM's main loop with K-contiguous B),
// then reduces each query column in registers (within a thread, then across
// the 8 lanes that share a column by shuffles, then across the two warp rows
// through shared memory).  The query tile index is the fastest grid axis, so
// the blocks that share a bin run together and read its corpus rows from L2.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BD = MMA_TILE;  // docs per block = one bin
constexpr int BQ = MMA_TILE;  // queries per block

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(256)
    bin_kernel(const bf16* __restrict__ corpus, const bf16* __restrict__ qry,
               float* __restrict__ vals, int* __restrict__ idx, int N, int Q,
               int D, int valid_n, int bin_off) {
  __shared__ float red_v[2][BQ];
  __shared__ int red_i[2][BQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.x * BQ, bin = blockIdx.y + bin_off, d0 = bin * BD;

  float acc[4][4][4];
  mma_tile<true>(corpus + (size_t)d0 * D, N - d0, qry + (size_t)q0 * D,
                 Q - q0, D, D, acc);

  // per query column: (max, lowest doc) over this warp's 64 docs
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float bv = -INFINITY;
      int bi = 1 << 30;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int r = wm * 64 + mi * 16 + g + half * 8;
          float v = d0 + r < valid_n ? acc[mi][ni][half * 2 + j] : -INFINITY;
          better(bv, bi, v, r);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
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
    float bv = red_v[0][tid];
    int bi = red_i[0][tid];
    better(bv, bi, red_v[1][tid], red_i[1][tid]);
    const size_t o = (size_t)bin * Q + q0 + tid;
    vals[o] = bv;
    idx[o] = d0 + bi;
  }
}

}  // namespace

extern "C" {

// corpus [N, D] bf16, queries [Q, D] bf16 -> vals/idx [ceil(N/128), Q].
int bin_topk_bins(const void* corpus, const void* queries, void* vals,
                  void* idx, int N, int Q, int D, int valid_n, void* stream) {
  const int n_bins = (N + BD - 1) / BD;
  for (int b0 = 0; b0 < n_bins; b0 += 65535) {  // gridDim.y limit
    int nb = n_bins - b0 < 65535 ? n_bins - b0 : 65535;
    dim3 grid((Q + BQ - 1) / BQ, nb);
    bin_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(corpus), static_cast<const bf16*>(queries),
        static_cast<float*>(vals), static_cast<int*>(idx), N, Q, D, valid_n,
        b0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
