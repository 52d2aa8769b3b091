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
// bf16 peak, against 2.1 GB of f32 scores written, 0.64 ms at the memory
// rate: operations, barely.  Design: the encoder GEMMs' 128 x 128 tile loop
// (common.cuh mma_tile: 256 threads, 8 warps of 64 x 32, a two-stage
// cp.async ring over D in slices of 32, mma.sync m16n8k16 with f32
// accumulation), reading corpus_t in its given [D, N] layout through
// ldmatrix.trans; the epilogue stores each f32 accumulator pair as one
// 8-byte write (an odd output width stores each value alone).  Query rows
// past Q read as zero; N must be a multiple of 128 (the wrapper pads a
// ragged corpus and keeps the first n_out columns).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
    score_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ct,
                 float* __restrict__ out, int Q, int D, int N, int n_out) {
  const int n0 = blockIdx.x * MMA_TILE, q0 = blockIdx.y * MMA_TILE;
  float acc[4][4][4];
  mma_tile<false, float>(q + (size_t)q0 * D, Q - q0, ct + n0, MMA_TILE, N, D,
                         acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= Q) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        float* o = out + (size_t)row * n_out + col;
        if (col + 1 < n_out && n_out % 2 == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
        } else {
          if (col < n_out) o[0] = acc[mi][ni][half * 2];
          if (col + 1 < n_out) o[1] = acc[mi][ni][half * 2 + 1];
        }
      }
    }
}

}  // namespace

extern "C" {

// queries [Q, D] bf16, corpus_t [D, N] bf16 (N % 128 == 0, D % 32 == 0),
// both contiguous -> out [Q, n_out] f32, the first n_out <= N columns.
int pallas_score(const void* q, const void* ct, void* out, int Q, int D,
                 int N, int n_out, void* stream) {
  if (N % MMA_TILE || D % MMA_BK || n_out > N)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(N / MMA_TILE, (Q + MMA_TILE - 1) / MMA_TILE);
  score_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ct),
      static_cast<float*>(out), Q, D, N, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
