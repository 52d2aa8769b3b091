// Causal GQA flash attention for prefill, reading K and V in place.
//
// Replaces: bergen_tpu/ops/flash_attention.py::flash_attention (Pallas body
// _flash_kernel).  For batch row b, query head h (KV head h / group) and
// query row i at position q_offset + i it computes, over key blocks of 64,
//   s = q.k * scale, masked to -1e30 where the key is above the diagonal
//       (causal) or not valid, and excluded past the last key (Sk);
//   m' = max(m, rowmax s), p = exp(s - m'), a = exp(m - m'),
//   l' = l * a + rowsum p, acc' = acc * a + bf16(p) . V,
// then out = acc / max(l, 1e-30) in bf16: the TPU kernel's online softmax
// with its -1e30 mask, so a row with no valid key averages V uniformly over
// the keys of the blocks it visits.  Key blocks wholly above the diagonal of
// a query block are skipped: the visited keys of query block [q0, q0 + 64)
// are [0, min(Sk, 64 * ((q_offset + last row) / 64 + 1))).
//
// What bounds it on the H100: 4 * B * H * S * (keys per row) * Dh tensor-core
// operations (2.7e11 at Llama-2-7B width, B 8, S 2,048: 0.28 ms at the bf16
// peak); the score matrix never leaves the chip, which is why it exists (the
// plain prefill builds f32 scores of [B, H, S, L], 4.3 GB per layer at that
// shape).  Design: one 128-thread block per (64 queries, head, row), four
// warps of 16 query rows each (the FlashAttention-2 split), Q fragments held
// in registers, K and V tiles of 64 keys double-buffered in shared memory by
// cp.async straight from the flat [B, L, KH*Dh] cache (row stride KH*Dh, no
// reshaped copy), S = Q.K^T and O += P.V on mma.sync m16n8k16 with the
// probabilities passed from the score accumulators to A fragments in
// registers.  The head width DH (64 or 128) is a template parameter.  Query
// blocks run last-first, so the longest causal rows start early.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                 int Sq, int Sk, int H, int KH, int kv_batch_stride,
                 int kv_row_stride, int causal, int q_offset, float scale) {
  constexpr int LD = DH + 8;     // padded row: conflict-free ldmatrix
  constexpr int CPR = DH / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const size_t HD = (size_t)H * DH;
  const bf16* qb = q + (size_t)b * Sq * HD + (size_t)h * DH;
  const bf16* kb = k + (size_t)b * kv_batch_stride + (size_t)kvh * DH;
  const bf16* vb = v + (size_t)b * kv_batch_stride + (size_t)kvh * DH;
  const uint8_t* vm = valid + (size_t)b * Sk;

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend =
      causal ? min(Sk, ((q_offset + last_row) / BK + 1) * BK) : Sk;
  const int n_kb = (kend + BK - 1) / BK;

  for (int i = tid; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = q0 + r < Sq;
    cp_async16(Qs + r * LD + c, qb + (size_t)(ok ? q0 + r : 0) * HD + c, ok);
  }
  auto load_kv = [&](int stage, int blk) {
    bf16* ks = Ks + stage * BK * LD;
    bf16* vs = Vs + stage * BK * LD;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int key = blk * BK + r;
      const bool ok = key < Sk;  // zero rows past the last key
      const size_t off = (size_t)(ok ? key : 0) * kv_row_stride + c;
      cp_async16(ks + r * LD + c, kb + off, ok);
      cp_async16(vs + r * LD + c, vb + off, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);  // the first group carries the Q tile too

  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int blk = 0; blk < n_kb; ++blk) {
    const int stage = blk & 1;
    if (blk + 1 < n_kb) {
      load_kv(stage ^ 1, blk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (blk == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* ks = Ks + stage * BK * LD;
    const bf16* vs = Vs + stage * BK * LD;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t t4[4];
        ldmatrix_x4(t4, ks + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t4[0], t4[1]}, b1[2] = {t4[2], t4[3]};
        mma_bf16(s[2 * nj], qf[kk], b0);
        mma_bf16(s[2 * nj + 1], qf[kk], b1);
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = blk * BK + j * 8 + 2 * t + (e & 1);
        const int qpos = q_offset + row0 + 8 * (e >> 1);
        float x = s[j][e] * scale;
        if (key >= Sk)
          x = -INFINITY;
        else if ((causal && key > qpos) || vm[key] == 0)
          x = -1e30f;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = l_r[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t t4[4];
        ldmatrix_x4_trans(t4, vs + (kk * 16 + (lane & 15)) * LD + nd * 16 +
                                  (lane >> 4) * 8);
        const uint32_t b0[2] = {t4[0], t4[1]}, b1[2] = {t4[2], t4[3]};
        mma_bf16(o[2 * nd], a, b0);
        mma_bf16(o[2 * nd + 1], a, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    bf16* orow = out + ((size_t)b * Sq + row) * HD + (size_t)h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(o[j][2 * i] / den, o[j][2 * i + 1] / den);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int Sq, int Sk, int H, int KH, int kv_batch_stride,
           int kv_row_stride, int causal, int q_offset, float scale,
           cudaStream_t st) {
  const int smem = (BQ + 4 * BK) * (DH + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<DH><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(out), Sq, Sk, H, KH, kv_batch_stride, kv_row_stride,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Sq, H, Dh] bf16 (contiguous); k, v: rows of KH*Dh bf16 at
// kv_row_stride elements, batch rows kv_batch_stride apart, Sk keys; valid
// [B, Sk] uint8 -> out [B, Sq, H, Dh] bf16.  Returns cudaErrorInvalidValue
// for a head width it was not built for.
int flash_attention(const void* q, const void* k, const void* v,
                    const void* valid, void* out, int B, int Sq, int Sk,
                    int H, int KH, int Dh, int kv_batch_stride,
                    int kv_row_stride, int causal, int q_offset, float scale,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch<64>(q, k, v, valid, out, B, Sq, Sk, H, KH, kv_batch_stride,
                      kv_row_stride, causal, q_offset, scale, st);
  if (Dh == 128)
    return launch<128>(q, k, v, valid, out, B, Sq, Sk, H, KH, kv_batch_stride,
                       kv_row_stride, causal, q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
