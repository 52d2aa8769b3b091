// GQA flash attention with a key band per query row, reading K and V in
// place (the chunked-prefill drain's chunk-row attention).
//
// Replaces: bergen_tpu/ops/flash_attention.py::flash_attention_band (Pallas
// body _flash_kernel_band).  Query row i of head h (KV head h / group)
// attends keys [lo_i, hi_i) of one cache row; over key blocks of 64 it
// computes
//   s = q.k * scale, and -1e30 outside the band (keys at or past Sk are
//       outside every band);
//   m' = max(m, rowmax s), p = exp(s - m') inside the band and exactly 0
//       outside it, a = exp(m - m'),
//   l' = l * a + rowsum p, acc' = acc * a + bf16(p) . V,
// then out = acc / max(l, 1e-30) in bf16: the TPU kernel's rule, whose hard
// zeroing makes a row with an empty band output exact zeros (the drain's
// inactive chunk rows), where the prefill kernel's rows average V.
//
// What bounds it on the H100: the bytes of the keys the bands cover (K and
// V rows of KH*Dh bf16 each: 4 MB for 1,024 keys at Mistral-7B width) against
// 4 * H * Dh operations per in-band (row, key) pair; a drain step's 128
// chunk rows do ~1.5 GFLOP, so both bounds are about a microsecond and the
// launch itself dominates.  Design: the prefill kernel's (flash_attention.cu)
// tiles -- one 128-thread block per (64 query rows, head), four warps of 16
// rows, Q fragments in registers, K and V tiles of 64 keys double-buffered
// by cp.async straight from the flat cache row (row stride KH*Dh, no copy),
// S = Q.K^T and O += P.V on mma.sync m16n8k16 -- and the band decides which
// key blocks a query block visits: only those that meet the union of its
// rows' bands.  The TPU grid visits every key block of the window; skipping
// the others is what makes the cost follow the staged prefix (JAX's
// grown-window lax.switch in llama.py gets that effect on the TPU).  A
// block whose rows all have empty bands loads nothing and writes zeros.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;

template <int DH>
__global__ void __launch_bounds__(THREADS)
    band_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ band,
                bf16* __restrict__ out, int Sq, int Sk, int H, int KH,
                int kv_row_stride, float scale) {
  constexpr int LD = DH + 8;     // padded row: conflict-free ldmatrix
  constexpr int CPR = DH / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int kvh = h / (H / KH);
  const size_t HD = (size_t)H * DH;
  const bf16* kb = k + (size_t)kvh * DH;
  const bf16* vb = v + (size_t)kvh * DH;

  // the union of this block's nonempty bands, clipped to [0, Sk)
  if (tid == 0) {
    s_lo = Sk;
    s_hi = 0;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Sq) {
    const int lo = max(band[2 * (q0 + tid)], 0);
    const int hi = min(band[2 * (q0 + tid) + 1], Sk);
    if (lo < hi) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  __syncthreads();
  const int kb0 = s_lo / BK;
  const int n_kb = s_lo < s_hi ? (s_hi + BK - 1) / BK - kb0 : 0;

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int lo_r[2], hi_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lo_r[i] = row < Sq ? band[2 * row] : 0;
    hi_r[i] = row < Sq ? min(band[2 * row + 1], Sk) : 0;
  }

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};

  if (n_kb > 0) {
    for (int i = tid; i < BQ * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = q0 + r < Sq;
      cp_async16(Qs + r * LD + c, q + (size_t)(ok ? q0 + r : 0) * HD +
                                      (size_t)h * DH + c, ok);
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
    load_kv(0, kb0);  // the first group carries the Q tile too

    uint32_t qf[DH / 16][4];
    for (int bi = 0; bi < n_kb; ++bi) {
      const int blk = kb0 + bi;
      const int stage = bi & 1;
      if (bi + 1 < n_kb) {
        load_kv(stage ^ 1, blk + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (bi == 0) {
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
          ldmatrix_x4(t4, ks + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {t4[0], t4[1]}, b1[2] = {t4[2], t4[3]};
          mma_bf16(s[2 * nj], qf[kk], b0);
          mma_bf16(s[2 * nj + 1], qf[kk], b1);
        }

      // inside: whether (row, key) lies in the row's band; outside scores
      // are -1e30 and their probabilities exactly 0
      uint32_t inside[2] = {0u, 0u};
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = blk * BK + j * 8 + 2 * t + (e & 1);
          const int i = e >> 1;
          const bool in = key >= lo_r[i] && key < hi_r[i];
          const float x = in ? s[j][e] * scale : -1e30f;
          if (in) inside[i] |= 1u << (j * 2 + (e & 1));
          s[j][e] = x;
          mx[i] = fmaxf(mx[i], x);
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
          const int i = e >> 1;
          const float p = (inside[i] >> (j * 2 + (e & 1))) & 1u
                              ? expf(s[j][e] - m_r[i])
                              : 0.f;
          s[j][e] = p;
          rs[i] += p;
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    bf16* orow = out + (size_t)row * HD + (size_t)h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(o[j][2 * i] / den, o[j][2 * i + 1] / den);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* band,
           void* out, int Sq, int Sk, int H, int KH, int kv_row_stride,
           float scale, cudaStream_t st) {
  const int smem = (BQ + 4 * BK) * (DH + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      band_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, H);
  band_kernel<DH><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(band),
      static_cast<bf16*>(out), Sq, Sk, H, KH, kv_row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [Sq, H, Dh] bf16 (contiguous); k, v: Sk rows of KH*Dh bf16 at
// kv_row_stride elements; band [Sq, 2] int32 -> out [Sq, H, Dh] bf16.
// Returns cudaErrorInvalidValue for a head width it was not built for.
int flash_attention_band(const void* q, const void* k, const void* v,
                         const void* band, void* out, int Sq, int Sk, int H,
                         int KH, int Dh, int kv_row_stride, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch<64>(q, k, v, band, out, Sq, Sk, H, KH, kv_row_stride, scale,
                      st);
  if (Dh == 128)
    return launch<128>(q, k, v, band, out, Sq, Sk, H, KH, kv_row_stride,
                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
