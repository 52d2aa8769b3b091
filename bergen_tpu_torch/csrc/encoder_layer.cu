// One post-LN BERT encoder layer as a chain of hand-written Hopper kernels.
//
// Replaces: bergen_tpu/ops/encoder_attention.py::encoder_layer (Pallas body
// _layer_kernel), which computes
//   y = LN1(x + Wo . attn(Wqkv . x + bqkv) + bo)
//   out = LN2(y + W2 . act(W1 . y + b1) + b2)
// for one [S, D] sequence per grid step with all ~14 MB of weights resident
// in VMEM.  That residency does not exist on Hopper (227 KB of shared memory
// per block), so the layer becomes five launches from this file:
//   gemm_kernel<EPI_BIAS>      qkv  = bf16(x Wqkv + bqkv)           [M, 3D]
//   attention_kernel           ctx  = softmax(q k^T / sqrt(Dh)) v   [M, D]
//   gemm_kernel<EPI_BIAS_RES>  o    = ctx Wo + bo + x (f32)         [M, D]
//   layernorm_kernel           y    = LN1(o) (f32 and bf16 copies)
//   gemm_kernel<EPI_BIAS_ACT>  h    = bf16(act(y Wi + bi))          [M, I]
//   gemm_kernel<EPI_BIAS_RES>  f    = h W2 + b2 + y (f32)
//   layernorm_kernel           out  = bf16(LN2(f))
// The rounding points are the TPU kernel's: qkv, the attention context and
// the FFN hidden are rounded to bf16; residual sums and LayerNorms are f32.
//
// What bounds it on the H100: the four GEMMs are 2*M*D*(4D + 2I) FLOPs
// (0.95 TFLOP at B 512, S 128, D 768, I 3072) against ~0.25 GB of
// activation traffic, so the layer is compute-bound on the tensor cores.
// The GEMM is a plain mma.sync m16n8k16 kernel: 128x128x32 block tiles,
// 8 warps of 64x32, a two-stage cp.async ring and ldmatrix fragment loads
// from padded (bank-conflict-free) shared tiles, with the bias, activation
// and residual fused into its epilogue so that no elementwise pass touches
// device memory; its main loop is common.cuh's mma_tile, which the bin top-k
// shares.  Attention keeps the [S, S] scores out of device memory:
// one block per (sequence, head, 64-query tile) streams 64-key tiles with an
// online softmax, so any bucket up to S 512 runs in ~37 KB of shared memory.
// The attention takes head width 32 or 64 (a template parameter).
//
// It also serves bergen_tpu/ops/encoder_attention.py::encoder_layer_prebias
// (Pallas body _layer_kernel_prebias): DeBERTa's layer from the scores on,
// with qkv computed outside and a per-sequence [B, H, S, S] bf16 score bias
// (the disentangled c2p + p2c terms, already divided by the scale).  The
// bias is the largest operand there (B 256, S 512, H 12: 1.6 GB per layer,
// against ~0.3 GB of activations), so it is streamed, never staged whole:
// each attention block copies the bias tile of its 64 queries x 64 keys into
// shared memory with cp.async beside each K/V tile and adds it in f32 after
// s * scale + maskbias, as the TPU kernel does.  Read once, the bias bounds
// that layer by bytes at short S; the GEMMs bound it by operations above.
//
// The same attention kernel is bergen_tpu/ops/encoder_attention.py::
// encoder_attention (Pallas body _kernel), the attention of the rope and
// ALiBi encoders (nomic-embed, GTE-v1.5, jina-v2) whose layers are not the
// fused chain: entry encoder_attention_qkv takes q, k and v as three
// [B, S, D] operands (row stride D) and an optional batch-invariant [H, S, S]
// f32 bias (ALiBi's -slope * |i - j| reaches -127 at S 256; bf16's spacing
// of 0.5 there would move the scores).  Its bytes (q, k, v and the context:
// 0.8 GB at B 512, S 256, D 768) bound it: 0.24 ms at 3.35 TB/s against
// 0.10 ms of tensor-core work; the f32 bias (3 MB) is read by every
// sequence's blocks from L2.  The design keeps the [S, S] scores and
// probabilities on chip and reads each operand tile once per 64 queries.
// wgmma/TMA pipelines are later work.
#include "common.cuh"

namespace {

constexpr int BM = MMA_TILE, BN = MMA_TILE;

enum { EPI_BIAS = 0, EPI_BIAS_ACT = 1, EPI_BIAS_RES = 2 };
// C[M, N] = A[M, K] @ B[K, N] (+ epilogue); A, B bf16 row-major, bias f32.
// EPI_BIAS / EPI_BIAS_ACT write bf16; EPI_BIAS_RES adds a bf16 or f32
// residual [M, N] and writes f32.  Needs N % 128 == 0 and K % 32 == 0.
template <int EPI>
__global__ void __launch_bounds__(256)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                const float* __restrict__ bias, const void* __restrict__ res,
                void* __restrict__ out, int M, int N, int K, int act,
                int res_f32) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
  mma_tile<false>(A + (size_t)m0 * K, M - m0, B + n0, BN, N, K, acc);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        float v0 = acc[mi][ni][half * 2] + bias[col];
        float v1 = acc[mi][ni][half * 2 + 1] + bias[col + 1];
        const size_t o = (size_t)row * N + col;
        if (EPI == EPI_BIAS_RES) {
          if (res_f32) {
            float2 r = *reinterpret_cast<const float2*>(
                static_cast<const float*>(res) + o);
            v0 += r.x;
            v1 += r.y;
          } else {
            __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const bf16*>(res) + o);
            v0 += __bfloat162float(r.x);
            v1 += __bfloat162float(r.y);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
        } else {
          if (EPI == EPI_BIAS_ACT) {
            v0 = act_fn(v0, act);
            v1 = act_fn(v1, act);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

constexpr int ATT_Q = 64;         // query rows per block (16 per warp)
constexpr int ATT_K = 64;         // keys per streamed tile
constexpr int BIAS_LD = ATT_K + 8;  // padded smem row of the bias tile

// Masked bidirectional attention, head width DH.  q, k and v point at head 0
// of their sequence's first row; rows are rs elements apart and sequences
// S * rs (the fused [B*S, 3D] qkv: rs = 3D; separate [B, S, D] operands:
// rs = D).  mask [B, S] int32, 1 = attend.  A masked key scores -1e30
// (NEG_INF of the TPU kernel), so a fully masked row averages V uniformly
// over the S keys; keys past S score -inf.  BiasT (bf16 or float; void for
// none): bias [H, S, S] per sequence, bias_bs elements apart (0: one bias
// for the batch), is added to each score after s * scale + maskbias; its
// rows are copied 16 bytes at a time, so S % (16 / sizeof(BiasT)) == 0.
template <int DH, typename BiasT>
__global__ void __launch_bounds__(128)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, size_t rs,
                     const int* __restrict__ mask,
                     const BiasT* __restrict__ bias, size_t bias_bs,
                     bf16* __restrict__ out, int S, int H, float scale) {
  constexpr bool BIAS = !std::is_void<BiasT>::value;
  using BiasS = typename std::conditional<BIAS, BiasT, bf16>::type;
  constexpr int BV = 16 / sizeof(BiasS);  // bias elements per 16-byte copy
  constexpr int LD = DH + 8;  // padded smem row
  __shared__ __align__(16) bf16 Qs[ATT_Q * LD];
  __shared__ __align__(16) bf16 Ks[ATT_K * LD];
  __shared__ __align__(16) bf16 Vs[ATT_K * LD];
  __shared__ __align__(16) BiasS Bs[BIAS ? ATT_Q * BIAS_LD : BV];
  __shared__ float kbias[ATT_K];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_Q;
  const int D = H * DH;
  const size_t seq = (size_t)b * S * rs + (size_t)h * DH;
  const bf16 *qb = q + seq, *kb = k + seq, *vb = v + seq;
  const BiasS* bbase = nullptr;
  if constexpr (BIAS)
    bbase = reinterpret_cast<const BiasS*>(bias) + b * bias_bs +
            (size_t)h * S * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < ATT_Q * (DH / 8); i += 128) {
    int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    bool ok = q0 + r < S;
    cp_async16(&Qs[r * LD + c], qb + (ok ? q0 + r : 0) * rs + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    int r = warp * 16 + (lane & 15);
    int c = ks * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[ks], &Qs[r * LD + c]);
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < S; k0 += ATT_K) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < ATT_K * (DH / 8); i += 128) {
      int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      bool ok = k0 + r < S;
      const size_t off = (ok ? k0 + r : 0) * rs + c;
      cp_async16(&Ks[r * LD + c], kb + off, ok);
      cp_async16(&Vs[r * LD + c], vb + off, ok);
    }
    if constexpr (BIAS) {
      for (int i = tid; i < ATT_Q * (ATT_K / BV); i += 128) {
        int r = i / (ATT_K / BV), c = (i % (ATT_K / BV)) * BV;
        bool ok = q0 + r < S && k0 + c < S;
        cp_async16(&Bs[r * BIAS_LD + c],
                   bbase + (ok ? (size_t)(q0 + r) * S + k0 + c : 0), ok);
      }
    }
    cp_async_commit();
    if (tid < ATT_K) {
      int key = k0 + tid;
      kbias[tid] = key >= S ? -INFINITY
                            : (mask[(size_t)b * S + key] ? 0.f : -1e30f);
    }
    cp_async_wait<0>();
    __syncthreads();

    float s[ATT_K / 8][4];
#pragma unroll
    for (int i = 0; i < ATT_K / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < ATT_K / 16; ++np) {
        uint32_t kf[4];
        int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        int c = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, &Ks[r * LD + c]);
        mma_bf16(s[2 * np], qf[ks], kf);
        mma_bf16(s[2 * np + 1], qf[ks], kf + 2);
      }
    }

    // online softmax; rows g (half 0) and g + 8 (half 1), 4 lanes per row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < ATT_K / 8; ++ni) {
        float2 bb = make_float2(0.f, 0.f);
        if constexpr (BIAS) {
          const BiasS* bp =
              &Bs[(warp * 16 + g + half * 8) * BIAS_LD + ni * 8 + t * 2];
          if constexpr (std::is_same<BiasS, float>::value)
            bb = *reinterpret_cast<const float2*>(bp);
          else
            bb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bp));
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[ni][half * 2 + j] * scale + kbias[ni * 8 + t * 2 + j];
          if constexpr (BIAS) x += j ? bb.y : bb.x;
          s[ni][half * 2 + j] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mnew = fmaxf(mrow[half], mt);
      const float alpha = expf(mrow[half] - mnew);
      mrow[half] = mnew;
      float ls = 0.f;
#pragma unroll
      for (int ni = 0; ni < ATT_K / 8; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p = expf(s[ni][half * 2 + j] - mnew);
          s[ni][half * 2 + j] = p;
          ls += p;
        }
      }
      lrow[half] = lrow[half] * alpha + ls;
#pragma unroll
      for (int di = 0; di < DH / 8; ++di) {
        o[di][half * 2] *= alpha;
        o[di][half * 2 + 1] *= alpha;
      }
    }

    // ctx += P V: the score accumulators become the A fragments of P
#pragma unroll
    for (int kk = 0; kk < ATT_K / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        int r = kk * 16 + (lane & 15);
        int c = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, &Vs[r * LD + c]);
        mma_bf16(o[2 * dp], pa, vf);
        mma_bf16(o[2 * dp + 1], pa, vf + 2);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = lrow[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + g + half * 8;
    if (row >= S) continue;
    bf16* dst = out + ((size_t)b * S + row) * D + h * DH;
#pragma unroll
    for (int di = 0; di < DH / 8; ++di) {
      *reinterpret_cast<__nv_bfloat162*>(dst + di * 8 + t * 2) =
          __floats2bfloat162_rn(o[di][half * 2] * inv,
                                o[di][half * 2 + 1] * inv);
    }
  }
}

template <int DH, typename BiasT>
void launch_attention(const bf16* q, const bf16* k, const bf16* v, size_t rs,
                      const int* mask, const void* bias, size_t bias_bs,
                      bf16* out, int B, int S, int H, float scale,
                      cudaStream_t st) {
  dim3 grid((S + ATT_Q - 1) / ATT_Q, H, B);
  attention_kernel<DH, BiasT><<<grid, 128, 0, st>>>(
      q, k, v, rs, mask, static_cast<const BiasT*>(bias), bias_bs, out, S, H,
      scale);
}

// bias_kind 0: none; 1: bf16; 2: f32.
template <int DH>
void launch_attention_bias(const bf16* q, const bf16* k, const bf16* v,
                           size_t rs, const int* mask, const void* bias,
                           int bias_kind, size_t bias_bs, bf16* out, int B,
                           int S, int H, float scale, cudaStream_t st) {
  if (bias_kind == 2)
    launch_attention<DH, float>(q, k, v, rs, mask, bias, bias_bs, out, B, S,
                                H, scale, st);
  else if (bias_kind == 1)
    launch_attention<DH, bf16>(q, k, v, rs, mask, bias, bias_bs, out, B, S,
                               H, scale, st);
  else
    launch_attention<DH, void>(q, k, v, rs, mask, nullptr, 0, out, B, S, H,
                               scale, st);
}

int attention(const bf16* q, const bf16* k, const bf16* v, size_t rs,
              const int* mask, const void* bias, int bias_kind, size_t bias_bs,
              bf16* out, int B, int S, int H, int head_dim, float scale,
              cudaStream_t st) {
  if (head_dim == 64)
    launch_attention_bias<64>(q, k, v, rs, mask, bias, bias_kind, bias_bs,
                              out, B, S, H, scale, st);
  else if (head_dim == 32)
    launch_attention_bias<32>(q, k, v, rs, mask, bias, bias_kind, bias_bs,
                              out, B, S, H, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Row LayerNorm in f32: one warp per row, D % 128 == 0, D <= 1024.
// Writes bf16 (always) and f32 (when out_f is not null).
__global__ void __launch_bounds__(256)
    layernorm_kernel(const float* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out_b,
                     float* __restrict__ out_f, int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const int n4 = D / 128;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * D);
  float4 v[8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n4) {
      v[i] = xr[i * 32 + lane];
      sum += v[i].x + v[i].y + v[i].z + v[i].w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mean = sum / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n4) {
      float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean,
            d = v[i].w - mean;
      sq += a * a + b * b + c * c + d * d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rstd = rsqrtf(sq / D + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n4) {
      const int c = (i * 32 + lane) * 4;
      float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      float4 bt = *reinterpret_cast<const float4*>(beta + c);
      float4 y;
      y.x = (v[i].x - mean) * rstd * gm.x + bt.x;
      y.y = (v[i].y - mean) * rstd * gm.y + bt.y;
      y.z = (v[i].z - mean) * rstd * gm.z + bt.z;
      y.w = (v[i].w - mean) * rstd * gm.w + bt.w;
      bf16* ob = out_b + (size_t)row * D + c;
      *reinterpret_cast<__nv_bfloat162*>(ob) = __floats2bfloat162_rn(y.x, y.y);
      *reinterpret_cast<__nv_bfloat162*>(ob + 2) =
          __floats2bfloat162_rn(y.z, y.w);
      if (out_f != nullptr)
        *reinterpret_cast<float4*>(out_f + (size_t)row * D + c) = y;
    }
  }
}

}  // namespace

extern "C" {

int encoder_gemm(const void* A, const void* B, const void* bias,
                 const void* res, void* out, int M, int N, int K, int epi,
                 int act, int res_f32, void* stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const float* bs = static_cast<const float*>(bias);
  if (epi == EPI_BIAS)
    gemm_kernel<EPI_BIAS><<<grid, 256, 0, st>>>(a, b, bs, res, out, M, N, K,
                                                act, res_f32);
  else if (epi == EPI_BIAS_ACT)
    gemm_kernel<EPI_BIAS_ACT><<<grid, 256, 0, st>>>(a, b, bs, res, out, M, N,
                                                    K, act, res_f32);
  else
    gemm_kernel<EPI_BIAS_RES><<<grid, 256, 0, st>>>(a, b, bs, res, out, M, N,
                                                    K, act, res_f32);
  return static_cast<int>(cudaGetLastError());
}

// qkv [B*S, 3D] bf16; bias: [B, H, S, S] bf16 or null; head_dim 32 or 64.
int encoder_attention(const void* qkv, const void* mask, const void* bias,
                      void* out, int B, int S, int H, int head_dim,
                      float scale, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const size_t D = (size_t)H * head_dim;
  return attention(q, q + D, q + 2 * D, 3 * D, static_cast<const int*>(mask),
                   bias, bias != nullptr ? 1 : 0, (size_t)H * S * S,
                   static_cast<bf16*>(out), B, S, H, head_dim, scale,
                   static_cast<cudaStream_t>(stream));
}

// q, k, v [B, S, D] bf16; bias: one [H, S, S] f32 for the whole batch, or
// null; head_dim 32 or 64.
int encoder_attention_qkv(const void* q, const void* k, const void* v,
                          const void* mask, const void* bias, void* out,
                          int B, int S, int H, int head_dim, float scale,
                          void* stream) {
  return attention(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), (size_t)H * head_dim,
                   static_cast<const int*>(mask), bias,
                   bias != nullptr ? 2 : 0, 0, static_cast<bf16*>(out), B, S,
                   H, head_dim, scale, static_cast<cudaStream_t>(stream));
}

int encoder_layernorm(const void* x, const void* gamma, const void* beta,
                      void* out_b, void* out_f, int M, int D, float eps,
                      void* stream) {
  dim3 grid((M + 7) / 8);
  layernorm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out_b),
      static_cast<float*>(out_f), M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
