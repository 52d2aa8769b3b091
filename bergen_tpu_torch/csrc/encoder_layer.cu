// One post-LN BERT encoder layer as a chain of hand-written Hopper kernels.
//
// Replaces: bergen_tpu/ops/encoder_attention.py::encoder_layer (Pallas body
// _layer_kernel), which computes
//   y = LN1(x + Wo . attn(Wqkv . x + bqkv) + bo)
//   out = LN2(y + W2 . act(W1 . y + b1) + b2)
// for one [S, D] sequence per grid step with all ~14 MB of weights resident
// in VMEM.  That residency does not exist on Hopper (227 KB of shared memory
// per block), so the layer becomes seven launches from this file:
//   wg_gemm_kernel, EPI_BIAS      qkv  = bf16(x Wqkv + bqkv)        [M, 3D]
//   attention_kernel              ctx  = softmax(q k^T / sqrt(Dh)) v [M, D]
//   wg_gemm_kernel, EPI_BIAS_RES  o    = ctx Wo + bo + x (f32)      [M, D]
//   layernorm_kernel              y    = LN1(o) (f32 and bf16 copies)
//   wg_gemm_kernel, EPI_BIAS_ACT  h    = bf16(act(y Wi + bi))       [M, I]
//   wg_gemm_kernel, EPI_BIAS_RES  f    = h W2 + b2 + y (f32)
//   layernorm_kernel              out  = bf16(LN2(f))
// The rounding points are the TPU kernel's: qkv, the attention context and
// the FFN hidden are rounded to bf16; residual sums and LayerNorms are f32.
//
// What bounds it on the H100: the four GEMMs are 2*M*D*(4D + 2I) FLOPs
// (0.95 TFLOP at B 512, S 128, D 768, I 3072) against ~0.25 GB of
// activation traffic, so the layer is compute-bound on the tensor cores.
// The GEMMs run on wgmma.cuh's persistent warp-specialised main loop (TMA
// producer, two consumer warpgroups of m64nNk16 wgmma, 128 x 256 output
// tiles, or 128 x 128 where N is not a multiple of 256 or the 256-wide
// tiles would leave SMs idle), with B, the [K, N] row-major weight, read
// MN-major through the wgmma descriptor (no transposed copy); the bias,
// activation and residual are fused into the epilogue, which stages C in
// shared memory and stores it with TMA, so no elementwise pass touches
// device memory.  The epilogue does not overlap the next tile's products:
// the erf GELU of the FFN-in GEMM and the residual reads of the o and
// FFN-out GEMMs are what keeps them from the main loop's rate.
// Attention keeps the [S, S] scores out of device memory:
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
// bergen_tpu/ops/encoder_attention.py::encoder_attention (:825, Pallas body
// _kernel), the attention of the rope and ALiBi encoders (nomic-embed,
// GTE-v1.5, jina-v2) whose layers are not the fused chain, is entry
// encoder_attention_qkv: q, k and v as three [B, S, D] operands and an
// optional batch-invariant [H, S, S] f32 bias (ALiBi's -slope * |i - j|
// reaches -127 at S 256; bf16's spacing of 0.5 there would move the
// scores).  Its bytes (q, k, v and the context: 0.8 GB at B 512, S 256,
// D 768) bound it: 0.24 ms at 3.35 TB/s against 0.10 ms of tensor-core
// work; the bias (3 MB at S 256) is read from L2 by every sequence, 1.6 GB
// of L2 traffic at B 512.  At head width 64 it runs on
// wgmma_attention.cuh's warp-specialised main loop, so the loads overlap
// the products: a persistent grid walks the (sequence, head) pairs, one
// block taking all S / 128 query tiles of a pair, so the pair's K and V
// tiles come from device memory once and from L2 after (EncPolicy); up to
// S 64 a 128-row tile holds two sequences, each warpgroup attending its
// own 64 keys, so no warpgroup computes on empty rows (EncPairPolicy).
// Three-dimensional maps {D, S, B} read rows past S as zeros.  The bias
// tile of each (query tile, key tile) comes by TMA beside K, a ring ahead
// of the scores that read it (up to S 64 by direct loads a unit ahead).
// The scores skip the mask arithmetic on tiles whose keys all attend, or
// all do not.  Head width 32 (MiniLM, no path) keeps attention_kernel.
#include "wgmma_attention.cuh"

namespace {

enum { EPI_BIAS = 0, EPI_BIAS_ACT = 1, EPI_BIAS_RES = 2 };

// The GEMM epilogue of wg_gemm_kernel: C = bf16(acc + bias) (EPI_BIAS),
// bf16(act(acc + bias)) (EPI_BIAS_ACT), or acc + bias + a bf16 or f32
// residual in f32 (EPI_BIAS_RES).  The consumers write C a pass at a time
// into one of two shared staging boxes of 128 rows x 128 bytes (64 bf16 or
// 32 f32 columns) in the 128-byte swizzle (conflict-free stores), and one
// thread stores the box with TMA, which drops rows at or past M.  A box is
// rewritten once the store of two passes back has read it, so a pass's
// stores overlap the next pass.  The activation is a template parameter
// of the pass, so its loop is straight-line code.  Each pass's residual
// is read into registers during the pass before.
template <int EPI, int BN>
struct GemmEpi {
  static constexpr int BOX = WG_BM * 128;  // bytes of one staging box
  static constexpr int SMEM = 2 * BOX;
  CUtensorMap tma_c;  // C [M, N] in [128][64] bf16 or [128][32] f32 boxes
  const float* bias;
  const void* res;
  int M, N, act, res_f32;

  __device__ __forceinline__ void finish(int ctid) const {
    if (ctid == 0) bulk_wait<0, false>();
  }

  // Box `p & 1` is free once the store of pass p - 2 has read it.
  __device__ __forceinline__ void begin_pass(int ctid) const {
    if (ctid == 0) bulk_wait<1, true>();
    consumer_sync();
  }

  // Box `box` written: store it at column c of row tile mt.
  __device__ __forceinline__ void end_pass(int ctid, unsigned char* box,
                                           int c, int mt) const {
    fence_proxy_async();
    consumer_sync();
    if (ctid == 0) {
      tma_store_2d(&tma_c, box, c, mt * WG_BM);
      bulk_commit();
    }
  }

  template <int ACT>
  __device__ __forceinline__ void store_bf16(const float (&acc)[BN / 2],
                                             int mt, int nt, int r0, int t,
                                             int ctid,
                                             unsigned char* stage) const {
#pragma unroll
    for (int p = 0; p < BN / 64; ++p) {
      unsigned char* box = stage + (p & 1) * BOX;
      begin_pass(ctid);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {  // 8-column groups: 16-byte units
        const int j = 8 * p + jj;
        const float2 b = __ldg(
            reinterpret_cast<const float2*>(bias + nt * BN + 8 * j + 2 * t));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          float v0 = acc[4 * j + 2 * half] + b.x;
          float v1 = acc[4 * j + 2 * half + 1] + b.y;
          if constexpr (ACT >= 0) {
            v0 = act_fn(v0, ACT);
            v1 = act_fn(v1, ACT);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              box + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      end_pass(ctid, box, nt * BN + 64 * p, mt);
    }
  }

  // The residual pairs of pass p (4 column groups, 2 rows).
  __device__ __forceinline__ void load_res(float2 (&rv)[4][2], int p, int nt,
                                           int row, int t) const {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half < M ? row + 8 * half : 0;
        const size_t o = (size_t)r * N + nt * BN + 8 * (4 * p + jj) + 2 * t;
        if (res_f32)
          rv[jj][half] = *reinterpret_cast<const float2*>(
              static_cast<const float*>(res) + o);
        else
          rv[jj][half] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  static_cast<const bf16*>(res) + o));
      }
  }

  __device__ __forceinline__ void store_res(const float (&acc)[BN / 2],
                                            int mt, int nt, int r0, int t,
                                            int ctid,
                                            unsigned char* stage) const {
    constexpr int P = BN / 32;  // passes of 32 f32 columns
    const int row = mt * WG_BM + r0;
    float2 rv[P][4][2];
    load_res(rv[0], 0, nt, row, t);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p + 1 < P) load_res(rv[p + 1], p + 1, nt, row, t);
      unsigned char* box = stage + (p & 1) * BOX;
      begin_pass(ctid);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // 8-column groups: two units each
        const int j = 4 * p + jj;
        const float2 b = __ldg(
            reinterpret_cast<const float2*>(bias + nt * BN + 8 * j + 2 * t));
        const int u = 2 * jj + (t >> 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          *reinterpret_cast<float2*>(box + r * 128 + ((u ^ (r & 7)) << 4) +
                                     8 * (t & 1)) =
              make_float2(acc[4 * j + 2 * half] + b.x + rv[p][jj][half].x,
                          acc[4 * j + 2 * half + 1] + b.y +
                              rv[p][jj][half].y);
        }
      }
      end_pass(ctid, box, nt * BN + 32 * p, mt);
    }
  }

  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2],
                                             int mt, int nt, int wg, int ctid,
                                             unsigned char* stage) const {
    const int t = ctid & 3;
    const int r0 = wg * 64 + ((ctid >> 5) & 3) * 16 + ((ctid & 31) >> 2);
    if constexpr (EPI == EPI_BIAS) {
      store_bf16<-1>(acc, mt, nt, r0, t, ctid, stage);
    } else if constexpr (EPI == EPI_BIAS_ACT) {
      switch (act) {
        case ACT_GELU:
          store_bf16<ACT_GELU>(acc, mt, nt, r0, t, ctid, stage);
          break;
        case ACT_GELU_TANH:
          store_bf16<ACT_GELU_TANH>(acc, mt, nt, r0, t, ctid, stage);
          break;
        case ACT_RELU:
          store_bf16<ACT_RELU>(acc, mt, nt, r0, t, ctid, stage);
          break;
        default:
          store_bf16<ACT_SILU>(acc, mt, nt, r0, t, ctid, stage);
      }
    } else {
      store_res(acc, mt, nt, r0, t, ctid, stage);
    }
  }
};

// Output tile width of the encoder GEMM at [M, N]: 256 where N allows it
// and the 128 x 256 tiles still give every SM one, else 128 (MiniLM's D 384
// and 3D 1,152; the ut1 query batch, M 1,600, whose N 768 makes 39 tiles of
// 256 for 132 SMs).
int tile_n(int M, int N) {
  const long long tiles256 = (long long)(M + WG_BM - 1) / WG_BM * (N / 256);
  return N % 256 == 0 && tiles256 >= sm_count() ? 256 : 128;
}

template <int EPI, int BN>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                const float* bias, const void* res, void* out, int M, int N,
                int K, int act, int res_f32, cudaStream_t st) {
  GemmEpi<EPI, BN> epi{};
  const bool f32 = EPI == EPI_BIAS_RES;
  const int e = tma_map(&epi.tma_c, out, f32, M, N, N, WG_BM, f32 ? 32 : 64);
  if (e != 0) return e;
  epi.bias = bias;
  epi.res = res;
  epi.M = M;
  epi.N = N;
  epi.act = act;
  epi.res_f32 = res_f32;
  return wg_gemm_launch<BN, true>(ta, tb, (M + WG_BM - 1) / WG_BM, N / BN,
                                  (K + WG_BK - 1) / WG_BK, epi, st);
}

template <int BN>
int gemm_bn(const CUtensorMap& ta, const CUtensorMap& tb, const float* bias,
            const void* res, void* out, int M, int N, int K, int epi, int act,
            int res_f32, cudaStream_t st) {
  if (epi == EPI_BIAS)
    return launch_gemm<EPI_BIAS, BN>(ta, tb, bias, res, out, M, N, K, act,
                                     res_f32, st);
  if (epi == EPI_BIAS_ACT)
    return launch_gemm<EPI_BIAS_ACT, BN>(ta, tb, bias, res, out, M, N, K, act,
                                         res_f32, st);
  return launch_gemm<EPI_BIAS_RES, BN>(ta, tb, bias, res, out, M, N, K, act,
                                       res_f32, st);
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

// encoder_attention_qkv at head width 64 on the wgmma attention main loop:
// a unit is one (sequence, head) with its S / 128 query tiles; key tiles of
// BK_ (64 with a bias, 128 without).  A masked key scores s * scale - 1e30
// (+ bias), a key past S -inf; the bias [H, S, S] f32 (BIAS) is added
// after s * scale + maskbias.  The bias tile of each (query tile, key
// tile), [128 rows][64 keys], comes by TMA into the K slot beside K, as two
// [128][32] f32 boxes in the 128-byte swizzle (rows and keys past S read
// as zeros), so its loads run a ring ahead of the scores that read it.
template <bool BIAS, int BK_>
struct EncPolicy {
  static constexpr int DH = 64, BK = BK_, QS = 4;
  static constexpr int STAGES = BIAS ? 3 : 8 * 64 / BK_;
  static constexpr bool SPLIT = false;
  static constexpr int XB = BIAS ? AT_BQ * BK_ * 4 : 0;
  __device__ static float m_init() { return -INFINITY; }
  static constexpr bool CLAMP_L = false;
  struct Pre {};
  CUtensorMap tq, tk, tv, to;
  CUtensorMap tb;  // the bias {S, S, H} in [128][32] f32 boxes
  const int* mask;
  int B, S, H;
  float scale;

  __host__ __device__ int n_units() const { return B * H; }
  __device__ int n_qtiles(int) const { return (S + AT_BQ - 1) / AT_BQ; }
  __device__ AttTile tile(int u, int i) const {
    const int h = u % H;
    return {u / H, h, h, i * AT_BQ, (S + BK - 1) / BK};
  }
  __device__ int3 q_box(const AttTile& t, int r) const {
    return make_int3(t.qh * DH, t.q0 + 64 * r, t.b);
  }
  __device__ int3 kv_box(const AttTile& t, int j, int h) const {
    return make_int3(t.kvh * DH, j * BK + 64 * h, t.b);
  }
  __device__ bool key_ok(const AttTile& t, int key) const {
    return key < S && mask[(size_t)t.b * S + key] != 0;
  }
  __device__ void load_extra(unsigned char* dst, uint64_t* bar,
                             const AttTile& t, int j) const {
#pragma unroll
    for (int c = 0; c < BK / 32; ++c)
      tma_load_3d(dst + c * AT_BQ * 128, &tb, bar, j * BK + 32 * c, t.q0,
                  t.qh);
  }
  __device__ void prefetch(Pre&, const AttTile&, int, int, int, int) const {}
  // y = (q.k * scale + maskbias + bias) * log2 e with maskbias 0 or -1e30
  // (which absorbs the rest: y = -1e30); -inf past S
  template <int N>
  __device__ void scores(float (&s)[N], const uint32_t (&bits)[N / 16],
                         const unsigned char* xs, const Pre&,
                         const AttTile&, int j, int wg, int warp,
                         int lane) const {
    const int k0 = j * BK, g = lane >> 2, c0 = 2 * (lane & 3);
    const float scale2 = scale * AT_L2E;
    // this thread's bias pair (key 8c + c0, + 1) of row half r: box c / 4,
    // 16-byte chunk 2 (c % 4) + lane % 4 / 2 xor the row's (g) swizzle
    auto bias = [&](int x) -> float {
      const int c = x >> 2, r = (x >> 1) & 1;
      const int row = 64 * wg + 16 * warp + g + 8 * r;
      const float2 b = *reinterpret_cast<const float2*>(
          xs + (c >> 2) * AT_BQ * 128 + row * 128 +
          (((2 * (c & 3) + ((lane & 3) >> 1)) ^ g) << 4) + (lane & 1) * 8);
      return x & 1 ? b.y : b.x;
    };
    bool all_valid = k0 + BK <= S, none_valid = all_valid;
#pragma unroll
    for (int w = 0; w < N / 16; ++w) {
      all_valid &= bits[w] == ~0u;
      none_valid &= bits[w] == 0u;
    }
    if (all_valid || none_valid) {
#pragma unroll
      for (int x = 0; x < N; ++x) {
        float v = s[x] * scale2;
        if constexpr (BIAS) v = fmaf(s[x], scale, bias(x)) * AT_L2E;
        s[x] = none_valid ? -1e30f : v;
      }
      return;
    }
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int col = 8 * (x >> 2) + c0 + (x & 1);
      const bool ok =
          (bits[x >> 4] >> (8 * ((x >> 2) & 3) + c0 + (x & 1))) & 1;
      float v = s[x] * scale2;
      if constexpr (BIAS) v = fmaf(s[x], scale, bias(x)) * AT_L2E;
      if (!ok) v = -1e30f;
      if (k0 + col >= S) v = -INFINITY;
      s[x] = v;
    }
  }
  __device__ int3 o_box(const AttTile& t, int wg) const {
    return make_int3(t.qh * DH, t.q0 + 64 * wg, t.b);
  }
};

// encoder_attention_qkv at head width 64 and S <= 64 on the same loop:
// a unit holds two (sequence, head) pairs n = 2u and 2u + 1 (n = b H + h),
// each warpgroup one: its 64 query rows, and its own 64-key half of one
// 128-key tile (SPLIT), so neither warpgroup computes on empty rows.  A
// pair past the last one reads batch B, past the tensor: zeros.
template <bool BIAS>
struct EncPairPolicy {
  static constexpr int DH = 64, BK = 128, STAGES = 4, QS = 4;
  static constexpr bool SPLIT = true;
  static constexpr int XB = 0;
  __device__ static float m_init() { return -INFINITY; }
  static constexpr bool CLAMP_L = false;
  struct Pre {
    float2 bias[BIAS ? 8 : 1][2];  // key 8 c + 2 (lane % 4), row half r
  };
  CUtensorMap tq, tk, tv, to;
  const int* mask;
  const float* bias;
  int B, S, H;
  float scale;

  __host__ __device__ int n_units() const { return (B * H + 1) / 2; }
  __device__ int n_qtiles(int) const { return 1; }
  __device__ AttTile tile(int u, int) const { return {u, 0, 0, 0, 1}; }
  // warpgroup w's (batch, head): b == B past the last pair
  __device__ int2 pair(const AttTile& t, int w) const {
    const int n = 2 * t.b + w;
    return n < B * H ? make_int2(n / H, n % H) : make_int2(B, 0);
  }
  __device__ int3 q_box(const AttTile& t, int r) const {
    const int2 bh = pair(t, r);
    return make_int3(bh.y * DH, 0, bh.x);
  }
  __device__ int3 kv_box(const AttTile& t, int, int h) const {
    const int2 bh = pair(t, h);
    return make_int3(bh.y * DH, 0, bh.x);
  }
  __device__ bool key_ok(const AttTile& t, int key) const {
    const int2 bh = pair(t, key >> 6);
    const int k = key & 63;
    return bh.x < B && k < S && mask[(size_t)bh.x * S + k] != 0;
  }
  __device__ void load_extra(unsigned char*, uint64_t*, const AttTile&,
                             int) const {}
  // the bias of the warpgroup's rows and keys, from L2 (S <= 64: 16 KB a
  // head), a tile ahead
  __device__ void prefetch(Pre& pre, const AttTile& t, int, int wg, int warp,
                           int lane) const {
    if constexpr (BIAS) {
      const int2 bh = pair(t, wg);
      const int row = 16 * warp + (lane >> 2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* brow = bias + ((size_t)bh.y * S + row + 8 * r) * S;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = 8 * c + 2 * (lane & 3);
          pre.bias[c][r] = row + 8 * r < S && key < S
                               ? __ldg(reinterpret_cast<const float2*>(
                                     brow + key))
                               : make_float2(0.f, 0.f);
        }
      }
    }
  }
  // as EncPolicy's, over the warpgroup's own 64 keys
  template <int N>
  __device__ void scores(float (&s)[N], const uint32_t (&bits)[N / 16],
                         const unsigned char*, const Pre& pre,
                         const AttTile&, int, int, int, int lane) const {
    const int c0 = 2 * (lane & 3);
    const float scale2 = scale * AT_L2E;
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int col = 8 * (x >> 2) + c0 + (x & 1);
      const bool ok =
          (bits[x >> 4] >> (8 * ((x >> 2) & 3) + c0 + (x & 1))) & 1;
      float v = s[x] * scale2;
      if constexpr (BIAS) {
        const float2 b = pre.bias[x >> 2][(x >> 1) & 1];
        v = fmaf(s[x], scale, x & 1 ? b.y : b.x) * AT_L2E;
      }
      if (!ok) v = -1e30f;
      if (col >= S) v = -INFINITY;
      s[x] = v;
    }
  }
  __device__ int3 o_box(const AttTile& t, int wg) const {
    const int2 bh = pair(t, wg);
    return make_int3(bh.y * DH, 0, bh.x);
  }
};

template <class P>
int wg_attention(const void* q, const void* k, const void* v,
                 const int* mask, const void* bias, void* out, int B, int S,
                 int H, float scale, cudaStream_t st) {
  P p;
  const long long D = (long long)H * 64;
  int e = tma_map_3d(&p.tq, q, D, S, B, D * 2, D * S * 2, 64, 64);
  if (e == 0) e = tma_map_3d(&p.tk, k, D, S, B, D * 2, D * S * 2, 64, 64);
  if (e == 0) e = tma_map_3d(&p.tv, v, D, S, B, D * 2, D * S * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.to, out, D, S, B, D * 2, D * S * 2, 64, 64);
  if constexpr (P::XB > 0) {
    if (e == 0)
      e = tma_map_3d(&p.tb, bias, S, S, H, S * 4LL, S * S * 4LL, 32, AT_BQ,
                     true);
  } else if constexpr (P::SPLIT) {
    p.bias = static_cast<const float*>(bias);
  }
  if (e != 0) return e;
  p.mask = mask;
  p.B = B;
  p.S = S;
  p.H = H;
  p.scale = scale;
  return att_launch(p, st);
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

// C[M, N] = A[M, K] . B[K, N] + bias (+ epilogue), A and B bf16 row-major
// (B MN-major for wgmma), bias f32: EPI_BIAS / EPI_BIAS_ACT write bf16,
// EPI_BIAS_RES adds a bf16 or f32 residual [M, N] and writes f32.  Needs
// N % 128 == 0 and K % 8 == 0 (16-byte rows for TMA); k past K reads as
// zero.
int encoder_gemm(const void* A, const void* B, const void* bias,
                 const void* res, void* out, int M, int N, int K, int epi,
                 int act, int res_f32, void* stream) {
  if (N % 128 || K % 8 || M < 0 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap ta, tb;
  int e = tma_map(&ta, A, false, M, K, K, WG_BM, WG_BK);
  if (e == 0) e = tma_map(&tb, B, false, K, N, N, WG_BK, 64);
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bs = static_cast<const float*>(bias);
  if (tile_n(M, N) == 256)
    return gemm_bn<256>(ta, tb, bs, res, out, M, N, K, epi, act, res_f32, st);
  return gemm_bn<128>(ta, tb, bs, res, out, M, N, K, epi, act, res_f32, st);
}

// The output tile width that encoder_gemm takes at [M, N] (128 or 256).
int encoder_gemm_tile_n(int M, int N) { return tile_n(M, N); }

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

// q, k, v [B, S, D] bf16 (16-byte aligned); bias: one [H, S, S] f32 for
// the whole batch (S even), or null; head_dim 64 (the wgmma main loop) or
// 32 (attention_kernel).
int encoder_attention_qkv(const void* q, const void* k, const void* v,
                          const void* mask, const void* bias, void* out,
                          int B, int S, int H, int head_dim, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mask);
  if (head_dim == 64) {
    if (B == 0 || S == 0) return 0;
    if (S <= 64 && bias != nullptr)
      return wg_attention<EncPairPolicy<true>>(q, k, v, m, bias, out, B, S,
                                               H, scale, st);
    if (S <= 64)
      return wg_attention<EncPairPolicy<false>>(q, k, v, m, nullptr, out, B,
                                                S, H, scale, st);
    if (bias != nullptr)
      return wg_attention<EncPolicy<true, 64>>(q, k, v, m, bias, out, B, S,
                                               H, scale, st);
    return wg_attention<EncPolicy<false, 128>>(q, k, v, m, nullptr, out, B,
                                               S, H, scale, st);
  }
  return attention(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), (size_t)H * head_dim, m, bias,
                   bias != nullptr ? 2 : 0, 0, static_cast<bf16*>(out), B, S,
                   H, head_dim, scale, st);
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
