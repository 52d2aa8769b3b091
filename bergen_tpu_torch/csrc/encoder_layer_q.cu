// The W8A8 post-LN encoder layer: int8 tensor-core products with per-row
// activation scales and per-column weight scales.
//
// Replaces: bergen_tpu/ops/encoder_attention.py::encoder_layer_q (Pallas
// body _layer_kernel_q), whose four products are each _qdot:
//   sx = max(max|x_row|, 1e-8) / 127,  xq = round(x / sx) (int8),
//   y  = float(xq . Wq) (int32 sums) * sx * sw   (sw: per-column f32 scale)
// The TPU kernel holds the int8 weights in VMEM and quantizes in-kernel;
// here the layer is a chain of ten launches, with the attention and the
// last LayerNorm kernels of encoder_layer.cu between them:
//   rowquant_kernel<bf16>          xq, sx  = quant(x)
//   wg_gemm<S8> QEPI_BF16          qkv     = bf16(xq Wqkv * sx * sw + bqkv)
//   (encoder_layer.cu)             ctx     = attention(qkv)           bf16
//   rowquant_kernel<bf16>          cq, sc  = quant(ctx)
//   wg_gemm<S8> QEPI_RES           o       = cq Wo * sc * sw + bo + x   f32
//   layernorm_q_kernel             y, yq, sy = LN1(o), quant(LN1(o))   f32
//   wg_gemm<S8> QEPI_ACT_MAX       h, hm   = act(yq W1 * sy * sw + b1) f32,
//                                            its rows' max |h| a 128 columns
//   rowquant_kernel<float>         hq, sh  = quant(h), sh from hm
//   wg_gemm<S8> QEPI_RES           f       = hq W2 * sh * sw + b2 + y   f32
//   (encoder_layer.cu)             out     = bf16(LN2(f))
// The rounding points are the TPU kernel's: qkv is rounded to bf16 for the
// attention, the context is bf16, and y and the FFN hidden h stay f32 and
// are quantized from f32.  x / s is a true division rounded to nearest and
// the codes round half to even, as jnp.round, so the codes and the int32
// sums equal the plain version's; the epilogue applies the scales with
// round-to-nearest multiplies (no fused multiply-add), in the TPU kernel's
// order, so only the f32 round-off of the LayerNorm sums differs.
//
// What bounds it on the H100: the int8 tensor cores run at 1,979 TOP/s, so
// at B 512, S 128, D 768 the products (0.93 TOP) take 0.47 ms at peak,
// about what the f32 FFN hidden costs to write and read back (1.0 GB with
// its codes) at 3.35 TB/s.
// * The four GEMMs run on wgmma.cuh's persistent warp-specialised loop with
//   s8 wgmma (m64nBNk32, exact s32 sums): a stage is 128 int8 k of A [128
//   rows] and of B, the [N, K] weight (s8 wgmma reads both operands
//   K-major; the weights are transposed once when the layer is prepared).
//   The epilogues stage their output in shared memory and store it by TMA.
//   qkv, o and FFN-out, whose epilogues move memory, run the loop's
//   ping-pong (each consumer warpgroup on whole 128 x 128 tiles, one's
//   epilogue beside the other's products); FFN-in, whose GELU is
//   arithmetic, both warpgroups on each 128 x 256 tile (encoder_qgemm).
// * LN1 has y's whole row, so it also writes y's codes and scale.
// * FFN-in writes h f32 and, beside it, each row's largest |h| in each
//   128 columns (exact: a max has no order), so h's row quantization reads
//   h once (a stream at the card's rate) instead of twice.
// * x and the context come from outside a GEMM or span heads, so they keep
//   a row quantization of their own: one warp a row, 16-byte loads, the
//   codes written once.
//
// The generators' W8A8 projection (ops/w8a8_matmul.py) runs two of these
// launches, the row quantization and the GEMM's QEPI_BF16.  A row-parallel
// slice under tensor parallelism holds K / tp columns of each row, while
// the row's scale spans all K (bergen_tpu/models/llama.py:313-321): its
// rank takes its rows' largest |x| (rowmax_kernel), the ranks share them
// by a max all-reduce, and the row quantization reads the shared maxima as
// one partial (n_part 1).  QEPI_S32 then writes the exact int32 sums, which
// the ranks add as integers before the scales are applied, once, so the
// result is the one-rank product's bit for bit.
#include "wgmma.cuh"

namespace {

enum { QEPI_BF16 = 0, QEPI_RES = 1, QEPI_ACT_MAX = 2, QEPI_S32 = 3 };

// FFN-in's row maxima: one a row for each MAX_COLS columns, whatever the
// tile's width, so that their layout [N / MAX_COLS, M] is fixed.
constexpr int MAX_COLS = 128;

// The code of v at row scale s: rint(v / s), a true division.
__device__ __forceinline__ int quant_code(float v, float s) {
  return __float2int_rn(__fdiv_rn(v, s));
}

// act_fn with each multiply and add rounded on its own (no contraction).
__device__ __forceinline__ float act_rn(float x, int act) {
  switch (act) {
    case ACT_GELU:
      return __fmul_rn(__fmul_rn(0.5f, x),
                       __fadd_rn(1.f, erff(__fmul_rn(x, 0.7071067811865476f))));
    case ACT_GELU_TANH: {
      const float c = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
      return __fmul_rn(
          __fmul_rn(0.5f, x),
          __fadd_rn(1.f, tanhf(__fmul_rn(0.7978845608028654f,
                                         __fadd_rn(x, c)))));
    }
    case ACT_RELU:
      return fmaxf(x, 0.f);
    default:
      return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
  }
}

__device__ __forceinline__ float row_scale(float m) {
  return __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
}

__device__ __forceinline__ uint32_t pack_codes4(float a, float b, float c,
                                                float d, float s) {
  return (quant_code(a, s) & 0xff) | (quant_code(b, s) & 0xff) << 8 |
         (quant_code(c, s) & 0xff) << 16 |
         static_cast<uint32_t>(quant_code(d, s) & 0xff) << 24;
}

// The 8 bf16 or 4 f32 values of a 16-byte chunk, as f32.
template <typename T>
__device__ __forceinline__ void chunk_f32(const uint4& c,
                                          float (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(c.x);
    v[1] = __uint_as_float(c.y);
    v[2] = __uint_as_float(c.z);
    v[3] = __uint_as_float(c.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// One warp per row of x [M, K] (K % (16 / sizeof(T)) == 0, 16-byte rows):
// s = max(max|x|, 1e-8) / 127 and q = rint(x / s) as int8.  The row's
// largest |x| is the largest of the n_part values partial[p * M + row] when
// partial is given (the FFN-in GEMM's per-tile maxima), so x is read once;
// else each 16-byte chunk of x is read once for the max and once (from L1)
// for the codes.
template <typename T>
__global__ void __launch_bounds__(256)
    rowquant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale,
                    const float* __restrict__ partial, int n_part, int M,
                    int K) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int n = K / V;
  float m = 0.f;
  if (partial) {
    for (int p = lane; p < n_part; p += 32)
      m = fmaxf(m, partial[(size_t)p * M + row]);
  } else {
    for (int i = lane; i < n; i += 32) {
      float v[V];
      chunk_f32<T>(xr[i], v);
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = row_scale(m);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * K);
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    float v[V];
    chunk_f32<T>(xr[i], v);
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
      qr[i * (V / 4) + j] = pack_codes4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                        v[4 * j + 3], s);
  }
  if (lane == 0) scale[row] = s;
}

// One warp per row of x [M, K] bf16 (K % 8 == 0, 16-byte rows): the row's
// largest |x| (a max has no order: exact), each 16-byte chunk read once.
__global__ void __launch_bounds__(256)
    rowmax_kernel(const bf16* __restrict__ x, float* __restrict__ out, int M,
                  int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  float m = 0.f;
  for (int i = lane; i < K / 8; i += 32) {
    float v[8];
    chunk_f32<bf16>(xr[i], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row] = m;
}

// LN1 of the W8A8 layer: encoder_layer.cu's row LayerNorm (one warp per
// row, D % 128 == 0, D <= 1024, the same arithmetic) writing y f32 and,
// from the same registers, y's codes and row scale.
__global__ void __launch_bounds__(256)
    layernorm_q_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ out_f, int8_t* __restrict__ q,
                       float* __restrict__ scale, int M, int D, float eps) {
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
  float m = 0.f;
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
      *reinterpret_cast<float4*>(out_f + (size_t)row * D + c) = y;
      v[i] = y;
      m = fmaxf(m, fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)),
                         fmaxf(fabsf(y.z), fabsf(y.w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = row_scale(m);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n4)
      *reinterpret_cast<uint32_t*>(q + (size_t)row * D +
                                   (i * 32 + lane) * 4) =
          pack_codes4(v[i].x, v[i].y, v[i].z, v[i].w, s);
  }
  if (lane == 0) scale[row] = s;
}

// The epilogue of the int8 GEMM on wg_gemm_kernel<BN, false, QGemmEpi,
// WgS8, PP>: v = float(sum) * sa[row] * sw[col] + bias[col]
// (round-to-nearest, no FMA), then
//   QEPI_BF16:    bf16(v)                                  [M, N] bf16
//   QEPI_RES:     v + a bf16 or f32 residual [M, N]        [M, N] f32
//   QEPI_ACT_MAX: act(v) [M, N] f32, and each row's largest |act(v)| in
//                 each MAX_COLS columns (out_scale [N / MAX_COLS, M]:
//                 exact, a max has no order), which rowquant_kernel reduces
//   QEPI_S32:     the int32 sums themselves, no scale   [M, N] int32
// The tile's consumers write C a pass at a time into one of two shared
// staging boxes of 128 rows x 128 bytes (64 bf16 or 32 f32 columns) in the
// 128-byte swizzle, and one thread stores the box with TMA, which drops
// rows at or past M; a box is rewritten once the store of two passes back
// has read it (encoder_layer.cu's GemmEpi).  A thread
// holds H accumulators of 64 rows: the cooperative loop calls operator()
// with one (its warpgroup's rows of the tile; 256 threads on named barrier
// 1), the ping-pong loop calls team() with both of a warpgroup's whole
// tile (128 threads on barrier 2 + wg).
template <int EPI, int BN>
struct QGemmEpi {
  static constexpr int BOX = WG_BM * 128;  // bytes of one staging box
  static constexpr int SMEM = 2 * BOX;
  CUtensorMap tma_c;
  const float* sa;    // [M] row scales of A
  const float* sw;    // [N] column scales of B
  const float* bias;  // [N]
  const void* res;    // QEPI_RES: [M, N] bf16 or f32
  float* out_scale;   // QEPI_ACT_MAX: [N / MAX_COLS, M]
  int M, N, act, res_f32;

  struct Team {  // the threads that share a tile, and their barrier
    int bar, threads;
  };

  __device__ __forceinline__ void sync(const Team& tm) const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(tm.bar), "r"(tm.threads)
                 : "memory");
  }

  __device__ __forceinline__ void finish(int ctid) const {
    if (ctid == 0) bulk_wait<0, false>();
  }

  __device__ __forceinline__ void begin_pass(int ctid, const Team& tm) const {
    if (ctid == 0) bulk_wait<1, true>();
    sync(tm);
  }

  __device__ __forceinline__ void end_pass(int ctid, const Team& tm,
                                           unsigned char* box, int c,
                                           int mt) const {
    fence_proxy_async();
    sync(tm);
    if (ctid == 0) {
      tma_store_2d(&tma_c, box, c, mt * WG_BM);
      bulk_commit();
    }
  }

  // v of acc[4j + 2 half + e] (column 8j + 2t + e of the tile)
  __device__ __forceinline__ float2 value(const int (&acc)[BN / 2], int j,
                                          int half, float s_row,
                                          const float2& w,
                                          const float2& b) const {
    return make_float2(
        __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * half]),
                                      s_row),
                            w.x),
                  b.x),
        __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * half + 1]),
                                s_row),
                      w.y),
            b.y));
  }

  __device__ __forceinline__ float2 col_pair(const float* p, int col) const {
    return __ldg(reinterpret_cast<const float2*>(p + col));
  }

  template <int H>
  __device__ __forceinline__ void store_bf16(const int (&acc)[H][BN / 2],
                                             int mt, int nt, int r0, int t,
                                             const float (&s)[H][2],
                                             int ctid, const Team& tm,
                                             unsigned char* stage) const {
#pragma unroll
    for (int p = 0; p < BN / 64; ++p) {
      unsigned char* box = stage + (p & 1) * BOX;
      begin_pass(ctid, tm);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {  // 8-column groups: 16-byte units
        const int j = 8 * p + jj, col = nt * BN + 8 * j + 2 * t;
        const float2 w = col_pair(sw, col), b = col_pair(bias, col);
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 64 * h + 8 * half;
            const float2 v = value(acc[h], j, half, s[h][half], w, b);
            *reinterpret_cast<__nv_bfloat162*>(
                box + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t) =
                __floats2bfloat162_rn(v.x, v.y);
          }
      }
      end_pass(ctid, tm, box, nt * BN + 64 * p, mt);
    }
  }

  // 4-byte out: act(v) (QEPI_ACT_MAX), v + the residual (QEPI_RES) or the
  // sums' int32 bits (QEPI_S32)
  template <int H, int ACT>
  __device__ __forceinline__ void store_f32(const int (&acc)[H][BN / 2],
                                            int mt, int nt, int r0, int t,
                                            const float (&s)[H][2], int ctid,
                                            const Team& tm,
                                            unsigned char* stage) const {
    constexpr int P = BN / 32;  // passes of 32 f32 columns
    constexpr int G = BN / MAX_COLS;
    const int row = mt * WG_BM + r0;
    float m[H][2][G] = {};  // QEPI_ACT_MAX: the rows' largest |act(v)|
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float2 rv[H][4][2];
      if constexpr (EPI == QEPI_RES) {
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rr = row + 64 * h + 8 * half;
              const size_t o = (size_t)(rr < M ? rr : 0) * N + nt * BN +
                               8 * (4 * p + jj) + 2 * t;
              rv[h][jj][half] =
                  res_f32 ? *reinterpret_cast<const float2*>(
                                static_cast<const float*>(res) + o)
                          : __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(
                                    static_cast<const bf16*>(res) + o));
            }
      }
      unsigned char* box = stage + (p & 1) * BOX;
      begin_pass(ctid, tm);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // 8-column groups: two units each
        const int j = 4 * p + jj, col = nt * BN + 8 * j + 2 * t;
        const float2 w = col_pair(sw, col), b = col_pair(bias, col);
        const int u = 2 * jj + (t >> 1);
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 64 * h + 8 * half;
            float2 v;
            if constexpr (EPI == QEPI_S32) {
              v = make_float2(__int_as_float(acc[h][4 * j + 2 * half]),
                              __int_as_float(acc[h][4 * j + 2 * half + 1]));
            } else {
              v = value(acc[h], j, half, s[h][half], w, b);
            }
            if constexpr (EPI == QEPI_S32) {
            } else if constexpr (EPI == QEPI_RES) {
              v.x = __fadd_rn(v.x, rv[h][jj][half].x);
              v.y = __fadd_rn(v.y, rv[h][jj][half].y);
            } else {
              v.x = act_rn(v.x, ACT);
              v.y = act_rn(v.y, ACT);
              if constexpr (EPI == QEPI_ACT_MAX)
                m[h][half][p * 32 / MAX_COLS] =
                    fmaxf(m[h][half][p * 32 / MAX_COLS],
                          fmaxf(fabsf(v.x), fabsf(v.y)));
            }
            *reinterpret_cast<float2*>(box + r * 128 +
                                       ((u ^ (r & 7)) << 4) + 8 * (t & 1)) =
                v;
          }
      }
      end_pass(ctid, tm, box, nt * BN + 32 * p, mt);
    }
    if constexpr (EPI == QEPI_ACT_MAX) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float x = m[h][half][g];
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            const int rr = row + 64 * h + 8 * half;
            if (t == 0 && rr < M)
              out_scale[(size_t)(nt * G + g) * M + rr] = x;
          }
    }
  }

  // rows r0 + 64 h + 8 half of the tile, h < H: r0 from the thread's place
  // among the tile's consumers (ctid)
  template <int H>
  __device__ __forceinline__ void run(const int (&acc)[H][BN / 2], int mt,
                                      int nt, int ctid, const Team& tm,
                                      unsigned char* stage) const {
    const int t = ctid & 3;
    const int r0 = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16 +
                   ((ctid & 31) >> 2);
    float s[H][2];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * WG_BM + r0 + 64 * h + 8 * half;
        s[h][half] = row < M ? sa[row] : 0.f;
      }
    if constexpr (EPI == QEPI_BF16) {
      store_bf16<H>(acc, mt, nt, r0, t, s, ctid, tm, stage);
    } else if constexpr (EPI == QEPI_RES || EPI == QEPI_S32) {
      store_f32<H, -1>(acc, mt, nt, r0, t, s, ctid, tm, stage);
    } else {
      switch (act) {
        case ACT_GELU:
          store_f32<H, ACT_GELU>(acc, mt, nt, r0, t, s, ctid, tm, stage);
          break;
        case ACT_GELU_TANH:
          store_f32<H, ACT_GELU_TANH>(acc, mt, nt, r0, t, s, ctid, tm,
                                      stage);
          break;
        case ACT_RELU:
          store_f32<H, ACT_RELU>(acc, mt, nt, r0, t, s, ctid, tm, stage);
          break;
        default:
          store_f32<H, ACT_SILU>(acc, mt, nt, r0, t, s, ctid, tm, stage);
      }
    }
  }

  // the cooperative loop: this warpgroup's 64 rows of the tile
  __device__ __forceinline__ void operator()(const int (&acc)[BN / 2],
                                             int mt, int nt, int wg, int ctid,
                                             unsigned char* stage) const {
    run<1>(reinterpret_cast<const int(&)[1][BN / 2]>(acc), mt, nt, ctid,
           Team{1, 256}, stage);
  }

  // the ping-pong loop: warpgroup wg's whole tile
  __device__ __forceinline__ void team(const int (&acc)[2][BN / 2], int mt,
                                       int nt, int wg, int ctid,
                                       unsigned char* stage) const {
    run<2>(acc, mt, nt, ctid, Team{2 + wg, 128}, stage);
  }
};

// FFN-in's output tile width at [M, N] (its loop is cooperative):
// encoder_layer.cu's rule, 256 where N allows it and the 128 x 256 tiles
// still give every SM one.
int act_tile_n(int M, int N) {
  const long long tiles256 = (long long)(M + WG_BM - 1) / WG_BM * (N / 256);
  return N % 256 || tiles256 < sm_count() ? 128 : 256;
}

struct QArgs {
  const float *sa, *sw, *bias;
  const void* res;
  void* out;
  float* out_scale;
  int M, N, K, act, res_f32;
};

template <int EPI, int BN, bool PP>
int launch_qgemm(const CUtensorMap& ta, const CUtensorMap& tb,
                 const QArgs& a, cudaStream_t st) {
  QGemmEpi<EPI, BN> epi{};
  const int kind = EPI == QEPI_BF16 ? TMA_BF16 : TMA_F32;
  const int e = tma_map(&epi.tma_c, a.out, kind, a.M, a.N, a.N, WG_BM,
                        128 / tma_elem_bytes(kind));
  if (e != 0) return e;
  epi.sa = a.sa;
  epi.sw = a.sw;
  epi.bias = a.bias;
  epi.res = a.res;
  epi.out_scale = a.out_scale;
  epi.M = a.M;
  epi.N = a.N;
  epi.act = a.act;
  epi.res_f32 = a.res_f32;
  return wg_gemm_launch<BN, false, QGemmEpi<EPI, BN>, WgS8, PP>(
      ta, tb, (a.M + WG_BM - 1) / WG_BM, a.N / BN,
      (a.K + WgS8::BK - 1) / WgS8::BK, epi, st);
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_f32 == 0) or f32 -> q [M, K] int8, scale [M] f32;
// K % 8 == 0 (bf16) or K % 4 == 0 (f32).  partial (or null): the rows'
// largest |x| in n_part column ranges, [n_part, M] f32 (QEPI_ACT_MAX's).
int encoder_rowquant(const void* x, int x_f32, void* q, void* scale,
                     const void* partial, int n_part, int M, int K,
                     void* stream) {
  if (K % (x_f32 ? 4 : 8) || M < 0 || (partial && n_part < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  dim3 grid((M + 7) / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scale);
  const float* p = static_cast<const float*>(partial);
  if (x_f32)
    rowquant_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), qq, s, p, n_part, M, K);
  else
    rowquant_kernel<bf16><<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(x), qq, s, p, n_part, M, K);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K] bf16 -> out [M] f32, each row's largest |x|; K % 8 == 0.
int encoder_rowmax(const void* x, void* out, int M, int K, void* stream) {
  if (K % 8 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  rowmax_kernel<<<dim3((M + 7) / 8), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(out), M, K);
  return static_cast<int>(cudaGetLastError());
}

// LN1 of the W8A8 layer: x [M, D] f32 -> out_f [M, D] f32 and its codes
// q [M, D] int8 and scales [M]; D % 128 == 0, D <= 1024.
int encoder_layernorm_q(const void* x, const void* gamma, const void* beta,
                        void* out_f, void* q, void* scale, int M, int D,
                        float eps, void* stream) {
  if (D % 128 || D > 1024 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  dim3 grid((M + 7) / 8);
  layernorm_q_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out_f),
      static_cast<int8_t*>(q), static_cast<float*>(scale), M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// C[M, N] = (A[M, K] . Bt[N, K]^T) * sa[row] * sw[col] + bias[col] with
// epilogue epi (QEPI_*; res: the QEPI_RES residual, bf16 or f32 by
// res_f32; out_scale: QEPI_ACT_MAX's row maxima [N / 128, M]; QEPI_S32:
// the int32 sums alone, sa, sw and bias read but unused), A and Bt int8,
// K-contiguous.  Needs N % 128 == 0 and K % 16 == 0 (16-byte rows
// for TMA); k past K reads as zero.
int encoder_qgemm(const void* A, const void* Bt, const void* sa,
                  const void* sw, const void* bias, const void* res, void* out,
                  void* out_scale, int M, int N, int K, int epi, int act,
                  int res_f32, void* stream) {
  if (N % MAX_COLS || K % 16 || M < 0 || K < 1 || epi < 0 ||
      epi > QEPI_S32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int bn = epi == QEPI_ACT_MAX ? act_tile_n(M, N) : 128;
  CUtensorMap ta, tb;
  int e = tma_map(&ta, A, TMA_I8, M, K, K, WG_BM, WgS8::BK);
  if (e == 0) e = tma_map(&tb, Bt, TMA_I8, N, K, K, bn, WgS8::BK);
  if (e != 0) return e;
  const QArgs a{static_cast<const float*>(sa),  static_cast<const float*>(sw),
                static_cast<const float*>(bias), res, out,
                static_cast<float*>(out_scale), M, N, K, act, res_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ping-pong (each consumer warpgroup on whole 128 x 128 tiles of its
  // own, one's epilogue beside the other's products) where the epilogue is
  // memory traffic; cooperative (both warpgroups on each tile) for FFN-in's
  // activation, which is arithmetic: under ping-pong it runs on one warp a
  // scheduler instead of two, and FFN-in took 0.654 ms against the
  // cooperative 0.543 at B 512, S 128 (H100 80GB HBM3, 700 W) while o,
  // FFN-out and qkv gained.
  if (epi == QEPI_BF16)
    return launch_qgemm<QEPI_BF16, 128, true>(ta, tb, a, st);
  if (epi == QEPI_RES)
    return launch_qgemm<QEPI_RES, 128, true>(ta, tb, a, st);
  if (epi == QEPI_S32)
    return launch_qgemm<QEPI_S32, 128, true>(ta, tb, a, st);
  return bn == 256 ? launch_qgemm<QEPI_ACT_MAX, 256, false>(ta, tb, a, st)
                   : launch_qgemm<QEPI_ACT_MAX, 128, false>(ta, tb, a, st);
}

}  // extern "C"
