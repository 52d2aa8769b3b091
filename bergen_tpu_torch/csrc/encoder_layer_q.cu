// The W8A8 post-LN encoder layer: int8 tensor-core products with per-row
// activation scales and per-column weight scales.
//
// Replaces: bergen_tpu/ops/encoder_attention.py::encoder_layer_q (Pallas
// body _layer_kernel_q), whose four products are each _qdot:
//   sx = max(max|x_row|, 1e-8) / 127,  xq = round(x / sx) (int8),
//   y  = float(xq . Wq) (int32 sums) * sx * sw   (sw: per-column f32 scale)
// The TPU kernel holds the int8 weights in VMEM and quantizes in-kernel;
// here the layer is a chain of launches, with the attention and LayerNorm
// kernels of encoder_layer.cu between them:
//   rowquant_kernel<bf16>       xq, sx   = quant(x)
//   qgemm_kernel<QEPI_BF16>     qkv      = bf16(xq Wqkv * sx * sw + bqkv)
//   (encoder_layer.cu)          ctx      = attention(qkv)          bf16
//   rowquant_kernel<bf16>       cq, sc   = quant(ctx)
//   qgemm_kernel<QEPI_RES>      o        = cq Wo * sc * sw + bo + x     f32
//   (encoder_layer.cu)          y        = LN1(o)                        f32
//   rowquant_kernel<float>      yq, sy   = quant(y)
//   qgemm_kernel<QEPI_ACT>      h        = act(yq W1 * sy * sw + b1)    f32
//   rowquant_kernel<float>      hq, sh   = quant(h)
//   qgemm_kernel<QEPI_RES>      f        = hq W2 * sh * sw + b2 + y     f32
//   (encoder_layer.cu)          out      = bf16(LN2(f))
// The rounding points are the TPU kernel's: qkv is rounded to bf16 for the
// attention, the context is bf16, and y and the FFN hidden h stay f32 and
// are quantized from f32.  x / sx is a true division rounded to nearest and
// the codes round half to even (rintf), as jnp.round, so the codes and the
// int32 sums equal the plain version's; the epilogue applies the scales with
// round-to-nearest multiplies (no fused multiply-add), in the TPU kernel's
// order, so only the f32 round-off of the LayerNorm sums differs.
//
// What bounds it on the H100: the int8 tensor cores run at twice the bf16
// rate (1,979 TOP/s), so at B 512, S 128, D 768 the products (0.9 TOP) take
// 0.46 ms at peak while the activations the chain moves (~0.5 GB with the
// f32 intermediates and int8 copies) take 0.15 ms: operations bound it.  The
// GEMM is common.cuh's mma.sync loop (mma_tile) on m16n8k32 s8 fragments:
// both operands are K-contiguous ([M, K] activations, [N, K] weights,
// transposed once when the layer's operands are prepared), which is the
// "row.col" form the instruction wants.  wgmma.cuh's loop with s8 wgmma,
// and fusing the quantization into the producing epilogue, are later work.
#include "common.cuh"

namespace {

constexpr int BM = MMA_TILE, BN = MMA_TILE;

enum { QEPI_BF16 = 0, QEPI_ACT = 1, QEPI_RES = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One warp per row of x [M, K]: s = max(max|x|, 1e-8) / 127 and
// q = rint(x / s) as int8.
template <typename T>
__global__ void __launch_bounds__(256)
    rowquant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float m = 0.f;
  for (int i = lane; i < K; i += 32) m = fmaxf(m, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  int8_t* qr = q + (size_t)row * K;
  for (int i = lane; i < K; i += 32)
    qr[i] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(to_f32(xr[i]), s)));
  if (lane == 0) scale[row] = s;
}

// C[M, N] = (A[M, K] . Bt[N, K]^T) * sa[row] * sw[col] + bias[col], then
// QEPI_BF16: written bf16; QEPI_ACT: act, written f32; QEPI_RES: plus a bf16
// or f32 residual [M, N], written f32.  A, Bt int8; needs N % 128 == 0 and
// K % 64 == 0.
template <int EPI>
__global__ void __launch_bounds__(256)
    qgemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ sa, const float* __restrict__ sw,
                 const float* __restrict__ bias, const void* __restrict__ res,
                 void* __restrict__ out, int M, int N, int K, int act,
                 int res_f32) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
  mma_tile<true, int>(reinterpret_cast<const bf16*>(A + (size_t)m0 * K),
                      M - m0,
                      reinterpret_cast<const bf16*>(Bt + (size_t)n0 * K),
                      N - n0, 0, K / 2, acc);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float s_row = sa[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        float v0 = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][half * 2]),
                                s_row),
                      sw[col]),
            bias[col]);
        float v1 = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][half * 2 + 1]),
                                s_row),
                      sw[col + 1]),
            bias[col + 1]);
        const size_t o = (size_t)row * N + col;
        if (EPI == QEPI_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
          continue;
        }
        if (EPI == QEPI_ACT) {
          v0 = act_fn(v0, act);
          v1 = act_fn(v1, act);
        } else if (res_f32) {
          float2 r = *reinterpret_cast<const float2*>(
              static_cast<const float*>(res) + o);
          v0 = __fadd_rn(v0, r.x);
          v1 = __fadd_rn(v1, r.y);
        } else {
          __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const bf16*>(res) + o);
          v0 = __fadd_rn(v0, __bfloat162float(r.x));
          v1 = __fadd_rn(v1, __bfloat162float(r.y));
        }
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_f32 == 0) or f32 -> q [M, K] int8, scale [M] f32.
int encoder_rowquant(const void* x, int x_f32, void* q, void* scale, int M,
                     int K, void* stream) {
  dim3 grid((M + 7) / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scale);
  if (x_f32)
    rowquant_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                                 qq, s, M, K);
  else
    rowquant_kernel<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x),
                                                qq, s, M, K);
  return static_cast<int>(cudaGetLastError());
}

int encoder_qgemm(const void* A, const void* Bt, const void* sa,
                  const void* sw, const void* bias, const void* res, void* out,
                  int M, int N, int K, int epi, int act, int res_f32,
                  void* stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(Bt);
  const float* s_a = static_cast<const float*>(sa);
  const float* s_w = static_cast<const float*>(sw);
  const float* bs = static_cast<const float*>(bias);
  if (epi == QEPI_BF16)
    qgemm_kernel<QEPI_BF16><<<grid, 256, 0, st>>>(a, b, s_a, s_w, bs, res, out,
                                                  M, N, K, act, res_f32);
  else if (epi == QEPI_ACT)
    qgemm_kernel<QEPI_ACT><<<grid, 256, 0, st>>>(a, b, s_a, s_w, bs, res, out,
                                                 M, N, K, act, res_f32);
  else
    qgemm_kernel<QEPI_RES><<<grid, 256, 0, st>>>(a, b, s_a, s_w, bs, res, out,
                                                 M, N, K, act, res_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
