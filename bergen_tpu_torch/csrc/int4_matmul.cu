// Weight-only int4 matmul over packed nibbles with group-wise f32 scales.
//
// Replaces: bergen_tpu/ops/int4_matmul.py::matmul_int4_packed (Pallas
// bodies _kernel, _kernel_stacked, _kernel_duo, _kernel_mono).  It computes
//   y[m, n] = sum_g scales[g, n] * sum_{k in g} bf16(x[m, k]) * q[k, n]
// in f32, where q holds the [-7, 7] codes of
// models/convert.py::quantize_int4_packed: packed byte wp[i, n] carries row
// 2i in its low nibble (sign-extended) and row 2i+1 as
// (b >> 4) + ((b >> 3) & 1).  Each group's dot is summed in f32 by the
// tensor cores, then multiplied by its f32 scale and added to the output
// sum, so the weights are never rounded (the TPU's dot-identity forms exist
// to feed its matrix unit byte operands; on Hopper a code converts to bf16
// exactly and feeds mma.sync directly).
//
// Layout trick: a bf16 m16n8k16 B fragment holds k rows {2t, 2t+1} (and
// {2t+8, 2t+9}) of one column in one register, which is exactly one packed
// byte.  Each warp permutes the columns of its NT n8-tiles so that MMA
// column c of tile j is the tile's column NT*c + j: a thread's bytes for
// all NT tiles are then NT consecutive bytes of one packed row, one load,
// and its accumulators cover 2*NT consecutive output columns.
//
// What bounds it on the H100: decode (M <= 16) reads K*N/2 bytes of codes
// and K/group*N*4 of scales for 2*M*K*N operations, so it is bound by bytes
// (8.4 MB at K = N = 4,096: 2.6 us at 3.35 TB/s); the decode kernel keeps
// many independent loads in flight (8 warps split the groups of a 32-column
// stripe, loads straight into fragment registers, one shared-memory
// reduction at the end).  Prefill (M = batch x bucket) is bound by the
// tensor cores; the prefill kernel is the 128 x 128 mma.sync tile of
// common.cuh with a two-stage cp.async ring over one group per stage and
// the codes unpacked from shared memory into fragments.
#include "common.cuh"

namespace {

// One packed byte -> the bf16x2 B-fragment register of its two rows.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t byte) {
  const int b = static_cast<int>(static_cast<int8_t>(byte & 0xFFu));
  const int lo = static_cast<int>(static_cast<uint32_t>(b) << 28) >> 28;
  const int hi = (b >> 4) + ((b >> 3) & 1);
  return pack_bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// ---------------------------------------------------------------- decode

constexpr int DEC_WARPS = 8;
constexpr int DEC_NT = 4;             // n8 tiles per warp
constexpr int DEC_BN = 8 * DEC_NT;    // 32 output columns per block

// M <= 16 rows; grid N / DEC_BN; warp w takes groups w, w + 8, ...
__global__ void __launch_bounds__(DEC_WARPS * 32)
    int4_decode_kernel(const bf16* __restrict__ x,
                       const int8_t* __restrict__ wp,
                       const float* __restrict__ scales,
                       float* __restrict__ y, int M, int N, int K,
                       int group) {
  __shared__ float red[DEC_WARPS][16][DEC_BN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * DEC_BN;
  const int n_groups = K / group;
  const bool row0 = g < M, row1 = g + 8 < M;
  const bf16* x0 = x + (size_t)g * K + 2 * t;
  const bf16* x1 = x + (size_t)(g + 8) * K + 2 * t;
  const int8_t* wcol = wp + n0 + DEC_NT * g;

  float acc[DEC_NT][4];
#pragma unroll
  for (int j = 0; j < DEC_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int gi = warp; gi < n_groups; gi += DEC_WARPS) {
    float gacc[DEC_NT][4];
#pragma unroll
    for (int j = 0; j < DEC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
    const int kg = gi * group;
#pragma unroll 8
    for (int kk = 0; kk < group; kk += 16) {
      const int k0 = kg + kk;
      uint32_t a[4];
      a[0] = row0 ? ld_u32(x0 + k0) : 0u;
      a[1] = row1 ? ld_u32(x1 + k0) : 0u;
      a[2] = row0 ? ld_u32(x0 + k0 + 8) : 0u;
      a[3] = row1 ? ld_u32(x1 + k0 + 8) : 0u;
      const uint32_t w0 = ld_u32(wcol + (size_t)(k0 / 2 + t) * N);
      const uint32_t w1 = ld_u32(wcol + (size_t)(k0 / 2 + 4 + t) * N);
#pragma unroll
      for (int j = 0; j < DEC_NT; ++j) {
        uint32_t b[2] = {nibbles_bf16x2(w0 >> (8 * j)),
                         nibbles_bf16x2(w1 >> (8 * j))};
        mma_bf16(gacc[j], a, b);
      }
    }
    // this thread's columns: n0 + DEC_NT * (2t + h) + j, h = e & 1
    const float4* sp = reinterpret_cast<const float4*>(
        scales + (size_t)gi * N + n0 + 2 * DEC_NT * t);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float s[2][DEC_NT] = {{s0.x, s0.y, s0.z, s0.w},
                                {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
    for (int j = 0; j < DEC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += gacc[j][e] * s[e & 1][j];
  }

#pragma unroll
  for (int j = 0; j < DEC_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][g + 8 * (e >> 1)][DEC_NT * (2 * t + (e & 1)) + j] = acc[j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * DEC_BN; i += DEC_WARPS * 32) {
    const int r = i / DEC_BN, c = i % DEC_BN;
    if (r >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) sum += red[w][r][c];
    y[(size_t)r * N + n0 + c] = sum;
  }
}

// --------------------------------------------------------------- prefill

constexpr int PF_BM = 128, PF_BN = 128;
constexpr int PF_WP_LD = PF_BN + 32;  // packed row pitch: conflict-free reads

// grid (N / 128, ceil(M / 128)), 256 threads: 8 warps of 64 x 32 (2 x 4).
// Shared memory per stage: x [128][group + 8] bf16, codes [group/2][160].
__global__ void __launch_bounds__(256, 1)
    int4_prefill_kernel(const bf16* __restrict__ x,
                        const int8_t* __restrict__ wp,
                        const float* __restrict__ scales,
                        float* __restrict__ y, int M, int N, int K,
                        int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x_ld = group + 8;
  const int x_bytes = PF_BM * x_ld * 2;
  const int stage_bytes = x_bytes + (group / 2) * PF_WP_LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * PF_BN, m0 = blockIdx.y * PF_BM;
  const int a_rows = M - m0;
  const int n_groups = K / group;

  auto load_stage = [&](int stage, int gi) {
    bf16* xs = reinterpret_cast<bf16*>(smem + stage * stage_bytes);
    int8_t* ws = reinterpret_cast<int8_t*>(smem + stage * stage_bytes +
                                           x_bytes);
    const int kg = gi * group;
    const int xc = group / 8;  // 16-byte chunks per x row
    for (int i = tid; i < PF_BM * xc; i += 256) {
      const int r = i / xc, c = (i % xc) * 8;
      const bool ok = r < a_rows;
      cp_async16(xs + r * x_ld + c,
                 x + (size_t)(m0 + (ok ? r : 0)) * K + kg + c, ok);
    }
    for (int i = tid; i < (group / 2) * (PF_BN / 16); i += 256) {
      const int r = i / (PF_BN / 16), c = (i % (PF_BN / 16)) * 16;
      cp_async16(ws + r * PF_WP_LD + c,
                 wp + (size_t)(kg / 2 + r) * N + n0 + c, true);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(0, 0);
  for (int gi = 0; gi < n_groups; ++gi) {
    const int stage = gi & 1;
    if (gi + 1 < n_groups) {
      load_stage(stage ^ 1, gi + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = reinterpret_cast<const bf16*>(smem + stage * stage_bytes);
    const int8_t* ws = reinterpret_cast<const int8_t*>(
        smem + stage * stage_bytes + x_bytes);
    float gacc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
    for (int kk = 0; kk < group; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mi], xs + r * x_ld + c);
      }
      const int8_t* wrow = ws + (kk / 2 + t) * PF_WP_LD + wn * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wrow);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(wrow + 4 * PF_WP_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[2] = {nibbles_bf16x2(w0 >> (8 * j)),
                         nibbles_bf16x2(w1 >> (8 * j))};
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(gacc[mi][j], af[mi], b);
      }
    }
    // columns n0 + wn*32 + 4*(2t + h) + j: 8 consecutive scales
    const float4* sp = reinterpret_cast<const float4*>(
        scales + (size_t)gi * N + n0 + wn * 32 + 8 * t);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float s[2][4] = {{s0.x, s0.y, s0.z, s0.w},
                           {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] += gacc[mi][j][e] * s[e & 1][j];
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mi * 16 + g + 8 * half;
      if (r >= a_rows) continue;
      float4* out = reinterpret_cast<float4*>(
          y + (size_t)(m0 + r) * N + n0 + wn * 32 + 8 * t);
      out[0] = make_float4(acc[mi][0][2 * half], acc[mi][1][2 * half],
                           acc[mi][2][2 * half], acc[mi][3][2 * half]);
      out[1] = make_float4(acc[mi][0][2 * half + 1], acc[mi][1][2 * half + 1],
                           acc[mi][2][2 * half + 1],
                           acc[mi][3][2 * half + 1]);
    }
}

}  // namespace

extern "C" {

// x [M, K] bf16, wp [K/2, N] int8, scales [K/group, N] f32 -> y [M, N] f32.
// Needs N % 128 == 0, group % 16 == 0, group <= 256, K % group == 0.
int int4_matmul(const void* x, const void* wp, const void* scales, void* y,
                int M, int N, int K, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % PF_BN || group % 16 || group > 256 || K % group || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* w = static_cast<const int8_t*>(wp);
  const float* s = static_cast<const float*>(scales);
  float* out = static_cast<float*>(y);
  if (M <= 16) {
    int4_decode_kernel<<<N / DEC_BN, DEC_WARPS * 32, 0, st>>>(xb, w, s, out,
                                                               M, N, K, group);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = 2 * (PF_BM * (group + 8) * 2 + (group / 2) * PF_WP_LD);
  cudaError_t e = cudaFuncSetAttribute(
      int4_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(N / PF_BN, (M + PF_BM - 1) / PF_BM);
  int4_prefill_kernel<<<grid, 256, smem, st>>>(xb, w, s, out, M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
