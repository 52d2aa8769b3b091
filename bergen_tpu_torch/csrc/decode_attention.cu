// S=1 GQA decode attention over the flat KV cache.
//
// Replaces: bergen_tpu/ops/decode_attention.py::decode_attention (Pallas
// body _decode_kernel).  For each cache row b and query head h (KV head
// h / group) it computes
//   p = softmax(mask ? q.k_l * scale : -1e30),  out = bf16(p) . V
// over the flat [B, L, KH*Dh] cache, with p = e / max(sum e, 1e-30) rounded
// to bf16 before the context product as on the TPU.  A fully masked row
// therefore averages V uniformly over L.
//
// What bounds it on the H100: the K and V reads (2*B*L*KH*Dh bf16, 17 MB at
// B 8, L 2,112, TinyLlama widths), about 5 us at 3.35 TB/s: memory-bound,
// with so little work per layer that launch and latency dominate.  The TPU
// kernel's block-diagonal q trick exists to feed its matrix unit; on Hopper
// one block takes one (row, KV head) pair and does the dot products on the
// CUDA cores: eight threads cover one 64-wide key row with 16-byte loads
// (32 keys per pass over 256 threads), each thread keeps its 8-lane slice of
// all `group` queries in registers, the f32 scores of the whole row live in
// shared memory ([group, L], 68 KB at group 8, L 2,112), the softmax runs one
// warp per query head, and the context product streams V the same way and
// reduces across keys with shuffles and one shared-memory pass.  The head
// width DH (64 or 128) is a template parameter: DH / 8 threads cover one key
// row, so a pass over 256 threads takes 2048 / DH keys.  Splitting L over
// more blocks (more SMs in flight at small B) is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <int G, int DH>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc,
                  const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                  int H, int KH, int L, float scale) {
  extern __shared__ float sm[];
  float* sc = sm;              // [G, L] scores, then bf16-rounded probs
  float* red = sm + G * L;     // [WARPS, G, DH] partial contexts
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int CH = DH / 8;                  // threads per key row
  constexpr int KPASS = THREADS / CH;         // key rows per pass
  const int chunk = tid % CH, kl = tid / CH;
  const size_t KHD = (size_t)KH * DH;
  const bf16* kb = kc + (size_t)b * L * KHD + kh * DH + chunk * 8;
  const bf16* vb = vc + (size_t)b * L * KHD + kh * DH + chunk * 8;
  const uint8_t* vm = valid + (size_t)b * L;

  float qv[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    uint4 u = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * H + kh * G + gi) * DH + chunk * 8);
    unpack8(u, qv[gi]);
  }

  for (int l0 = 0; l0 < L; l0 += KPASS) {
    const int l = l0 + kl;
    float part[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
    if (l < L) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kb + l * KHD), kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < 8; ++i) part[gi] += qv[gi][i] * kf[i];
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int off = 1; off < CH; off <<= 1)
        part[gi] += __shfl_xor_sync(0xffffffffu, part[gi], off);
    if (chunk == 0 && l < L) {
      const bool ok = vm[l] != 0;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        sc[gi * L + l] = ok ? part[gi] * scale : -1e30f;
    }
  }
  __syncthreads();

  for (int gi = warp; gi < G; gi += WARPS) {
    float* row = sc + gi * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, row[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int l = lane; l < L; l += 32) {
      float e = expf(row[l] - m);
      row[l] = e;
      s += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float den = fmaxf(s, 1e-30f);
    for (int l = lane; l < L; l += 32)
      row[l] = __bfloat162float(__float2bfloat16(row[l] / den));
  }
  __syncthreads();

  float acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0.f;
  for (int l = kl; l < L; l += KPASS) {
    float vf[8];
    unpack8(*reinterpret_cast<const uint4*>(vb + l * KHD), vf);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = sc[gi * L + l];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gi][i] += p * vf[i];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int off = CH; off < 32; off <<= 1)
        acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
  if (lane < CH) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(warp * G + gi) * DH + lane * 8 + i] = acc[gi][i];
  }
  __syncthreads();
  for (int o = tid; o < G * DH; o += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * G * DH + o];
    const int gi = o / DH, d = o % DH;
    out[((size_t)b * H + kh * G + gi) * DH + d] = __float2bfloat16(s);
  }
}

template <int G, int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int H, int KH, int L, float scale,
           cudaStream_t st) {
  const size_t smem = ((size_t)G * L + (size_t)WARPS * G * DH) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<G, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(KH, B);
  decode_kernel<G, DH><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(out), H, KH, L, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* valid,
              void* out, int B, int H, int KH, int L, float scale,
              cudaStream_t st) {
  switch (H / KH) {
    case 1:
      return launch<1, DH>(q, k, v, valid, out, B, H, KH, L, scale, st);
    case 2:
      return launch<2, DH>(q, k, v, valid, out, B, H, KH, L, scale, st);
    case 4:
      return launch<4, DH>(q, k, v, valid, out, B, H, KH, L, scale, st);
    case 8:
      return launch<8, DH>(q, k, v, valid, out, B, H, KH, L, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [B, H, Dh], k/v [B, L, KH*Dh] bf16, valid [B, L] uint8 -> out [B, H, Dh].
// Returns cudaErrorInvalidValue for a head width or group size it was not
// built for.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid, void* out, int B, int H, int KH, int L,
                     int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dh<64>(q, k, v, valid, out, B, H, KH, L, scale, st);
  if (Dh == 128)
    return launch_dh<128>(q, k, v, valid, out, B, H, KH, L, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
