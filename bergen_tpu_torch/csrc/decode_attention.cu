// S=1 GQA decode attention over the flat KV cache, split over the cache
// length (flash-decoding) in one launch.
//
// Replaces: bergen_tpu/ops/decode_attention.py::decode_attention (Pallas
// body _decode_kernel).  For each cache row b and query head h (KV head
// h / group) it computes
//   p = softmax(mask ? q.k_l * scale : -1e30),  out = bf16(p) . V
// over the flat [B, L, KH*Dh] cache, with p = exp(s - m) / max(l, 1e-30)
// rounded to bf16 before the context product as on the TPU, where m and l
// are the max and the sum of the WHOLE row.  A fully masked row therefore
// averages V uniformly over L.
//
// What bounds it on the H100: the K and V reads (2*B*L*KH*Dh bf16, 17 MB at
// B 8, L 2,112, TinyLlama widths), about 5 us at 3.35 TB/s: memory-bound,
// with so little work per layer that latency dominates.  One block per
// (row, KV head) pair gives 32 blocks at B 8, KH 4 on a 132-SM card, so the
// cache length is split over `splits` blocks per pair (chosen from B*KH and
// L by decode_attention_splits).  Rounding p needs the row's global (m, l)
// before any block rounds, so the launch is cooperative (every block
// resident) and the blocks of one pair meet at a barrier of their own:
//   1. each block scores its keys into shared memory ([G, chunk] f32) and
//      publishes its split's (max, sum of exp(s - max)) per query head;
//   2. after the pair's barrier every block combines the splits' (m, l) in
//      split order, rounds p = bf16(exp(s - m) / max(l, 1e-30)) (a split
//      with no valid key has s = -1e30 and gets exactly zero weight; a
//      fully masked row has m = -1e30 and gets exp(0) = 1 per key) and
//      forms its partial context p . V in f32;
//   3. the last block of the pair to finish sums the partial contexts in
//      split order (deterministic) and writes the bf16 output.
// With one split (B*KH alone fills the card) there is no barrier, no
// scratch and a plain launch.  Within a block, eight threads cover one
// 64-wide key row with 16-byte loads (DH / 8 threads a row), each thread
// keeps its 8-lane slice of all `group` queries in registers, the softmax
// runs one warp per query head, and the context product streams V the same
// way and reduces across keys with shuffles and one shared-memory pass.
// It is built for every group G from 1 to 8 (Llama-3.2-3B's 3, Qwen2.5's 5
// and 7 among them): a thread holds G query slices and G partial sums, the
// softmax warps take heads warp, warp + 8, ... below G (warps G.. idle when
// G < 8), and every per-head array is G rows long, so no row past the
// group is read or written.  Head widths 64, 128 and 256 (Gemma's): at 256
// a whole warp covers one key row (DH / 8 = 32 threads), eight key rows a
// pass, and the cross-row reduction of the context product needs no
// shuffle; the [8 warps, G, 256] f32 partial contexts reach 64 KiB at G 8,
// which every launch takes as dynamic shared memory (opted in per size).
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CHUNK = 64;  // keys per split at least

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// The blocks of one (row, KV head) pair wait for each other: the last to
// arrive resets the arrival count and advances the pair's generation.
// Every block of the cooperative launch is resident, so this cannot wait on
// a block that has not started; a wait far past any real one traps instead
// of hanging the card.
__device__ __forceinline__ void pair_barrier(int* count, int* gen, int n) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* vgen = gen;
    const int g0 = *vgen;
    __threadfence();
    if (atomicAdd(count, 1) == n - 1) {
      atomicExch(count, 0);
      __threadfence();
      atomicAdd(gen, 1);
    } else {
      long long spins = 0;
      while (*vgen == g0) {
        __nanosleep(64);
        if (++spins > (1ll << 26)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// grid (splits, KH, B).  Scratch (splits > 1): stats [B*KH, splits, G]
// float2 (max, sum), ctx [B*KH, splits, G*DH] f32, counters [B*KH, 3]
// int32 (arrivals, generation, finished) per pair, zero at the first
// launch and left zero (arrivals, finished) by every launch.
template <int G, int DH>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc,
                  const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                  float2* __restrict__ stats, float* __restrict__ ctx,
                  int* __restrict__ counters, int H, int KH, int L, int chunk,
                  float scale) {
  extern __shared__ float sm[];
  const int splits = gridDim.x, sidx = blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int pair = b * KH + kh;
  const int l0 = sidx * chunk, n = min(chunk, L - l0);
  float* sc = sm;              // [G, chunk] scores, then bf16-rounded probs
  float* red = sm + G * chunk; // [WARPS, G, DH] partial contexts
  __shared__ float m_row[G], l_row[G];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int CH = DH / 8;                  // threads per key row
  constexpr int KPASS = THREADS / CH;         // key rows per pass
  const int part_i = tid % CH, kl = tid / CH;
  const size_t KHD = (size_t)KH * DH;
  const bf16* kb = kc + ((size_t)b * L + l0) * KHD + kh * DH + part_i * 8;
  const bf16* vb = vc + ((size_t)b * L + l0) * KHD + kh * DH + part_i * 8;
  const uint8_t* vm = valid + (size_t)b * L + l0;

  float qv[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    uint4 u = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * H + kh * G + gi) * DH + part_i * 8);
    unpack8(u, qv[gi]);
  }

  // 1. this split's scores, max and sum
#pragma unroll 4
  for (int j0 = 0; j0 < n; j0 += KPASS) {
    const int j = j0 + kl;
    float part[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
    if (j < n) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kb + j * KHD), kf);
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
    if (part_i == 0 && j < n) {
      const bool ok = vm[j] != 0;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        sc[gi * chunk + j] = ok ? part[gi] * scale : -1e30f;
    }
  }
  __syncthreads();

  for (int gi = warp; gi < G; gi += WARPS) {
    const float* row = sc + gi * chunk;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += expf(row[j] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      m_row[gi] = m;
      l_row[gi] = s;
      if (splits > 1)
        stats[((size_t)pair * splits + sidx) * G + gi] = make_float2(m, s);
    }
  }

  // 2. the whole row's (m, l), in split order; rounded probabilities
  if (splits > 1) {
    pair_barrier(counters + 3 * pair, counters + 3 * pair + 1, splits);
    for (int gi = warp; gi < G; gi += WARPS) {
      if (lane == 0) {
        const float2* st = stats + (size_t)pair * splits * G + gi;
        float m = -INFINITY;
        for (int s = 0; s < splits; ++s) m = fmaxf(m, __ldcg(st + s * G).x);
        float l = 0.f;
        for (int s = 0; s < splits; ++s) {
          const float2 v = __ldcg(st + s * G);
          l += v.y * expf(v.x - m);
        }
        m_row[gi] = m;
        l_row[gi] = l;
      }
    }
  }
  __syncthreads();
  for (int gi = warp; gi < G; gi += WARPS) {
    float* row = sc + gi * chunk;
    const float m = m_row[gi], den = fmaxf(l_row[gi], 1e-30f);
    for (int j = lane; j < n; j += 32)
      row[j] = __bfloat162float(__float2bfloat16(expf(row[j] - m) / den));
  }
  __syncthreads();

  // 3. this split's context, then the pair's sum in split order
  float acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0.f;
#pragma unroll 4
  for (int j = kl; j < n; j += KPASS) {
    float vf[8];
    unpack8(*reinterpret_cast<const uint4*>(vb + j * KHD), vf);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = sc[gi * chunk + j];
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
  bf16* ob = out + ((size_t)b * H + kh * G) * DH;
  if (splits == 1) {
    for (int o = tid; o < G * DH; o += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * G * DH + o];
      ob[o] = __float2bfloat16(s);
    }
    return;
  }
  float* cp = ctx + (size_t)pair * splits * G * DH;
  for (int o = tid; o < G * DH; o += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * G * DH + o];
    cp[(size_t)sidx * G * DH + o] = s;
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* done = counters + 3 * pair + 2;
    last = atomicAdd(done, 1) == splits - 1;
    if (last) atomicExch(done, 0);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int o = tid; o < G * DH; o += THREADS) {
    float s = 0.f;
    for (int si = 0; si < splits; ++si)
      s += __ldcg(cp + (size_t)si * G * DH + o);
    ob[o] = __float2bfloat16(s);
  }
}

size_t smem_bytes(int G, int DH, int chunk) {
  return ((size_t)G * chunk + (size_t)WARPS * G * DH) * sizeof(float);
}

// Blocks of decode_kernel<G, DH> resident on one SM at this chunk, cached.
template <int G, int DH>
int per_sm(int chunk) {
  static int chunks[8], counts[8], used = 0;
  for (int i = 0; i < used; ++i)
    if (chunks[i] == chunk) return counts[i];
  const size_t smem = smem_bytes(G, DH, chunk);
  int n = 0;
  if (smem > 232448 ||
      cudaFuncSetAttribute(decode_kernel<G, DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_kernel<G, DH>, THREADS, smem) != cudaSuccess)
    n = 0;
  if (used < 8) {
    chunks[used] = chunk;
    counts[used++] = n;
  }
  return n;
}

template <int DH>
int per_sm_g(int G, int chunk) {
  switch (G) {
    case 1: return per_sm<1, DH>(chunk);
    case 2: return per_sm<2, DH>(chunk);
    case 3: return per_sm<3, DH>(chunk);
    case 4: return per_sm<4, DH>(chunk);
    case 5: return per_sm<5, DH>(chunk);
    case 6: return per_sm<6, DH>(chunk);
    case 7: return per_sm<7, DH>(chunk);
    case 8: return per_sm<8, DH>(chunk);
    default: return 0;
  }
}

// Splits per (row, KV head) pair: enough blocks for two per SM, at least
// MIN_CHUNK keys each, every split non-empty, and every block of the
// cooperative launch resident at once.
int choose_splits(int B, int KH, int L, int G, int DH) {
  const long long pairs = (long long)B * KH;
  const long long want = (2 * sm_count() + pairs - 1) / pairs;
  int s = (int)std::max(1ll, std::min(want, (long long)(L / MIN_CHUNK)));
  while (s > 1) {
    const int chunk = (L + s - 1) / s;
    s = (L + chunk - 1) / chunk;
    const int cap = DH == 64    ? per_sm_g<64>(G, chunk)
                    : DH == 128 ? per_sm_g<128>(G, chunk)
                                : per_sm_g<256>(G, chunk);
    if ((long long)s * pairs <= (long long)cap * sm_count()) break;
    --s;
  }
  return s;
}

template <int G, int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* stats, void* ctx, void* counters, int B, int H,
           int KH, int L, int splits, float scale, cudaStream_t st) {
  const int chunk = (L + splits - 1) / splits;
  const size_t smem = smem_bytes(G, DH, chunk);
  auto kern = decode_kernel<G, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(splits, KH, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(valid);
  bf16* op = static_cast<bf16*>(out);
  float2* sp = static_cast<float2*>(stats);
  float* cp = static_cast<float*>(ctx);
  int* np = static_cast<int*>(counters);
  if (splits == 1) {
    kern<<<grid, THREADS, smem, st>>>(qp, kp, vp, mp, op, sp, cp, np, H, KH,
                                      L, chunk, scale);
    return static_cast<int>(cudaGetLastError());
  }
  int Hv = H, KHv = KH, Lv = L, cv = chunk;
  float scv = scale;
  void* args[] = {&qp, &kp, &vp, &mp, &op, &sp, &cp, &np,
                  &Hv, &KHv, &Lv, &cv, &scv};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid,
                                  dim3(THREADS), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* valid,
              void* out, void* stats, void* ctx, void* counters, int B, int H,
              int KH, int L, int splits, float scale, cudaStream_t st) {
  switch (H / KH) {
#define DA_CASE(G)                                                         \
  case G:                                                                  \
    return launch<G, DH>(q, k, v, valid, out, stats, ctx, counters, B, H, \
                         KH, L, splits, scale, st);
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(3)
    DA_CASE(4)
    DA_CASE(5)
    DA_CASE(6)
    DA_CASE(7)
    DA_CASE(8)
#undef DA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The split count the launch below uses for this shape.
int decode_attention_splits(int B, int H, int KH, int L, int Dh) {
  if (KH < 1 || H % KH || (Dh != 64 && Dh != 128 && Dh != 256)) return 0;
  return choose_splits(B, KH, L, H / KH, Dh);
}

// q [B, H, Dh], k/v [B, L, KH*Dh] bf16, valid [B, L] uint8 -> out [B, H, Dh].
// stats, ctx: scratch of at least B*KH*splits*G float2 and
// B*KH*splits*G*Dh f32; counters: 3*B*KH int32, zero before the first
// launch (every launch leaves them fit for the next).  splits must be
// decode_attention_splits(B, H, KH, L, Dh).  Returns cudaErrorInvalidValue
// for a head width or group size it was not built for.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid, void* out, void* stats, void* ctx,
                     void* counters, int B, int H, int KH, int L, int Dh,
                     int splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KH < 1 || H % KH || splits < 1 ||
      splits != decode_attention_splits(B, H, KH, L, Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 64)
    return launch_dh<64>(q, k, v, valid, out, stats, ctx, counters, B, H, KH,
                         L, splits, scale, st);
  if (Dh == 128)
    return launch_dh<128>(q, k, v, valid, out, stats, ctx, counters, B, H,
                          KH, L, splits, scale, st);
  if (Dh == 256)
    return launch_dh<256>(q, k, v, valid, out, stats, ctx, counters, B, H,
                          KH, L, splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
