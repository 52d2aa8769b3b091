// Paged decode attention: one slot's unnormalised softmax partial over its
// full 128-token pages, read in place from the page pool.
//
// Replaces: bergen_tpu/ops/paged_attention.py::paged_partial_pallas (Pallas
// body _paged_kernel).  For slot s and query head h (KV head h / group) it
// computes, over pages i = starts[s] / 128 .. n_pages[s] - 1 of the slot's
// block table, the online softmax of JAX's kernel:
//   sc = q.k * scale (lanes before starts[s] score -1e30),
//   m' = max(m, max sc), a = exp(m - m'), p = exp(sc - m'),
//   l = l * a + sum p,  acc = acc * a + bf16(p) . V,  m = m'
// and writes acc [S, H, Dh], m and l [S, H] in f32.  A slot with no such
// page writes acc 0, m -1e30, l 0 (an absent partial for the merge).
//
// What bounds it on the H100: the K and V pages (2 * 32 KB per page and KV
// head at Dh 128), about 4 FLOP per byte, so memory.  The TPU kernel batches
// 8 slots per grid step to amortise its DMA semaphores; on Hopper one block
// takes one (slot, KV head) pair and streams that head's pages through two
// shared-memory buffers with cp.async (page j + 2 loads while page j
// computes; each page's head slice is contiguous in the [NP, KH, 128, Dh]
// pool, so the copy is 2,048 16-byte chunks of K and of V).  The group's
// query heads stay in registers; sixteen threads cover one 128-wide key row
// (8 lanes each, 16-byte shared loads), so a pass over 256 threads scores 16
// keys; one warp per query head runs the online softmax over the page's 128
// scores and keeps m and l in registers; the PV product streams V the same
// way and each thread keeps its slice of the context for its key rows,
// rescaled by a every page and reduced across the block at the end.  The
// dot products run on the CUDA cores, which keep up with the memory rate at
// this intensity.  Splitting a long slot's pages over blocks
// (flash-decoding) is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int PAGE = 128;
constexpr int DH = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = DH / 8;           // threads per key row
constexpr int KPASS = THREADS / CH;  // key rows per pass
constexpr int TILE = PAGE * DH;      // bf16 values of one page of one head
constexpr float NEG = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ npg, const int* __restrict__ starts,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int KH, int maxP, int NP,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);                // [2][TILE]
  bf16* vbuf = kbuf + 2 * TILE;                              // [2][TILE]
  float* sc = reinterpret_cast<float*>(vbuf + 2 * TILE);     // [G][PAGE]
  float* alpha = sc + G * PAGE;                              // [G]
  const int kh = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = tid % CH, kl = tid / CH;
  const int start = starts[s];
  const int p0 = start / PAGE;
  // a slot has at most maxP pages: its table row bounds the walk
  const int steps = max(min(npg[s], maxP) - p0, 0);
  const int* tbl = tables + (size_t)s * maxP;

  float qv[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    unpack8(*reinterpret_cast<const uint4*>(
                q + ((size_t)s * H + kh * G + gi) * DH + chunk * 8),
            qv[gi]);
  float acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0.f;
  float m_run = NEG, l_run = 0.f;  // warp gi < G: query head gi's state

  // one cp.async group per page (empty past the last page, so that the
  // wait counts stay the same every iteration)
  auto issue = [&](int j, int buf) {
    if (j < steps) {
      const int page = min(max(tbl[p0 + j], 0), NP - 1);
      const size_t off = ((size_t)page * KH + kh) * TILE;
      for (int i = tid; i < TILE / 8; i += THREADS) {
        cp_async16(kbuf + buf * TILE + i * 8, kp + off + i * 8, true);
        cp_async16(vbuf + buf * TILE + i * 8, vp + off + i * 8, true);
      }
    }
    cp_async_commit();
  };

  issue(0, 0);
  issue(1, 1);
  for (int j = 0; j < steps; ++j) {
    const int buf = j & 1;
    cp_async_wait<1>();  // page j has landed; page j + 1 may be in flight
    __syncthreads();
    const bf16* kt = kbuf + buf * TILE;
    const bf16* vt = vbuf + buf * TILE;
    const int base = (p0 + j) * PAGE;
    for (int t0 = 0; t0 < PAGE; t0 += KPASS) {
      const int t = t0 + kl;
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kt + t * DH + chunk * 8), kf);
      float part[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        part[gi] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part[gi] += qv[gi][i] * kf[i];
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int o = 1; o < CH; o <<= 1)
          part[gi] += __shfl_xor_sync(0xffffffffu, part[gi], o);
      if (chunk == 0) {
        const bool pad = base + t < start;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          sc[gi * PAGE + t] = pad ? NEG : part[gi] * scale;
      }
    }
    __syncthreads();
    if (warp < G) {
      float* row = sc + warp * PAGE;
      float x[PAGE / 32];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < PAGE / 32; ++i) {
        x[i] = row[lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float a = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PAGE / 32; ++i) {
        const float e = expf(x[i] - m_new);
        sum += e;
        row[lane + 32 * i] = __bfloat162float(__float2bfloat16(e));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * a + sum;
      m_run = m_new;
      if (lane == 0) alpha[warp] = a;
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float a = alpha[gi];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gi][i] *= a;
    }
    for (int t = kl; t < PAGE; t += KPASS) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(vt + t * DH + chunk * 8), vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = sc[gi * PAGE + t];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[gi][i] += p * vf[i];
      }
    }
    __syncthreads();  // both buffers' readers are done before the refill
    issue(j + 2, buf);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the two key rows of a warp, then the eight warps through shared memory
  // (the K buffers are free now)
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][G][DH]
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], CH);
  if (lane < CH) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(warp * G + gi) * DH + lane * 8 + i] = acc[gi][i];
  }
  __syncthreads();
  for (int o = tid; o < G * DH; o += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w * G * DH + o];
    acc_out[((size_t)s * H + kh * G) * DH + o] = v;
  }
  if (warp < G && lane == 0) {
    m_out[(size_t)s * H + kh * G + warp] = m_run;
    l_out[(size_t)s * H + kh * G + warp] = l_run;
  }
}

template <int G>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* npg, const void* starts, void* acc, void* m, void* l,
           int S, int H, int KH, int maxP, int NP, float scale,
           cudaStream_t st) {
  const size_t smem =
      4 * (size_t)TILE * sizeof(bf16) + (G * PAGE + G) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      paged_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(KH, S);
  paged_kernel<G><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(npg), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), H, KH, maxP, NP, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [S, H, 128] bf16; k/v pool [NP, KH, 128, 128] bf16; tables [S, maxP],
// n_pages and starts [S] int32 -> acc [S, H, 128], m and l [S, H] f32.
// Returns cudaErrorInvalidValue for a head width or group it was not built
// for.
int paged_partial(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* npg, const void* starts,
                  void* acc, void* m, void* l, int S, int H, int KH, int maxP,
                  int NP, int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh != DH || KH <= 0 || H % KH != 0 || NP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  switch (H / KH) {
    case 1:
      return launch<1>(q, kp, vp, tables, npg, starts, acc, m, l, S, H, KH,
                       maxP, NP, scale, st);
    case 2:
      return launch<2>(q, kp, vp, tables, npg, starts, acc, m, l, S, H, KH,
                       maxP, NP, scale, st);
    case 4:
      return launch<4>(q, kp, vp, tables, npg, starts, acc, m, l, S, H, KH,
                       maxP, NP, scale, st);
    case 8:
      return launch<8>(q, kp, vp, tables, npg, starts, acc, m, l, S, H, KH,
                       maxP, NP, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
