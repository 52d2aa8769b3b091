// Weight-only int4 matmul over packed nibbles with group-wise f32 scales.
//
// Replaces: bergen_tpu/ops/int4_matmul.py::matmul_int4_packed (Pallas
// bodies _kernel, _kernel_stacked, _kernel_duo, _kernel_mono).  It computes
//   y[m, n] = sum_g scales[g, n] * sum_{k in g} bf16(x[m, k]) * q[k, n]
// in f32, where q holds the [-7, 7] codes of
// models/convert.py::quantize_int4_packed: packed byte wp[i, n] is
// 16 * q[2i+1, n] + q[2i, n] (row 2i in its low nibble, sign-extended; row
// 2i+1 as (b >> 4) + ((b >> 3) & 1)).  Each group's dot is summed in f32 by
// the tensor cores, then multiplied by its f32 scale and added to the output
// sum, so the weights are never rounded (the TPU's dot-identity forms exist
// to feed its matrix unit byte operands; on Hopper a code converts to bf16
// exactly and feeds the tensor cores directly).  An optional f32 bias[n]
// joins the output sum in the epilogue, so that the caller rounds the
// biased sum once (qwen2's q/k/v biases: the JAX package's int4
// projection drops them, a fault the port repairs).
//
// Unpacking: from four packed bytes w, lo + 8 = (w & 0x0F) ^ 8 and hi + 8 =
// ((w >> 4 & 0x0F) ^ 8) + (w >> 3 & 1) per byte, all in [0, 16] (no carry
// between bytes); a byte permute puts one code pair in the low bytes of the
// two halves of a word, and (0x4300 | v) is bf16(128 + v) exactly, so one
// bf16x2 subtraction of 136 gives the two codes as bf16.  About three
// instructions per pair of codes, no integer-to-float conversion.
//
// What bounds it on the H100, and the two kernels:
// * decode (M <= 16): K*N/2 bytes of codes and K/group*N*4 of scales for
//   2*M*K*N operations, so bound by bytes (8.4 MB at K = N = 4,096: 2.6 us
//   at 3.35 TB/s).  The product is computed transposed (y^T = Q^T x^T), so
//   the m16n8k16 MMA's 16 rows are output columns and its 8 columns the
//   batch rows: nothing of the tile is padding at M 8.  A warp's task is a
//   128-column stripe of one group; a thread's two 16-byte loads per k16
//   step (packed rows t and 4 + t, columns 16g..16g+15) feed 8 MMAs, and
//   the 8 lanes of a quarter-warp read one whole 128-byte line.
//   K is split over blocks (int4_decode_splits: about four blocks of four
//   warps per SM at every Llama-2-7B shape); each block writes its f32
//   partial and the last block of a stripe to finish sums the partials in
//   split order (deterministic), in the same launch.
// * prefill (M > 16): bound by the tensor cores.  A persistent wgmma
//   kernel, one block per SM walking the 128 x 128 output tiles in bands
//   of 8 row tiles.  A 5-stage ring of 64-k stages in shared memory: a
//   loader warpgroup fills a stage with cp.async (the x tile written in
//   the 128-byte swizzle that wgmma reads, the packed codes, the group's
//   128 scales; arrival on the stage's mbarrier); an unpacker warpgroup
//   turns the stage's codes into a bf16 B tile beside it (K-major, the
//   same swizzle) once, as soon as it lands, so loads and unpacking run
//   ahead of the tensor cores (both give their registers to the consumers
//   with setmaxnreg); two consumer warpgroups of 64 x 128 run m64n128k16
//   wgmma on each ready stage.  Each group of 128 k rows is accumulated
//   into a fresh register accumulator, then multiplied by the group's f32
//   column scales and added into the main accumulator (per-group
//   promotion), and only then are the group's stages given back to the
//   loaders.  Groups of 64 and 256 work the same way over 1 and 4 stages;
//   any other multiple of 16 promotes at the k16 step where its group
//   ends, inside a stage, and gives each stage back once its own products
//   are done (a slower schedule for groups that no config uses).
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------- codes

// (lo + 8, hi + 8) of each of the four packed bytes of w, one per byte.
__device__ __forceinline__ void codes8(uint32_t w, uint32_t& lo8,
                                       uint32_t& hi8) {
  lo8 = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  hi8 = (((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + ((w >> 3) & 0x01010101u);
}

// The bf16x2 {lo, hi} of the byte that sel = j | (j + 4) << 8 picks.
__device__ __forceinline__ uint32_t code_pair(uint32_t lo8, uint32_t hi8,
                                              uint32_t sel) {
  uint32_t r = (__byte_perm(lo8, hi8, sel) & 0x00FF00FFu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ constexpr uint32_t byte_sel(int j) {
  return static_cast<uint32_t>(j | ((j + 4) << 8));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// ---------------------------------------------------------------- decode

constexpr int DEC_WARPS = 4;
constexpr int DEC_BN = 128;  // output columns per block (one warp stripe)

// Groups per block of the decode kernel: a multiple of DEC_WARPS, so that
// the (stripe, split) blocks number about four per SM.
int decode_groups_per_block(int N, int K, int group) {
  const long long n_groups = K / group, stripes = N / DEC_BN;
  const long long per = (n_groups * stripes + 4ll * sm_count() - 1) /
                        (4ll * sm_count());
  long long gpb = (per + DEC_WARPS - 1) / DEC_WARPS * DEC_WARPS;
  return static_cast<int>(gpb < DEC_WARPS ? DEC_WARPS : gpb);
}

int decode_splits(int N, int K, int group) {
  const int gpb = decode_groups_per_block(N, K, group);
  return (K / group + gpb - 1) / gpb;
}

// M <= 8 * MT rows; grid (N / 128, splits); warp w of split s takes groups
// s * gpb + w, + 4, ... below (s + 1) * gpb.  part [splits, M, N] f32 and
// counters [N / 128] (zero, and left zero) serve the split reduction.
template <int MT>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    int4_decode_kernel(const bf16* __restrict__ x,
                       const int8_t* __restrict__ wp,
                       const float* __restrict__ scales,
                       const float* __restrict__ bias,
                       float* __restrict__ y, float* __restrict__ part,
                       int* __restrict__ counters, int M, int N, int K,
                       int group, int gpb) {
  __shared__ float red[DEC_WARPS][8 * MT][DEC_BN];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int stripe = blockIdx.x, n0 = stripe * DEC_BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int g_end = min(K / group, (split + 1) * gpb);
  const int8_t* wcol = wp + n0 + 16 * g;

  // acc[mt][j][e]: output column n0 + 16g + 2j + (e >> 1), batch row
  // 8mt + 2t + (e & 1)
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int gi = split * gpb + warp; gi < g_end; gi += DEC_WARPS) {
    float gacc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[mt][j][e] = 0.f;
    const int kg = gi * group;
#pragma unroll 8
    for (int kk = 0; kk < group; kk += 16) {
      const int k0 = kg + kk;
      const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(
          wcol + (size_t)(k0 / 2 + t) * N));
      const uint4 c1 = __ldg(reinterpret_cast<const uint4*>(
          wcol + (size_t)(k0 / 2 + 4 + t) * N));
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = 8 * mt + g;
        const bf16* xr = x + (size_t)row * K + k0 + 2 * t;
        b[mt][0] = row < M ? ld_u32(xr) : 0u;
        b[mt][1] = row < M ? ld_u32(xr + 8) : 0u;
      }
      const uint32_t w0[4] = {c0.x, c0.y, c0.z, c0.w};
      const uint32_t w1[4] = {c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t lo0, hi0, lo1, hi1;
        codes8(w0[q], lo0, hi0);
        codes8(w1[q], lo1, hi1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // tile j = 2q + h: A rows g / g + 8 are bytes 2j / 2j + 1
          const uint32_t a[4] = {code_pair(lo0, hi0, byte_sel(2 * h)),
                                 code_pair(lo0, hi0, byte_sel(2 * h + 1)),
                                 code_pair(lo1, hi1, byte_sel(2 * h)),
                                 code_pair(lo1, hi1, byte_sel(2 * h + 1))};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(gacc[mt][2 * q + h], a, b[mt]);
        }
      }
    }
    const float4* sp = reinterpret_cast<const float4*>(
        scales + (size_t)gi * N + n0 + 16 * g);
    float s[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(sp + i);
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][j][e] = fmaf(gacc[mt][j][e], s[2 * j + (e >> 1)],
                               acc[mt][j][e]);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][8 * mt + 2 * t + (e & 1)][16 * g + 2 * j + (e >> 1)] =
            acc[mt][j][e];
  __syncthreads();
  const int rows = min(M, 8 * MT);
  float* dst = splits == 1 ? y : part + (size_t)split * M * N;
  for (int i = tid; i < rows * DEC_BN; i += DEC_WARPS * 32) {
    const int r = i / DEC_BN, c = i % DEC_BN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) sum += red[w][r][c];
    if (splits == 1 && bias) sum += bias[n0 + c];
    dst[(size_t)r * N + n0 + c] = sum;
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + stripe, 1) == splits - 1;
    if (last) atomicExch(counters + stripe, 0);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int i = tid; i < rows * DEC_BN; i += DEC_WARPS * 32) {
    const size_t o = (size_t)(i / DEC_BN) * N + n0 + i % DEC_BN;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s)
      sum += __ldcg(part + (size_t)s * M * N + o);
    if (bias) sum += bias[n0 + i % DEC_BN];
    y[o] = sum;
  }
}

// --------------------------------------------------------------- prefill

constexpr int PF_BM = 128, PF_BN = 128, PF_BK = 64;
constexpr int PF_STAGES = 5;
// a stage's slot: the x tile [128 rows][128 B] and the unpacked B tile
// [128 n][128 B] (both K-major in the 128-byte swizzle, 1024-aligned), the
// packed codes [32 rows][128] and f32 scales [4][128]: the group's in row 0
// (a group of 64, 128 or 256), else one row per k16 step (other groups)
constexpr int PF_X_OFF = 0, PF_B_OFF = 16384, PF_C_OFF = 32768;
constexpr int PF_S_OFF = 36864, PF_STAGE_BYTES = 38912;
constexpr int PF_THREADS = 512;  // two consumer warpgroups, two producer
// setmaxnreg moves registers from the producer warpgroups to the consumers
// within what the block was launched with (int4_matmul checks that it was
// launched with enough: otherwise the consumers' increase would wait for
// ever)
constexpr int PF_REGS_PRODUCER = 56, PF_REGS_CONSUMER = 200;
constexpr int PF_SMEM = 1024 + PF_STAGES * PF_STAGE_BYTES + 3 * PF_STAGES * 8;

// Unpacks k rows 8 * kc .. + 7 of one stage's codes [32 packed rows][128
// columns], columns 4 * lane .. + 3, into the bf16 B tile [128 n][64 k]
// (K-major, 128-byte swizzle): four conflict-free word loads; the four
// 16-byte stores visit the columns in a lane-rotated order, so each
// quarter-warp's stores hit eight distinct 16-byte bank groups.
__device__ __forceinline__ void unpack_rows(const unsigned char* codes,
                                            unsigned char* bt, int lane,
                                            int kc) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    codes8(*reinterpret_cast<const uint32_t*>(codes + (4 * kc + r) * PF_BN +
                                              4 * lane),
           lo[r], hi[r]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = (c + (lane >> 1)) & 3;
    const uint32_t sel = byte_sel(cc);
    const int n = 4 * lane + cc;
    uint4 v;
    v.x = code_pair(lo[0], hi[0], sel);
    v.y = code_pair(lo[1], hi[1], sel);
    v.z = code_pair(lo[2], hi[2], sel);
    v.w = code_pair(lo[3], hi[3], sel);
    *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n & 7)) << 4)) = v;
  }
}

// Output tile t -> (row tile, column tile), in bands of 8 row tiles.
__device__ __forceinline__ void tile_coords(int t, int m_tiles, int n_tiles,
                                            int& mt, int& nt) {
  const int band = t / (8 * n_tiles);
  const int rows = min(8, m_tiles - band * 8);
  const int in = t - band * 8 * n_tiles;
  mt = band * 8 + in % rows;
  nt = in / rows;
}

// acc += gacc * the column scales sc[128] (per-group promotion).
__device__ __forceinline__ void promote(float (&acc)[64],
                                        const float (&gacc)[64],
                                        const float* sc, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
    acc[4 * j] = fmaf(gacc[4 * j], s.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(gacc[4 * j + 1], s.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(gacc[4 * j + 2], s.x, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(gacc[4 * j + 3], s.y, acc[4 * j + 3]);
  }
}

// grid min(tiles, SMs), 512 threads: warpgroups 0 and 1 consume (rows
// 64 * wg .. + 63 of a tile), warpgroup 2 loads, warpgroup 3 unpacks.  Needs
// N % 128 == 0, K % group == 0 and group == 64 * GS, or (GS == 0) any
// multiple of 16: a group then ends at some k16 step of a stage, the
// consumers promote there, and every stage is given back as soon as its
// own wgmma are done (slower: each stage waits for its products).
template <int GS>
__global__ void __launch_bounds__(PF_THREADS, 1)
    int4_prefill_kernel(const bf16* __restrict__ x,
                        const int8_t* __restrict__ wp,
                        const float* __restrict__ scales,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int M, int N, int K,
                        int group) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem + PF_STAGES *
                                                 PF_STAGE_BYTES);
  uint64_t* ready = loaded + PF_STAGES;
  uint64_t* empty = ready + PF_STAGES;
  // roles, warp-uniform to the compiler (no divergent path around wgmma)
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, lane = tid & 31;
  const int m_tiles = (M + PF_BM - 1) / PF_BM, n_tiles = N / PF_BN;
  const int tiles = m_tiles * n_tiles;
  const int k_stages = K / PF_BK;

  if (tid == 0) {
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(&loaded[s], 128);  // the loaders' cp.async arrivals
      mbar_init(&ready[s], 128);   // the unpackers, after unpacking
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PF_REGS_PRODUCER)
                 : "memory");
    const int n_stages = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                         (int)gridDim.x * k_stages;
    if (wg == 2) {
      // ---- loaders: the stage's x tile, codes and scales with cp.async
      const int ptid = tid - 256;
      const int ch = ptid & 7, r0 = ptid >> 3;  // chunk, first row
      int tile = blockIdx.x, ks = 0, m0 = 0, n0 = 0;
      for (int it = 0; it < n_stages; ++it) {
        if (ks == 0) {
          int mt, nt;
          tile_coords(tile, m_tiles, n_tiles, mt, nt);
          m0 = mt * PF_BM;
          n0 = nt * PF_BN;
        }
        const int slot = it % PF_STAGES;
        mbar_wait(&empty[slot], ((it / PF_STAGES) & 1) ^ 1);
        unsigned char* st = smem + slot * PF_STAGE_BYTES;
        const int k0 = ks * PF_BK;
        const bf16* xs = x + k0 + ch * 8;
        unsigned char* xd = st + PF_X_OFF + ((ch ^ (r0 & 7)) << 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // rows r0 + 16i: the same swizzle
          const int r = r0 + 16 * i;
          const bool ok = m0 + r < M;
          cp_async16(xd + r * 128, xs + (size_t)(ok ? m0 + r : 0) * K, ok);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 16 * i;
          cp_async16(st + PF_C_OFF + r * PF_BN + ch * 16,
                     wp + (size_t)(k0 / 2 + r) * N + n0 + ch * 16, true);
        }
        if constexpr (GS == 0) {
          // row i: the scales of the group that k16 step i starts in
          const int i = ptid >> 5, c = ptid & 31;
          cp_async16(st + PF_S_OFF + i * 512 + c * 16,
                     scales + (size_t)((k0 + 16 * i) / group) * N + n0 + c * 4,
                     true);
        } else if (ptid < 32) {
          cp_async16(st + PF_S_OFF + ptid * 16,
                     scales + (size_t)(k0 / group) * N + n0 + ptid * 4, true);
        }
        cp_async_mbar_arrive(&loaded[slot]);
        if (++ks == k_stages) {
          ks = 0;
          tile += gridDim.x;
        }
      }
      cp_async_wait<0>();
    } else {
      // ---- unpackers: each warp two of the stage's eight 8-row slices of
      // codes into its bf16 B tile, as soon as the stage has landed
      const int uw = warp - 12;
      for (int it = 0; it < n_stages; ++it) {
        const int slot = it % PF_STAGES;
        mbar_wait(&loaded[slot], (it / PF_STAGES) & 1);
        unsigned char* st = smem + slot * PF_STAGE_BYTES;
        unpack_rows(st + PF_C_OFF, st + PF_B_OFF, lane, uw);
        unpack_rows(st + PF_C_OFF, st + PF_B_OFF, lane, uw + 4);
        // the B tile (st.shared) and the x tile (cp.async) visible to wgmma
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[slot]);
      }
    }
  } else {
    // ---- consumers: wgmma per stage, promotion per group
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PF_REGS_CONSUMER)
                 : "memory");
    const int g = lane >> 2, t = lane & 3;
    float acc[64], gacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gacc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_coords(tile, m_tiles, n_tiles, mt, nt);
      const int m0 = mt * PF_BM, n0 = nt * PF_BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if constexpr (GS == 0) {
        const int kg = group / 16;  // k16 steps a group
        int kq = 0;                 // of them done in the current group
        for (int ks = 0; ks < k_stages; ++ks, ++it) {
          const int slot = it % PF_STAGES;
          unsigned char* st = smem + slot * PF_STAGE_BYTES;
          mbar_wait(&ready[slot], (it / PF_STAGES) & 1);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_fence();
          const uint64_t da = wg_desc(st + PF_X_OFF + wg * 64 * 128);
          const uint64_t db = wg_desc(st + PF_B_OFF);
#pragma unroll
          for (int kk = 0; kk < PF_BK / 16; ++kk) {
            wgmma_128(gacc, da + 2 * kk, db + 2 * kk, kq == 0 ? 0 : 1);
            if (++kq == kg) {
              wg_commit();
              wg_wait<0>();
              fence_acc(gacc);
              promote(acc, gacc,
                      reinterpret_cast<const float*>(st + PF_S_OFF + kk * 512),
                      t);
              fence_acc(gacc);
              wg_fence();
              kq = 0;
            }
          }
          wg_commit();
          wg_wait<0>();
          fence_acc(gacc);
          mbar_arrive(&empty[slot]);
        }
      } else {
        // one group per iteration, its stages unrolled: no wgmma is in
        // flight across the loop's back edge (else the compiler waits there)
        for (int gi = 0; gi < k_stages / GS; ++gi) {
#pragma unroll
          for (int s = 0; s < GS; ++s) {
            const int slot = (it + s) % PF_STAGES;
            unsigned char* st = smem + slot * PF_STAGE_BYTES;
            mbar_wait(&ready[slot], ((it + s) / PF_STAGES) & 1);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            wg_fence();
            const uint64_t da = wg_desc(st + PF_X_OFF + wg * 64 * 128);
            const uint64_t db = wg_desc(st + PF_B_OFF);
#pragma unroll
            for (int kk = 0; kk < PF_BK / 16; ++kk)
              wgmma_128(gacc, da + 2 * kk, db + 2 * kk,
                        (s == 0 && kk == 0) ? 0 : 1);
            wg_commit();
          }
          // the group's sum is complete: scale it into the main sum and
          // give the group's stages back to the loader
          wg_wait<0>();
          fence_acc(gacc);
          promote(acc, gacc,
                  reinterpret_cast<const float*>(
                      smem + (it + GS - 1) % PF_STAGES * PF_STAGE_BYTES +
                      PF_S_OFF),
                  t);
          fence_acc(gacc);
#pragma unroll
          for (int s = 0; s < GS; ++s)
            mbar_arrive(&empty[(it + s) % PF_STAGES]);
          it += GS;
        }
      }
      const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col)
                              : make_float2(0.f, 0.f);
        if (r0 < M)
          *reinterpret_cast<float2*>(y + (size_t)r0 * N + col) =
              make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        if (r0 + 8 < M)
          *reinterpret_cast<float2*>(y + (size_t)(r0 + 8) * N + col) =
              make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
      }
    }
  }
}

template <int GS>
int launch_prefill(const bf16* x, const int8_t* wp, const float* scales,
                   const float* bias, float* y, int M, int N, int K,
                   int group, int grid, cudaStream_t st) {
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, int4_prefill_kernel<GS>);
    if (e != cudaSuccess) return static_cast<int>(e);
    launch_regs = (attr.numRegs + 7) / 8 * 8;
  }
  if (launch_regs * PF_THREADS <
      PF_REGS_CONSUMER * 256 + PF_REGS_PRODUCER * 256)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(
      int4_prefill_kernel<GS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PF_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int4_prefill_kernel<GS><<<grid, PF_THREADS, PF_SMEM, st>>>(
      x, wp, scales, bias, y, M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K-splits of the decode kernel (M <= 16) at this shape; the caller's part
// scratch holds splits * M * N f32 when it is above 1.
int int4_decode_splits(int N, int K, int group) {
  if (N % DEC_BN || group < 16 || group % 16 || K % group) return 0;
  return decode_splits(N, K, group);
}

// x [M, K] bf16, wp [K/2, N] int8, scales [K/group, N] f32, bias [N] f32 or
// null -> y [M, N] f32 (bias added to the f32 sums).
// M <= 16 (decode): part, counters as int4_decode_splits says (counters
// [N / 128] int32, zero before the first launch; every launch leaves them
// zero).  Both kernels need group % 16 == 0, N % 128 == 0 and K % group == 0.
int int4_matmul(const void* x, const void* wp, const void* scales,
                const void* bias, void* y, void* part, void* counters, int M,
                int N, int K, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % DEC_BN || group < 16 || group % 16 || K % group || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* w = static_cast<const int8_t*>(wp);
  const float* s = static_cast<const float*>(scales);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  if (M <= 16) {
    const int gpb = decode_groups_per_block(N, K, group);
    dim3 grid(N / DEC_BN, decode_splits(N, K, group));
    float* p = static_cast<float*>(part);
    int* c = static_cast<int*>(counters);
    if (M <= 8)
      int4_decode_kernel<1><<<grid, DEC_WARPS * 32, 0, st>>>(
          xb, w, s, b, out, p, c, M, N, K, group, gpb);
    else
      int4_decode_kernel<2><<<grid, DEC_WARPS * 32, 0, st>>>(
          xb, w, s, b, out, p, c, M, N, K, group, gpb);
    return static_cast<int>(cudaGetLastError());
  }
  // groups of 64, 128 and 256 k rows hold their 1, 2 or 4 stages (of the
  // 5) until their promotion; every other group takes the GS 0 version
  const int tiles = (M + PF_BM - 1) / PF_BM * (N / PF_BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  switch (group) {
    case 64:
      return launch_prefill<1>(xb, w, s, b, out, M, N, K, group, grid, st);
    case 128:
      return launch_prefill<2>(xb, w, s, b, out, M, N, K, group, grid, st);
    case 256:
      return launch_prefill<4>(xb, w, s, b, out, M, N, K, group, grid, st);
    default:
      return launch_prefill<0>(xb, w, s, b, out, M, N, K, group, grid, st);
  }
}

}  // extern "C"
