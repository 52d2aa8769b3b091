// Shared device helpers for the hand-written Hopper kernels: cp.async
// copies, ldmatrix fragment loads, the bf16 m16n8k16 and s8 m16n8k32
// tensor-core MMAs, the encoder activations, and the 128 x 128 tile
// mma.sync main loop that the W8A8 encoder GEMM, the int8 bin top-k and
// the score kernel share (the bf16 encoder GEMMs and bin top-k run on
// wgmma.cuh's loop).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, an A fragment holds rows {g, g+8} x cols {2t, 2t+1, 2t+8,
// 2t+9}; a B fragment holds k rows {2t, 2t+1, 2t+8, 2t+9} of column g; the
// f32 accumulator holds rows {g, g+8} x cols {2t, 2t+1}.  In bytes this is
// the layout of mma.m16n8k32 .s8 too (A: rows {g, g+8} x bytes {4t..4t+3,
// 16+4t..16+4t+3}; B: k bytes {4t..4t+3, 16+4t..} of column g; s32
// accumulator as the f32 one), so one loop of 16-bit ldmatrix loads feeds
// both: an int8 [rows, K] tile is read as a bf16 [rows, K / 2] tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

// The card's SM count (the persistent kernels' grids).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
    case ACT_GELU_TANH:
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case ACT_RELU:
      return fmaxf(x, 0.f);
    default:
      return x / (1.f + expf(-x));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; pred=false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b, s8 inputs, s32 accumulate (m16n8k32).
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_acc(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  mma_bf16(c, a, b);
}

__device__ __forceinline__ void mma_acc(int* c, const uint32_t* a,
                                        const uint32_t* b) {
  mma_s8(c, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int MMA_TILE = 128;  // output tile: 128 A rows x 128 B columns
constexpr int MMA_BK = 32;     // K slice per pipeline stage

// The main loop of a 256-thread block that computes one 128 x 128 tile of
// A . B with bf16 mma.sync m16n8k16 and f32 accumulation: a two-stage
// cp.async ring over K in 32-wide slices, ldmatrix fragment loads from
// padded (bank-conflict-free) shared tiles, 8 warps of 64 x 32.  On return,
// acc[mi][ni][half * 2 + j] of warp (wm, wn) = (warp / 4, warp % 4) holds
// row wm*64 + mi*16 + g + half*8 and column wn*32 + ni*8 + 2t + j of the
// tile (g = lane / 4, t = lane % 4).
//   A: [rows, K] row-major from the tile's first row; rows at or past
//      a_rows read as zero.
//   B_NK: B is [cols, K] row-major from the tile's first column (K
//      contiguous); columns at or past b_cols read as zero.
//   otherwise: B is [K, cols] row-major with row stride ldb, from the tile's
//      first column; every column of the tile must exist.
// Needs K % 32 == 0.  Acc float: bf16 products (m16n8k16); Acc int: int8
// products (m16n8k32) of int8 operands passed as bf16 pointers with K
// counted in pairs of int8 (B_NK only).
template <bool B_NK, typename Acc = float>
__device__ __forceinline__ void mma_tile(const bf16* __restrict__ A,
                                         int a_rows,
                                         const bf16* __restrict__ B,
                                         int b_cols, int ldb, int K,
                                         Acc (&acc)[4][4][4]) {
  constexpr int A_LD = MMA_BK + 8;
  constexpr int B_LD = B_NK ? MMA_BK + 8 : MMA_TILE + 8;
  constexpr int B_SIZE = B_NK ? MMA_TILE * B_LD : MMA_BK * B_LD;
  __shared__ __align__(16) bf16 As[2][MMA_TILE * A_LD];
  __shared__ __align__(16) bf16 Bs[2][B_SIZE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = tid; i < MMA_TILE * (MMA_BK / 8); i += 256) {
      int r = i / (MMA_BK / 8), c = (i % (MMA_BK / 8)) * 8;
      bool ok = r < a_rows;
      cp_async16(&As[stage][r * A_LD + c],
                 A + (size_t)(ok ? r : 0) * K + k0 + c, ok);
      if constexpr (B_NK) {
        bool okb = r < b_cols;
        cp_async16(&Bs[stage][r * B_LD + c],
                   B + (size_t)(okb ? r : 0) * K + k0 + c, okb);
      }
    }
    if constexpr (!B_NK) {
#pragma unroll
      for (int i = tid; i < MMA_BK * (MMA_TILE / 8); i += 256) {
        int r = i / (MMA_TILE / 8), c = (i % (MMA_TILE / 8)) * 8;
        cp_async16(&Bs[stage][r * B_LD + c], B + (size_t)(k0 + r) * ldb + c,
                   true);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = Acc(0);

  const int nk = K / MMA_BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) {
      load_tile(stage ^ 1, (kt + 1) * MMA_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[stage];
    const bf16* bs = Bs[stage];
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        int r = wm * 64 + mi * 16 + (lane & 15);
        int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mi], as + r * A_LD + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t4[4];
        if constexpr (B_NK) {
          int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
          int c = kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(t4, bs + r * B_LD + c);
        } else {
          int r = kk + (lane & 15);
          int c = wn * 32 + nj * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(t4, bs + r * B_LD + c);
        }
        bfr[nj * 2][0] = t4[0];
        bfr[nj * 2][1] = t4[1];
        bfr[nj * 2 + 1][0] = t4[2];
        bfr[nj * 2 + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_acc(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
}
