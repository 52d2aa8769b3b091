// Shared device helpers for the hand-written Hopper kernels: cp.async
// copies, ldmatrix fragment loads, the bf16 m16n8k16 tensor-core MMA and
// the encoder activations (the GEMMs run on wgmma.cuh's loop).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, an A fragment holds rows {g, g+8} x cols {2t, 2t+1, 2t+8,
// 2t+9}; a B fragment holds k rows {2t, 2t+1, 2t+8, 2t+9} of column g; the
// f32 accumulator holds rows {g, g+8} x cols {2t, 2t+1}.
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
