// Paged decode attention: one slot's unnormalised softmax partial over its
// full 128-token pages, read in place from the page pool.
//
// Replaces: bergen_tpu/ops/paged_attention.py::paged_partial_pallas (Pallas
// body _paged_kernel).  For slot s and query head h (KV head h / group) it
// computes, over pages i = starts[s] / 128 .. n_pages[s] - 1 of the slot's
// block table, the online softmax
//   sc = q.k * scale (lanes before starts[s] score -1e30),
//   m' = max(m, max sc), a = exp(m - m'), p = exp(sc - m'),
//   l = l * a + sum p,  acc = acc * a + bf16(p) . V,  m = m'
// and writes acc [S, H, Dh], m and l [S, H] in f32.  A slot with no such
// page writes acc 0, m -1e30, l 0 (an absent partial for the merge).
//
// What bounds it on the H100: the K and V pages (2 * 32 KB per page and KV
// head at Dh 128), about 4 operations per byte, so memory: 34.8 MB at the
// ut1-like tables of Mistral-7B's geometry (10.4 us at 3.35 TB/s), 250 MB at
// the ragged ones.  Design:
// * Work items.  The pages of one (slot, KV head) pair are cut into
//   n_split items (the wrapper's paged_splits, from S, KH, maxP and the SM
//   count alone: no value on the card decides the grid, so a step needs no
//   host sync and stays capturable): item j takes the run of at most
//   P = ceil(maxP / n_split) pages from p0 + j * P.  One block an item,
//   grid S * KH * n_split with the split fastest; an item past the pair's
//   last page ends at once.  Runs, not interleaved pages, so that a slot
//   of P pages or fewer (every slot of a short prompt) is one item whose
//   result is JAX's schedule exactly, and only long slots round in pieces.
// * Copies.  A stage is 64 keys (half a page) of K and of V.  One producer
//   warp brings each in by sixteen 2 KB bulk copies (cp.async.bulk, TMA's
//   one-dimensional form, completing on the stage's mbarrier; the page
//   slice is contiguous in the [NP, KH, 128, 128] pool): eight rows of 256
//   bytes each, the eight-row blocks 2,064 bytes apart, so that the eight
//   rows an ldmatrix reads (key rows 8 apart) fall in eight different bank
//   groups.  A ring of three stages (99 KB) leaves room for two blocks an
//   SM; the consumers hold a page's two stages while the third loads.
// * Products on the tensor cores (mma.sync m16n8k16, f32 sums).  Four
//   consumer warps take 16 keys of each stage (keys 8 b + 2 w and
//   8 b + 2 w + 1, b = 0..7): the scores as q . K^T with the group's G <= 8
//   query heads as the 16 rows (rows G.. zero) and the keys as two n8
//   tiles; those accumulators are, head for head, the B operand of the
//   context product V^T . P^T (dh as 8 m16 tiles, the warp's 16 keys as k,
//   V through ldmatrix.trans), so p never leaves registers.
// * Softmax, page by page as JAX's kernel: each warp reduces its 32 keys'
//   maxima; one named barrier a page shares them, so every warp takes the
//   item's running max (the same in all four), rounds p = exp(sc - m') to
//   bf16 against it and keeps its own l and context, rescaled by the same
//   a; the four are summed, in warp order, at the item's end.
// * Merge.  With one live item the block writes the outputs.  Otherwise
//   each item writes its (acc, m, l) to scratch and the last of the pair's
//   items to arrive (an arrival counter, reset by that block) merges them
//   flash-style in split order: deterministic, one launch, no cooperative
//   grid (no item needs another's max before it rounds).
// An item after the first rounds p against its own running max, not
// against the whole walk's, so a long slot's result is JAX's up to that
// rounding (the wrapper's paged_partial_splits_plain is this schedule in
// PyTorch).
#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr int PAGE = 128;
constexpr int DH = 128;
constexpr int CHUNK = 64;               // keys a stage
constexpr int STAGES = 3;
constexpr int ROW = DH * 2;             // bytes of one key row
constexpr int BLK = 8 * ROW + 16;       // eight key rows and a bank shift
constexpr int HALF = 8 * BLK;           // one stage of K (or of V)
constexpr int STAGE = 2 * HALF;
constexpr int CONSUMERS = 4;            // warps of 16 keys a stage
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int GMAX = 8;                 // query heads a KV head, at most
constexpr int RED_LD = DH + 4;          // a row of the context reduction
constexpr int SMEM = STAGES * STAGE + 2 * CONSUMERS * GMAX * 4 +
                     2 * STAGES * 8;
constexpr float NEG = -1e30f;

static_assert(CONSUMERS * GMAX * RED_LD * 4 + (CONSUMERS + 2) * GMAX * 4 <=
                  STAGES * STAGE,
              "the context reduction reuses the ring");

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barrier 1 over the consumer warps.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMERS) : "memory");
}

// grid S * KH * n_split (split fastest).  part_acc [S * KH, n_split, G, DH]
// and part_ml [S * KH, n_split, G, 2] f32 and counters [S * KH] int32 (zero
// before the first launch, left zero by every launch) are used when
// n_split > 1.
__global__ void __launch_bounds__(THREADS, 2)
    paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ npg, const int* __restrict__ starts,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int* __restrict__ counters,
                 int H, int KH, int G, int maxP, int NP, int n_split,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x % n_split, pair = blockIdx.x / n_split;
  const int s = pair / KH, kh = pair % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = starts[s];
  const int p0 = start / PAGE;
  // a slot has at most maxP pages: its table row bounds the walk
  const int pages = max(min(npg[s], maxP) - p0, 0);
  const int run = (maxP + n_split - 1) / n_split;  // pages an item
  const int live = (pages + run - 1) / run;        // items with a page

  const size_t head0 = (size_t)s * H + kh * G;
  if (j >= live) {
    if (j == 0) {  // no page: the absent partial
      for (int i = tid; i < G * DH; i += THREADS) acc_out[head0 * DH + i] = 0.f;
      if (tid < G) {
        m_out[head0 + tid] = NEG;
        l_out[head0 + tid] = 0.f;
      }
    }
    return;
  }
  const int first = j * run;
  const int chunks = 2 * min(run, pages - first);
  const int* tbl = tables + (size_t)s * maxP + p0 + first;
  float* red_max = reinterpret_cast<float*>(smem + STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red_max + 2 * CONSUMERS * GMAX);
  uint64_t* empty = full + STAGES;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer warp
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % STAGES;
      mbar_wait(&empty[slot], ((c / STAGES) & 1) ^ 1);
      const int page = min(max(tbl[c >> 1], 0), NP - 1);
      if (lane == 0) mbar_expect_tx(&full[slot], 2 * CHUNK * ROW);
      __syncwarp();
      if (lane < 16) {
        const bf16* src = (lane < 8 ? kp : vp) +
                          (((size_t)page * KH + kh) * PAGE + (c & 1) * CHUNK +
                           (lane & 7) * 8) *
                              DH;
        bulk_load(smem + slot * STAGE + (lane >> 3) * HALF + (lane & 7) * BLK,
                  src, 8 * ROW, &full[slot]);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // the group's queries as the A operand: row g (head g; rows 8.. zero)
  uint32_t qa[DH / 16][2];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qa[kk][0] = qa[kk][1] = 0u;
    if (g < G) {
      const bf16* qr = q + (head0 + g) * DH + 16 * kk + 2 * t;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  // this lane's ldmatrix row: key 8 (lane % 8) + 2 warp + lane / 16 of the
  // stage, 16-byte column (lane / 8) % 2 of a 32-byte k (or dh) step
  const int roff = (lane & 7) * BLK + (2 * warp + (lane >> 4)) * ROW +
                   ((lane >> 3) & 1) * 16;
  // the page keys of this thread's eight scores (head g): four in each
  // half of the page
  int key[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[4 * h] = h * CHUNK + 16 * t + 2 * warp;
    key[4 * h + 1] = key[4 * h] + 8;
    key[4 * h + 2] = key[4 * h] + 1;
    key[4 * h + 3] = key[4 * h] + 9;
  }
  // running max of heads g, 2t and 2t + 1 (the same in every warp)
  float m_g = NEG, m_c0 = NEG, m_c1 = NEG;
  float l_g = 0.f;  // head g over this thread's keys
  float acc[DH / 16][4];  // context [dh 16 mt + g (+8)][head 2t (+1)]
#pragma unroll
  for (int mt = 0; mt < DH / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  for (int c = 0; c < chunks; c += 2) {  // one page: stages c and c + 1
    const unsigned char* kb[2];
    float x[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (c + h) % STAGES;
      mbar_wait(&full[slot], ((c + h) / STAGES) & 1);
      kb[h] = smem + slot * STAGE + roff;
      float sA[4] = {0.f, 0.f, 0.f, 0.f}, sB[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kb[h] + 32 * kk);
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(sA, a, b);
        mma_bf16(sB, a, b + 2);
      }
      x[4 * h] = sA[0];
      x[4 * h + 1] = sA[1];
      x[4 * h + 2] = sB[0];
      x[4 * h + 3] = sB[1];
    }
    const int pos0 = (p0 + first + (c >> 1)) * PAGE;
    bool ok[8];
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ok[i] = pos0 + key[i] >= start;
      x[i] = ok[i] ? x[i] * scale : NEG;
      mx = fmaxf(mx, x[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float* rm = red_max + ((c >> 1) & 1) * CONSUMERS * GMAX;
    if (t == 0) rm[warp * GMAX + g] = mx;
    consumers_sync();
    auto page_max = [&](int h) {
      float v = rm[h];
#pragma unroll
      for (int w = 1; w < CONSUMERS; ++w) v = fmaxf(v, rm[w * GMAX + h]);
      return v;
    };
    const float n_g = fmaxf(m_g, page_max(g));
    const float n_c0 = fmaxf(m_c0, page_max(2 * t));
    const float n_c1 = fmaxf(m_c1, page_max(2 * t + 1));
    const float a_g = expf(m_g - n_g), a_c0 = expf(m_c0 - n_c0),
                a_c1 = expf(m_c1 - n_c1);
    m_g = n_g;
    m_c0 = n_c0;
    m_c1 = n_c1;
    float p[8], psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i] = ok[i] ? expf(x[i] - n_g) : 0.f;
      psum += p[i];
    }
    l_g = l_g * a_g + psum;
#pragma unroll
    for (int mt = 0; mt < DH / 16; ++mt) {
      acc[mt][0] *= a_c0;
      acc[mt][1] *= a_c1;
      acc[mt][2] *= a_c0;
      acc[mt][3] *= a_c1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t pb[2] = {pack_bf16x2(p[4 * h], p[4 * h + 1]),
                              pack_bf16x2(p[4 * h + 2], p[4 * h + 3])};
      const unsigned char* vb = kb[h] + HALF;
#pragma unroll
      for (int mt = 0; mt < DH / 16; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vb + 32 * mt);
        mma_bf16(acc[mt], a, pb);
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[c % STAGES]);
      mbar_arrive(&empty[(c + 1) % STAGES]);
    }
  }

  // the item's partial: the four warps' sums in warp order, through the
  // ring (every stage has landed and been read once all warps pass)
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 1);
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 2);
  consumers_sync();
  float* red = reinterpret_cast<float*>(smem);  // [CONSUMERS][GMAX][RED_LD]
  float* red_l = red + CONSUMERS * GMAX * RED_LD;  // [CONSUMERS][GMAX]
  float* red_m = red_l + CONSUMERS * GMAX;         // [GMAX]
  int* flag = reinterpret_cast<int*>(red_m + GMAX);
#pragma unroll
  for (int mt = 0; mt < DH / 16; ++mt) {
    float* r = red + (warp * GMAX + 2 * t) * RED_LD + 16 * mt + g;
    r[0] = acc[mt][0];
    r[RED_LD] = acc[mt][1];
    r[8] = acc[mt][2];
    r[RED_LD + 8] = acc[mt][3];
  }
  if (t == 0) {
    red_l[warp * GMAX + g] = l_g;
    if (warp == 0) red_m[g] = m_g;
  }
  consumers_sync();
  const bool direct = live == 1;
  const size_t item = (size_t)pair * n_split + j;
  float* dst = direct ? acc_out + head0 * DH : part_acc + item * G * DH;
  for (int i = tid; i < G * DH; i += 32 * CONSUMERS) {
    const int h = i / DH, d = i % DH;
    float v = red[h * RED_LD + d];
#pragma unroll
    for (int w = 1; w < CONSUMERS; ++w) v += red[(w * GMAX + h) * RED_LD + d];
    dst[i] = v;
  }
  if (tid < G) {
    float l = red_l[tid];
#pragma unroll
    for (int w = 1; w < CONSUMERS; ++w) l += red_l[w * GMAX + tid];
    if (direct) {
      m_out[head0 + tid] = red_m[tid];
      l_out[head0 + tid] = l;
    } else {
      part_ml[(item * G + tid) * 2] = red_m[tid];
      part_ml[(item * G + tid) * 2 + 1] = l;
    }
  }
  if (direct) return;

  // the last of the pair's live items to arrive merges them, in split order
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    const int last = atomicAdd(&counters[pair], 1) == live - 1;
    if (last) counters[pair] = 0;  // fit for the next launch
    *flag = last;
  }
  consumers_sync();
  if (!*flag) return;
  __threadfence();
  const float* pa = part_acc + (size_t)pair * n_split * G * DH;
  const float* pm = part_ml + (size_t)pair * n_split * G * 2;
  for (int i = tid; i < G * DH; i += 32 * CONSUMERS) {
    const int h = i / DH;
    float m = NEG;
    for (int k = 0; k < live; ++k) m = fmaxf(m, __ldcg(pm + (k * G + h) * 2));
    float a = 0.f, l = 0.f;
    for (int k = 0; k < live; ++k) {
      const float w = expf(__ldcg(pm + (k * G + h) * 2) - m);
      a += __ldcg(pa + (size_t)k * G * DH + i) * w;
      l += __ldcg(pm + (k * G + h) * 2 + 1) * w;
    }
    acc_out[head0 * DH + i] = a;
    if (i % DH == 0) {
      m_out[head0 + h] = m;
      l_out[head0 + h] = l;
    }
  }
}

}  // namespace

extern "C" {

// q [S, H, 128] bf16; k/v pool [NP, KH, 128, 128] bf16; tables [S, maxP],
// n_pages and starts [S] int32 -> acc [S, H, 128], m and l [S, H] f32, over
// n_split items a (slot, KV head) pair.  n_split > 1 needs part_acc (at
// least S * KH * n_split * G * 128 f32), part_ml (S * KH * n_split * G * 2
// f32) and counters (S * KH int32, zero before the first launch; every
// launch leaves them zero); launches that share them must be on one stream.
// Returns cudaErrorInvalidValue for a head width, group or split it does
// not take.
int paged_partial(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* npg, const void* starts,
                  void* acc, void* m, void* l, void* part_acc, void* part_ml,
                  void* counters, int S, int H, int KH, int maxP, int NP,
                  int Dh, int n_split, float scale, void* stream) {
  if (Dh != DH || KH <= 0 || H % KH != 0 || H / KH > GMAX || NP <= 0 ||
      maxP <= 0 || n_split < 1 ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if ((long long)S * KH * n_split >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  static int ready = 0;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = 1;
  }
  paged_kernel<<<S * KH * n_split, THREADS, SMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(npg), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters), H, KH,
      H / KH, maxP, NP, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resident blocks an SM (the split rule assumes two).
int paged_partial_blocks_per_sm() {
  int n = 0;
  cudaFuncSetAttribute(paged_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_kernel, THREADS,
                                                    SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
