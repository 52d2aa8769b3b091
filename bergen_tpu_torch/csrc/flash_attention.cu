// Causal GQA flash attention for prefill, reading K and V in place.
//
// Replaces: bergen_tpu/ops/flash_attention.py::flash_attention (:144, Pallas
// body _flash_kernel).  For batch row b, query head h (KV head h / group)
// and query row i at position q_offset + i it computes, over its keys,
//   x = q.k * scale, masked to -1e30 where the key is above the diagonal
//       (causal) or not valid, and excluded (-inf) past the keys visited;
//   m' = max(m, rowmax x), p = exp(x - m'), a = exp(m - m'),
//   l' = l * a + rowsum p, acc' = acc * a + bf16(p) . V,
// then out = acc / max(l, 1e-30) in bf16: the TPU kernel's online softmax
// with its -1e30 mask, so a row with no valid key averages V uniformly over
// the keys it visits.  The visited keys of the 64-row query block [r0,
// r0 + 64) are [0, min(Sk, 64 * ((q_offset + last row) / 64 + 1))) (all Sk
// without causal), as ops/flash_attention.py::_visited_keys says.
//
// What bounds it on the H100: 4 * B * H * Dh * (keys visited per row)
// tensor-core operations (the causal work from key 0 at Llama-2-7B width,
// B 8, S 2,048: 2.75e11, 0.278 ms at the bf16 peak); its bytes (q, k, v
// and out, 0.54 GB there) take 0.16 ms.  The design keeps the tensor cores
// fed: it runs on wgmma_attention.cuh's warp-specialised main loop, with
// 128-query x 128-key tiles (one producer thread streaming Q, K and V by
// TMA through three-dimensional maps of the cache, rows past Sk reading as
// zeros, and the key mask read into bits by the producer group's other
// warps; two consumer warpgroups of 64 rows issuing S = Q.K^T and
// O += P.V on wgmma with P in registers, each one's softmax overlapping
// the other's products).  A persistent grid walks units of two query
// tiles of one (row, head), the longest causal tile with the shortest, so
// every unit carries the same work; consecutive units share their K/V head,
// whose tiles then come from L2.  Key tiles wholly past a tile's visited
// keys are not loaded; tiles on the diagonal or with a masked key are
// masked per element, the others only scaled; keys past the visited end of
// a warpgroup's 64-row block score -inf.  The head width DH (64, 96, 128
// or 256) is a template parameter.  At 256 (Gemma's) a 128 x 256 query tile
// is 64 KiB, so a block holds one query slot, two stages of 64-key K and V
// tiles (64-key S by m64n64 wgmma, P.V by one m64n256 wgmma per 16 keys,
// O in 128 registers a thread) and no output staging box: each consumer
// thread stores its rows' bf16 pairs straight to the output.  At 96
// (Phi-3's) a row of 192 bytes is past the 128-byte swizzle's 64-element
// box, so a head takes the 128-wide tiles of head width 128 through two
// 64-wide boxes from its first column: the second box's last 32 columns
// hold the next head's values (zeros past the last head), which the
// scores skip (6 k16 steps, DK 96) and P . V carries into 32 output
// columns that are never stored: the output goes from registers, 96
// columns a row, as at 256.
#include "wgmma_attention.cuh"

namespace {

template <int DH_>
struct FlashPolicy {
  // head width 256: one query slot and two stages of 64-key K and V
  // (192 KiB), the output stored from registers (o_row); head width 96:
  // the 128-wide tiles with DK 96 (the boxes' last 32 columns unused, the
  // output stored from registers)
  static constexpr int DH = DH_ == 96 ? 128 : DH_, DK = DH_;
  static constexpr int BK = DH_ == 256 ? 64 : 128;
  static constexpr int STAGES = DH_ == 64 ? 4 : 2;
  static constexpr int QS = DH_ == 256 ? 1 : 2;
  static constexpr bool SPLIT = false;
  static constexpr int XB = 0;
  __device__ static float m_init() { return -1e30f; }
  static constexpr bool CLAMP_L = true;
  struct Pre {};
  CUtensorMap tq, tk, tv, to;
  const uint8_t* valid;  // row b at valid + b * valid_stride
  bf16* out;             // [B, Sq, H, DH]
  int B, Sq, Sk, H, group, n_qt, causal, q_offset, valid_stride;
  float scale;

  __host__ __device__ int n_pairs() const { return (n_qt + 1) / 2; }
  __host__ __device__ int n_units() const { return B * H * n_pairs(); }
  // unit (b, h, k): query tiles n_qt - 1 - k and k (one when they meet)
  __device__ int n_qtiles(int u) const {
    const int k = u % n_pairs();
    return n_qt - 1 - k > k ? 2 : 1;
  }
  // the keys [0, end) that the 64-row block ending at row q1 - 1 visits
  __device__ int visited(int q1) const {
    if (!causal) return Sk;
    return min(Sk, ((q_offset + q1 - 1) / 64 + 1) * 64);
  }
  __device__ AttTile tile(int u, int i) const {
    const int k = u % n_pairs(), bh = u / n_pairs();
    const int q0 = (i == 0 ? n_qt - 1 - k : k) * AT_BQ;
    const int h = bh % H;
    const int end = visited(min(q0 + AT_BQ, Sq));
    return {bh / H, h, h / group, q0, (end + BK - 1) / BK};
  }
  __device__ int3 q_box(const AttTile& t, int r) const {
    return make_int3(t.qh * DK, t.q0 + 64 * r, t.b);
  }
  __device__ int3 kv_box(const AttTile& t, int j, int h) const {
    return make_int3(t.kvh * DK, j * BK + 64 * h, t.b);
  }
  __device__ bool key_ok(const AttTile& t, int key) const {
    return key < Sk && valid[(size_t)t.b * valid_stride + key] != 0;
  }
  __device__ void load_extra(void*, uint64_t*, const AttTile&, int) const {}
  __device__ void prefetch(Pre&, const AttTile&, int, int, int, int) const {}
  // y = q.k * scale * log2 e; -1e30 above the diagonal or at an invalid
  // key; -inf past the warpgroup's visited keys
  template <int N>
  __device__ void scores(float (&s)[N], const uint32_t (&bits)[N / 16],
                         const unsigned char*, const Pre&, const AttTile& t,
                         int j, int wg, int warp, int lane) const {
    const int k0 = j * BK, r0 = t.q0 + 64 * wg;
    const int end = r0 < Sq ? visited(min(r0 + 64, Sq)) : 0;
    const float scale2 = scale * AT_L2E;
    bool all_valid = true;
#pragma unroll
    for (int w = 0; w < BK / 32; ++w) all_valid &= bits[w] == ~0u;
    const bool diag = causal && k0 + BK - 1 > q_offset + r0;
    if (all_valid && !diag && k0 + BK <= end) {
#pragma unroll
      for (int x = 0; x < N; ++x) s[x] *= scale2;
      return;
    }
    const int qpos = q_offset + r0 + 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int key = k0 + 8 * (x >> 2) + c0 + (x & 1);
      const bool ok =
          (bits[x >> 4] >> (8 * ((x >> 2) & 3) + c0 + (x & 1))) & 1;
      float v = ok ? s[x] * scale2 : -1e30f;
      if (causal && key > qpos + 8 * ((x >> 1) & 1)) v = -1e30f;
      if (key >= end) v = -INFINITY;
      s[x] = v;
    }
  }
  __device__ int3 o_box(const AttTile& t, int wg) const {
    return make_int3(t.qh * DH, t.q0 + 64 * wg, t.b);
  }
  __device__ bf16* o_row(const AttTile& t, int wg, int r) const {
    const int row = t.q0 + 64 * wg + r;
    return row < Sq ? out + (((size_t)t.b * Sq + row) * H + t.qh) * DK
                    : nullptr;
  }
};

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int Sq, int Sk, int H, int KH,
           long long kv_batch_stride, long long kv_row_stride,
           int valid_stride, int causal, int q_offset, float scale,
           cudaStream_t st) {
  // DH is the head width (96: FlashPolicy's 128-wide tiles with DK 96)
  FlashPolicy<DH> p;
  const long long qrow = (long long)H * DH;
  int e = tma_map_3d(&p.tq, q, qrow, Sq, B, qrow * 2, qrow * Sq * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.tk, k, (long long)KH * DH, Sk, B, kv_row_stride * 2,
                   kv_batch_stride * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.tv, v, (long long)KH * DH, Sk, B, kv_row_stride * 2,
                   kv_batch_stride * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.to, out, qrow, Sq, B, qrow * 2, qrow * Sq * 2, 64, 64);
  if (e != 0) return e;
  p.valid = static_cast<const uint8_t*>(valid);
  p.out = static_cast<bf16*>(out);
  p.valid_stride = valid_stride;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.group = H / KH;
  p.n_qt = (Sq + AT_BQ - 1) / AT_BQ;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  return att_launch(p, st);
}

}  // namespace

extern "C" {

// q [B, Sq, H, Dh] bf16 (contiguous, 16-byte aligned); k, v: rows of KH*Dh
// bf16 at kv_row_stride elements, batch rows kv_batch_stride apart (both
// multiples of 8, bases 16-byte aligned), Sk keys; valid [B, Sk] bytes (0:
// masked), rows valid_stride apart -> out [B, Sq, H, Dh] bf16.  Returns
// cudaErrorInvalidValue for a head width it was not built for.
int flash_attention(const void* q, const void* k, const void* v,
                    const void* valid, void* out, int B, int Sq, int Sk,
                    int H, int KH, int Dh, int kv_batch_stride,
                    int kv_row_stride, int valid_stride, int causal,
                    int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0) return 0;
  if (Dh == 64)
    return launch<64>(q, k, v, valid, out, B, Sq, Sk, H, KH, kv_batch_stride,
                      kv_row_stride, valid_stride, causal, q_offset, scale,
                      st);
  if (Dh == 96)
    return launch<96>(q, k, v, valid, out, B, Sq, Sk, H, KH, kv_batch_stride,
                      kv_row_stride, valid_stride, causal, q_offset, scale,
                      st);
  if (Dh == 128)
    return launch<128>(q, k, v, valid, out, B, Sq, Sk, H, KH,
                       kv_batch_stride, kv_row_stride, valid_stride, causal,
                       q_offset, scale, st);
  if (Dh == 256)
    return launch<256>(q, k, v, valid, out, B, Sq, Sk, H, KH,
                       kv_batch_stride, kv_row_stride, valid_stride, causal,
                       q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
